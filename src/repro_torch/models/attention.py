"""Attention: GQA/MHA with the flash kernel on the prefill path.

PyTorch counterpart of ``repro/models/attention.py``. Causal self-attention
without a cache (training-style forward) and the prompt written into a
cache both go through ``ops.flash_attention`` in (B, H, S, D) layout, with
k/v heads repeated for GQA: the CUDA kernel on the card, its plain version
on the CPU. The reference reaches the same function through
``full_attention`` or ``chunked_attention`` (pure XLA); both stay here as
plain functions for the tests, and the sliding-window ``local`` blocks of
``transformer.py`` run on them. Decode attends over the cache with one
einsum. MLA and a window inside an ``attn`` block wait for ROADMAP queue 1.

Caches are updated in place: a decode step writes its token's k/v into the
cache it was given and returns the same tensors, where the functional
reference returns new ones. That keeps a 12.9 GB cache from being copied
every step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


# --------------------------------------------------------------------- #
# parameter init
# --------------------------------------------------------------------- #
def init_attention(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
                   device="cpu", lead: tuple = ()):
    if cfg.mla is not None:
        raise NotImplementedError("MLA: ROADMAP queue 1, item 7")
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": L.dense_init(generator, (d, h, hd), **kw),
        "wk": L.dense_init(generator, (d, kv, hd), **kw),
        "wv": L.dense_init(generator, (d, kv, hd), **kw),
        "wo": L.dense_init(generator, (h, hd, d),
                           1.0 / np.sqrt(2 * n_layers), **kw),
    }


# --------------------------------------------------------------------- #
# plain attention (reference shapes: q (B,Sq,H,hd), k/v (B,Sk,kv,hd))
# --------------------------------------------------------------------- #
def _mask(sq, sk, causal, window, q_offset, device):
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def full_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0):
    """Unblocked attention in f32, cast back to q's dtype."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) / np.sqrt(hd)
    s = torch.where(_mask(sq, sk, causal, window, q_offset, q.device), s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_block: int = 1024, kv_block: int = 1024, q_offset=0):
    """Online softmax over KV blocks, as the reference's lax.scan version."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    q_block, kv_block = min(q_block, sq), min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        raise ValueError((sq, q_block, sk, kv_block))
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    outs = []
    for q0 in range(0, sq, q_block):
        qg = q[:, q0:q0 + q_block].reshape(b, q_block, kvh, g, hd)
        m_run = torch.full((b, kvh, g, q_block), NEG_INF, device=q.device)
        l_run = torch.zeros(b, kvh, g, q_block, device=q.device)
        o_run = torch.zeros(b, kvh, g, q_block, hd, device=q.device)
        for k0 in range(0, sk, kv_block):
            kb, vb = k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), kb.float()) * scale
            s = torch.where(mask[q0:q0 + q_block, k0:k0 + kv_block], s, NEG_INF)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            o = torch.einsum("bkgqs,bskh->bkgqh", p, vb.float())
            m_new = torch.maximum(m_run, m)
            a1, a2 = torch.exp(m_run - m_new), torch.exp(m - m_new)
            l_run = l_run * a1 + p.sum(dim=-1) * a2
            o_run = o_run * a1[..., None] + o * a2[..., None]
            m_run = m_new
        out = o_run / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, t, *, window: int = 0):
    """Single-token attention over a (B,S,kv,hd) cache, valid length t."""
    b, s, kvh, hd = k_cache.shape
    h = q.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k_cache.float()) / np.sqrt(hd)
    kpos = torch.arange(s, device=q.device)
    valid = kpos < t
    if window > 0:
        valid &= kpos >= t - window
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _flash(q, k, v, *, causal: bool):
    """(B,S,H,hd) q and (B,S,kv,hd) k/v through ops.flash_attention."""
    g = q.shape[2] // k.shape[2]
    s = q.shape[1]
    blk = _pick_block(s, s, 128)
    o = ops.flash_attention(
        q.transpose(1, 2).contiguous(),
        k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
        v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
        causal=causal, bq=blk, bk=blk)
    return o.transpose(1, 2)


# --------------------------------------------------------------------- #
# GQA block (projection + attention + output)
# --------------------------------------------------------------------- #
def gqa_forward(x, p, cfg, positions, *, causal=True, cache=None, t=None):
    """x: (B,S,D). cache: dict(k, v) of (B,Smax,kv,hd), updated in place,
    or None. Returns (out, cache)."""
    if cfg.attention_kind == "local":
        raise NotImplementedError("a window in an attn block: ROADMAP queue "
                                  "1, item 18")
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = L.positional(q, positions, cfg.pos_kind, cfg.rope_theta)
    k = L.positional(k, positions, cfg.pos_kind, cfg.rope_theta)

    if cache is not None:
        if t is None:
            raise ValueError("cache update requires t")
        cache["k"][:, t:t + s] = k.to(cache["k"].dtype)
        cache["v"][:, t:t + s] = v.to(cache["v"].dtype)
        if s == 1:  # decode: one token at position t
            o = decode_attention(q, cache["k"], cache["v"], t + 1)
        else:       # prompt into the cache
            o = _flash(q, k, v, causal=causal)
    else:
        o = _flash(q, k, v, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, cache


def _pick_block(sq: int, sk: int, target: int = 1024) -> int:
    """Largest divisor of gcd(sq, sk) that is <= target."""
    g = int(np.gcd(sq, sk))
    for d in range(min(target, g), 0, -1):
        if g % d == 0:
            return d
    return 1


def init_cache(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cpu", lead: tuple = ()):
    if cfg.mla is not None:
        raise NotImplementedError("MLA: ROADMAP queue 1, item 7")
    shape = tuple(lead) + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
