"""Attention: GQA/MHA and DeepSeek's MLA, with the flash kernel on the
prefill path.

PyTorch counterpart of ``repro/models/attention.py``. Causal self-attention
without a cache (training-style forward) and the prompt written into a
cache both go through ``ops.flash_attention`` in (B, H, S, D) layout, with
k/v heads repeated for GQA: the CUDA kernel on the card, its plain version
on the CPU. MLA's prompt takes the same route at its q.k dim (192 at full
width), with v padded to it (``_pad_v``). The reference reaches the same
function through ``full_attention``, ``chunked_attention`` or
``chunked_attention_causal_skip`` (pure XLA); they stay here as plain
functions for the tests, and the sliding-window ``local`` blocks of
``transformer.py`` run on them. Decode attends over the cache with
einsums; MLA's default decode (``mla_decode="absorbed"``) attends in the
latent space. Whisper's encoder (non-causal, no cache) takes K3's full
path; its decoder's cross-attention runs the plain ``full_attention``, as
the reference's does. A window inside an ``attn`` block waits for ROADMAP
queue 1, item 18.

Caches are updated in place: a decode step writes its token's k/v into the
cache it was given and returns the same tensors, where the functional
reference returns new ones. That keeps a 12.9 GB cache from being copied
every step.

A prompt of more than one token written into a cache at t > 0 raises
(ROADMAP queue 3, fault 8): the reference attends there as if t were 0.

While autograd records (training), K3 runs inside ``FlashAttention``:
its forward is the kernel, its backward autograd through
``plain_attention``, the form the reference trains through.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain

NEG_INF = -1e30


def _constrain_qkv(*ts):
    """Pin (B, S, H, hd) tensors to (dp, None, model, None), where the
    reference does (there, against GSPMD replicating scan-invariant
    attention operands inside the KV-block loop)."""
    return tuple(constrain(t, "dp", None, "model", None) for t in ts)


# --------------------------------------------------------------------- #
# parameter init
# --------------------------------------------------------------------- #
def init_attention(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
                   device="cpu", lead: tuple = ()):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq_a": L.dense_init(generator, (d, m.q_lora_rank), **kw),
            "q_norm": L.init_norm("rmsnorm", m.q_lora_rank, device=device,
                                  lead=lead),
            "wq_b": L.dense_init(generator, (m.q_lora_rank, h, m.qk_nope_dim
                                             + m.qk_rope_dim), **kw),
            "wkv_a": L.dense_init(generator, (d, m.kv_lora_rank
                                              + m.qk_rope_dim), **kw),
            "kv_norm": L.init_norm("rmsnorm", m.kv_lora_rank, device=device,
                                   lead=lead),
            "wkv_b": L.dense_init(generator, (m.kv_lora_rank, h, m.qk_nope_dim
                                              + m.v_head_dim), **kw),
            "wo": L.dense_init(generator, (h, m.v_head_dim, d),
                               1.0 / np.sqrt(2 * n_layers), **kw),
        }
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


def chunked_attention_causal_skip(q, k, v, *, q_block: int = 1024,
                                  kv_block: int = 1024, groups: int = 4):
    """Causal attention that splits q into ``groups`` chunks, chunk g
    scanning KV only up to its own end (the reference's coarse skip of
    fully masked KV blocks)."""
    sq = q.shape[1]
    groups = min(groups, max(sq // q_block, 1))
    gsz = sq // groups
    outs = []
    for g in range(groups):
        kv_len = (g + 1) * gsz
        outs.append(chunked_attention(
            q[:, g * gsz:(g + 1) * gsz], k[:, :kv_len], v[:, :kv_len],
            causal=True, q_block=min(q_block, gsz),
            kv_block=min(kv_block, kv_len), q_offset=g * gsz))
    return torch.cat(outs, dim=1)


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
    """(B,S,H,hd) q and (B,S,kv,hd) k/v through ops.flash_attention; while
    autograd records, through ``FlashAttention``, whose backward is the
    reference's plain attention."""
    if L.records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal=causal)


def plain_attention(q, k, v, *, causal: bool):
    """The attention the reference trains through, as ``gqa_forward``
    picks it with no cache: ``full_attention`` up to two blocks, else
    ``chunked_attention`` (so no S x S f32 matrix is held at S = 4096)."""
    s = q.shape[1]
    blk = _pick_block(s, k.shape[1])
    if s <= 2 * blk:
        return full_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, q_block=blk,
                             kv_block=blk)


class FlashAttention(torch.autograd.Function):
    """K3 under autograd: the forward is the kernel (``_flash_fwd``), the
    backward autograd through ``plain_attention`` recomputed from q, k, v.
    No Pallas kernel of the reference has a backward: it trains by XLA
    autodiff of these plain forms."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        return L.plain_vjp(
            lambda q, k, v: plain_attention(q, k, v, causal=ctx.causal),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (g,)) + (None,)


def _flash_fwd(q, k, v, *, causal: bool):
    """K3's forward (the plain version on the CPU)."""
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
def gqa_forward(x, p, cfg, positions, *, causal=True, cache=None, t=None,
                kv_source=None):
    """x: (B,S,D). cache: dict(k, v) of (B,Smax,kv,hd), updated in place,
    or None. ``kv_source`` (B,Skv,D) makes it cross-attention (Whisper's
    decoder): k/v are projected from it, no positions apply, and it attends
    with the plain ``full_attention``, as the reference does (K3 takes q,
    k and v of one length). Returns (out, cache)."""
    if cfg.attention_kind == "local":
        raise NotImplementedError("a window in an attn block: ROADMAP queue "
                                  "1, item 18")
    b, s, d = x.shape
    src = x if kv_source is None else kv_source
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    q, k, v = _constrain_qkv(q, k, v)
    if kv_source is not None:
        o = full_attention(q, k, v, causal=False)
        return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache
    q = L.positional(q, positions, cfg.pos_kind, cfg.rope_theta)
    k = L.positional(k, positions, cfg.pos_kind, cfg.rope_theta)

    if cache is not None:
        _check_prompt_at(s, t)
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


def _check_prompt_at(s: int, t) -> None:
    """A cache update needs t; a prompt (s > 1) must start the cache."""
    if t is None:
        raise ValueError("cache update requires t")
    if s > 1 and t > 0:
        raise ValueError(
            f"a prompt of {s} tokens into a cache at t = {t} > 0: the "
            "reference attends there as if t were 0 (ROADMAP queue 3, "
            "fault 8); prefill at t = 0 and decode one token a step")


def _pick_block(sq: int, sk: int, target: int = 1024) -> int:
    """Largest divisor of gcd(sq, sk) that is <= target."""
    g = int(np.gcd(sq, sk))
    for d in range(min(target, g), 0, -1):
        if g % d == 0:
            return d
    return 1


def init_cache(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cpu", lead: tuple = ()):
    lead = tuple(lead) + (batch, max_len)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                   device=device),
                "krope": torch.zeros(lead + (m.qk_rope_dim,), dtype=dtype,
                                     device=device)}
    shape = lead + (cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------- #
# MLA (DeepSeek Multi-head Latent Attention)
# --------------------------------------------------------------------- #
def mla_forward(x, p, cfg, positions, *, causal=True, cache=None, t=None):
    """MLA with a compressed cache: ``ckv`` (B, Smax, kv_lora_rank) and the
    shared ``krope`` (B, Smax, qk_rope_dim), written in place.

    The prompt expands K/V from the latents and attends through
    ``ops.flash_attention`` at the q.k dim, v padded to it. A decode step
    attends over the cache's first t + 1 rows: in the latent space under
    ``mla_decode="absorbed"`` (the reference's default), or over K/V
    expanded from the cached latents under ``"expand"``."""
    m = cfg.mla
    b, s, d = x.shape
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim

    # queries
    q_lat = L.rmsnorm(x @ p["wq_a"], p["q_norm"]["scale"])
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])     # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    # latent kv
    kv_a = x @ p["wkv_a"]                                    # (B,S,r+dr)
    c_kv = L.rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"]["scale"])
    k_rope = L.apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :],
                          positions, cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        _check_prompt_at(s, t)
        cache["ckv"][:, t:t + s] = c_kv.to(cache["ckv"].dtype)
        cache["krope"][:, t:t + s] = k_rope.to(cache["krope"].dtype)
        c_kv = cache["ckv"][:, :t + s]        # what the cache holds, as the
        k_rope = cache["krope"][:, :t + s]    # reference reads it back
        if s == 1 and cfg.mla_decode == "absorbed":
            o = _mla_absorbed_decode(q_nope, q_rope, c_kv, k_rope,
                                     p["wkv_b"], dn, x.dtype)
            return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache

    # expand k/v from the latents
    kv = torch.einsum("bsr,rhk->bshk", c_kv.to(x.dtype), p["wkv_b"])
    k_nope, vv = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.to(x.dtype)[:, :, None, :].expand(
        *k_nope.shape[:-1], dr)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qq, k, vv = _constrain_qkv(qq, k, vv)
    if cache is not None and s == 1:
        o = decode_attention(qq, k, _pad_v(vv, dn + dr), t + 1)[..., :dv]
    else:
        o = _flash(qq, k, _pad_v(vv, dn + dr), causal=causal)[..., :dv]
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


def _mla_absorbed_decode(q_nope, q_rope, ckv, krope, wkv_b, dn, dtype):
    """One token's attention in the latent space: the score is
    (q_nope W_k^T) . c_kv + q_rope . k_rope, and the output
    (p . c_kv) W_v, so K/V are never expanded over the cache."""
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]     # (r,H,dn), (r,H,dv)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_k)      # (B,1,H,r)
    scale = 1.0 / np.sqrt(dn + q_rope.shape[-1])
    ckv_f = ckv.float()
    logits = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_f)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) * scale          # (B,H,1,T)
    pr = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", pr, ckv_f)
    return torch.einsum("bshr,rhv->bshv", o_lat.to(dtype), w_v)


def _pad_v(v, qk_dim: int):
    """Pad v's head dim up to the q.k head dim, so the shared attention
    code (and K3) applies."""
    dv = v.shape[-1]
    if dv == qk_dim:
        return v
    return torch.nn.functional.pad(v, (0, qk_dim - dv))
