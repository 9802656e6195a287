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
functions for the tests, the CPU and autograd, and the sliding-window
``local`` blocks of ``transformer.py`` run their prompts on them there; on
the card those prompts take K3 with its causal window
(``_flash_fwd(window=)``).
Decode attends over the cache through
``ops.decode_attention`` (the split-K kernel D1 on the card, which reads
the bf16 cache in place), as do the ring cache of the ``local`` blocks
and Whisper's cross-attention decode; MLA's default decode
(``mla_decode="absorbed"``) attends in the latent space through
``ops.mla_decode_attention`` (the kernel D2 on the card, which reads the
bf16 latents in place).
Whisper's encoder (non-causal, no cache) takes K3's full path; its
decoder's cross-attention over the encoder's output (no cache) runs the
plain ``full_attention``, as the reference's does. A window inside an
``attn`` block (``attention_kind="local"``) takes the reference's plain
routes with the window, as the reference runs it. Under YaRN
(``cfg.rope_scaling``) an ``attn`` block rotates q and k by its
frequencies and multiplies q by its softmax gain before K3 or D1, which
scale by 1/sqrt(hd) themselves; the ``local`` blocks keep plain RoPE
(Mellum2's per-type rope).

Caches are updated in place: a decode step writes its token's k/v into the
cache it was given and returns the same tensors, where the functional
reference returns new ones. That keeps a 12.9 GB cache from being copied
every step.

A prompt of more than one token written into a cache at t > 0 raises
(ROADMAP queue 3, fault 8): the reference attends there as if t were 0.

While autograd records (training), K3 runs inside ``FlashAttention``:
its forward is the kernel, its backward autograd through
``plain_attention``, the form the reference trains through.

On the train step's sequence block (``sharding.seq_block``) a block with
no cache gathers the sequence over ``model``, projects only this rank's
heads (``Heads``; MLA's latents are gathered instead of x), attends over
the whole sequence, so the causal mask needs no offset, and its output
projection's partial sum is reduce-scattered back to the sequence block.
Where ``model`` does not divide the heads every rank computes all of them
and keeps its block; where it divides the q heads but not the kv heads,
every kv head is projected and each of this rank's q heads takes its own.

Serving under a ``CacheBlock`` (``sharding.use_cache_block``) keeps each
cache in its own layout, not attention's: a prompt computed on this
rank's heads writes every head of the cache rows this rank holds
(``write_prompt``), and a decode step attends over those rows and combines
the ranks' partial softmaxes (``split_k_combine``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import layers as L
from repro_torch.models.sharding import (constrain, current_cache_block,
                                         seq_block)

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
        qk = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora_rank:
            q = {"wq_a": L.dense_init(generator, (d, m.q_lora_rank), **kw),
                 "q_norm": L.init_norm("rmsnorm", m.q_lora_rank,
                                       device=device, lead=lead),
                 "wq_b": L.dense_init(generator, (m.q_lora_rank, h, qk),
                                      **kw)}
        else:                                   # a direct query projection
            q = {"wq": L.dense_init(generator, (d, h, qk), **kw)}
        return {
            **q,
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


def split_k_combine(m, l, o, group):
    """The exact softmax-weighted output over keys split across
    ``group``'s ranks, from each rank's partial max ``m`` (...), sum ``l``
    (...) and unnormalised output ``o`` (..., dv), all f32: one all-reduce
    of the max, then one of the sum and output rescaled to it. A rank
    whose keys are all masked brings max NEG_INF and sum 0; its rescale
    exp(NEG_INF - max) is 0, so it adds nothing and divides nothing while
    any rank holds a valid key."""
    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    a = torch.exp(m - top)
    both = torch.cat([(l * a)[..., None], o * a[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    return both[..., 1:] / both[..., :1]


def decode_attention(q, k_cache, v_cache, t, *, window: int = 0,
                     offset: int = 0, group=None, pos=None):
    """Single-token attention over a (B,S,kv,hd) cache, valid length t:
    the keys at positions [t - window, t) ([0, t) with no window), read by
    ``ops.decode_attention`` (the kernel D1 on the card, in the cache's
    own dtype; no f32 copy of it). ``offset`` is the global position of
    the cache's first row, ``pos`` (S,) the position each row holds where
    the rows are a ring's slots (-1 empty), and ``group`` the ranks
    holding the other rows, whose partials ``split_k_combine`` merges;
    with no group the output is o / l, the same arithmetic."""
    b, _, h, hd = q.shape
    m, l_sum, o = ops.decode_attention(
        q.reshape(b, h, hd), k_cache, v_cache,
        lo=t - window if window > 0 else None, hi=t, offset=offset, pos=pos)
    if group is not None:
        o = split_k_combine(m, l_sum, o, group)
    else:
        o = o / l_sum[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _flash(q, k, v, *, causal: bool):
    """(B,S,H,hd) q and (B,S,kv,hd) k/v through ops.flash_attention; while
    autograd records, through ``FlashAttention``, whose backward is the
    reference's plain attention."""
    if L.records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal=causal)


def takes_window_kernel(q, k, v) -> bool:
    """Whether a causal windowed prompt runs on K3's window: on the card,
    bf16, a head dim K3 has, and no autograd graph recorded through it
    (its backward would be the plain form). Elsewhere, and at head dim 256
    (RecurrentGemma), the plain windowed routes."""
    return (q.is_cuda and q.dtype == torch.bfloat16
            and q.shape[-1] in HEAD_DIMS and not L.records_grad(q, k, v))


def plain_attention(q, k, v, *, causal: bool, window: int = 0):
    """The attention the reference trains through, as ``gqa_forward``
    picks it with no cache: ``full_attention`` up to two blocks, else
    ``chunked_attention`` (so no S x S f32 matrix is held at S = 4096).
    It is also the route of a window inside an ``attn`` block with no
    cache: K3 has no window (ROADMAP item 18)."""
    s = q.shape[1]
    blk = _pick_block(s, k.shape[1])
    if s <= 2 * blk:
        return full_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_block=blk, kv_block=blk)


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


def _flash_fwd(q, k, v, *, causal: bool, window: int = 0):
    """K3's forward (the plain version on the CPU); ``window`` > 0 keeps
    the keys k with q - k < window of a causal call."""
    g = q.shape[2] // k.shape[2]
    s = q.shape[1]
    blk = _pick_block(s, s, 128)
    o = ops.flash_attention(
        q.transpose(1, 2).contiguous(),
        k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
        v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
        causal=causal, bq=blk, bk=blk, window=window)
    return o.transpose(1, 2)


# --------------------------------------------------------------------- #
# GQA block (projection + attention + output)
# --------------------------------------------------------------------- #
def _to_block(out, blk, split: bool):
    """An attention block's output (B, S, D) over the whole sequence, back
    on this rank's sequence block ``blk``: the sum of the ranks' partial
    sums over their heads where the heads are ``split``, else this block
    of the whole (None: as it is)."""
    if blk is None:
        return out
    if split:
        return blk.scatter_seq(out)
    return out[:, blk.share(out.shape[1])]


@dataclasses.dataclass(frozen=True)
class Heads:
    """The projections of a GQA block that this rank computes: on a
    sequence block ``blk`` where ``model`` divides the heads, this rank's
    q heads (and ``wo``'s rows for them) and their kv heads, or every kv
    head with ``kv_idx``, the kv head of each of this rank's q heads, where
    it does not divide the kv heads; else all of them."""
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    blk: object = None
    split: bool = False
    kv_idx: torch.Tensor = None

    @classmethod
    def of(cls, p, cfg, blk):
        hs = blk.share(cfg.num_heads) if blk is not None else None
        if hs is None:
            return cls(p["wq"], p["wk"], p["wv"], p["wo"], blk)
        kvs = blk.share(cfg.num_kv_heads)
        if kvs is not None:
            return cls(p["wq"][:, hs], p["wk"][:, kvs], p["wv"][:, kvs],
                       p["wo"][hs], blk, True)
        g = cfg.num_heads // cfg.num_kv_heads
        idx = torch.arange(hs.start, hs.stop, device=p["wq"].device) // g
        return cls(p["wq"][:, hs], p["wk"], p["wv"], p["wo"][hs], blk, True,
                   idx)

    def kv(self, k, v):
        """k, v (B, S, kv, hd) for this rank's q heads."""
        if self.kv_idx is None:
            return k, v
        return k[:, :, self.kv_idx], v[:, :, self.kv_idx]

    def to_block(self, out):
        return _to_block(out, self.blk, self.split)


def gqa_forward(x, p, cfg, positions, *, causal=True, cache=None, t=None,
                kv_source=None):
    """x: (B,S,D). cache: dict(k, v) of (B,Smax,kv,hd), updated in place,
    or None. ``kv_source`` (B,Skv,D) makes it cross-attention (Whisper's
    decoder): k/v are projected from it, no positions apply, and it attends
    with the plain ``full_attention``, as the reference does (K3 takes q,
    k and v of one length). Returns (out, cache). On a sequence block x
    is this rank's block and ``positions`` the whole sequence's.

    Under a serving ``CacheBlock`` whose cache holds an S block of
    ``max_len`` rows (``sharding.use_cache_block``), a prompt writes every
    head of the rows of its block (``write_prompt``) and a decode step
    attends over them (``decode_attention``'s split-K combine)."""
    blk = seq_block()
    if blk is not None:
        x = blk.gather_seq(x)
    b, s, d = x.shape
    window = cfg.local_window if cfg.attention_kind == "local" else 0
    src = x if kv_source is None else kv_source
    w = Heads.of(p, cfg, blk)
    q = torch.einsum("bsd,dhk->bshk", x, w.wq)
    k_kv, v_kv = (torch.einsum("bsd,dhk->bshk", src, w.wk),
                  torch.einsum("bsd,dhk->bshk", src, w.wv))
    k, v = w.kv(k_kv, v_kv)
    q, k, v = _constrain_qkv(q, k, v)
    if kv_source is not None:
        o = full_attention(q, k, v, causal=False)
        return w.to_block(torch.einsum("bshk,hkd->bsd", o, w.wo)), cache
    rs = cfg.rope_scaling
    q = L.positional(q, positions, cfg.pos_kind, cfg.rope_theta, rs)
    k = L.positional(k, positions, cfg.pos_kind, cfg.rope_theta, rs)
    if rs is not None and rs.softmax_gain != 1.0:
        q = q * rs.softmax_gain         # K3 and D1 scale by 1/sqrt(hd)

    if cache is not None:
        cb = current_cache_block()
        own = cb.share(cb.max_len) if cb is not None else None
        _check_prompt_at(s, t, cb.max_len if cb is not None
                         else cache["k"].shape[1])
        if s == 1:  # decode: the rank that holds row t writes it
            offset = own.start if own is not None else 0
            if offset <= t < offset + cache["k"].shape[1]:
                cache["k"][:, t - offset] = k[:, 0].to(cache["k"].dtype)
                cache["v"][:, t - offset] = v[:, 0].to(cache["v"].dtype)
            o = decode_attention(q, cache["k"], cache["v"], t + 1,
                                 window=window, offset=offset,
                                 group=cb.group if own is not None else None)
        else:
            if w.kv_idx is not None:    # every kv head, as the cache holds
                k_kv = L.positional(k_kv, positions, cfg.pos_kind,
                                    cfg.rope_theta, rs)
            else:
                k_kv, v_kv = k, v
            write_prompt(cache, {"k": k_kv, "v": v_kv}, cb,
                         blk if w.split and w.kv_idx is None else None)
            if window:  # the reference's plain route
                o = chunked_attention(q, k, v, causal=causal, window=window)
            else:
                o = _flash(q, k, v, causal=causal)
    elif window:
        o = plain_attention(q, k, v, causal=causal, window=window)
    else:
        o = _flash(q, k, v, causal=causal)
    return w.to_block(torch.einsum("bshk,hkd->bsd", o, w.wo)), cache


def write_prompt(cache, new: dict, cb, heads=None) -> None:
    """Write a prompt's S rows (at t = 0) of each ``new`` leaf (B, S, ...)
    into ``cache``: where the ``CacheBlock`` ``cb`` splits the cache's
    ``max_len`` rows over ``model``, only the rows of this rank's block
    (the rows [r·max_len/m, (r+1)·max_len/m) of the prompt, none where
    the prompt ends before it: a prompt shorter than max_len/m lands
    whole on rank 0's block, correct but unbalanced). ``heads``: the
    sequence block whose ``model`` axis split dim 2 (the kv heads) of each
    leaf; every head of this rank's rows is then fetched from the others,
    the exchange from (S, H/m) to (S block, H) by one all-to-all
    (``CacheBlock.to_owners``), or gathered where the cache is whole."""
    for key, val in new.items():
        s = val.shape[1]
        own = cb.share(cb.max_len) if cb is not None else None
        if own is None:
            if heads is not None:
                val = heads.gather_plain(val, 2)
        elif heads is not None:
            owner = torch.arange(s, device=val.device) // (own.stop
                                                           - own.start)
            val = cb.to_owners(val, owner)
        else:
            val = val[:, min(own.start, s):min(own.stop, s)]
        cache[key][:, :val.shape[1]] = val.to(cache[key].dtype)


def _check_prompt_at(s: int, t, rows: int) -> None:
    """A cache update needs t; a prompt (s > 1) must start the cache; and
    the tokens must fit its ``rows`` (the global max_len)."""
    if t is None:
        raise ValueError("cache update requires t")
    if s > 1 and t > 0:
        raise ValueError(
            f"a prompt of {s} tokens into a cache at t = {t} > 0: the "
            "reference attends there as if t were 0 (ROADMAP queue 3, "
            "fault 8); prefill at t = 0 and decode one token a step")
    if t + s > rows:
        raise ValueError(
            f"{s} tokens at t = {t} past a cache of {rows} rows: the "
            "reference clamps the write into the last rows (ROADMAP queue "
            "3, fault 17)")


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
    expanded from the cached latents under ``"expand"``. The query comes
    through a latent (``wq_a``, ``q_norm``, ``wq_b``) or, with
    ``q_lora_rank`` 0, straight from x (``wq``). Under YaRN
    (``cfg.rope_scaling``) the rope dims rotate by its frequencies and the
    softmax scale takes its mscale^2: q is multiplied by it before the
    kernels, which scale by 1/sqrt(dn + dr) themselves.

    On a sequence block the latents of this rank's positions are gathered
    over ``model`` and this rank's heads expanded from them; a prompt then
    writes the rows of its cache block (``write_prompt``). Under a
    serving ``CacheBlock`` that splits the cache's rows, a decode step
    attends over this rank's rows, in either route, through
    ``split_k_combine``."""
    m = cfg.mla
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    blk = seq_block()
    if m.q_lora_rank:
        q_lat = L.rmsnorm(x @ p["wq_a"], p["q_norm"]["scale"])
        wq = p["wq_b"]
    else:               # a direct query projection: x stands for the latent
        q_lat, wq = x, p["wq"]
    kv_a = x @ p["wkv_a"]                                    # (B,S,r+dr)
    if blk is not None:
        both = blk.gather_seq(torch.cat([q_lat, kv_a], dim=-1))
        q_lat, kv_a = both.split([q_lat.shape[-1], kv_a.shape[-1]], dim=-1)
    hs = blk.share(cfg.num_heads) if blk is not None else None
    wq, wkv_b, wo = ((wq, p["wkv_b"], p["wo"]) if hs is None else
                     (wq[:, hs], p["wkv_b"][:, hs], p["wo"][hs]))
    b, s, _ = kv_a.shape
    # YaRN's mscale^2 on the softmax scale
    gain = cfg.rope_scaling.softmax_gain if cfg.rope_scaling else 1.0

    # queries
    q = torch.einsum("bsr,rhk->bshk", q_lat, wq)             # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta,
                          cfg.rope_scaling)

    # latent kv
    c_kv = L.rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"]["scale"])
    k_rope = L.apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :],
                          positions, cfg.rope_theta,
                          cfg.rope_scaling)[:, :, 0, :]

    group, offset = None, 0
    if cache is not None:
        cb = current_cache_block()
        own = cb.share(cb.max_len) if cb is not None else None
        _check_prompt_at(s, t, cb.max_len if cb is not None
                         else cache["ckv"].shape[1])
        if own is None:
            cache["ckv"][:, t:t + s] = c_kv.to(cache["ckv"].dtype)
            cache["krope"][:, t:t + s] = k_rope.to(cache["krope"].dtype)
            c_kv = cache["ckv"][:, :t + s]    # what the cache holds, as the
            k_rope = cache["krope"][:, :t + s]  # reference reads it back
        elif s == 1:    # the rank holding row t writes it; attend over the
            if own.start <= t < own.stop:     # rows of this rank's block
                cache["ckv"][:, t - own.start] = c_kv[:, 0].to(
                    cache["ckv"].dtype)
                cache["krope"][:, t - own.start] = k_rope[:, 0].to(
                    cache["krope"].dtype)
            c_kv, k_rope = cache["ckv"], cache["krope"]
            group, offset = cb.group, own.start
        else:           # every rank holds the gathered prompt's latents
            write_prompt(cache, {"ckv": c_kv, "krope": k_rope}, cb)
            c_kv = c_kv.to(cache["ckv"].dtype)
            k_rope = k_rope.to(cache["krope"].dtype)
        if s == 1 and cfg.mla_decode == "absorbed":
            o = _mla_absorbed_decode(q_nope, q_rope, c_kv, k_rope,
                                     p["wkv_b"], dn, x.dtype, t + 1, offset,
                                     group, gain)
            return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache

    # expand k/v from the latents
    kv = torch.einsum("bsr,rhk->bshk", c_kv.to(x.dtype), wkv_b)
    k_nope, vv = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.to(x.dtype)[:, :, None, :].expand(
        *k_nope.shape[:-1], dr)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    if gain != 1.0:     # the kernels scale by 1/sqrt(dn + dr) themselves
        qq = qq * gain
    qq, k, vv = _constrain_qkv(qq, k, vv)
    if cache is not None and s == 1:
        o = decode_attention(qq, k, _pad_v(vv, dn + dr), t + 1,
                             offset=offset, group=group)[..., :dv]
    else:
        o = _flash(qq, k, _pad_v(vv, dn + dr), causal=causal)[..., :dv]
    return _to_block(torch.einsum("bshk,hkd->bsd", o, wo), blk,
                     hs is not None), cache


def _mla_absorbed_decode(q_nope, q_rope, ckv, krope, wkv_b, dn, dtype,
                         hi: int, offset: int = 0, group=None,
                         gain: float = 1.0):
    """One token's attention in the latent space: the score is
    (q_nope W_k^T) . c_kv + q_rope . k_rope, and the output
    (p . c_kv) W_v, so K/V are never expanded over the cache. The rows
    whose position (``offset`` + row) lies below ``hi`` are read by
    ``ops.mla_decode_attention`` (the kernel D2 on the card, from the bf16
    latents in place; no f32 copy of them); with ``group`` the rows are
    this rank's block and the latent output is combined over the ranks
    (``split_k_combine``). ``gain`` multiplies the softmax scale."""
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]     # (r,H,dn), (r,H,dv)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_k)      # (B,1,H,r)
    scale = gain / np.sqrt(dn + q_rope.shape[-1])
    m, l_sum, o_lat = ops.mla_decode_attention(
        q_abs[:, 0], q_rope[:, 0], ckv, krope, hi=hi, offset=offset,
        scale=float(scale))
    if group is not None:
        o_lat = split_k_combine(m, l_sum, o_lat, group)
    else:
        o_lat = o_lat / l_sum[..., None]
    return torch.einsum("bhr,rhv->bhv", o_lat.to(dtype), w_v)[:, None]


def _pad_v(v, qk_dim: int):
    """Pad v's head dim up to the q.k head dim, so the shared attention
    code (and K3) applies."""
    dv = v.shape[-1]
    if dv == qk_dim:
        return v
    return torch.nn.functional.pad(v, (0, qk_dim - dv))
