"""Public entry points for the port's kernels, with the keyword arguments of
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises (K3, K4 and K5 take strided slices, copied whole first; D1 and D2
read a cache in place through its strides, never a copy); a CPU tensor
goes to the plain version: ``ref`` for K1-K5 and D1 (for K4 and K5 the
chunked and scanned forms ``ref.rwkv6_chunked`` and ``ref.rglru_scan``),
``mla_decode.plain`` for D2 and ``grouped_experts.plain`` for G1.
A meta tensor (the dry run's, shapes and no data) goes to the plain
version too: no kernel can run on it. Nothing else selects the path: there
is no counterpart of ``REPRO_PALLAS_INTERPRET``.
``LAUNCHES`` counts the kernels' launches by name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import coschedule as _cs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_experts as _ge
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import rg_lru as _lru
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import sliced_matmul as _sm

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches


def _on_cpu(t) -> bool:
    """Whether ``t`` takes the plain version: a CPU or a meta tensor."""
    return t.device.type in ("cpu", "meta")


def _dense(*ts):
    """The tensors as the kernels read them, row-major and whole: a
    strided slice (a projection's heads or channels) is copied, a whole
    tensor passed as it is."""
    return tuple(t.contiguous() for t in ts)


def sliced_matmul(a, b, *, slice_size: int = 4, bm: int = 128,
                  bn: int = 128, bk: int = 128):
    _sm.check_shapes(a, b, bm, bn, bk)
    if _on_cpu(a):
        return ref.sliced_matmul(a, b)
    return _sm.sliced_matmul(a, b, slice_size=slice_size, bm=bm, bn=bn,
                             bk=bk)


def coschedule(a, b, x, *, scale: float = 2.0, run_a: int = 1,
               run_b: int = 1, bm: int = 128, bn: int = 128, bx: int = 256):
    _cs.check_shapes(a, b, x, bm, bn, bx)
    if _on_cpu(a):
        return ref.coschedule(a, b, x, scale)
    return _cs.coschedule(a, b, x, scale=scale, run_a=run_a, run_b=run_b,
                          bm=bm, bn=bn, bx=bx)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128, window: int = 0):
    """``window`` > 0, the port's addition to the reference's keywords,
    keeps the keys k with q - k < window of a causal call (a sliding-window
    layer); 0 none."""
    _fa.check_shapes(q, k, v, bq, bk, causal, window)
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(*_dense(q, k, v), causal=causal,
                               window=window)


def rwkv6_scan(r, k, v, w_log, u, *, chunk: int = 32, state=None):
    """Returns out (B, S, H, N) f32. ``state`` ((B, H, N, N) f32), an
    addition to the reference's keywords, is the initial state and is
    overwritten with the final one; None starts from zero."""
    _wkv.check_shapes(r, k, v, w_log, u, chunk)
    if _on_cpu(r):
        b, _, h, n = r.shape
        s0 = state if state is not None else torch.zeros(b, h, n, n,
                                                         device=r.device)
        out, final = ref.rwkv6_chunked(r, k, v, w_log, u, s0,
                                       chunk=min(chunk, r.shape[1]))
        if state is not None:
            state.copy_(final)
        return out
    return _wkv.rwkv6_scan(*_dense(r, k, v, w_log, u), state=state)


def rg_lru(x, a_log, *, chunk: int = 128, bw: int = 512, h0=None):
    """x, a_log (B, S, W) f32 or bf16 -> h (B, S, W) f32. ``h0`` ((B, W)
    f32), an addition to the reference's keywords, is the initial state;
    None means zeros."""
    _lru.check_shapes(x, a_log, chunk, bw)
    if _on_cpu(x):
        if h0 is None:
            h0 = torch.zeros(x.shape[0], x.shape[2], device=x.device)
        return ref.rglru_scan(x.float(), a_log.float(), h0.float())[0]
    return _lru.rg_lru(*_dense(x, a_log), h0=h0 if h0 is None else
                       h0.contiguous())


def decode_attention(q, k_cache, v_cache, *, lo=None, hi: int,
                     offset: int = 0, pos=None, n_splits: int = None):
    """One query token's attention partials over a (B, S, kv, D) cache:
    q (B, H, D) -> f32 (m (B, H), l (B, H), o (B, H, D)) over the rows
    whose key position (``offset`` + row, or ``pos[row]``, -1 empty) lies
    in [max(lo, 0), hi) (``ref.decode_attention``). Not a kernel of the
    reference, whose decode attention is plain XLA: ``lo``/``hi`` and
    ``pos`` are the port's. ``n_splits`` None: one split on the CPU, and
    on the card enough to fill it (``decode_attention.split_count``)."""
    _da.check_shapes(q, k_cache, v_cache, pos)
    lo = 0 if lo is None else lo
    if _on_cpu(q):
        return ref.decode_attention(q, k_cache, v_cache, lo=lo, hi=hi,
                                    offset=offset, pos=pos,
                                    n_splits=n_splits or 1)
    return _da.decode_attention(q, k_cache, v_cache, lo=lo, hi=hi,
                                offset=offset, pos=pos, n_splits=n_splits)


def mla_decode_attention(q_lat, q_rope, ckv, krope, *, lo=None, hi: int,
                         offset: int = 0, scale: float, n_splits: int = None):
    """MLA's absorbed attention partials for one query token over the
    latent cache: q_lat (B, H, R), q_rope (B, H, DR) against ckv (B, S, R)
    and krope (B, S, DR) -> f32 (m (B, H), l (B, H), o (B, H, R)) over the
    rows whose position ``offset`` + row lies in [max(lo, 0), hi), logits
    scaled by ``scale`` (``mla_decode.plain``). Not a kernel of the
    reference, whose absorbed decode is plain XLA. ``n_splits`` None: on
    the card the count that fills it (``mla_decode.split_count``)."""
    _mla.check_shapes(q_lat, q_rope, ckv, krope)
    lo = 0 if lo is None else lo
    if _on_cpu(q_lat):
        return _mla.plain(q_lat, q_rope, ckv, krope, lo=lo, hi=hi,
                          offset=offset, scale=scale)
    return _mla.mla_decode_attention(q_lat, q_rope, ckv, krope, lo=lo,
                                     hi=hi, offset=offset, scale=scale,
                                     n_splits=n_splits)


def grouped_experts(xs, counts, weights, sort_idx, wi, wg, wo):
    """A dropless MoE route's routed experts over its (token, choice)
    pairs sorted by expert: xs (N, D), each expert's count ``counts``
    (E,), the pairs' router ``weights`` (N,) and flat (token, choice)
    slots ``sort_idx`` (N,) -> (N, D) in slot order, row ``sort_idx[i]``
    being ``weights[i] * (silu(xs[i] @ wg[e]) * (xs[i] @ wi[e])) @ wo[e]``
    (``grouped_experts.plain``). Not a kernel of the reference, which
    leaves the experts to XLA's einsums. On the card the counts stay on
    the device: two launches, no read back (G1)."""
    _ge.check_shapes(xs, counts, weights, sort_idx, wi, wg, wo)
    if _on_cpu(xs):
        return _ge.plain(xs, counts, weights, sort_idx, wi, wg, wo)
    return _ge.grouped_experts(xs, counts, weights, sort_idx, wi, wg, wo)
