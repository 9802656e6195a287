"""Public entry points for the port's kernels, with the keyword arguments of
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain version: ``ref`` for K1-K3, and for
K4 and K5 the model's own chunked and scanned forms in
``repro_torch.models.recurrent``. A meta tensor (the dry run's, shapes and
no data) goes to the plain version too: no kernel can run on it. Nothing
else selects the path: there is no counterpart of
``REPRO_PALLAS_INTERPRET``.
``LAUNCHES`` counts the kernels' launches by name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import coschedule as _cs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rg_lru as _lru
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import sliced_matmul as _sm

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches


def _on_cpu(t) -> bool:
    """Whether ``t`` takes the plain version: a CPU or a meta tensor."""
    return t.device.type in ("cpu", "meta")


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
                    bk: int = 128):
    _fa.check_shapes(q, k, v, bq, bk)
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def rwkv6_scan(r, k, v, w_log, u, *, chunk: int = 32, state=None):
    """Returns out (B, S, H, N) f32. ``state`` ((B, H, N, N) f32), an
    addition to the reference's keywords, is the initial state and is
    overwritten with the final one; None starts from zero."""
    _wkv.check_shapes(r, k, v, w_log, u, chunk)
    if _on_cpu(r):
        from repro_torch.models.recurrent import rwkv6_chunked
        b, _, h, n = r.shape
        s0 = state if state is not None else torch.zeros(b, h, n, n,
                                                         device=r.device)
        out, final = rwkv6_chunked(r, k, v, w_log, u, s0,
                                   chunk=min(chunk, r.shape[1]))
        if state is not None:
            state.copy_(final)
        return out
    return _wkv.rwkv6_scan(r, k, v, w_log, u, state=state)


def rg_lru(x, a_log, *, chunk: int = 128, bw: int = 512, h0=None):
    """x, a_log (B, S, W) f32 or bf16 -> h (B, S, W) f32. ``h0`` ((B, W)
    f32), an addition to the reference's keywords, is the initial state;
    None means zeros."""
    _lru.check_shapes(x, a_log, chunk, bw)
    if _on_cpu(x):
        from repro_torch.models.recurrent import rglru_scan
        if h0 is None:
            h0 = torch.zeros(x.shape[0], x.shape[2], device=x.device)
        return rglru_scan(x.float(), a_log.float(), h0.float())[0]
    return _lru.rg_lru(x, a_log, h0=h0)
