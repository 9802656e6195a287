"""K5 on Hopper: the RG-LRU recurrence of Griffin / RecurrentGemma.

Replaces ``rg_lru`` of ``repro/kernels/rg_lru.py`` (the ``pl.pallas_call``
at :49). The CUDA kernel is ``csrc/rg_lru.cu``: one thread per channel and
time segment, sequential in time, loads coalesced across channels, the
segments chained through their carries; it starts from a given ``h0``. The
plain version is ``repro_torch.models.recurrent.rglru_scan``, the oracle
``repro_torch.kernels.ref.rg_lru``; ``repro_torch.kernels.ops.rg_lru``
picks between kernel and plain version by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at
(1, 2048, 4096) f32: ~101 MB over 3.35 TB/s, ~0.030 ms a call: memory-bound
(see PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rg_lru_fwd": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int)}


def check_shapes(x, a_log, chunk: int, bw: int) -> None:
    """The reference's preconditions (``rg_lru.py:45-47``)."""
    if x.ndim != 3 or x.shape != a_log.shape:
        raise ValueError(f"rg_lru: x and a_log must share one (B, S, W) "
                         f"shape, got {tuple(x.shape)}, {tuple(a_log.shape)}")
    _, s, w = x.shape
    if s % min(chunk, s) or w % min(bw, w):
        raise ValueError(f"rg_lru: (S, W)={(s, w)} does not divide into "
                         f"blocks of ({chunk}, {bw})")


def rg_lru(x, a_log, h0=None):
    """(B, S, W) f32 -> h (B, S, W) f32 on the card, from ``h0`` ((B, W)
    f32, zeros when None). The last row of h is the final state."""
    b, s, w = x.shape
    tensors = (x, a_log) if h0 is None else (x, a_log, h0)
    _build.require_cuda("rg_lru", *tensors)
    if x.dtype != torch.float32:
        raise ValueError(f"rg_lru: x and a_log must be float32, got {x.dtype}")
    if h0 is not None and tuple(h0.shape) != (b, w):
        raise ValueError(f"rg_lru: h0 must be {(b, w)}, got "
                         f"{tuple(h0.shape)}")
    out = torch.empty_like(x)
    lib = _build.load("rg_lru", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rg_lru_fwd(x.data_ptr(), a_log.data_ptr(),
                             h0.data_ptr() if h0 is not None else None,
                             out.data_ptr(), b, s, w, _build.stream_ptr(x))
    _build.check("rg_lru", err)
    return out
