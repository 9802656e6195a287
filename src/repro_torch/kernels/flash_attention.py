"""K3 on Hopper: causal (or full) flash attention with online softmax.

Replaces ``flash_attention`` of ``repro/kernels/flash_attention.py`` (the
``pl.pallas_call`` at :67). The CUDA kernel is ``csrc/flash_attention.cu``,
one launch per call, looping over KV tiles only up to the diagonal when
causal, with f32 m/l/acc in registers and the reference's mask constant and
final division. The dtype alone picks the path: bf16 runs ``wgmma`` on the
tensor cores (128-row q tiles, 64-key K/V tiles in a TMA ring), f32 runs FMA
on the CUDA cores (64-row q tiles). D is one of ``HEAD_DIMS``; D = 80
(StableLM-3B) runs in the 96-column tile, TMA filling columns 80-95 with
zeros. The plain version is
``repro_torch.kernels.ref.flash_attention``;
``repro_torch.kernels.ops.flash_attention`` picks between the two by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at
(1, 32, 2048, 96) bf16 causal: 25.8 GFLOP over 989 TFLOP/s, ~26 us a call
(see PERF.md for the kernel's time).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# template instances in csrc/flash_attention.cu
HEAD_DIMS = (32, 64, 80, 96, 128, 160)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": (
    [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P], ctypes.c_int)}


def check_shapes(q, k, v, bq: int, bk: int) -> None:
    """The reference's preconditions (``flash_attention.py:59-62``)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"(B, H, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[2]
    if s % min(bq, s) or s % min(bk, s):
        raise ValueError(f"flash_attention: S={s} does not divide into "
                         f"blocks of ({bq}, {bk})")


def flash_attention(q, k, v, *, causal: bool = True):
    """(B, H, S, D) -> (B, H, S, D) on the card. The kernel masks the
    ragged edge of its own tiles, so it takes any S."""
    _build.require_cuda("flash_attention", q, k, v)
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            s, d, float(np.float32(1.0 / np.sqrt(d))), int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check("flash_attention", err)
    return out
