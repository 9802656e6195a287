"""K4 on Hopper: chunked WKV6, the RWKV6 time mix, with its state carried.

Replaces ``rwkv6_scan`` of ``repro/kernels/rwkv6_scan.py`` (the
``pl.pallas_call`` at :72). The CUDA kernel is ``csrc/rwkv6_scan.cu``: one
CTA per (b, h) walks the chunks in order with the (N x N) f32 state in
shared memory, and forms the intra-chunk decay only below the diagonal.
Unlike the TPU kernel it starts from a given state and writes the final
one, so every multi-token call of the model runs on it. The plain version is
``repro_torch.models.recurrent.rwkv6_chunked``, the oracle
``repro_torch.kernels.ref.rwkv6``; ``repro_torch.kernels.ops.rwkv6_scan``
picks between kernel and plain version by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at
(4, 2048, 32, 64) with bf16 r/k/v: ~7.5 GFLOP of f32 arithmetic over
67 TFLOP/s, ~0.11 ms a call, above the ~0.07 ms its 235 MB take at
3.35 TB/s (see PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)        # template instances in csrc/rwkv6_scan.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv6_scan_fwd": ([_P] * 8 + [_I] * 5 + [_P], ctypes.c_int)}


def check_shapes(r, k, v, w_log, u, chunk: int) -> None:
    """The reference's preconditions (``rwkv6_scan.py:65-66``)."""
    if r.ndim != 4 or not r.shape == k.shape == v.shape == w_log.shape:
        raise ValueError(f"rwkv6_scan: r, k, v, w_log must share one "
                         f"(B, S, H, N) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w_log.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"rwkv6_scan: u must be (H, N) = "
                         f"{tuple(r.shape[2:])}, got {tuple(u.shape)}")
    s = r.shape[1]
    if s % min(chunk, s):
        raise ValueError(f"rwkv6_scan: S={s} does not divide into chunks "
                         f"of {chunk}")


def _require(r, k, v, w_log, u, state) -> None:
    """r/k/v in one dtype (f32 or bf16), w_log/u/state in f32: the mixed
    types the model hands over, each checked, none cast."""
    _build.require_cuda("rwkv6_scan", r, k, v)
    _build.require_cuda("rwkv6_scan", w_log, u, state)
    if w_log.dtype != torch.float32 or w_log.device != r.device:
        raise ValueError(f"rwkv6_scan: w_log, u and state must be float32 on "
                         f"{r.device}, got {w_log.dtype} on {w_log.device}")


def rwkv6_scan(r, k, v, w_log, u, state=None):
    """(B, S, H, N) -> out (B, S, H, N) f32 on the card. ``state``
    ((B, H, N, N) f32) is the initial state and is overwritten with the
    final one; None starts from zero and keeps no state."""
    b, s, h, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {n} not in {HEAD_DIMS}")
    state_out = state if state is not None else torch.empty(
        b, h, n, n, device=r.device)
    if tuple(state_out.shape) != (b, h, n, n):
        raise ValueError(f"rwkv6_scan: state must be {(b, h, n, n)}, got "
                         f"{tuple(state_out.shape)}")
    _require(r, k, v, w_log, u, state_out)
    out = torch.empty(b, s, h, n, device=r.device)
    lib = _build.load("rwkv6_scan", _SIGNATURES)
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state.data_ptr() if state is not None else None,
            out.data_ptr(), state_out.data_ptr(), b, s, h, n,
            _build.DTYPE_CODES[r.dtype], _build.stream_ptr(r))
    _build.check("rwkv6_scan", err)
    return out
