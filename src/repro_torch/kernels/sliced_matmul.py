"""K1 on Hopper: the paper's kernel slicing with index rectification (Fig. 3).

Replaces ``matmul_slice`` / ``sliced_matmul`` of
``repro/kernels/sliced_matmul.py`` (the ``pl.pallas_call`` at :65). The CUDA
kernel is ``csrc/sliced_matmul.cu``: a launch of ``slice_size`` CTAs, CTA b
rectifying ``offset + b`` to its (i, j) output tile and writing it in place,
so the TPU version's packed tiles and unpack step are gone. Its plain
version is ``repro_torch.kernels.ref.sliced_matmul`` (the full matmul);
``repro_torch.kernels.ops.sliced_matmul`` picks between the two by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at 8192^3
bf16: 1.1 TFLOP over 989 TFLOP/s, ~1.1 ms. The first kernel runs f32 FMA,
far from it (see PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEF_BM, DEF_BN, DEF_BK = 128, 128, 128
TILE = 128             # csrc/common.cuh TILE_M = TILE_N
TILE_K = 16            # csrc/common.cuh TILE_K

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sliced_matmul_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                                        ctypes.c_int)}


def check_shapes(a, b, bm: int, bn: int, bk: int) -> None:
    """The reference's preconditions (``sliced_matmul.py:53``)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"sliced_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m % bm or n % bn or k % bk:
        raise ValueError(f"sliced_matmul: ({m}, {k}) @ ({k}, {n}) does not "
                         f"divide into ({bm}, {bn}, {bk}) blocks")


def matmul_slice(a, b, out, *, offset: int, slice_size: int) -> None:
    """One launch: output tiles ``offset .. offset + slice_size - 1`` of
    ``a @ b``, written into their places in ``out``."""
    m, k = a.shape
    n = b.shape[1]
    n_tiles = (m // TILE) * (n // TILE)
    if not (0 <= offset and slice_size > 0 and offset + slice_size <= n_tiles):
        raise ValueError(f"sliced_matmul: slice [{offset}, "
                         f"{offset + slice_size}) outside {n_tiles} tiles")
    lib = _build.load("sliced_matmul", _SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.sliced_matmul_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, offset,
            slice_size, _build.DTYPE_CODES[a.dtype], _build.stream_ptr(a))
    _build.check("sliced_matmul", err)


def sliced_matmul(a, b, *, slice_size: int = 4, bm: int = DEF_BM,
                  bn: int = DEF_BN, bk: int = DEF_BK):
    """Full matmul as a loop of slice launches on the card (paper Fig. 3d).
    The kernel's tile is 128 x 128 and it stages K 16 values at a time, so
    ``bk`` only has to divide K into whole stages."""
    _build.require_cuda("sliced_matmul", a, b)
    check_shapes(a, b, bm, bn, bk)
    if (bm, bn) != (TILE, TILE) or bk % TILE_K:
        raise ValueError(f"sliced_matmul: the CUDA kernel takes bm = bn = "
                         f"{TILE} and bk a multiple of {TILE_K}, got "
                         f"({bm}, {bn}, {bk})")
    m, n = a.shape[0], b.shape[1]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    n_tiles = (m // TILE) * (n // TILE)
    off = 0
    while off < n_tiles:
        sz = min(slice_size, n_tiles - off)
        matmul_slice(a, b, out, offset=off, slice_size=sz)
        off += sz
    return out
