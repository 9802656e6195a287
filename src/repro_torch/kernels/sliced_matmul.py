"""K1 on Hopper: the paper's kernel slicing with index rectification (Fig. 3).

Replaces ``matmul_slice`` / ``sliced_matmul`` of
``repro/kernels/sliced_matmul.py`` (the ``pl.pallas_call`` at :65). The CUDA
kernel is ``csrc/sliced_matmul.cu``: a launch of ``slice_size`` CTAs, CTA b
rectifying ``offset + b`` to its (i, j) output tile and writing it in place,
so the TPU version's packed tiles and unpack step are gone. The dtype alone
picks the tile: bf16 runs ``wgmma`` on the tensor cores from a TMA ring
(``csrc/wgmma_tile.cuh``, K staged 64 at a time), f32 the FMA tile of
``csrc/common.cuh`` (K 16 at a time). Its plain version is
``repro_torch.kernels.ref.sliced_matmul`` (the full matmul);
``repro_torch.kernels.ops.sliced_matmul`` picks between the two by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at 8192^3
bf16: 1.1 TFLOP over 989 TFLOP/s, ~1.1 ms for one launch; a slice of s <
132 tiles holds s SMs, so at slice_size=4 the 1024 launches need at least
~37 ms (see PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEF_BM, DEF_BN, DEF_BK = 128, 128, 128
TILE = 128   # common.cuh TILE_M = TILE_N; wgmma_tile.cuh TILE_BM = TILE_BN
STAGE_K = {torch.float32: 16,      # csrc/common.cuh TILE_K
           torch.bfloat16: 64}     # csrc/wgmma_tile.cuh TILE_BK
MAP_BYTES = 256        # two CUtensorMap, csrc/sliced_matmul.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sliced_matmul_launch": ([_P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
    "sliced_matmul_tma_maps": ([_P, _P, _I, _I, _I, _P], ctypes.c_int),
    "sliced_matmul_launch_bf16": ([_P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
}


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


def _slicer(a, b, out):
    """A function that launches one slice, tiles ``offset .. offset + size -
    1`` of ``a @ b`` into ``out``, and returns the CUDA error code. For bf16
    the two TMA maps are encoded here, once for all the slices."""
    lib = _build.load("sliced_matmul", _SIGNATURES)
    m, k = a.shape
    n = b.shape[1]
    stream = _build.stream_ptr(a)
    if a.dtype == torch.bfloat16:
        maps = ctypes.create_string_buffer(MAP_BYTES)
        _build.raise_on("sliced_matmul", lib.sliced_matmul_tma_maps(
            a.data_ptr(), b.data_ptr(), m, n, k, maps), "TMA map encoding")
        c = out.data_ptr()
        return lambda offset, size: lib.sliced_matmul_launch_bf16(
            maps, c, n, k, offset, size, stream)
    pa, pb, c = a.data_ptr(), b.data_ptr(), out.data_ptr()
    return lambda offset, size: lib.sliced_matmul_launch(
        pa, pb, c, n, k, offset, size, stream)


def _check_tiles(a, b, bk: int) -> int:
    """Raise unless the kernel takes these operands; return the tile count."""
    _build.require_cuda("sliced_matmul", a, b)
    if bk % STAGE_K[a.dtype]:
        raise ValueError(f"sliced_matmul: the {a.dtype} kernel stages K "
                         f"{STAGE_K[a.dtype]} at a time, so bk must be a "
                         f"multiple of it, got {bk}")
    check_shapes(a, b, TILE, TILE, STAGE_K[a.dtype])
    return (a.shape[0] // TILE) * (b.shape[1] // TILE)


def matmul_slice(a, b, out, *, offset: int, slice_size: int) -> None:
    """One launch: output tiles ``offset .. offset + slice_size - 1`` of
    ``a @ b``, written into their places in ``out``."""
    n_tiles = _check_tiles(a, b, STAGE_K[a.dtype])
    if not (0 <= offset and slice_size > 0 and offset + slice_size <= n_tiles):
        raise ValueError(f"sliced_matmul: slice [{offset}, "
                         f"{offset + slice_size}) outside {n_tiles} tiles")
    with torch.cuda.device(a.device):
        err = _slicer(a, b, out)(offset, slice_size)
    _build.check("sliced_matmul", err)


def sliced_matmul(a, b, *, slice_size: int = 4, bm: int = DEF_BM,
                  bn: int = DEF_BN, bk: int = DEF_BK):
    """Full matmul as a loop of slice launches on the card (paper Fig. 3d).
    The kernel's tile is 128 x 128, so ``bm = bn = 128``; ``bk`` only has to
    divide K into whole stages of the dtype's tile (``STAGE_K``)."""
    check_shapes(a, b, bm, bn, bk)
    if (bm, bn) != (TILE, TILE):
        raise ValueError(f"sliced_matmul: the CUDA kernel takes bm = bn = "
                         f"{TILE}, got ({bm}, {bn})")
    n_tiles = _check_tiles(a, b, bk)
    out = torch.empty(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        launch = _slicer(a, b, out)
        for off in range(0, n_tiles, slice_size):
            _build.check("sliced_matmul",
                         launch(off, min(slice_size, n_tiles - off)))
    return out
