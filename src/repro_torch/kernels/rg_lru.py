"""K5 on Hopper: the RG-LRU recurrence of Griffin / RecurrentGemma.

Replaces ``rg_lru`` of ``repro/kernels/rg_lru.py`` (the ``pl.pallas_call``
at :49). The CUDA kernel is ``csrc/rg_lru.cu``: one pass over thread-block
clusters of ``RANKS`` CTAs cut along time. Each CTA brings a (``STEPS`` x 32
channels) tile of x and a_log into shared memory by TMA, its warps reduce
sub-segments of ``SUB`` steps to (product, end value) pairs, each rank
pushes its pair into the shared memory of the later ranks, and each
sub-segment runs again from its carry and writes h. So x and a_log are read
from device memory once and h is written once: 100.7 MB at (1, 2048, 4096)
f32, where the kernel it replaces read x and a_log twice (167.8 MB). x and
a_log may be f32 or bf16 (widened in registers, as the TPU kernel widens
them); h0 and h are f32. The plain version is
``repro_torch.kernels.ref.rglru_scan``, the oracle
``repro_torch.kernels.ref.rg_lru``; ``repro_torch.kernels.ops.rg_lru`` picks
between kernel and plain version by device. ``cluster_scan`` repeats the
kernel's decomposition in plain PyTorch for the CPU tests; the wrapper never
calls it.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at
(1, 2048, 4096) f32: 100.7 MB over 3.35 TB/s, 0.0301 ms a call: memory-bound
(see PERF.md).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

RANKS = 8           # csrc/rg_lru.cu RANKS: CTAs a cluster, along time
STEPS = 256         # csrc/rg_lru.cu STEPS: steps a CTA owns in a window
SUB = 32            # csrc/rg_lru.cu SUB: steps a warp's sub-segment

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {"rg_lru_fwd": ([_P] * 4 + [_I] * 4 + [_P], ctypes.c_int),
               "rg_lru_occupancy": ([_I, _IP, _IP], ctypes.c_int)}


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
    """(B, S, W) f32 or bf16 -> h (B, S, W) f32 on the card, from ``h0``
    ((B, W) f32, zeros when None). The last row of h is the final state."""
    b, s, w = x.shape
    _build.require_cuda("rg_lru", x, a_log)
    if h0 is not None and (h0.device != x.device or h0.dtype != torch.float32
                           or tuple(h0.shape) != (b, w)
                           or not h0.is_contiguous()):
        raise ValueError(f"rg_lru: h0 must be contiguous float32 {(b, w)} on "
                         f"{x.device}, got {h0.dtype} {tuple(h0.shape)} on "
                         f"{h0.device}")
    out = torch.empty(b, s, w, device=x.device)
    lib = _build.load("rg_lru", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.rg_lru_fwd(x.data_ptr(), a_log.data_ptr(),
                             h0.data_ptr() if h0 is not None else None,
                             out.data_ptr(), b, s, w,
                             _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check("rg_lru", err)
    return out


def occupancy(dtype=torch.float32) -> tuple[int, int]:
    """(clusters of ``RANKS`` CTAs the card holds at once, CTAs an SM) for
    the TMA kernel in ``dtype``, from the CUDA runtime."""
    lib = _build.load("rg_lru", _SIGNATURES)
    clusters, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.rg_lru_occupancy(_build.DTYPE_CODES[dtype],
                               ctypes.byref(clusters), ctypes.byref(per_sm))
    _build.raise_on("rg_lru", err, "occupancy query")
    return clusters.value, per_sm.value


def cluster_scan(x, a_log, h0=None, *, steps: int = STEPS, ranks: int = RANKS,
                 sub: int = SUB):
    """The kernel's decomposition in plain f32 PyTorch, for the CPU tests.

    S is cut into windows of ``ranks * steps`` (the last padded with the
    identity step a_log = x = 0), a window into ``ranks`` tiles of ``steps``
    and a tile into sub-segments of ``sub``. Per window: each sub-segment's
    product A and end value B from h = 0; each tile's (A, B) over its
    sub-segments; the ranks chained in order from the window's carry, then
    each sub-segment's carry inside its tile; each sub-segment run again from
    its carry. The window's carry is h0 (zeros when None) in the first
    window, else the previous window's last row of h. Returns h (B, S, W)."""
    b, s, w = x.shape
    warps = steps // sub
    window = ranks * steps
    nwin = -(-s // window)
    pad = (0, 0, 0, nwin * window - s)
    al = F.pad(a_log.float(), pad).reshape(b, nwin, ranks, warps, sub, w)
    xs = F.pad(x.float(), pad).reshape(b, nwin, ranks, warps, sub, w)
    a = torch.exp(al)
    bx = torch.sqrt(torch.clamp(1 - torch.exp(2 * al), min=1e-12)) * xs
    carry = torch.zeros(b, w) if h0 is None else h0.float()
    out = []
    for win in range(nwin):
        aw, bw = a[:, win], bx[:, win]            # (B, ranks, warps, sub, W)
        seg_a = torch.ones(b, ranks, warps, w)
        seg_b = torch.zeros(b, ranks, warps, w)
        for i in range(sub):
            seg_b = aw[..., i, :] * seg_b + bw[..., i, :]
            seg_a = seg_a * aw[..., i, :]
        tile_a, tile_b = torch.ones(b, ranks, w), torch.zeros(b, ranks, w)
        for k in range(warps):
            tile_b = seg_a[:, :, k] * tile_b + seg_b[:, :, k]
            tile_a = tile_a * seg_a[:, :, k]
        h, entering = carry, []
        for r in range(ranks):
            entering.append(h)
            h = tile_a[:, r] * h + tile_b[:, r]
        h, entering = torch.stack(entering, 1), []
        for k in range(warps):
            entering.append(h)
            h = seg_a[:, :, k] * h + seg_b[:, :, k]
        h, rows = torch.stack(entering, 2), []
        for i in range(sub):
            h = aw[..., i, :] * h + bw[..., i, :]
            rows.append(h)
        hw = torch.stack(rows, 3).reshape(b, window, w)
        out.append(hw)
        carry = hw[:, -1]
    return torch.cat(out, 1)[:, :s]
