"""K2 on Hopper: a compute-bound matmul and a memory-bound stream fused into
one launch at the scheduler's balanced slice ratio.

Replaces ``coschedule`` of ``repro/kernels/coschedule.py`` (the
``pl.pallas_call`` at :115). The CUDA kernel is ``csrc/coschedule.cu``: one
CTA per schedule step, each reading its (op, tile, block) from device
memory, so matmul CTAs and stream CTAs share the SMs. That co-residency is
Kernelet's concurrent kernel execution, which the TPU could only imitate
through its DMA/compute pipeline. The plain version is
``repro_torch.kernels.ref.coschedule``; ``repro_torch.kernels.ops.coschedule``
picks between the two by device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at 8192^3 bf16
plus a 65536 x 8192 bf16 stream: the matmul's ~1.1 ms, against ~1.75 ms for
the two run one after the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 128             # csrc/common.cuh TILE_M = TILE_N

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"coschedule_launch": (
    [_P] * 8 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P], ctypes.c_int)}


def make_schedule(n_a: int, n_b: int, run_a: int = 1, run_b: int = 1):
    """Interleave n_a matmul tiles and n_b stream blocks in runs of
    (run_a, run_b) — the co-schedule's balanced slice ratio.

    Returns (op, a_idx, b_idx) int32 arrays of length n_a + n_b. For steps
    executing the *other* op, an op's index repeats its previous value so
    the out-block copy-out rewrites identical data. (That is the Pallas
    kernel's copy-out: the CUDA kernel writes only the active op's block and
    never reads the idle op's index.)
    """
    op, ai, bi = [], [], []
    a_done = b_done = 0
    cur_a = cur_b = 0
    while a_done < n_a or b_done < n_b:
        for _ in range(run_a):
            if a_done < n_a:
                cur_a = a_done
                op.append(0)
                a_done += 1
                ai.append(cur_a)
                bi.append(cur_b)
        for _ in range(run_b):
            if b_done < n_b:
                cur_b = b_done
                op.append(1)
                b_done += 1
                ai.append(cur_a)
                bi.append(cur_b)
    return (np.asarray(op, np.int32), np.asarray(ai, np.int32),
            np.asarray(bi, np.int32))


def check_shapes(a, b, x, bm: int, bn: int, bx: int) -> None:
    """The reference's preconditions (``coschedule.py:85``)."""
    if a.ndim != 2 or b.ndim != 2 or x.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"coschedule: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}")
    if a.shape[0] % bm or b.shape[1] % bn or x.shape[0] % bx:
        raise ValueError(f"coschedule: shapes do not divide into "
                         f"({bm}, {bn}) tiles and {bx}-row blocks")


def launch(a, b, x, schedule, *, scale: float, bx: int):
    """One launch over ``schedule`` = (op, a_idx, b_idx). Returns (mm, st);
    blocks that no step of the schedule names are left unwritten."""
    m, k = a.shape
    n = b.shape[1]
    p, q = x.shape
    sched = torch.as_tensor(np.stack(schedule), dtype=torch.int32,
                            device=a.device)
    steps = sched.shape[1]
    mm = torch.empty(m, n, dtype=a.dtype, device=a.device)
    st = torch.empty(p, q, dtype=x.dtype, device=x.device)
    lib = _build.load("coschedule", _SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.coschedule_launch(
            sched[0].data_ptr(), sched[1].data_ptr(), sched[2].data_ptr(),
            a.data_ptr(), b.data_ptr(), x.data_ptr(), mm.data_ptr(),
            st.data_ptr(), n, k, q, bx, float(scale), steps,
            _build.DTYPE_CODES[a.dtype], _build.stream_ptr(a))
    _build.check("coschedule", err)
    return mm, st


def coschedule(a, b, x, *, scale: float = 2.0, run_a: int = 1,
               run_b: int = 1, bm: int = TILE, bn: int = TILE,
               bx: int = 256):
    """Fused interleaved ``(a @ b, x * scale)`` on the card."""
    _build.require_cuda("coschedule", a, b, x)
    check_shapes(a, b, x, bm, bn, bx)
    if (bm, bn) != (TILE, TILE):
        raise ValueError(f"coschedule: the CUDA kernel takes bm = bn = "
                         f"{TILE}, got ({bm}, {bn})")
    n_a = (a.shape[0] // bm) * (b.shape[1] // bn)
    n_b = x.shape[0] // bx
    return launch(a, b, x, make_schedule(n_a, n_b, run_a, run_b),
                  scale=scale, bx=bx)
