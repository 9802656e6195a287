"""Kernel slicing (paper §4.1): slice plans, index rectification, and the
minimum-slice-size search under the p% overhead budget.

A slice is a contiguous range of block IDs executed as an independent
launch; *index rectification* maps the slice-local block id back into the
original grid index space (Fig. 3). At the XLA/Pallas level the same
rectification is ``global_id = offset + local_id`` — implemented by
``repro.kernels.sliced_matmul`` for the on-TPU analogue and used logically
here for slice bookkeeping.

Slicing overhead on the simulator has the same two physical sources as on
the real GPU: per-launch cost and *occupancy loss* (a slice of m blocks/SM
runs with only m active units — the tunable-occupancy knob that makes
co-scheduling possible is also what makes tiny slices slow solo).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.profiles import GPUSpec, KernelProfile


@dataclasses.dataclass(frozen=True)
class Slice:
    kernel: str
    offset: int              # first (linearized) block id — index rectification
    size: int                # number of blocks

    def block_ids(self):
        return range(self.offset, self.offset + self.size)


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    kernel: str
    total_blocks: int
    slice_size: int

    @property
    def num_slices(self) -> int:
        return math.ceil(self.total_blocks / self.slice_size)

    def slices(self):
        for i in range(self.num_slices):
            off = i * self.slice_size
            yield Slice(self.kernel, off,
                        min(self.slice_size, self.total_blocks - off))


def rectify(local_id: int, offset: int, grid: tuple) -> tuple:
    """Paper Fig. 3c: slice-local block id + offset -> original grid coords
    (row-major linearization, wrapped into the grid index space)."""
    g = offset + local_id
    coords = []
    for dim in reversed(grid):
        coords.append(g % dim)
        g //= dim
    return tuple(reversed(coords))


def unsliced_time(prof: KernelProfile, gpu: GPUSpec,
                  ipc_solo: float) -> float:
    """Solo kernel time (ipc_solo in virtual-SM scale; throughput over the
    whole GPU is ipc * n_sm in those units — the scale cancels in ratios)."""
    return (prof.num_blocks * prof.insns_per_block
            / max(ipc_solo * gpu.n_sm, 1e-12) + gpu.launch_overhead)


def sliced_time(prof: KernelProfile, slice_size: int, gpu: GPUSpec,
                ipc_solo: float) -> float:
    """Slices are enqueued back-to-back on a stream, so occupancy is
    preserved and the overhead is per-launch cost (this is what makes the
    paper's Fig. 6 overheads small at >=3x|SM| slices on 16k-block kernels
    while a tiny kernel like SAD still pays ~60% at 1x|SM|)."""
    n_slices = math.ceil(prof.num_blocks / slice_size)
    return (prof.num_blocks * prof.insns_per_block
            / max(ipc_solo * gpu.n_sm, 1e-12)
            + n_slices * gpu.launch_overhead)


def slicing_overhead(prof: KernelProfile, slice_size: int, gpu: GPUSpec,
                     ipc_solo: float) -> float:
    """T_s / T_ns - 1 (paper §5.2)."""
    return (sliced_time(prof, slice_size, gpu, ipc_solo)
            / unsliced_time(prof, gpu, ipc_solo)) - 1.0


def min_slice_size(prof: KernelProfile, gpu: GPUSpec, ipc_solo: float,
                   p_pct: float = 2.0, max_mult: int = 64) -> int:
    """Smallest slice size (multiple of |SM|) with overhead <= p% (§4.1)."""
    for m in range(1, max_mult + 1):
        s = m * gpu.n_sm
        if s >= prof.num_blocks:
            return prof.num_blocks
        if slicing_overhead(prof, s, gpu, ipc_solo) <= p_pct / 100.0:
            return s
    return max_mult * gpu.n_sm
