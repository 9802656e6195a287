"""Hardware specs and kernel profiles for Kernelet slicing/scheduling.

A ``KernelProfile`` is what the paper obtains from "hardware profiling of a
small number of thread blocks": the memory-instruction ratio R_m, coalesced
fraction, instructions per block, block count and occupancy. PUR/MUR are the
paper's pruning features (Table 4).

The paper's eight benchmark kernels (Table 3/4) are reconstructed here: R_m
and the coalesced fraction are *derived* from the published PUR/MUR via the
bandwidth identity  requests/instr = MUR·B_sm / PUR  (so the simulator and
model reproduce Table-4-like utilization by construction), and block counts /
occupancies are taken directly from Tables 3-4.

``GPUSpec`` also hosts the *virtual SM* reduction (Kepler multi-scheduler ->
single-scheduler model, §4.4), the TPU adaptation (a v5e core modeled as
one "scheduler" whose units are in-flight Pallas grid slices) and the H100
that the PyTorch port runs on (``H100``, ``h100_profile_from_costs``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.core.costs import H100_HBM_BW, H100_PEAK_FLOPS


def content_digest(spec) -> str:
    """Short stable digest of a frozen dataclass's field values — the
    content-addressing primitive for the on-disk IPC cache (two profiles or
    GPU specs with identical fields share cached measurements)."""
    payload = json.dumps(dataclasses.asdict(spec), sort_keys=True,
                         default=repr)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    n_sm: int
    units_per_sm: int          # scheduling units (thread blocks) per SM
    n_schedulers: int          # warp schedulers per SM (virtual-SM divisor)
    peak_ipc: float            # reported peak IPC per SM (paper's scale)
    mem_latency: float         # L0, rounds-equivalent base latency
    bw_per_sm: float           # B: memory requests/cycle/SM at peak
    uncoal_factor: float       # latency multiplier for uncoalesced access
    launch_overhead: float     # cycles per slice launch (slicing overhead)
    contention: float = 2.0    # added latency (cycles) per outstanding req
    dep_latency: float = 22.0  # pipeline-dependency stall latency (cycles)
    effective_peak: float = 0  # achievable IPC/SM (0 -> peak_ipc); Kepler's
                               # dual-issue peak of 8 is not reachable by
                               # these kernels — single-issue peak is 4
    freq_mhz: float = 1000.0
    # ---- power model (PR 10; Goswami et al., arXiv 2011.02368) ---- #
    # Per-(virtual-)SM activity -> watts coefficients. Static draw is in
    # watts; dynamic event energies are in *watt-cycles* (1 watt-cycle =
    # 1 / (freq_mhz * 1e6) joules), so the simulator's per-round accrual
    # is exact integer-count arithmetic and avg_watts = acc / cycles
    # needs no frequency term. idle_watts is a power of two on purpose:
    # idle * int_cycles is exact in float64, pinning the zero-activity
    # draw to exactly idle_watts.
    idle_watts: float = 8.0    # static W per virtual SM (always drawn)
    stall_watts: float = 0.5   # W per unit parked in a stall class
    issue_energy: float = 2.0  # watt-cycles per issued instruction
    req_energy: float = 40.0   # watt-cycles per coalesced memory request
    uncoal_penalty: float = 1.5  # extra energy multiplier per uncoalesced
                                 # *event* (on top of the uncoal_factor x
                                 # request amplification)

    @property
    def peak_eff(self) -> float:
        return self.effective_peak or self.peak_ipc

    def virtual(self) -> "GPUSpec":
        """Single-scheduler virtual SM (paper §4.4, 'Adaptation to GPUs
        with multiple warp schedulers')."""
        if self.n_schedulers == 1:
            return self
        return dataclasses.replace(
            self, name=self.name + "-virtual", n_schedulers=1,
            units_per_sm=max(2, self.units_per_sm // self.n_schedulers),
            bw_per_sm=self.bw_per_sm / self.n_schedulers,
            peak_ipc=self.peak_eff / self.n_schedulers,
            effective_peak=0)


# Tesla C2050 (Fermi GF110): 14 SM, 2 schedulers, theoretical IPC 1.0.
# mem_latency/contention are in cycles (global memory ~400 + queueing).
C2050 = GPUSpec("C2050", n_sm=14, units_per_sm=8, n_schedulers=2,
                peak_ipc=1.0, mem_latency=400.0, bw_per_sm=0.0699,
                uncoal_factor=6.0, launch_overhead=1000.0, contention=12.0,
                freq_mhz=1147)

# GTX680 (Kepler GK104): 8 SMX, 4 schedulers (dual-issue), theoretical IPC 8.
GTX680 = GPUSpec("GTX680", n_sm=8, units_per_sm=16, n_schedulers=4,
                 peak_ipc=8.0, mem_latency=300.0, bw_per_sm=0.233,
                 uncoal_factor=6.0, launch_overhead=300.0, contention=6.0,
                 dep_latency=48.0, effective_peak=4.0, freq_mhz=706)

# TPU v5e core as a "virtual SM": units = in-flight Pallas grid slices
# (double-buffered pipeline stages). R_m analogue = fraction of grid steps
# stalled on HBM DMA; bw is normalized DMA completions per "round".
TPU_V5E = GPUSpec("TPUv5e", n_sm=1, units_per_sm=4, n_schedulers=1,
                  peak_ipc=1.0, mem_latency=8.0, bw_per_sm=0.5,
                  uncoal_factor=2.0, launch_overhead=100.0, freq_mhz=940)

# NVIDIA H100 SXM5 (Hopper; data sheet): 132 SMs, 4 warp schedulers and at
# most 32 resident blocks an SM, 1980 MHz maximum SM clock. bw_per_sm is HBM
# bytes/s over (SMs x clock) in 128-byte requests, the rule that puts C2050
# (144 GB/s, 14 SMs, 1147 MHz) at 0.0701 beside its 0.0699. The module's
# n_sm stays 132 so that content digests are the same on every host; a
# caller with a card may replace it with the card's multi_processor_count
# (``launch.serve.card_spec``).
H100_N_SM = 132
H100_FREQ_MHZ = 1980.0
# Placeholders until measured on the card: mem_latency, uncoal_factor,
# launch_overhead and contention are C2050's, dep_latency and the power
# coefficients (idle_watts .. uncoal_penalty) the GPUSpec defaults.
H100 = GPUSpec("H100", n_sm=H100_N_SM, units_per_sm=32, n_schedulers=4,
               peak_ipc=4.0, mem_latency=400.0,
               bw_per_sm=H100_HBM_BW / (H100_N_SM * H100_FREQ_MHZ * 1e6)
               / 128,
               uncoal_factor=6.0, launch_overhead=1000.0, contention=12.0,
               freq_mhz=H100_FREQ_MHZ)

GPUS = {g.name: g for g in (C2050, GTX680, TPU_V5E, H100)}


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    name: str
    rm: float                  # memory instruction ratio R_m
    coal: float                # fraction of coalesced memory instructions
    insns_per_block: float     # I_K: scheduling-unit instructions per block
    num_blocks: int            # k: total thread blocks
    occupancy: float           # fraction of SM units this kernel can fill
    pur: float = 0.0           # measured single-kernel PUR (pruning feature)
    mur: float = 0.0           # measured MUR
    dep_ratio: float = 0.0     # pipeline-dependency stall instruction ratio

    def active_units(self, gpu: GPUSpec) -> int:
        return max(1, round(self.occupancy * gpu.units_per_sm))


def profile_from_pur_mur(name, pur, mur, gpu: GPUSpec, *, occupancy=1.0,
                         num_blocks=16384, insns_per_block=4000.0,
                         uncoal=False) -> KernelProfile:
    """Reconstruct R_m from published PUR/MUR (Table 4).

    requests/instr = MUR*B_sm / PUR ; an uncoalesced mem instruction issues
    ~uncoal_factor x the requests of a coalesced one.
    """
    req_per_instr = mur * gpu.bw_per_sm * gpu.n_schedulers / max(pur, 1e-4)
    coal = 0.1 if uncoal else 1.0
    req_per_minstr = coal + (1 - coal) * gpu.uncoal_factor
    rm = req_per_instr / req_per_minstr
    rm = min(max(rm, 0.002), 0.9)
    return KernelProfile(name, rm=rm, coal=coal,
                         insns_per_block=insns_per_block,
                         num_blocks=num_blocks, occupancy=occupancy,
                         pur=pur, mur=mur)


def paper_benchmarks(gpu: GPUSpec) -> dict:
    """The paper's 8 kernels (Tables 3-4). PUR/MUR per GPU; PC and SPMV are
    the uncoalesced ones (§5.3, Fig. 10)."""
    if gpu.name.startswith("GTX680"):
        table = {  # name: (pur, mur, occupancy, blocks, uncoal)
            "PC":   (0.0072, 0.1746, 1.00, 16384, True),
            "SAD":  (0.1062, 0.1351, 0.25, 8048, False),
            "SPMV": (0.3027, 0.0043, 1.00, 16384, True),
            "ST":   (0.2016, 0.1179, 1.00, 16384, False),
            "MM":   (0.5321, 0.0569, 1.00, 16384, False),
            "MRIQ": (1.6784, 0.0007, 1.00, 8192, False),
            "BS":   (1.2007, 0.1323, 1.00, 16384, False),
            "TEA":  (1.1417, 0.0353, 1.00, 16384, False),
        }
    else:
        table = {
            "PC":   (0.0096, 0.1404, 1.000, 16384, True),
            "SAD":  (0.1498, 0.1120, 0.167, 8048, False),
            "SPMV": (0.3464, 0.0030, 1.000, 16384, True),
            "ST":   (0.3629, 0.1156, 0.667, 16384, False),
            "MM":   (0.5804, 0.0161, 0.677, 16384, False),
            "MRIQ": (0.8539, 0.0002, 0.833, 8192, False),
            "BS":   (0.8642, 0.0604, 0.677, 16384, False),
            "TEA":  (0.9978, 0.0196, 0.677, 16384, False),
        }
        pass
    out = {}
    for name, (pur, mur, occ, blocks, uncoal) in table.items():
        # pur is stored at the published scale (pruning thresholds α_p are
        # defined on it); calibration normalizes by gpu.peak_ipc.
        out[name] = profile_from_pur_mur(
            name, pur, mur, gpu, occupancy=occ,
            num_blocks=blocks, uncoal=uncoal)
    return out


# paper's workload mixes (Table 5)
WORKLOADS = {
    "CI": ["BS", "MM", "TEA", "MRIQ"],
    "MI": ["PC", "SPMV", "ST", "SAD"],
    "MIX": ["PC", "BS", "TEA", "SAD"],
    "ALL": ["PC", "SPMV", "ST", "BS", "MM", "TEA", "MRIQ", "SAD"],
}


def tpu_profile_from_costs(name: str, flops: float, bytes_hbm: float,
                           num_blocks: int, *, peak_flops=197e12,
                           hbm_bw=819e9) -> KernelProfile:
    """TPU adaptation: derive the two-resource profile of a jitted step from
    its compiled cost analysis. The 'memory stall fraction' plays R_m; PUR
    and MUR are exactly the compute/memory roofline-term utilizations.
    """
    t_compute = flops / peak_flops
    t_memory = bytes_hbm / hbm_bw
    total = max(t_compute + t_memory, 1e-12)
    rm = t_memory / total
    pur = t_compute / max(t_compute, t_memory)
    mur = t_memory / max(t_compute, t_memory)
    return KernelProfile(name, rm=min(max(rm, 0.002), 0.98), coal=1.0,
                         insns_per_block=4000.0, num_blocks=num_blocks,
                         occupancy=1.0, pur=pur, mur=mur)


def h100_profile_from_costs(name: str, flops: float, bytes_hbm: float,
                            num_blocks: int, *, peak_flops=H100_PEAK_FLOPS,
                            hbm_bw=H100_HBM_BW) -> KernelProfile:
    """``tpu_profile_from_costs`` at the H100's peaks: the step's compute
    and memory roofline terms on the card give its R_m, PUR and MUR."""
    return tpu_profile_from_costs(name, flops, bytes_hbm, num_blocks,
                                  peak_flops=peak_flops, hbm_bw=hbm_bw)
