"""Profile calibration — the stand-in for the paper's hardware profiling.

The paper obtains R_m by profiling a few thread blocks on the real GPU. We
have no GPU, so we reconstruct each benchmark kernel from its published
Table-4 measurements:

  1. R_m (memory-stall ratio) comes from the bandwidth identity
         requests/instr = MUR * B_sm / PUR
     (uncoalesced kernels issue uncoal_factor x requests per instruction;
     their coalesced fraction is solved jointly).
  2. dep_ratio (pipeline-dependency stall ratio) is inverted so the modeled
     solo IPC matches the published PUR. This attributes the non-memory part
     of the measured stall budget to short-latency dependency stalls — the
     resource compute-bound kernels contend for, and what the published CI
     co-scheduling gains require.
  3. insns_per_block equalizes per-instance solo runtime (~20 ms class), as
     the paper's equal-instance-count mixes imply.

Everything downstream (pair cIPCs, CP, scheduling gains) is then a genuine
model prediction validated against the independent discrete-event simulator.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import ipc_cache
from repro_torch.core.markov import MARKOV_SCHEMA, MarkovModel
from repro_torch.core.profiles import (GPUSpec, KernelProfile, content_digest,
                                 paper_benchmarks)

# bump when the calibration procedure changes in a way that alters profiles
_CALIB_SCHEMA = 1

# the store's effective version folds in the Markov schema: calibration
# inverts model solves, so a physics change must invalidate stored
# profiles too (single source of truth — ipc_cache.live_schemas() reads
# this for GC)
CALIB_STORE_SCHEMA = _CALIB_SCHEMA * 1000 + MARKOV_SCHEMA


def _profile_store(gpu: GPUSpec):
    """Per-GPU persistent store for calibrated profiles."""
    base = ipc_cache.cache_dir()
    if base is None:
        return None
    return ipc_cache.open_store(
        f"calib_{content_digest(gpu)}", ("profiles",),
        schema=CALIB_STORE_SCHEMA, dirname=base)


def _invert(model: MarkovModel, base: KernelProfile, w: int,
            target_frac: float, field: str, lo: float, hi: float,
            increase_lowers_ipc: bool = True) -> float:
    """Binary search a profile field so modeled solo IPC hits target."""
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        prof = dataclasses.replace(base, **{field: mid})
        ipc = model.single_ipc(prof, w) / model.gpu.peak_ipc
        high = ipc > target_frac
        if high == increase_lowers_ipc:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@functools.lru_cache(maxsize=8)
def calibrated_benchmarks(gpu: GPUSpec) -> dict:
    """Paper's 8 kernels calibrated to Table 4 PUR/MUR (see module doc).

    Results are persisted in the artifacts cache (content-addressed on the
    GPU digest plus the calibration/Markov schema), so warm processes skip
    the ~0.3 s of Markov binary searches entirely."""
    store = _profile_store(gpu)
    if store is not None:
        hit = store.get("profiles", "benchmarks")
        if hit is not None:
            try:
                return {name: KernelProfile(**fields)
                        for name, fields in hit.items()}
            except TypeError:
                pass             # field-set drift: fall through, recompute
    vgpu = gpu.virtual()
    # persist=False: the bisection probes are hundreds of one-off midpoint
    # profiles nothing ever re-queries — only the final *profiles* artifact
    # is worth disk (schedulers re-solve the calibrated profiles under
    # their own keys and persist those)
    model = MarkovModel(vgpu, three_state=True, persist=False)
    out = {}
    for name, p in paper_benchmarks(gpu).items():
        w = p.active_units(vgpu)
        target = min(p.pur / gpu.peak_eff, 0.98)
        uf = vgpu.uncoal_factor
        is_uncoal = p.coal < 1.0
        # --- step 1: memory stalls from the MUR identity ---
        coal = p.coal
        req_per_minstr = coal + (1 - coal) * uf
        rm = p.mur * vgpu.bw_per_sm / max(target * req_per_minstr, 1e-9)
        rm = min(max(rm, 0.0005), 0.9)
        probe = dataclasses.replace(p, rm=rm, coal=coal, dep_ratio=0.0)
        mem_only_ipc = model.single_ipc(probe, w) / vgpu.peak_ipc
        if mem_only_ipc < target * 1.15:
            # memory stalls alone already put us below target (strongly
            # memory-bound kernel): trim rm / coal to hit the target exactly
            if is_uncoal:
                coal = _invert(model, probe, w, target, "coal", 0.0, 1.0,
                               increase_lowers_ipc=False)
                probe = dataclasses.replace(probe, coal=coal)
                if model.single_ipc(probe, w) / vgpu.peak_ipc < target:
                    rm = _invert(model, probe, w, target, "rm", 0.0005, rm)
            else:
                rm = _invert(model, probe, w, target, "rm", 0.0005, rm)
            dep = 0.0
        else:
            # --- step 2: attribute the PUR residual to dependency stalls ---
            dep = _invert(model, probe, w, target, "dep_ratio", 0.0,
                          min(0.95, 1.0 - rm))
        out[name] = dataclasses.replace(p, rm=rm, coal=coal, dep_ratio=dep)
    # --- step 3: equalize per-instance solo runtimes (~20 ms class) ---
    t_inst = {"SAD": 1.2e6}          # SAD's input (Table 3) is ~20x smaller
    for name, p in out.items():
        ipc_vg = model.single_ipc(p, p.active_units(vgpu))
        ipb = max(50.0, t_inst.get(name, 2.0e7) * ipc_vg * gpu.n_sm
                  / p.num_blocks)
        out[name] = dataclasses.replace(p, insns_per_block=float(round(ipb)))
    if store is not None:
        store.put("profiles", "benchmarks",
                  {name: dataclasses.asdict(p) for name, p in out.items()})
        store.save()
    return out
