"""Discrete-event SM simulator — the "hardware" stand-in.

This box has no GPU, so measured quantities in the paper's figures are
produced by a round-based discrete-event simulator implementing the same SM
physics the Markov model abstracts (round-robin issue among ready units,
memory stalls with contention-dependent latency, coalesced/uncoalesced
access, co-resident kernels sharing unit slots). The Markov model is then
validated *against this simulator* exactly as the paper validates against
real GPUs — prediction vs measurement.

Granularity matches the model: one scheduling unit = one thread block.

Measurement path layout (the hot path of the whole repro):

  * ``simulate_many`` — batched sweep over many (profiles, units)
    configurations in one round loop, each configuration on its own seeded
    stream: per-config results are bit-identical to a standalone
    ``simulate`` call, independent of batch composition. Supports both
    steady-state and *makespan mode* per configuration (per-config alive
    masks retire thread blocks until each block budget drains), so an
    entire IPC-table row and a slice-granular replay sweep alike run in a
    single call.
  * ``simulate`` — single-configuration convenience wrapper: a batch of
    one through the same inner loop.
  * ``simulate_many_sharded`` — the same sweep fanned out across worker
    processes (``REPRO_SWEEP_WORKERS``); valid because per-config streams
    make results independent of batch composition, so any sharding returns
    identical values.
  * ``simulate_reference`` — the pre-refactor scalar implementation, kept
    verbatim as the equivalence oracle for tests (both modes).
  * ``IPCTable`` — measurement cache with an optional content-addressed
    on-disk store (``repro.core.ipc_cache``) so identical measurements are
    never repeated across processes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import GPUSpec, KernelProfile, content_digest
from repro_torch.core import ipc_cache

ENV_SWEEP_WORKERS = "REPRO_SWEEP_WORKERS"


@dataclasses.dataclass
class SimResult:
    ipcs: list              # per-kernel IPC (paper scale)
    cycles: float           # total cycles simulated / makespan
    instructions: list      # per-kernel instructions issued
    pur: list               # per-kernel pipeline utilization ratio
    mur: list               # per-kernel memory utilization ratio
    # power model (PR 10): energy accrued by this configuration's single
    # virtual SM over the simulated window, and its mean draw. Per-round
    # accounting against the GPUSpec power coefficients: static idle +
    # stalled-unit watts over the round duration, plus per-issue and
    # per-memory-request event energies (uncoalesced events pay
    # uncoal_factor * uncoal_penalty times the coalesced request energy).
    energy_j: float = 0.0   # joules (= watt-cycles / (freq_mhz * 1e6))
    avg_watts: float = 0.0  # energy / wall time == watt-cycles / cycles


def _setup_units(profiles, units, blocks, insns_per_block):
    """Initial unit assignment shared by all simulate variants."""
    nk = len(profiles)
    owner, rem_ins = [], []
    blocks_left = list(blocks) if blocks is not None else [np.inf] * nk
    ipb = (insns_per_block if insns_per_block is not None
           else [p.insns_per_block for p in profiles])
    for k in range(nk):
        for _ in range(units[k]):
            if blocks_left[k] > 0:
                blocks_left[k] -= 1
                owner.append(k)
                rem_ins.append(ipb[k])
    return (np.asarray(owner, dtype=np.intp),
            np.asarray(rem_ins, dtype=np.float64), blocks_left, ipb)


def _finish(instr, mem_reqs, cycles, nk, gpu, energy_wc=0.0):
    ipcs = [instr[k] / max(cycles, 1.0) * gpu.peak_ipc for k in range(nk)]
    purs = [ipcs[k] / gpu.peak_ipc for k in range(nk)]
    murs = [mem_reqs[k] / max(cycles, 1.0) / gpu.bw_per_sm for k in range(nk)]
    return SimResult(ipcs=ipcs, cycles=cycles, instructions=list(instr),
                     pur=purs, mur=murs,
                     energy_j=energy_wc / (gpu.freq_mhz * 1e6),
                     avg_watts=energy_wc / max(cycles, 1.0))


def simulate(profiles, units, gpu: GPUSpec, *, seed: int = 0,
             rounds: int = 20000, blocks: Optional[list] = None,
             insns_per_block: Optional[list] = None) -> SimResult:
    """Simulate co-resident kernels on one (virtual) SM.

    profiles: list of KernelProfile; units: per-kernel active unit slots.
    If ``blocks`` is given, runs in makespan mode: unit slots retire blocks
    (insns_per_block instructions each) until the per-kernel block budget is
    exhausted; otherwise measures steady-state IPC over ``rounds``.

    A batch of one through ``simulate_many``'s inner loop — bit-identical
    to ``simulate_reference`` at a fixed seed in both modes.
    """
    return simulate_many(
        [(profiles, units)], gpu, seed=seed, rounds=rounds,
        blocks=None if blocks is None else [list(blocks)],
        insns_per_block=(None if insns_per_block is None
                         else [list(insns_per_block)]))[0]


def simulate_many(configs: Sequence[Tuple[Sequence[KernelProfile],
                                          Sequence[int]]],
                  gpu: GPUSpec, *, seed: int = 0, rounds: int = 20000,
                  blocks: Optional[Sequence[Optional[Sequence[float]]]] = None,
                  insns_per_block: Optional[Sequence] = None) -> list:
    """Batched sweep: one round loop advances every (profiles, units)
    configuration at once.

    Each configuration runs on its own RNG stream seeded with ``seed``, so
    result ``i`` is bit-identical to
    ``simulate(configs[i][0], configs[i][1], gpu, seed=seed, ...)``
    regardless of which other configurations share the batch — batched
    measurements are therefore safe to cache under per-configuration keys.

    ``blocks`` (optional) selects *makespan mode* per configuration: entry
    ``i`` is either None (steady-state over ``rounds``) or a per-kernel
    block-budget list; ``insns_per_block`` follows the same shape. Makespan
    configurations keep a per-config alive mask: unit slots retire blocks
    until the budget drains, the config stops accumulating cycles (and
    consuming draws) once every unit has retired, and steady-state
    configurations freeze after exactly ``rounds`` rounds — mixed batches
    are therefore safe. Returns a list of SimResult.
    """
    nc = len(configs)
    if nc == 0:
        return []
    blocks_l = list(blocks) if blocks is not None else [None] * nc
    ipb_l = (list(insns_per_block) if insns_per_block is not None
             else [None] * nc)
    if len(blocks_l) != nc or len(ipb_l) != nc:
        raise ValueError("blocks/insns_per_block must have one entry "
                         "per config")
    # flatten all units of all configs into one state vector
    cfg_of, owner_g, rm_l, coal_l, dep_l = [], [], [], [], []
    rem_ins_l, blk_left_l, ipb_g = [], [], []
    kbase = []          # first global kernel id of each config
    nk_of = []
    kb = 0
    for c, (profiles, units) in enumerate(configs):
        owner_c, rem_ins_c, blocks_left_c, ipb_c = _setup_units(
            profiles, units, blocks_l[c], ipb_l[c])
        kbase.append(kb)
        nk_of.append(len(profiles))
        cfg_of.extend([c] * owner_c.size)
        owner_g.extend((kb + owner_c).tolist())
        rem_ins_l.extend(rem_ins_c.tolist())
        blk_left_l.extend(blocks_left_c)
        ipb_g.extend(ipb_c)
        rm = np.array([p.rm for p in profiles])
        co = np.array([p.coal for p in profiles])
        dp = np.array([getattr(p, "dep_ratio", 0.0) for p in profiles])
        rm_l.extend(rm[owner_c].tolist())
        coal_l.extend(co[owner_c].tolist())
        dep_l.extend(dp[owner_c].tolist())
        kb += len(profiles)
    cfg_of = np.asarray(cfg_of, dtype=np.intp)
    owner_g = np.asarray(owner_g, dtype=np.intp)
    rm_u = np.asarray(rm_l)
    coal_u = np.asarray(coal_l)
    dep_u = np.asarray(dep_l)
    rem_ins = np.asarray(rem_ins_l, dtype=np.float64)
    blk_left = blk_left_l                 # per global kernel (inf = steady)
    nu = owner_g.size
    nk_total = kb
    is_ms = np.asarray([b is not None for b in blocks_l], dtype=bool)
    any_ms = bool(is_ms.any())
    # unit index range of each config (units are laid out config-major)
    cfg_starts = np.searchsorted(cfg_of, np.arange(nc))
    cfg_sizes = np.diff(np.append(cfg_starts, nu))
    if (cfg_sizes < 1).any():
        raise ValueError("every config needs at least one active unit")

    rem_lat = np.zeros(nu, dtype=np.float64)
    uncoal = np.zeros(nu, dtype=bool)
    mem_pend = np.zeros(nu, dtype=bool)
    alive = np.ones(nu, dtype=bool)
    ms_unit = is_ms[cfg_of]               # units in makespan-mode configs

    # Per-config RNG streams, prefetched into one 2D buffer so every round's
    # draws come from a single fancy-indexed gather instead of a Python loop
    # over configs. Each config consumes its stream exactly as the scalar
    # reference's random(n)-then-random(n) sequence (numpy Generators fill
    # arrays from consecutive bit-generator output, so chunked prefetch
    # preserves it).
    rngs = [np.random.default_rng(seed) for _ in range(nc)]
    chunk = max(4096, 8 * int(cfg_sizes.max()))
    buf = np.empty((nc, chunk))
    for c in range(nc):
        buf[c] = rngs[c].random(chunk)
    pos = np.zeros(nc, dtype=np.int64)
    cfg_ids = np.arange(nc)
    if cfg_sizes.max() > 127:
        raise ValueError("simulate_many supports at most 127 units/config")

    instr = np.zeros(nk_total)
    mem_reqs = np.zeros(nk_total)
    cycles = np.zeros(nc)
    uf = gpu.uncoal_factor
    # power accounting (watt-cycles, float64): the per-round accrual below
    # is written as the exact same expression tree — over exact integer
    # event counts — as the scalar reference's, so per-config energy is
    # bit-identical to a standalone run regardless of batch composition
    energy = np.zeros(nc)
    iw, sw, ie = gpu.idle_watts, gpu.stall_watts, gpu.issue_energy
    re_ = gpu.req_energy
    ue = gpu.req_energy * uf * gpu.uncoal_penalty
    _zc = np.zeros(nc, dtype=np.int64)
    r = 0
    while True:
        if any_ms:
            # per-config liveness: makespan configs run until every unit
            # retired its budget, steady-state ones exactly `rounds` rounds
            alive_cnt = np.add.reduceat(alive.view(np.int8),
                                        cfg_starts).astype(np.int64)
            alive_c = alive_cnt > 0
            running = np.where(is_ms, alive_c, r < rounds)
            if not running.any():
                break
            ready = alive & running[cfg_of] & (rem_lat <= 0)
        else:
            if r >= rounds:
                break
            ready = rem_lat <= 0
        r += 1
        # per-config segment counts (reduceat over the config-major layout;
        # int8 view — reduceat on bool would compute logical-or, not counts,
        # and segments are <= 127 units so int8 cannot overflow)
        n_ready_c = np.add.reduceat(ready.view(np.int8),
                                    cfg_starts).astype(np.int64)
        dur_c = np.maximum(n_ready_c, 1)
        if any_ms:
            dur_c = np.where(running, dur_c, 0)
            n_stall_c = alive_cnt - n_ready_c
        else:
            n_stall_c = cfg_sizes - n_ready_c
        n_co_c = n_un_c = _zc
        idx = np.where(ready)[0]          # config-major (units contiguous)
        if idx.size:
            ks = owner_g[idx]
            instr += np.bincount(ks, minlength=nk_total)
            if any_ms:
                rem_ins[idx] -= 1.0
            need = 2 * n_ready_c
            short = np.where(pos + need > chunk)[0]
            for c in short:               # amortized: every ~chunk/2U rounds
                tail = chunk - pos[c]
                buf[c, :tail] = buf[c, pos[c]:].copy()
                buf[c, tail:] = rngs[c].random(pos[c])
                pos[c] = 0
            # ready-unit draw coordinates: config row, then offset within
            # that config's stream (u block first, v block second)
            cfg_rep = np.repeat(cfg_ids, n_ready_c)
            cum0 = np.concatenate(([0], np.cumsum(n_ready_c)[:-1]))
            rank = np.arange(idx.size) - cum0[cfg_rep]
            u_col = pos[cfg_rep] + rank
            u = buf[cfg_rep, u_col]
            v = buf[cfg_rep, u_col + n_ready_c[cfg_rep]]
            pos += need
            rms = rm_u[idx]
            mem_stall = u < rms
            dep_stall = (~mem_stall) & (u < rms + dep_u[idx])
            is_uncoal = mem_stall & (v >= coal_u[idx])
            # per-config memory contention over *alive* units (all units
            # are alive in steady state)
            pend_a = mem_pend & alive if any_ms else mem_pend
            req_c = (np.add.reduceat(pend_a.astype(np.int64), cfg_starts)
                     + np.add.reduceat((pend_a & uncoal).astype(np.int64),
                                       cfg_starts)
                     * (uf - 1))
            lat_base = gpu.mem_latency + gpu.contention * req_c
            lat_u = np.repeat(lat_base, n_ready_c)   # == lat_base[cfg_of[idx]]
            st_idx = idx[mem_stall]
            rem_lat[st_idx] = np.where(is_uncoal[mem_stall],
                                       lat_u[mem_stall] * uf,
                                       lat_u[mem_stall])
            uncoal[st_idx] = is_uncoal[mem_stall]
            mem_pend[st_idx] = True
            dp_idx = idx[dep_stall]
            rem_lat[dp_idx] = gpu.dep_latency
            mem_pend[dp_idx] = False
            mem_reqs += np.bincount(
                ks[mem_stall],
                weights=np.where(is_uncoal[mem_stall], uf, 1.0),
                minlength=nk_total)
            # integer memory-event counts per config (coalesced vs
            # uncoalesced) — counts, not summed weights, so the energy
            # accrual is order-independent and bit-exact vs the scalar
            n_un_c = np.bincount(cfg_rep[is_uncoal], minlength=nc)
            n_co_c = np.bincount(cfg_rep[mem_stall], minlength=nc) - n_un_c
        cycles += dur_c
        energy += (iw + sw * n_stall_c) * dur_c + ie * n_ready_c \
            + re_ * n_co_c + ue * n_un_c
        np.subtract(rem_lat, np.repeat(dur_c, cfg_sizes), out=rem_lat)
        np.maximum(rem_lat, 0.0, out=rem_lat)
        mem_pend &= rem_lat > 0
        # block retirement (makespan configs only): refill a retired slot
        # from the kernel's remaining budget or kill it, in unit order —
        # the same event order as the scalar reference
        if any_ms:
            done = alive & ms_unit & (rem_ins <= 0) & (rem_lat <= 0)
            for i in np.where(done)[0]:
                k = owner_g[i]
                if blk_left[k] > 0:
                    blk_left[k] -= 1
                    rem_ins[i] = ipb_g[k]
                else:
                    alive[i] = False

    out = []
    for c in range(nc):
        nk = nk_of[c]
        sl = slice(kbase[c], kbase[c] + nk)
        out.append(_finish(instr[sl], mem_reqs[sl], float(cycles[c]),
                           nk, gpu, energy_wc=float(energy[c])))
    return out


# --------------------------------------------------------------------- #
# sharded sweeps: the same batch fanned out across worker processes
# --------------------------------------------------------------------- #
def sweep_workers() -> int:
    """Worker-process count for large sweeps (``REPRO_SWEEP_WORKERS``);
    1 (the default) keeps everything in-process."""
    raw = os.environ.get(ENV_SWEEP_WORKERS, "")
    try:
        n = int(raw.strip() or "1")
    except ValueError:
        return 1
    return max(1, n)


def _sweep_shard(payload):
    """Worker entry point (module-level for pickling)."""
    cfgs, gpu, seed, rounds, blocks, ipb = payload
    return simulate_many(cfgs, gpu, seed=seed, rounds=rounds, blocks=blocks,
                         insns_per_block=ipb)


# below this many configs a sweep is not worth worker-process startup (the
# online decision path measures a handful of configs at a time; spawning
# interpreters for those would invert the latency win)
MIN_SHARD_CONFIGS = 32


def simulate_many_sharded(configs, gpu: GPUSpec, *, seed: int = 0,
                          rounds: int = 20000,
                          blocks: Optional[Sequence] = None,
                          insns_per_block: Optional[Sequence] = None,
                          workers: Optional[int] = None) -> list:
    """``simulate_many`` sharded across worker processes.

    Because every configuration runs on its own seeded stream, results are
    independent of batch composition — any contiguous sharding returns
    exactly the values of the single-process sweep, in the same order.
    That argument holds for *both* modes, so ``blocks``/``insns_per_block``
    (per-config makespan budgets, same shape as in ``simulate_many``) shard
    right alongside their configs: steady-state IPC-table builds and
    slice-granular replay sweeps fan out the same way. Worker count comes
    from ``workers`` or the ``REPRO_SWEEP_WORKERS`` env var; env-derived
    sharding only kicks in above ``MIN_SHARD_CONFIGS`` (an explicit
    ``workers`` argument is always honored), and degraded environments (no
    spawn) fall back in-process with a warning.
    """
    n = len(configs)
    blocks_l = list(blocks) if blocks is not None else None
    ipb_l = list(insns_per_block) if insns_per_block is not None else None
    for name, lst in (("blocks", blocks_l), ("insns_per_block", ipb_l)):
        if lst is not None and len(lst) != n:
            raise ValueError(f"{name} must have one entry per config")
    if workers is None:
        workers = sweep_workers() if n >= MIN_SHARD_CONFIGS else 1
    workers = min(max(1, int(workers)), n)
    if workers <= 1:
        return simulate_many(configs, gpu, seed=seed, rounds=rounds,
                             blocks=blocks_l, insns_per_block=ipb_l)
    import concurrent.futures as cf
    import multiprocessing as mp
    bounds = np.linspace(0, n, workers + 1).astype(int)

    def _cut(lst, i):
        if lst is None:
            return None
        return list(lst[bounds[i]:bounds[i + 1]])

    shards = [(list(configs[bounds[i]:bounds[i + 1]]),
               _cut(blocks_l, i), _cut(ipb_l, i))
              for i in range(workers) if bounds[i] < bounds[i + 1]]
    try:
        # spawn, not fork: the host process may carry XLA/BLAS thread
        # pools by the time a sweep runs, and forking a multi-threaded
        # process can deadlock (and is deprecated in 3.12+)
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=len(shards),
                                    mp_context=ctx) as ex:
            parts = list(ex.map(
                _sweep_shard,
                [(s, gpu, seed, rounds, b, i) for s, b, i in shards]))
    except (OSError, ImportError, cf.process.BrokenProcessPool,
            mp.ProcessError) as e:
        # sandboxed / spawn-less environments (or a crashed worker):
        # parallelism is an optimization, never a correctness dependency —
        # but don't be silent about an N-times-slower sweep. Exceptions
        # raised *by the simulation itself* inside a worker keep their
        # type and propagate normally.
        import warnings
        warnings.warn(f"sharded sweep fell back in-process ({e!r})",
                      RuntimeWarning, stacklevel=2)
        return simulate_many(configs, gpu, seed=seed, rounds=rounds,
                             blocks=blocks_l, insns_per_block=ipb_l)
    return [res for part in parts for res in part]


def simulate_reference(profiles, units, gpu: GPUSpec, *, seed: int = 0,
                       rounds: int = 20000, blocks: Optional[list] = None,
                       insns_per_block: Optional[list] = None) -> SimResult:
    """Pre-refactor scalar implementation, kept verbatim as the equivalence
    oracle: ``simulate`` must match this bit-for-bit at a fixed seed."""
    rng = np.random.default_rng(seed)
    nk = len(profiles)
    owner, rem_lat, rem_ins = [], [], []
    blocks_left = list(blocks) if blocks is not None else [np.inf] * nk
    ipb = (insns_per_block if insns_per_block is not None
           else [p.insns_per_block for p in profiles])
    for k in range(nk):
        for _ in range(units[k]):
            if blocks_left[k] > 0:
                blocks_left[k] -= 1
                owner.append(k)
                rem_lat.append(0.0)
                rem_ins.append(ipb[k])
    owner = np.array(owner)
    rem_lat = np.array(rem_lat, dtype=np.float64)
    rem_ins = np.array(rem_ins, dtype=np.float64)
    uncoal = np.zeros(len(owner), dtype=bool)
    mem_pend = np.zeros(len(owner), dtype=bool)   # stalled on memory (vs dep)
    alive = np.ones(len(owner), dtype=bool)

    instr = np.zeros(nk)
    mem_reqs = np.zeros(nk)
    cycles = 0.0
    # power accounting (watt-cycles): mirror expression of simulate_many's
    # vectorized accrual — same operand values, same op order, bit-exact
    energy = 0.0
    iw, sw, ie = gpu.idle_watts, gpu.stall_watts, gpu.issue_energy
    re_ = gpu.req_energy
    ue = gpu.req_energy * gpu.uncoal_factor * gpu.uncoal_penalty
    r = 0
    while True:
        r += 1
        if blocks is None and r > rounds:
            break
        if not alive.any():
            break
        n_alive = int(alive.sum())
        ready = alive & (rem_lat <= 0)
        n_ready = int(ready.sum())
        dur = max(n_ready, 1)
        n_co = n_un = 0
        # issue one instruction per ready unit
        if n_ready:
            ks = owner[ready]
            np.add.at(instr, ks, 1.0)
            rem_ins[ready] -= 1.0
            # stalls: memory (coalesced / uncoalesced) or pipeline dependency
            rms = np.array([profiles[k].rm for k in ks])
            coals = np.array([profiles[k].coal for k in ks])
            deps = np.array([profiles[k].dep_ratio for k in ks])
            u = rng.random(n_ready)
            mem_stall = u < rms
            dep_stall = (~mem_stall) & (u < rms + deps)
            is_uncoal = mem_stall & (rng.random(n_ready) >= coals)
            n_req_now = float((mem_pend[alive]).sum()
                              + uncoal[alive & mem_pend].sum()
                              * (gpu.uncoal_factor - 1))
            lat_c = gpu.mem_latency + gpu.contention * n_req_now
            lat = np.where(is_uncoal, lat_c * gpu.uncoal_factor, lat_c)
            idx = np.where(ready)[0]
            st_idx = idx[mem_stall]
            rem_lat[st_idx] = lat[mem_stall]
            uncoal[st_idx] = is_uncoal[mem_stall]
            mem_pend[st_idx] = True
            dp_idx = idx[dep_stall]
            rem_lat[dp_idx] = gpu.dep_latency
            mem_pend[dp_idx] = False
            np.add.at(mem_reqs, ks[mem_stall],
                      np.where(is_uncoal[mem_stall], gpu.uncoal_factor, 1.0))
            n_un = int(is_uncoal.sum())
            n_co = int(mem_stall.sum()) - n_un
        # advance time
        cycles += dur
        energy += (iw + sw * (n_alive - n_ready)) * dur + ie * n_ready \
            + re_ * n_co + ue * n_un
        rem_lat = np.maximum(rem_lat - dur, 0.0)
        mem_pend &= rem_lat > 0
        # block retirement (makespan mode)
        if blocks is not None:
            done = alive & (rem_ins <= 0) & (rem_lat <= 0)
            for i in np.where(done)[0]:
                k = owner[i]
                if blocks_left[k] > 0:
                    blocks_left[k] -= 1
                    rem_ins[i] = ipb[k]
                else:
                    alive[i] = False
    return _finish(instr, mem_reqs, cycles, nk, gpu, energy_wc=energy)


# --------------------------------------------------------------------- #
# cached IPC tables ("pre-execution", used as ground truth / oracle input)
# --------------------------------------------------------------------- #
class IPCTable:
    """Caches simulator measurements: solo IPCs and pair cIPCs per split.

    With ``persist=True`` (default) measurements are also kept in a
    content-addressed on-disk store shared across processes — see
    ``repro_torch.core.ipc_cache`` for the key scheme and the
    ``REPRO_TORCH_IPC_CACHE`` override. ``solo_many``/``pair_many`` measure all missing entries of a
    batch in a single ``simulate_many`` sweep, sharded across worker
    processes when ``REPRO_SWEEP_WORKERS`` > 1.
    """

    def __init__(self, gpu: GPUSpec, seed: int = 0, rounds: int = 12000,
                 persist: bool = True):
        self.gpu = gpu
        self.seed = seed
        self.rounds = rounds
        self._solo = {}
        self._pair = {}
        # per-config mean draw (avg_watts of the same measurement), cached
        # next to the IPC values under the ``solo_w``/``pair_w`` store kinds
        self._solo_w = {}
        self._pair_w = {}
        self._store = (ipc_cache.open_ipc_cache(gpu, seed, rounds)
                       if persist else None)

    @property
    def content_key(self) -> tuple:
        """This table's measurement identity: (gpu content digest, seed,
        rounds). Two tables with equal keys return bit-identical values
        for every query — what lets the engine batch lookups per content
        across a heterogeneous fleet, and ``run_fleet`` share one table
        object per distinct GPUSpec."""
        return (content_digest(self.gpu), self.seed, self.rounds)

    @property
    def persisted(self) -> bool:
        """Whether this table writes through to the on-disk store."""
        return self._store is not None

    def absorb(self, other: "IPCTable") -> None:
        """Copy a content-identical table's in-memory measurements into
        this one. Values are deterministic in ``content_key``, so this is
        a pure cache transfer; absorbing a different content is an error
        (it would serve another GPU's physics)."""
        if other.content_key != self.content_key:
            raise ValueError(
                f"cannot absorb table {other.content_key} into "
                f"{self.content_key}: measurement contents differ")
        self._solo.update(other._solo)
        self._pair.update(other._pair)
        self._solo_w.update(other._solo_w)
        self._pair_w.update(other._pair_w)

    # ---- persistent-store plumbing ---- #
    def _store_get(self, kind, prof_ws):
        if self._store is None:
            return None
        return self._store.get(kind, prof_ws)

    def _store_put(self, kind, prof_ws, value):
        if self._store is not None:
            self._store.put(kind, prof_ws, value)

    def save(self):
        """Flush newly measured entries to the on-disk store (no-op when
        persistence is disabled)."""
        if self._store is not None:
            self._store.save()

    # ---- batched measurement core ---- #
    def _measure(self, specs):
        """specs: list of (key_kind, in-mem key, [(prof, w), ...]). Measures
        every spec missing from both cache layers in one (possibly sharded)
        simulate_many sweep and fills both layers — the IPC value and the
        config's mean draw together (a store entry counts as a hit only
        when both are present, so files written before the power model
        simply re-measure)."""
        missing, queued = [], set()
        for kind, key, prof_ws in specs:
            mem = self._solo if kind == "solo" else self._pair
            memw = self._solo_w if kind == "solo" else self._pair_w
            if key in mem or (kind, key) in queued:
                continue
            hit = self._store_get(kind, prof_ws)
            hit_w = self._store_get(kind + "_w", prof_ws)
            if hit is not None and hit_w is not None:
                mem[key] = hit
                memw[key] = hit_w
                continue
            queued.add((kind, key))
            missing.append((kind, key, prof_ws))
        if missing:
            cfgs = [([p for p, _ in prof_ws], [w for _, w in prof_ws])
                    for _, _, prof_ws in missing]
            results = simulate_many_sharded(cfgs, self.gpu, seed=self.seed,
                                            rounds=self.rounds)
            for (kind, key, prof_ws), res in zip(missing, results):
                mem = self._solo if kind == "solo" else self._pair
                memw = self._solo_w if kind == "solo" else self._pair_w
                val = (res.ipcs[0] if kind == "solo"
                       else (res.ipcs[0], res.ipcs[1]))
                mem[key] = val
                memw[key] = res.avg_watts
                self._store_put(kind, prof_ws, val)
                self._store_put(kind + "_w", prof_ws, res.avg_watts)
            self.save()

    # ---- public API ---- #
    # in-memory keys hold the (frozen, hashable) profiles themselves, so two
    # same-named profiles with different content can never collide
    def solo(self, prof: KernelProfile, w: Optional[int] = None) -> float:
        w = w if w is not None else prof.active_units(self.gpu)
        self._measure([("solo", (prof, w), [(prof, w)])])
        return self._solo[(prof, w)]

    def pair(self, p1: KernelProfile, w1: int, p2: KernelProfile, w2: int):
        key = (p1, w1, p2, w2)
        self._measure([("pair", key, [(p1, w1), (p2, w2)])])
        return self._pair[key]

    def solo_many(self, items):
        """items: [(prof, w)] -> list of solo IPCs, measured in one sweep."""
        specs = [("solo", (p, w), [(p, w)]) for p, w in items]
        self._measure(specs)
        return [self._solo[(p, w)] for p, w in items]

    def pair_many(self, items):
        """items: [(p1, w1, p2, w2)] -> list of (cIPC1, cIPC2), measuring
        every missing configuration in a single batched sweep."""
        specs = [("pair", tuple(it), [(it[0], it[1]), (it[2], it[3])])
                 for it in items]
        self._measure(specs)
        return [self._pair[tuple(it)] for it in items]

    def solo_watts(self, prof: KernelProfile,
                   w: Optional[int] = None) -> float:
        """Measured mean draw (watts, one virtual SM) of the solo config —
        cached by the same sweep that produced its IPC, so after a
        ``solo``/``solo_many`` call this is a pure cache hit."""
        w = w if w is not None else prof.active_units(self.gpu)
        self._measure([("solo", (prof, w), [(prof, w)])])
        return self._solo_w[(prof, w)]

    def pair_watts(self, p1: KernelProfile, w1: int,
                   p2: KernelProfile, w2: int) -> float:
        """Measured mean draw (watts, one virtual SM) of the co-resident
        pair config — one value for the pair, not per kernel (the SM draws
        as a whole; attribution is a policy question, not a measurement)."""
        key = (p1, w1, p2, w2)
        self._measure([("pair", key, [(p1, w1), (p2, w2)])])
        return self._pair_w[key]

    def solo_with_watts(self, prof: KernelProfile,
                        w: Optional[int] = None):
        """(solo IPC, mean draw) in a single lookup round trip — the
        engine's charge-pass accessor: both values come from the same
        measurement, so fetching them together keeps the hot loop at one
        ``_measure`` call per action (the pre-power-model cost). Delegates
        to ``solo`` — which fills the watts cache as a side effect — so
        instrumentation wrapping the single-value accessor still fires."""
        w = w if w is not None else prof.active_units(self.gpu)
        return self.solo(prof, w), self._solo_w[(prof, w)]

    def pair_with_watts(self, p1: KernelProfile, w1: int,
                        p2: KernelProfile, w2: int):
        """((cIPC1, cIPC2), mean draw) in a single lookup round trip —
        see ``solo_with_watts``."""
        return (self.pair(p1, w1, p2, w2),
                self._pair_w[(p1, w1, p2, w2)])

    def pair_row(self, p1: KernelProfile, p2: KernelProfile, splits):
        """All W splits of one pair (an IPC-table row) in one batched call.
        splits: [(w1, w2)] -> {(w1, w2): (cIPC1, cIPC2)}."""
        vals = self.pair_many([(p1, w1, p2, w2) for w1, w2 in splits])
        return dict(zip(splits, vals))

    def prefill(self, profiles):
        """The paper's pre-execution step: measure the full table — every
        kernel's solo IPC at its occupancy plus every ordered pair at every
        feasible split — in one batched (optionally sharded) sweep.
        Afterwards any solo()/pair() query a scheduler or replay can make
        is a cache hit.

        profiles: dict or iterable of KernelProfile.
        """
        profs = (list(profiles.values()) if isinstance(profiles, dict)
                 else list(profiles))
        W = self.gpu.units_per_sm
        specs = []
        for p in profs:
            w = p.active_units(self.gpu)
            specs.append(("solo", (p, w), [(p, w)]))
        for p1 in profs:
            w1_max = p1.active_units(self.gpu)
            for p2 in profs:
                if p1 is p2:
                    continue
                w2_max = p2.active_units(self.gpu)
                for w1 in range(1, W):
                    w2 = min(W - w1, w2_max)
                    if w1 > w1_max or w2 < 1:
                        continue
                    specs.append(("pair", (p1, w1, p2, w2),
                                  [(p1, w1), (p2, w2)]))
        self._measure(specs)


# --------------------------------------------------------------------- #
# analytic makespan of a scheduled execution, driven by an IPC table
# --------------------------------------------------------------------- #
def coexec_makespan(b1: float, i1: float, b2: float, i2: float,
                    cipc1: float, cipc2: float, ipc1: float, ipc2: float,
                    s1: int, s2: int, gpu: GPUSpec) -> float:
    """Cycles to drain b1 blocks of K1 (i1 instr each) co-scheduled with b2
    of K2, slice sizes (s1, s2), per-SM ipcs given. The co-scheduled phase
    runs while both have blocks; the survivor drains solo. Slice launch
    overhead is charged per slice launch (paper Fig. 6 physics)."""
    per_sm = gpu.n_sm
    # per-GPU throughputs (blocks/cycle)
    thr1 = cipc1 * per_sm / max(i1, 1e-9)
    thr2 = cipc2 * per_sm / max(i2, 1e-9)
    t_drain1 = b1 / max(thr1, 1e-12)
    t_drain2 = b2 / max(thr2, 1e-12)
    t_co = min(t_drain1, t_drain2)
    if t_drain1 <= t_drain2:
        rem2 = b2 - thr2 * t_co
        t_solo = rem2 * i2 / max(ipc2 * per_sm, 1e-12)
        n_slices = b1 / max(s1, 1) + (b2 - rem2) / max(s2, 1) + rem2 / max(s2, 1)
    else:
        rem1 = b1 - thr1 * t_co
        t_solo = rem1 * i1 / max(ipc1 * per_sm, 1e-12)
        n_slices = b2 / max(s2, 1) + (b1 - rem1) / max(s1, 1) + rem1 / max(s1, 1)
    return t_co + t_solo + n_slices * gpu.launch_overhead


def solo_makespan(blocks: float, insns: float, ipc: float, gpu: GPUSpec,
                  slice_size: Optional[int] = None) -> float:
    t = blocks * insns / max(ipc * gpu.n_sm, 1e-12)
    if slice_size:
        t += blocks / slice_size * gpu.launch_overhead
    else:
        t += gpu.launch_overhead
    return t
