"""Workload execution (paper §5.4): Poisson-submitted kernel instances drained
by a scheduling policy; total simulated execution time is the metric.

Policies:
  BASE     — kernel consolidation [Ravi et al.]: kernels run whole in queue
             order; a kernel that cannot fill the SM shares leftover units
             with the next kernel (space/time sharing without slicing).
  KERNELET — Alg. 1: greedy best-CP pair of *slices* (Markov-model decisions).
  OPT      — same greedy, but decisions use pre-executed (simulated) IPCs —
             the offline oracle of §5.1.
  MC       — random pair + random split/ratio schedules (Fig. 14).

Execution is always charged against the simulator-derived IPCTable: the
co-scheduled phase drains both kernels at their measured pair cIPCs, the
survivor drains solo, and every slice launch pays the launch overhead.
"""
from __future__ import annotations

import collections
import collections.abc
import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.profiles import GPUSpec, KernelProfile
from repro_torch.core.scheduler import CoSchedule, KerneletScheduler
from repro_torch.core.simulator import IPCTable


@dataclasses.dataclass(eq=False)
class Metrics(collections.abc.Mapping):
    """Typed metric bundle shared by the latency and energy reporting
    paths (PR 10 API consolidation): ``latency_metrics()``,
    ``FleetResult.latency``/``.energy`` and ``energy_metrics()`` all
    return one of these instead of ad-hoc dicts.

    Implements the ``Mapping`` protocol over its *populated* fields
    (``None`` means "not applicable to this lane", exactly like the old
    dicts' absent keys), so existing consumers — ``m["wait_p50"]``,
    ``"slo_attainment" in m``, ``dict(m)``, ``m.items()``, ``**m`` — keep
    working unchanged, and flattened history field names stay stable.
    ``m["absent"]`` raises ``KeyError`` just as the old dicts did, and
    equality holds against any mapping with the same populated entries
    (including plain-dict golden pins and other ``Metrics``)."""
    n_completed: Optional[int] = None
    wait_p50: Optional[float] = None
    wait_p95: Optional[float] = None
    wait_mean: Optional[float] = None
    wait_max: Optional[float] = None
    n_expected: Optional[int] = None
    slo_deadline: Optional[float] = None
    slo_attainment: Optional[float] = None
    energy_j: Optional[float] = None
    energy_per_instance: Optional[float] = None
    throughput_per_watt: Optional[float] = None
    avg_watts: Optional[float] = None
    max_watts: Optional[float] = None

    def to_dict(self) -> dict:
        """Populated fields only — the exact dict the pre-PR-10 callers
        received (JSON-safe; use for serialization)."""
        return {f.name: v for f in dataclasses.fields(self)
                if (v := getattr(self, f.name)) is not None}

    def __getitem__(self, key):
        if key not in {f.name for f in dataclasses.fields(self)}:
            raise KeyError(key)
        v = getattr(self, key)
        if v is None:
            raise KeyError(key)
        return v

    def __iter__(self):
        return iter(self.to_dict())

    def __len__(self):
        return len(self.to_dict())

    def __eq__(self, other):
        if isinstance(other, Metrics):
            return self.to_dict() == other.to_dict()
        if isinstance(other, collections.abc.Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    __hash__ = None


@dataclasses.dataclass
class WorkloadResult:
    policy: str
    total_cycles: float
    n_coschedules: int
    n_slices: float
    time_line: list          # (cycles, event) log
    # arrival-timed lanes only: one (name, arrival, completion) record per
    # admitted kernel instance, in completion order (backlog lanes: empty)
    completions: list = dataclasses.field(default_factory=list)
    # arrival-timed lanes: instances submitted (admitted or not). When set,
    # it is the SLO-attainment denominator, so instances that never finish
    # count as misses instead of silently inflating attainment.
    n_expected: Optional[int] = None
    # adaptive lanes only (repro/core/online.py): estimator convergence and
    # re-decision counters; None for non-adaptive lanes
    adapt_stats: Optional[dict] = None
    # power model (PR 10): lane energy in joules (integral of the measured
    # draw over every charged phase + idle launch overheads), the
    # time-averaged draw over the busy cycles, and the peak phase draw —
    # all for the whole GPU (per-vSM watts x n_sm)
    energy_j: float = 0.0
    avg_watts: float = 0.0
    max_watts: float = 0.0

    def latency_metrics(self, slo_deadline: Optional[float] = None,
                        *, n_expected: Optional[int] = None) -> "Metrics":
        """Derived latency metrics over the per-instance completion records
        (arrival-timed lanes). Wait is the sojourn time — completion minus
        arrival — so it includes both queueing and service; completions are
        resolved at phase-end granularity (the event-log resolution).
        ``slo_attainment`` is the fraction of instances whose wait is
        within ``slo_deadline`` cycles; the denominator is ``n_expected``
        when known (instances that never finished are misses), else the
        completed count. Degenerate inputs are well-defined: zero
        completions yield all-zero waits with no numpy warnings, a single
        completion pins p50 == p95 == mean == max to that wait exactly."""
        waits = np.asarray([c - a for _, a, c in self.completions],
                           dtype=np.float64)
        if n_expected is None:
            n_expected = self.n_expected
        if waits.size == 0:
            out = {"n_completed": 0, "wait_p50": 0.0, "wait_p95": 0.0,
                   "wait_mean": 0.0, "wait_max": 0.0}
        elif waits.size == 1:
            w = float(waits[0])
            out = {"n_completed": 1, "wait_p50": w, "wait_p95": w,
                   "wait_mean": w, "wait_max": w}
        else:
            out = {"n_completed": int(waits.size),
                   "wait_p50": float(np.percentile(waits, 50)),
                   "wait_p95": float(np.percentile(waits, 95)),
                   "wait_mean": float(waits.mean()),
                   "wait_max": float(waits.max())}
        if n_expected is not None:
            out["n_expected"] = int(n_expected)
        if slo_deadline is not None:
            out["slo_deadline"] = float(slo_deadline)
            met = int(np.count_nonzero(waits <= slo_deadline))
            if n_expected is not None and int(n_expected) > 0:
                out["slo_attainment"] = met / int(n_expected)
            elif waits.size:
                out["slo_attainment"] = met / int(waits.size)
            else:
                # nothing expected, nothing completed: vacuously met
                out["slo_attainment"] = 1.0
        return Metrics(**out)

    def energy_metrics(self, n_instances: Optional[int] = None) -> "Metrics":
        """Derived energy metrics (power model, PR 10). ``n_instances``
        (completed instances; defaults to the completion-record count)
        feeds the per-instance and throughput-per-watt ratios — both are
        ``None`` when the lane has no instance accounting (backlog lanes
        replayed without arrivals)."""
        if n_instances is None:
            n_instances = len(self.completions) or None
        epi = tpw = None
        if n_instances is not None and int(n_instances) > 0:
            epi = self.energy_j / int(n_instances)
            if self.energy_j > 0.0:
                tpw = int(n_instances) / self.energy_j
        return Metrics(energy_j=float(self.energy_j),
                       energy_per_instance=epi, throughput_per_watt=tpw,
                       avg_watts=float(self.avg_watts),
                       max_watts=float(self.max_watts))


def make_workload(profiles: Dict[str, KernelProfile], names: List[str],
                  instances: int = 1000, lam: float = 1.0, seed: int = 0):
    """Poisson arrivals (same λ per application, paper §5.1). Returns
    arrival-ordered list of kernel names; with the paper's assumption of a
    persistent backlog, order only matters for BASE."""
    rng = np.random.default_rng(seed)
    arrivals = []
    for n in names:
        t = 0.0
        for _ in range(instances):
            t += rng.exponential(1.0 / lam)
            arrivals.append((t, n))
    arrivals.sort()
    return [n for _, n in arrivals]


class _Pending:
    """Aggregated remaining blocks per kernel type. The queue order lives in
    an insertion-ordered dict so retiring a drained kernel is O(1) instead
    of an O(n) list scan per drain call.

    With ``arrivals`` (one timestamp per ``order`` entry) the queue is
    time-gated: instances are held back until ``admit_until(now)`` passes
    their arrival, and per-instance completion times are recorded so
    arrival-timed replays can derive queue-wait / SLO metrics. Admission
    order is arrival order (stable for ties), so a schedule with every
    arrival at t=0 builds the exact ledger the backlog constructor builds.

    ``deadlines`` (absolute, one per ``order`` entry) or ``rel_deadline``
    (one wait budget added to every arrival) attach a deadline to each
    instance; ``earliest_deadline``/``earliest_arrival`` expose the head
    of the per-name FIFO ledgers to deadline/wait-aware policies
    (EDF-KERNELET, PWAIT-CP). ``interpolate`` sharpens completion
    timestamps: with a phase window registered via ``begin_phase``,
    instances retired inside the phase are stamped linearly in drained
    blocks instead of at phase-end granularity. Backlog queues record no
    completions, so interpolation is inert there by construction.
    """

    def __init__(self, profiles, order,
                 arrivals: Optional[Sequence[float]] = None,
                 deadlines: Optional[Sequence[float]] = None,
                 rel_deadline: Optional[float] = None,
                 interpolate: bool = True):
        self.profiles = profiles
        self.blocks = {}
        self._order = {}                     # queue order with dedup
        self._queue = collections.deque()    # unadmitted (arr, name, dl)
        self._timed = arrivals is not None
        self._interp = bool(interpolate)
        self._phase_start: Optional[float] = None
        self._phase_base: dict = {}          # _drained snapshot at phase start
        self.completions: list = []          # (name, arrival, completion)
        if not self._timed:
            for n in order:
                self.blocks[n] = (self.blocks.get(n, 0.0)
                                  + profiles[n].num_blocks)
                self._order.setdefault(n, None)
            return
        if len(arrivals) != len(order):
            raise ValueError("arrivals must parallel order: "
                             f"{len(arrivals)} != {len(order)}")
        if deadlines is not None and len(deadlines) != len(order):
            raise ValueError("deadlines must parallel order: "
                             f"{len(deadlines)} != {len(order)}")
        if deadlines is None:
            deadlines = ([a + rel_deadline for a in arrivals]
                         if rel_deadline is not None
                         else [np.inf] * len(order))
        self._admitted = {}                  # name -> cum admitted blocks
        self._drained = {}                   # name -> cum drained blocks
        self._instances = {}                 # name -> deque[(arr, cum, dl)]
        events = sorted(zip(arrivals, range(len(order))))  # stable on ties
        self._queue.extend((float(t), order[i], float(deadlines[i]))
                           for t, i in events)

    @property
    def order(self):
        return list(self._order)

    def active(self):
        return [n for n in self._order if self.blocks.get(n, 0) > 0]

    # ---- time-gated admission (arrival-timed mode) ---- #
    def has_pending(self) -> bool:
        return bool(self._queue)

    def next_arrival(self) -> Optional[float]:
        return self._queue[0][0] if self._queue else None

    def admit_until(self, now: float) -> int:
        """Admit every instance with arrival <= ``now`` (arrival order);
        returns the number admitted. No-op for backlog queues."""
        n_adm = 0
        q = self._queue
        while q and q[0][0] <= now:
            t, n, dl = q.popleft()
            nb = self.profiles[n].num_blocks
            self.blocks[n] = self.blocks.get(n, 0.0) + nb
            self._order.setdefault(n, None)
            cum = self._admitted.get(n, 0.0) + nb
            self._admitted[n] = cum
            self._instances.setdefault(
                n, collections.deque()).append((t, cum, dl))
            n_adm += 1
        return n_adm

    # ---- deadline/wait inputs for arrival-aware policies ---- #
    def earliest_deadline(self, name: str) -> float:
        """Deadline of the oldest admitted-but-uncompleted instance of
        ``name`` (FIFO head); +inf when untimed, undeadlined, or done."""
        if not self._timed:
            return float(np.inf)
        q = self._instances.get(name)
        return q[0][2] if q else float(np.inf)

    def earliest_arrival(self, name: str) -> float:
        """Arrival of the oldest admitted-but-uncompleted instance of
        ``name``; +inf when untimed or done (so fully drained names sort
        last in any urgency ranking)."""
        if not self._timed:
            return float(np.inf)
        q = self._instances.get(name)
        return q[0][0] if q else float(np.inf)

    def head_remaining(self, name: str) -> float:
        """Blocks still to drain before the oldest pending instance of
        ``name`` completes (its cumulative-admitted threshold minus the
        blocks drained so far) — the work its deadline is actually
        gated on, as opposed to ``blocks[name]`` which includes every
        later instance too. Backlog queues: the whole remaining ledger."""
        if not self._timed:
            return self.blocks.get(name, 0.0)
        q = self._instances.get(name)
        if not q:
            return 0.0
        return max(q[0][1] - self._drained.get(name, 0.0), 0.0)

    # ---- phase window for completion-time interpolation ---- #
    def begin_phase(self, start: float) -> None:
        """Register the start of a charged phase. With interpolation on,
        the next ``pop_completed(now)`` stamps instances retired inside
        [start, now] linearly in drained blocks instead of at ``now``."""
        if self._timed and self._interp:
            self._phase_start = start
            self._phase_base = dict(self._drained)

    def _completion_time(self, name: str, cum: float, now: float) -> float:
        """Timestamp for an instance whose cumulative-admitted threshold
        ``cum`` was crossed by ``now``: linear in blocks drained across the
        current phase window when one is registered, else ``now`` (the
        phase-end granularity of PR 4)."""
        start = self._phase_start
        if start is None or start >= now:
            return now
        base = self._phase_base.get(name, 0.0)
        drained = self._drained.get(name, 0.0)
        if drained <= base:
            return now
        frac = min(1.0, max(0.0, (cum - base) / (drained - base)))
        return start + frac * (now - start)

    def pop_completed(self, now: float) -> list:
        """Record (and return) instances fully drained by ``now``: instance
        j of a kernel completes when its cumulative drained blocks reach
        the cumulative admitted blocks through instance j (FIFO within a
        name). The 1e-9 relative slack only absorbs float accumulation on
        partial drains; full retirement snaps the ledger exactly.

        Within one phase window the interpolated stamps may cross between
        kernel names, so the batch is sorted by completion time before it
        is appended — phases never overlap, so the global record stays
        monotone."""
        if not self._timed or not self._instances:
            return []
        done = []
        for n in list(self._instances):
            q = self._instances[n]
            drained = self._drained.get(n, 0.0)
            while q and drained + 1e-9 * max(1.0, q[0][1]) >= q[0][1]:
                arr, cum, _ = q.popleft()
                done.append((n, arr, self._completion_time(n, cum, now)))
            if not q:
                del self._instances[n]
        done.sort(key=lambda rec: rec[2])
        self._phase_start = None
        self.completions.extend(done)
        return done

    # ---- checkpoint serialization (daemon phase-boundary snapshots) ---- #
    def to_json(self) -> dict:
        """Full ledger state as JSON-safe types. Floats survive exactly
        (repr shortest round-trip), so a restored queue replays the same
        IEEE-754 sequence; ``inf`` deadlines serialize as JSON Infinity
        (Python's json reads them back)."""
        st = {
            "timed": self._timed,
            "interp": self._interp,
            "blocks": dict(self.blocks),
            "order": list(self._order),
            "queue": [list(e) for e in self._queue],
            "phase_start": self._phase_start,
            "phase_base": dict(self._phase_base),
            "completions": [list(c) for c in self.completions],
        }
        if self._timed:
            st["admitted"] = dict(self._admitted)
            st["drained"] = dict(self._drained)
            st["instances"] = {n: [list(e) for e in q]
                               for n, q in self._instances.items()}
        return st

    @classmethod
    def from_json(cls, profiles, st: dict) -> "_Pending":
        """Rebuild a queue from ``to_json`` output (+ the profile dict,
        which is code-side state, not checkpoint payload)."""
        self = cls.__new__(cls)
        self.profiles = profiles
        self._timed = bool(st["timed"])
        self._interp = bool(st["interp"])
        self.blocks = {n: float(b) for n, b in st["blocks"].items()}
        self._order = {n: None for n in st["order"]}
        self._queue = collections.deque(
            (float(t), n, float(dl)) for t, n, dl in st["queue"])
        ps = st["phase_start"]
        self._phase_start = None if ps is None else float(ps)
        self._phase_base = {n: float(v)
                            for n, v in st["phase_base"].items()}
        self.completions = [(n, float(a), float(c))
                            for n, a, c in st["completions"]]
        if self._timed:
            self._admitted = {n: float(v)
                              for n, v in st["admitted"].items()}
            self._drained = {n: float(v)
                             for n, v in st["drained"].items()}
            self._instances = {
                n: collections.deque((float(a), float(c), float(dl))
                                     for a, c, dl in q)
                for n, q in st["instances"].items()}
        return self

    def drain(self, name, blocks):
        cur = self.blocks.get(name)
        if cur is None:
            return                           # already retired: idempotent
        left = max(0.0, cur - blocks)
        if self._timed:
            self._drained[name] = self._drained.get(name, 0.0) + (cur - left)
        if left <= 0:
            # retire fully: a drained kernel leaves the queue *and* the
            # block ledger (stale zero entries used to accumulate forever,
            # which at fleet scale is an unbounded dict per lane)
            self._order.pop(name, None)
            del self.blocks[name]
            if self._timed:
                # exact snap: everything admitted so far has drained
                self._drained[name] = self._admitted.get(name, 0.0)
        else:
            self.blocks[name] = left


def _coexec_phase(p1, b1, p2, b2, c1, c2, s1, s2, gpu):
    """Drain until one kernel empties. Returns (cycles, drained1, drained2,
    slices_launched)."""
    thr1 = c1 * gpu.n_sm / p1.insns_per_block
    thr2 = c2 * gpu.n_sm / p2.insns_per_block
    t1 = b1 / max(thr1, 1e-12)
    t2 = b2 / max(thr2, 1e-12)
    t = min(t1, t2)
    d1 = min(b1, thr1 * t)
    d2 = min(b2, thr2 * t)
    slices = d1 / max(s1, 1) + d2 / max(s2, 1)
    return t + slices * gpu.launch_overhead, d1, d2, slices


def _solo_phase(prof, blocks, ipc, gpu, slice_size=None):
    t = blocks * prof.insns_per_block / max(ipc * gpu.n_sm, 1e-12)
    n_slices = blocks / slice_size if slice_size else 1.0
    return t + n_slices * gpu.launch_overhead, n_slices


def run_policy(policy: str, profiles: Dict[str, KernelProfile],
               order: List[str], gpu: GPUSpec, truth: IPCTable,
               *, alpha_p: float = 0.4, alpha_m: float = 0.1,
               seed: int = 0, mc_rng=None,
               arrivals: Optional[Sequence[float]] = None,
               slo_deadline: Optional[float] = None,
               deadlines: Optional[Sequence[float]] = None,
               interpolate: bool = True,
               adapt: Union[bool, "AdaptConfig"] = False,
               priors: Optional[Dict[str, KernelProfile]] = None,
               adapt_alpha: Optional[float] = None,
               reslice_threshold: Optional[float] = None,
               adapt_min_conf: Optional[int] = None,
               probe_frac: Optional[float] = None,
               power_cap: Optional[float] = None) -> WorkloadResult:
    """Drain one workload under one policy — a single-lane run of the
    vectorized workload engine (``repro.core.engine``), pinned bit-identical
    to the scalar ``run_policy_reference`` implementation by tests.

    ``arrivals`` (one timestamp per ``order`` entry) switches the lane to
    arrival-timed replay: instances are admitted at their arrival time,
    running phases are truncated when new work lands, idle lanes
    fast-forward to the next arrival, and the result carries per-instance
    completion records (``WorkloadResult.completions`` /
    ``latency_metrics``). A schedule with every arrival at t=0 is pinned
    bit-identical (totals and event log) to the backlog mode.

    ``deadlines`` / ``slo_deadline`` attach per-instance deadlines (used
    by the EDF-KERNELET policy); ``interpolate=False`` reverts completion
    timestamps to phase-end granularity.

    ``priors`` mark unknown kernels: the scheduler decides from the prior
    profile while charging keeps the true physics in ``profiles``.
    ``adapt=True`` (or an ``online.AdaptConfig`` for tuned knobs)
    additionally learns per-kernel throughput scales online and
    re-slices as estimates settle (see ``repro.core.online``); the
    learned state lands in ``WorkloadResult.adapt_stats``. The loose
    ``adapt_alpha``/``reslice_threshold``/``adapt_min_conf``/
    ``probe_frac`` kwargs are deprecated aliases for an ``AdaptConfig``.

    ``power_cap`` (watts, whole GPU) arms the POWERCAP policy's
    co-scheduling gate; ignored by other policies."""
    from repro_torch.core.engine import LaneSpec, WorkloadEngine
    spec = LaneSpec(policy=policy, profiles=profiles, order=order, gpu=gpu,
                    truth=truth, alpha_p=alpha_p, alpha_m=alpha_m,
                    seed=seed, mc_rng=mc_rng, arrivals=arrivals,
                    slo_deadline=slo_deadline, deadlines=deadlines,
                    interpolate=interpolate, adapt=adapt, priors=priors,
                    adapt_alpha=adapt_alpha,
                    reslice_threshold=reslice_threshold,
                    adapt_min_conf=adapt_min_conf, probe_frac=probe_frac,
                    power_cap=power_cap)
    return WorkloadEngine().run([spec])[0]


def run_policy_reference(policy: str, profiles: Dict[str, KernelProfile],
                         order: List[str], gpu: GPUSpec, truth: IPCTable,
                         *, alpha_p: float = 0.4, alpha_m: float = 0.1,
                         seed: int = 0, mc_rng=None) -> WorkloadResult:
    """Pre-engine scalar drain loop, kept verbatim as the per-lane
    equivalence oracle: the engine must reproduce this bit-for-bit."""
    vg = gpu.virtual()
    pend = _Pending(profiles, order)
    total, n_cos, n_slices = 0.0, 0, 0.0
    log = []
    # one generator for the whole run: re-seeding per iteration would make
    # MC draw the identical pair/split forever
    rng = (mc_rng if mc_rng is not None
           else np.random.default_rng(seed)) if policy == "MC" else None

    if policy in ("KERNELET", "OPT"):
        sched = KerneletScheduler(
            gpu, profiles, alpha_p=alpha_p, alpha_m=alpha_m,
            decision_table=truth if policy == "OPT" else None)
    else:
        sched = None

    while pend.active():
        act = pend.active()
        if policy == "BASE":
            # queue order; space/time share leftover units (no slicing)
            n1 = act[0]
            p1 = profiles[n1]
            w1 = p1.active_units(vg)
            if w1 < vg.units_per_sm and len(act) > 1:
                n2 = act[1]
                p2 = profiles[n2]
                w2 = min(vg.units_per_sm - w1, p2.active_units(vg))
                c1, c2 = truth.pair(p1, w1, p2, w2)
                t, d1, d2, _ = _coexec_phase(
                    p1, pend.blocks[n1], p2, pend.blocks[n2], c1, c2,
                    p1.num_blocks, p2.num_blocks, gpu)
                pend.drain(n1, d1)
                pend.drain(n2, d2)
            else:
                ipc = truth.solo(p1, w1)
                t, _ = _solo_phase(p1, pend.blocks[n1], ipc, gpu)
                pend.drain(n1, pend.blocks[n1])
            total += t
            log.append((total, f"BASE:{n1}"))
            continue

        if policy == "MC":
            if len(act) >= 2:
                n1, n2 = rng.choice(act, size=2, replace=False)
                p1, p2 = profiles[n1], profiles[n2]
                W = vg.units_per_sm
                w1 = int(rng.integers(1, W))
                w1 = min(w1, p1.active_units(vg))
                w2 = min(W - w1, p2.active_units(vg))
                c1, c2 = truth.pair(p1, w1, p2, w2)
                m1 = int(rng.integers(1, 9)) * gpu.n_sm
                m2 = int(rng.integers(1, 9)) * gpu.n_sm
                t, d1, d2, sl = _coexec_phase(
                    p1, pend.blocks[n1], p2, pend.blocks[n2],
                    c1, c2, m1, m2, gpu)
                pend.drain(n1, d1)
                pend.drain(n2, d2)
                total += t
                n_slices += sl
                n_cos += 1
                # MC used to be the only policy that never logged, leaving
                # its replay traces empty
                log.append((total, f"mc:{n1}+{n2}@{w1}:{w2}"))
            else:
                n1 = act[0]
                p1 = profiles[n1]
                ipc = truth.solo(p1)
                t, _ = _solo_phase(p1, pend.blocks[n1], ipc, gpu)
                pend.drain(n1, pend.blocks[n1])
                total += t
                log.append((total, f"solo:{n1}"))
            continue

        # KERNELET / OPT
        cs: Optional[CoSchedule] = sched.find_coschedule(act)
        if cs.k2 is None:
            p1 = profiles[cs.k1]
            ipc = truth.solo(p1)
            t, sl = _solo_phase(p1, pend.blocks[cs.k1], ipc, gpu, cs.s1)
            pend.drain(cs.k1, pend.blocks[cs.k1])
            total += t
            n_slices += sl
            log.append((total, f"solo:{cs.k1}"))
            continue
        p1, p2 = profiles[cs.k1], profiles[cs.k2]
        c1, c2 = truth.pair(p1, cs.w1, p2, cs.w2)   # execution truth
        t, d1, d2, sl = _coexec_phase(
            p1, pend.blocks[cs.k1], p2, pend.blocks[cs.k2],
            c1, c2, cs.s1, cs.s2, gpu)
        pend.drain(cs.k1, d1)
        pend.drain(cs.k2, d2)
        total += t
        n_cos += 1
        n_slices += sl
        log.append((total, f"co:{cs.k1}+{cs.k2}@{cs.w1}:{cs.w2}"))

    return WorkloadResult(policy, total, n_cos, n_slices, log)
