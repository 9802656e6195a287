"""Vectorized, event-driven workload engine — fleet-scale policy replays.

``run_policy``'s scalar drain loop serves exactly one (gpu, policy, seed,
arrival-order) configuration per call: every policy/seed sweep and every
multi-GPU replay pays the loop, the scheduler construction, and the
candidate search once per configuration. This module replaces it with an
engine that advances many independent replay *lanes* at once:

  * **Lanes.** A lane is one full ``run_policy`` configuration (policy,
    profiles, arrival order, GPU, measurement table, seed). Lanes are
    independent by construction, so the engine can interleave their drain
    events freely — per-lane results are bit-identical to the scalar
    reference (``run_policy_reference``), pinned by tests.
  * **Batched steps.** Each engine step takes one drain decision per active
    lane, then (1) gathers every lane's pending measurement lookups and
    resolves them in single ``solo_many``/``pair_many`` sweeps per table
    (one ``simulate_many`` batch, sharded across ``REPRO_SWEEP_WORKERS``
    when large), and (2) charges all lanes' co-exec/solo phases in one
    vectorized NumPy pass instead of per-lane scalar arithmetic.
  * **Shared decisions.** Lanes with the same (gpu, profiles, alphas,
    decision mode) share one ``KerneletScheduler``, so an active set
    searched for lane 0 is a memo hit for lanes 1..N — and with the
    persistent decision cache (``REPRO_DECISION_CACHE``) even a cold
    process skips the search.
  * **Fleets.** ``run_fleet`` splits one arrival stream across N GPUs that
    share one measurement service and one decision cache — the multi-GPU /
    multi-tenant serving shape (see ``repro.launch.serve``).
  * **Online arrivals.** A ``LaneSpec.arrivals`` schedule makes the lane
    arrival-timed: kernels are admitted when the lane clock passes their
    timestamp, running phases are truncated at the next arrival (so the
    decision re-fires on the newly landed kernel), idle lanes fast-forward
    to their next arrival, and per-instance completion records feed
    latency/SLO metrics (``WorkloadResult.latency_metrics``). The all-zeros
    schedule is pinned bit-identical to backlog mode by tests.
  * **Arrival-aware policies.** ``EDF-KERNELET`` ranks the active set by
    slack to each instance's deadline (``LaneSpec.deadlines``, or
    ``arrival + slo_deadline``) and always serves the most urgent kernel,
    pairing it with the max-CP partner; ``PWAIT-CP`` ranks by predicted
    time-to-completion (remaining blocks over the Markov-model solo IPC —
    the measurement service as wait predictor) plus accumulated wait.
    Both ride ``KerneletScheduler.find_coschedule_ranked``, whose memo and
    persistent cache keys fold in the urgency ranking, so deadline changes
    can never replay a stale decision.
  * **Fleet dealing.** ``run_fleet`` deals one arrival stream over N GPUs
    via a pluggable ``DealPolicy``: ``RoundRobinDeal`` (the paper-era
    arrival-blind deal) or ``LeastBacklogDeal`` (greedy
    least-predicted-backlog, the default under arrivals, with a one-phase
    engine replay per kernel type as the service predictor).

The phase arithmetic is element-for-element the same IEEE-754 sequence as
the scalar ``_coexec_phase``/``_solo_phase`` helpers, so batching changes
wall-clock, never results. Arrival-timed lanes additionally interpolate
completion timestamps linearly in drained blocks within each charged
phase (``_Pending.begin_phase``; ``LaneSpec.interpolate=False`` restores
the PR 4 phase-end granularity) — totals and event logs are untouched, so
the t=0 == backlog pin holds with interpolation on.
"""
from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.markov import MarkovModel
from repro_torch.core.online import AdaptConfig, ProfileEstimator
from repro_torch.core.profiles import GPUSpec, KernelProfile, content_digest
from repro_torch.core.queue import Metrics, WorkloadResult, _Pending, _solo_phase
from repro_torch.core.scheduler import KerneletScheduler
from repro_torch.core.simulator import IPCTable

# policies that decide via a KerneletScheduler (model or oracle mode).
# EDF-KERNELET / PWAIT-CP are the arrival-aware family (deadline slack /
# predicted wait); POWERCAP is KERNELET with the co-scheduling candidates
# gated by a whole-GPU power budget (LaneSpec.power_cap) — with no cap set
# it decides byte-identically to KERNELET.
SCHEDULED_POLICIES = ("KERNELET", "OPT", "EDF-KERNELET", "PWAIT-CP",
                      "POWERCAP")
RANKED_POLICIES = ("EDF-KERNELET", "PWAIT-CP")
# policies that can learn profiles online (LaneSpec.adapt): the model-mode
# scheduled family. OPT decides on measured IPCs (nothing to learn), and
# BASE/MC never consult a predicted profile at all.
ADAPT_POLICIES = ("KERNELET", "EDF-KERNELET", "PWAIT-CP", "POWERCAP")

# LaneSpec kwargs superseded by AdaptConfig (PR 10): legacy name -> the
# AdaptConfig field it maps to
_LEGACY_ADAPT_KWARGS = {"adapt_alpha": "alpha",
                        "reslice_threshold": "reslice_threshold",
                        "adapt_min_conf": "min_confidence",
                        "probe_frac": "probe_frac"}


@dataclasses.dataclass
class LaneSpec:
    """One replay configuration: everything ``run_policy`` takes.

    ``arrivals`` (one timestamp per ``order`` entry) switches the lane to
    arrival-timed replay: kernels are admitted when the lane clock passes
    their arrival, running phases are truncated at the next arrival so
    decisions re-fire on newly landed work, idle lanes fast-forward to the
    next arrival, and per-instance completion records are collected for
    latency/SLO metrics. ``None`` (default) is the paper's backlog mode —
    and an arrival schedule that is all zeros is pinned bit-identical to
    it (totals and event log) by tests.

    ``deadlines`` (absolute, parallel to ``order``) gives each instance
    its own deadline for EDF-KERNELET; when absent, deadlines default to
    ``arrival + slo_deadline`` (one relative wait budget for every
    instance). ``interpolate=False`` turns off within-phase completion
    interpolation (timestamps revert to phase-end granularity)."""
    policy: str
    profiles: Dict[str, KernelProfile]
    order: List[str]
    gpu: GPUSpec
    truth: IPCTable
    alpha_p: float = 0.4
    alpha_m: float = 0.1
    seed: int = 0
    mc_rng: Optional[object] = None
    cp_margin: Optional[float] = None
    label: Optional[str] = None
    arrivals: Optional[Sequence[float]] = None
    slo_deadline: Optional[float] = None
    deadlines: Optional[Sequence[float]] = None
    interpolate: bool = True
    # ---- online profile learning (PR 9) ---- #
    # ``priors`` overlay the decision side only: kernels named here are
    # *unknown* — the scheduler predicts from the prior profile while the
    # measurement table keeps charging the true physics in ``profiles``.
    # ``adapt=True`` (model-mode scheduled policies only) attaches a
    # ``ProfileEstimator`` that learns a per-kernel throughput scale from
    # each charged phase and probes (truncates) phases until estimates
    # settle; ``adapt=False`` with priors replays the frozen prior —
    # bit-identical to the pre-PR-9 engine on the prior profiles. Tuned
    # knobs ride an ``online.AdaptConfig``: ``adapt=AdaptConfig(...)``
    # (the loose ``adapt_alpha``/... kwargs below are deprecated aliases,
    # converted — with a DeprecationWarning — by ``__post_init__``).
    adapt: Union[bool, AdaptConfig] = False
    priors: Optional[Dict[str, KernelProfile]] = None
    adapt_alpha: Optional[float] = None
    reslice_threshold: Optional[float] = None
    adapt_min_conf: Optional[int] = None
    probe_frac: Optional[float] = None
    # POWERCAP only: whole-GPU power budget in watts (per-vSM draw x
    # n_sm). None = uncapped — the decision path is then byte-identical
    # to KERNELET, including every cache key. Other policies ignore it.
    power_cap: Optional[float] = None

    def __post_init__(self):
        legacy = {k: getattr(self, k) for k in _LEGACY_ADAPT_KWARGS
                  if getattr(self, k) is not None}
        if not legacy:
            return
        warnings.warn(
            f"LaneSpec kwargs {sorted(legacy)} are deprecated; pass "
            "adapt=AdaptConfig(...) instead (repro.core.online)",
            DeprecationWarning, stacklevel=3)
        if isinstance(self.adapt, AdaptConfig):
            raise ValueError(
                "pass adaptation knobs either via adapt=AdaptConfig(...) "
                f"or the deprecated loose kwargs {sorted(legacy)}, not "
                "both")
        if self.adapt:
            self.adapt = AdaptConfig(
                **{_LEGACY_ADAPT_KWARGS[k]: v for k, v in legacy.items()})

    def adapt_config(self) -> Optional[AdaptConfig]:
        """The lane's resolved adaptation config: ``None`` when the lane
        does not adapt, the historical defaults for ``adapt=True``."""
        if isinstance(self.adapt, AdaptConfig):
            return self.adapt
        return AdaptConfig() if self.adapt else None


@dataclasses.dataclass
class FleetResult:
    """A multi-GPU replay: per-GPU lane results plus the fleet aggregates
    (makespan = slowest GPU, the workload-throughput metric). Arrival-timed
    fleets also carry the pooled latency metrics; ``deal`` names the
    dealing policy that split the stream and ``gpus`` the per-lane specs
    (heterogeneous fleets: one entry per lane, parallel to ``lanes``)."""
    lanes: List[WorkloadResult]
    makespan: float
    total_cycles: float
    n_coschedules: int
    n_slices: float
    latency: Optional[Metrics] = None
    deal: str = "round_robin"
    gpus: Optional[List[GPUSpec]] = None
    # power model (PR 10): pooled energy metrics — always populated by
    # ``run_fleet`` (energy accrues in every mode, unlike latency which
    # needs arrival records)
    energy: Optional[Metrics] = None


def aggregate_latency(results: Sequence[WorkloadResult],
                      slo_deadline: Optional[float] = None) -> Metrics:
    """Pool every lane's per-instance completion records into one latency
    summary (same fields as ``WorkloadResult.latency_metrics``). Lane
    expected-instance counts pool additively (lanes without one — backlog
    lanes — contribute completions only), so partially-drained fleets
    report honest SLO attainment."""
    known = [r.n_expected for r in results if r.n_expected is not None]
    pooled = WorkloadResult("", 0.0, 0, 0.0, [],
                            completions=[c for r in results
                                         for c in r.completions],
                            n_expected=sum(known) if known else None)
    return pooled.latency_metrics(slo_deadline)


def aggregate_energy(results: Sequence[WorkloadResult]) -> Metrics:
    """Pool every lane's energy accounting into one fleet summary.
    Energy pools additively; so do the lanes' time-averaged draws (fleet
    lanes run concurrently, so the fleet's mean draw is the sum of lane
    means); peak draw is the max over lanes (a per-lane, per-phase
    quantity — concurrent peaks are not assumed to align). The
    per-instance and throughput-per-watt ratios use the pooled completed
    count and are ``None`` for backlog fleets (no instance records)."""
    e = float(sum(r.energy_j for r in results))
    aw = float(sum(r.avg_watts for r in results))
    mw = float(max((r.max_watts for r in results), default=0.0))
    n = sum(len(r.completions) for r in results)
    epi = tpw = None
    if n > 0:
        epi = e / n
        if e > 0.0:
            tpw = n / e
    return Metrics(energy_j=e, energy_per_instance=epi,
                   throughput_per_watt=tpw, avg_watts=aw, max_watts=mw)


class _Lane:
    """Mutable replay state of one lane (mirrors the scalar loop's locals).
    ``total`` doubles as the lane clock in arrival-timed mode (it only ever
    moves forward, by charged phases or idle fast-forwards)."""

    def __init__(self, spec: LaneSpec, sched: Optional[KerneletScheduler]):
        self.spec = spec
        self.pend = _Pending(spec.profiles, spec.order, spec.arrivals,
                             deadlines=spec.deadlines,
                             rel_deadline=spec.slo_deadline,
                             interpolate=spec.interpolate)
        self.sched = sched
        # decision-side profiles: priors overlay the truth for unknown
        # kernels (the scheduler predicts from these; charging and the
        # pending ledger always use the true ``spec.profiles``)
        self.dprofiles = ({**spec.profiles, **spec.priors}
                          if spec.priors else spec.profiles)
        acfg = spec.adapt_config()
        if acfg is not None:
            if spec.policy not in ADAPT_POLICIES:
                raise ValueError(
                    f"adapt=True requires a model-mode scheduled policy "
                    f"{ADAPT_POLICIES}, not {spec.policy!r}")
            tracked = (spec.priors if spec.priors else spec.profiles)
            self.est = acfg.estimator(tracked)
        else:
            self.est = None
        # phases after which an estimate moved past the re-slice
        # threshold, i.e. the next decision re-fires against a materially
        # refreshed profile
        self.est_redecisions = 0
        self.total = 0.0
        self.n_cos = 0
        self.n_slices = 0.0
        # power model (PR 10): joules accrued over charged phases (whole
        # GPU), and the peak phase draw observed (watts, whole GPU)
        self.energy_j = 0.0
        self.max_watts = 0.0
        self.log: list = []
        # controller-set drain ceiling (daemon preempt/pause/cancel): the
        # charge pass truncates phases so the lane clock never passes it —
        # the PR 4 arrival-truncation cap reused as the preemption point.
        # inf (default) leaves every phase untouched, bit-identically. The
        # controller must park a lane once ``total >= cap_at``: the engine
        # itself would keep stepping it with zero-length phases.
        self.cap_at = np.inf
        # one generator for the whole lane (MC only): re-seeding per
        # iteration would make MC draw the identical pair/split forever
        self.rng = ((spec.mc_rng if spec.mc_rng is not None
                     else np.random.default_rng(spec.seed))
                    if spec.policy == "MC" else None)

    def live(self) -> bool:
        return bool(self.pend.active()) or self.pend.has_pending()

    def adapt_stats(self) -> Optional[dict]:
        """Estimate-quality summary for adaptive lanes (``None``
        otherwise): learned scales, confidence, update/re-decision
        counts, and the per-observation scale / prediction-error traces
        the adaptation bench asserts convergence on."""
        if self.est is None:
            return None
        est = self.est
        names = sorted(est.trace)
        return {
            "scales": {n: float(est.scale(n)) for n in names},
            "confidence": {n: int(est.confidence(n)) for n in names},
            "settled": {n: bool(est.settled(n)) for n in names},
            "n_updates": int(est.n_updates),
            "n_redecisions": int(self.est_redecisions),
            "trace": {n: [float(v) for v in est.trace[n]]
                      for n in names},
            "err_trace": {n: [float(v) for v in est.err_trace[n]]
                          for n in names},
        }

    def result(self) -> WorkloadResult:
        # arrival-timed lanes know their submitted-instance count: carry
        # it so partial drains (daemon preempt/cancel) report honest SLO
        # attainment — never-finished instances count as misses
        n_exp = (len(self.spec.order) if self.spec.arrivals is not None
                 else None)
        # mean draw over the lane clock (cycles -> seconds via the GPU
        # frequency); idle fast-forward gaps draw nothing, so an
        # arrival-timed lane's mean honestly reflects its duty cycle
        hz = self.spec.gpu.freq_mhz * 1e6
        avg_w = self.energy_j * hz / self.total if self.total > 0 else 0.0
        return WorkloadResult(self.spec.policy, self.total, self.n_cos,
                              self.n_slices, self.log,
                              completions=self.pend.completions,
                              n_expected=n_exp,
                              adapt_stats=self.adapt_stats(),
                              energy_j=float(self.energy_j),
                              avg_watts=float(avg_w),
                              max_watts=float(self.max_watts))

    # ---- checkpoint serialization (daemon phase-boundary snapshots) ---- #
    def state_json(self, fence=None) -> dict:
        """Everything mutable as JSON-safe types: progress counters, event
        log, the full ``_Pending`` ledger, and (MC lanes) the exact RNG
        state — restoring replays the identical IEEE-754 sequence, which
        is what makes kill/restart bit-identical to an uninterrupted run.
        ``spec``/``sched``/``cap_at`` are code- or controller-side and are
        rebuilt by the restorer, not checkpointed.

        ``fence=(pod_id, epoch)`` embeds lease provenance: which holder,
        at which fencing epoch, wrote this snapshot. The store rejects a
        stale holder's write outright (``StaleLease``); the embedded copy
        makes surviving checkpoints auditable after a failover."""
        st = {
            "total": float(self.total),
            "n_cos": int(self.n_cos),
            "n_slices": float(self.n_slices),
            "energy_j": float(self.energy_j),
            "max_watts": float(self.max_watts),
            "log": [[float(t), e] for t, e in self.log],
            "pend": self.pend.to_json(),
        }
        if fence is not None:
            st["fence"] = [str(fence[0]), int(fence[1])]
        if self.rng is not None:
            st["rng"] = self.rng.bit_generator.state
        if self.est is not None:
            # estimator state restores the exact learning trajectory, so
            # a kill/restart replays the same probe caps and decisions
            st["est"] = self.est.to_json()
            st["est_redecisions"] = int(self.est_redecisions)
        return st

    def load_state(self, st: dict):
        """Restore a ``state_json`` snapshot; returns the embedded fence
        provenance ``(pod_id, epoch)`` (or ``None``) for audit — it has
        no effect on the replayed state."""
        self.total = float(st["total"])
        self.n_cos = int(st["n_cos"])
        self.n_slices = float(st["n_slices"])
        # pre-PR-10 snapshots carry no energy ledger: restore as zero
        self.energy_j = float(st.get("energy_j", 0.0))
        self.max_watts = float(st.get("max_watts", 0.0))
        self.log = [(float(t), str(e)) for t, e in st["log"]]
        self.pend = _Pending.from_json(self.spec.profiles, st["pend"])
        if self.rng is not None and "rng" in st:
            self.rng.bit_generator.state = st["rng"]
        if self.est is not None and "est" in st:
            self.est = ProfileEstimator.from_json(st["est"])
            self.est_redecisions = int(st.get("est_redecisions", 0))
        f = st.get("fence")
        return None if f is None else (str(f[0]), int(f[1]))


# one decision per lane per step; co-exec and solo phases are charged in
# separate vectorized passes, so an action is either "co" or "solo"
@dataclasses.dataclass
class _Action:
    lane: _Lane
    kind: str                       # "co" | "solo"
    event: str                      # log line template (no totals yet)
    count: bool                     # count n_coschedules / n_slices?
    n1: str = ""
    n2: Optional[str] = None
    p1: Optional[KernelProfile] = None
    p2: Optional[KernelProfile] = None
    w1: int = 0
    w2: int = 0
    s1: float = 1.0                 # co: slice sizes; solo: 0 = unsliced
    s2: float = 1.0
    b1: float = 0.0
    b2: float = 0.0
    solo_w: Optional[int] = None    # solo: explicit units (None = default)
    # time budget until this lane's next arrival (inf = none): the charge
    # pass truncates the phase here so the decision re-fires on the newly
    # landed kernel. inf leaves the backlog arithmetic bit-identical.
    cap: float = np.inf
    # predicted throughput (blocks/cycle) of each kernel under the lane's
    # current estimate — adaptive lanes only; the charge pass compares
    # these against observed drain rates to refine the estimator
    pr1: Optional[float] = None
    pr2: Optional[float] = None


class WorkloadEngine:
    """Advances a batch of replay lanes to completion in batched steps."""

    def __init__(self):
        self._schedulers: Dict = {}
        # step/batch counters for benchmarks and docs (not part of results)
        # table_groups: max distinct measurement-table contents seen in one
        # step's lookup resolution — a heterogeneous fleet with K distinct
        # GPUSpecs resolves in K batched sweeps, never per-lane scalars.
        # charged: total charge-pass actions; charge_batches: vectorized
        # passes that served them (the vectorization ratio benches assert).
        self.stats = {"steps": 0, "lanes": 0, "pair_lookups": 0,
                      "solo_lookups": 0, "decisions": 0,
                      "admitted": 0, "idle_ffwd": 0,
                      "table_groups": 0, "charged": 0, "charge_batches": 0}

    # ---- shared decision state ---- #
    def scheduler_for(self, gpu: GPUSpec,
                      profiles: Dict[str, KernelProfile], *,
                      alpha_p: float = 0.4, alpha_m: float = 0.1,
                      cp_margin: Optional[float] = None,
                      decision_table: Optional[IPCTable] = None
                      ) -> KerneletScheduler:
        """One scheduler per decision identity, shared by every lane (and
        external caller, e.g. the serving dispatcher) with that identity:
        in-memory decisions dedupe across lanes, the persistent store
        dedupes across processes. Oracle-mode identity is the *content* of
        the decision table (gpu, seed, rounds), not the object."""
        mode = (("oracle", decision_table.gpu, decision_table.seed,
                 decision_table.rounds)
                if decision_table is not None else ("model",))
        key = (gpu, frozenset(profiles.items()), alpha_p, alpha_m,
               cp_margin, mode)
        sched = self._schedulers.get(key)
        if sched is None:
            sched = KerneletScheduler(
                gpu, profiles, alpha_p=alpha_p, alpha_m=alpha_m,
                decision_table=decision_table, cp_margin=cp_margin)
            self._schedulers[key] = sched
        return sched

    def _lane_scheduler(self, spec: LaneSpec) -> Optional[KerneletScheduler]:
        if spec.policy not in SCHEDULED_POLICIES:
            return None
        # unknown kernels decide on their prior profiles (the overlay
        # changes the scheduler's content identity, so prior-informed
        # decisions never share cache entries with true-profile ones)
        profiles = ({**spec.profiles, **spec.priors} if spec.priors
                    else spec.profiles)
        return self.scheduler_for(
            spec.gpu, profiles, alpha_p=spec.alpha_p,
            alpha_m=spec.alpha_m, cp_margin=spec.cp_margin,
            decision_table=spec.truth if spec.policy == "OPT" else None)

    # ---- urgency ranking for the arrival-aware policies ---- #
    @staticmethod
    def _predicted_service(lane: _Lane, name: str, blocks: float) -> float:
        """Predicted cycles to drain ``blocks`` of ``name`` served solo —
        the Markov-model (or, for oracle-mode lanes, measured) solo IPC as
        the wait predictor, same arithmetic as ``_solo_phase``. Adaptive
        lanes predict from the prior profile refined by the learned
        scale — the p95 lever: a corrected service estimate re-orders
        the EDF/PWAIT urgency ranking."""
        prof = lane.dprofiles[name]
        ipc = lane.sched.solo_ipc(name)
        if lane.est is not None:
            ipc = ipc * lane.est.scale(name)
        return blocks * prof.insns_per_block / max(
            ipc * lane.spec.gpu.n_sm, 1e-12)

    @classmethod
    def _edf_rank(cls, lane: _Lane, act: Sequence[str]):
        """EDF-KERNELET's slack-weighted selection: pin the earliest-
        deadline kernel only when it is *at risk* — its oldest pending
        instance cannot afford to be served after everything else — and
        still *feasible* (served now, it would meet its deadline; a
        hopeless instance must not preempt savable work). Returns the
        urgency-ranked tuple to pin, or ``None`` for the plain max-CP
        KERNELET decision (no kernel at risk: deadlines are not binding,
        so throughput rules; this also makes deadline-free and backlog
        lanes decide exactly like KERNELET)."""
        pend = lane.pend
        now = lane.total
        dl, arr, head_svc, full_svc = {}, {}, {}, {}
        for n in act:
            dl[n] = pend.earliest_deadline(n)
            arr[n] = pend.earliest_arrival(n)
            head_svc[n] = cls._predicted_service(
                lane, n, pend.head_remaining(n))
            full_svc[n] = cls._predicted_service(lane, n, pend.blocks[n])
        total_svc = sum(full_svc.values())
        at_risk = [
            n for n in act
            if np.isfinite(dl[n])
            # feasible: served immediately, the head instance makes it
            and now + head_svc[n] <= dl[n]
            # at risk: served last (after every other kernel), it misses
            and now + (total_svc - full_svc[n]) + head_svc[n] > dl[n]]
        if not at_risk:
            return None
        head = min(at_risk, key=lambda n: (dl[n], arr[n], n))
        rest = sorted((n for n in act if n != head),
                      key=lambda n: (dl[n], arr[n], n))
        return (head, *rest)

    @classmethod
    def _pwait_rank(cls, lane: _Lane, act: Sequence[str]):
        """PWAIT-CP's critical-path ordering: rank by predicted time-to-
        completion if served now (remaining blocks over the predicted
        solo IPC) plus the time the oldest pending instance has already
        waited — the largest total is the critical path under load and is
        always served this phase."""
        pend = lane.pend
        now = lane.total
        key = {}
        for i, n in enumerate(act):
            service = cls._predicted_service(lane, n, pend.blocks[n])
            a = pend.earliest_arrival(n)
            waited = max(now - a, 0.0) if np.isfinite(a) else 0.0
            key[n] = (-(service + waited), i)
        return tuple(sorted(act, key=key.__getitem__))

    # ---- decision phase (per lane, mirrors the scalar branch order) ---- #
    def _decide(self, lane: _Lane) -> _Action:
        spec = lane.spec
        pend = lane.pend
        act = pend.active()
        profiles = spec.profiles
        vg = spec.gpu.virtual()

        if spec.policy == "BASE":
            n1 = act[0]
            p1 = profiles[n1]
            w1 = p1.active_units(vg)
            if w1 < vg.units_per_sm and len(act) > 1:
                n2 = act[1]
                p2 = profiles[n2]
                w2 = min(vg.units_per_sm - w1, p2.active_units(vg))
                return _Action(lane, "co", f"BASE:{n1}", False,
                               n1=n1, n2=n2, p1=p1, p2=p2, w1=w1, w2=w2,
                               s1=p1.num_blocks, s2=p2.num_blocks,
                               b1=pend.blocks[n1], b2=pend.blocks[n2])
            return _Action(lane, "solo", f"BASE:{n1}", False, n1=n1, p1=p1,
                           b1=pend.blocks[n1], s1=0, solo_w=w1)

        if spec.policy == "MC":
            if len(act) >= 2:
                rng = lane.rng
                n1, n2 = rng.choice(act, size=2, replace=False)
                p1, p2 = profiles[n1], profiles[n2]
                W = vg.units_per_sm
                w1 = int(rng.integers(1, W))
                w1 = min(w1, p1.active_units(vg))
                w2 = min(W - w1, p2.active_units(vg))
                m1 = int(rng.integers(1, 9)) * spec.gpu.n_sm
                m2 = int(rng.integers(1, 9)) * spec.gpu.n_sm
                return _Action(lane, "co", f"mc:{n1}+{n2}@{w1}:{w2}", True,
                               n1=n1, n2=n2, p1=p1, p2=p2, w1=w1, w2=w2,
                               s1=m1, s2=m2,
                               b1=pend.blocks[n1], b2=pend.blocks[n2])
            n1 = act[0]
            p1 = profiles[n1]
            return _Action(lane, "solo", f"solo:{n1}", False, n1=n1, p1=p1,
                           b1=pend.blocks[n1], s1=0)

        # KERNELET / OPT / EDF-KERNELET / PWAIT-CP
        ranked = None
        if spec.policy == "EDF-KERNELET":
            ranked = self._edf_rank(lane, act)
        elif spec.policy == "PWAIT-CP":
            ranked = self._pwait_rank(lane, act)
        est = lane.est
        scales = est.scales() if est is not None else None
        if ranked is not None:
            cs = lane.sched.find_coschedule_ranked(ranked, scales=scales)
        else:
            # POWERCAP is KERNELET with the pair candidates gated by the
            # lane's power budget; a None cap keeps the exact KERNELET
            # decision path (and cache keys) byte-for-byte
            pcap = (spec.power_cap if spec.policy == "POWERCAP" else None)
            cs = lane.sched.find_coschedule(act, scales=scales,
                                            power_cap=pcap)
        self.stats["decisions"] += 1
        n_sm = spec.gpu.n_sm
        if cs.k2 is None:
            # charge with the TRUE profile; the decision (slice size,
            # predicted IPC) came from the prior-informed scheduler
            p1 = profiles[cs.k1]
            a = _Action(lane, "solo", f"solo:{cs.k1}", True, n1=cs.k1,
                        p1=p1, b1=pend.blocks[cs.k1], s1=cs.s1)
            if est is not None:
                a.pr1 = (cs.cipc1 * n_sm
                         / lane.dprofiles[cs.k1].insns_per_block)
            return a
        p1, p2 = profiles[cs.k1], profiles[cs.k2]
        a = _Action(lane, "co", f"co:{cs.k1}+{cs.k2}@{cs.w1}:{cs.w2}",
                    True, n1=cs.k1, n2=cs.k2, p1=p1, p2=p2,
                    w1=cs.w1, w2=cs.w2, s1=cs.s1, s2=cs.s2,
                    b1=pend.blocks[cs.k1], b2=pend.blocks[cs.k2])
        if est is not None:
            a.pr1 = (cs.cipc1 * n_sm
                     / lane.dprofiles[cs.k1].insns_per_block)
            a.pr2 = (cs.cipc2 * n_sm
                     / lane.dprofiles[cs.k2].insns_per_block)
        return a

    # ---- measurement phase: batch all lanes' lookups per table ---- #
    def _resolve_lookups(self, actions: Sequence[_Action]) -> None:
        """Gather every lane's pending measurement lookups and resolve them
        in one batched sweep per *table content* (``IPCTable.content_key``:
        gpu digest, seed, rounds) — a heterogeneous fleet with K distinct
        GPUSpecs costs K sweeps per step, not one per lane. Lanes that hold
        content-identical but distinct table objects share the sweep: the
        batch resolves into one representative and the others absorb its
        in-memory entries (deterministic in the content key, so this is a
        pure cache transfer)."""
        pair_by_key: Dict[tuple, dict] = {}
        solo_by_key: Dict[tuple, dict] = {}
        tables: Dict[tuple, List[IPCTable]] = {}
        for a in actions:
            truth = a.lane.spec.truth
            ck = truth.content_key
            group = tables.setdefault(ck, [])
            if all(t is not truth for t in group):
                group.append(truth)
            if a.kind == "co":
                pair_by_key.setdefault(ck, {})[
                    (a.p1, a.w1, a.p2, a.w2)] = None
            else:
                w = (a.solo_w if a.solo_w is not None
                     else a.p1.active_units(truth.gpu))
                solo_by_key.setdefault(ck, {})[(a.p1, w)] = None
        self.stats["table_groups"] = max(self.stats["table_groups"],
                                         len(tables))
        # dict-of-None keeps insertion order while deduping, so the batched
        # call measures each missing config exactly once
        for ck, items in solo_by_key.items():
            rep, *rest = tables[ck]
            for t in rest:            # pool what siblings already measured
                rep.absorb(t)
            rep.solo_many(list(items))
            for t in rest:
                t.absorb(rep)
            self.stats["solo_lookups"] += len(items)
        for ck, items in pair_by_key.items():
            rep, *rest = tables[ck]
            for t in rest:
                rep.absorb(t)
            rep.pair_many(list(items))
            for t in rest:
                t.absorb(rep)
            self.stats["pair_lookups"] += len(items)

    # ---- charge phase: vectorized co-exec / solo arithmetic ---- #
    @staticmethod
    def _charge_co(actions: List[_Action]):
        """All lanes' co-exec phases at once: element-for-element the same
        float64 sequence as the scalar ``_coexec_phase``. A finite ``cap``
        (arrival-timed lanes) truncates the drain time at the lane's next
        arrival; ``inf`` caps reproduce the scalar values bit-for-bit.

        The trailing energy outputs (phase joules and phase draw, whole
        GPU) ride the same pass: execution cycles are charged at the
        *measured* pair draw (cache hits from the same sweep that
        measured the cIPCs), launch-overhead cycles at the idle draw."""
        get = np.asarray
        b1 = get([a.b1 for a in actions], dtype=np.float64)
        b2 = get([a.b2 for a in actions], dtype=np.float64)
        cips = [a.lane.spec.truth.pair_with_watts(a.p1, a.w1, a.p2, a.w2)
                for a in actions]                       # cache hits
        c1 = get([c[0][0] for c in cips], dtype=np.float64)
        c2 = get([c[0][1] for c in cips], dtype=np.float64)
        pw = get([c[1] for c in cips], dtype=np.float64)
        i1 = get([a.p1.insns_per_block for a in actions], dtype=np.float64)
        i2 = get([a.p2.insns_per_block for a in actions], dtype=np.float64)
        s1 = get([a.s1 for a in actions], dtype=np.float64)
        s2 = get([a.s2 for a in actions], dtype=np.float64)
        n_sm = get([a.lane.spec.gpu.n_sm for a in actions], dtype=np.float64)
        lo = get([a.lane.spec.gpu.launch_overhead for a in actions],
                 dtype=np.float64)
        iw = get([a.lane.spec.gpu.idle_watts for a in actions],
                 dtype=np.float64)
        hz = get([a.lane.spec.gpu.freq_mhz * 1e6 for a in actions],
                 dtype=np.float64)
        cap = get([a.cap for a in actions], dtype=np.float64)
        thr1 = c1 * n_sm / i1
        thr2 = c2 * n_sm / i2
        t1 = b1 / np.maximum(thr1, 1e-12)
        t2 = b2 / np.maximum(thr2, 1e-12)
        t = np.minimum(np.minimum(t1, t2), cap)
        d1 = np.minimum(b1, thr1 * t)
        d2 = np.minimum(b2, thr2 * t)
        sl = d1 / np.maximum(s1, 1) + d2 / np.maximum(s2, 1)
        e = (pw * t + iw * (sl * lo)) * n_sm / hz
        pwt = pw * n_sm
        # also return the pre-overhead drain time: observed throughput
        # (online estimation) is drained blocks over execution time, with
        # launch overhead excluded
        return t + sl * lo, d1, d2, sl, t, e, pwt

    @staticmethod
    def _charge_solo(actions: List[_Action]):
        """All lanes' solo phases at once (``_solo_phase`` semantics;
        slice size 0 means unsliced — one launch charge). A finite ``cap``
        truncates the phase at the next arrival and drains only the blocks
        processed by then; the uncapped branch drains the exact ``b``
        (never a round-tripped ``thr * t``), keeping backlog lanes
        bit-identical to the scalar reference."""
        get = np.asarray
        b = get([a.b1 for a in actions], dtype=np.float64)
        ins = get([a.p1.insns_per_block for a in actions], dtype=np.float64)
        vals = [a.lane.spec.truth.solo_with_watts(
                    a.p1, a.solo_w if a.solo_w is not None else None)
                for a in actions]                          # cache hits
        ipcs = get([v[0] for v in vals], dtype=np.float64)
        pw = get([v[1] for v in vals], dtype=np.float64)
        ss = get([a.s1 for a in actions], dtype=np.float64)
        n_sm = get([a.lane.spec.gpu.n_sm for a in actions], dtype=np.float64)
        lo = get([a.lane.spec.gpu.launch_overhead for a in actions],
                 dtype=np.float64)
        iw = get([a.lane.spec.gpu.idle_watts for a in actions],
                 dtype=np.float64)
        hz = get([a.lane.spec.gpu.freq_mhz * 1e6 for a in actions],
                 dtype=np.float64)
        cap = get([a.cap for a in actions], dtype=np.float64)
        t_full = b * ins / np.maximum(ipcs * n_sm, 1e-12)
        t = np.minimum(t_full, cap)
        truncated = t < t_full
        thr = np.maximum(ipcs * n_sm, 1e-12) / ins
        d = np.where(truncated, np.minimum(b, thr * t), b)
        n_sl = np.where(ss > 0, d / np.maximum(ss, 1), 1.0)
        e = (pw * t + iw * (n_sl * lo)) * n_sm / hz
        pwt = pw * n_sm
        return t + n_sl * lo, n_sl, d, t, e, pwt

    # ---- main loop ---- #
    def start(self, specs: Sequence[LaneSpec]) -> List[_Lane]:
        """Materialize lanes without draining them — the incremental
        entry point for controllers (the serving daemon) that advance
        lanes with ``step`` and checkpoint between phases."""
        lanes = [_Lane(s, self._lane_scheduler(s)) for s in specs]
        self.stats["lanes"] += len(lanes)
        return lanes

    def step(self, active: Sequence[_Lane]) -> List[_Lane]:
        """Advance every lane in ``active`` by exactly one decision/charge
        phase; returns the still-live subset. After a step, every lane is
        at a phase boundary — the only points where lane state is
        checkpointable (``_Lane.state_json``) and where a finite
        ``cap_at`` parks a lane for preempt/cancel.

        Each step first admits everything that has landed by each lane's
        clock (fast-forwarding idle lanes to their next arrival), then
        decides/charges with per-lane phase caps at the next arrival (and
        the controller's ``cap_at``), then resolves completions."""
        active = list(active)
        if not active:
            return []
        self.stats["steps"] += 1
        # -- arrival events: admission + idle fast-forward -- #
        for ln in active:
            self.stats["admitted"] += ln.pend.admit_until(ln.total)
            if not ln.pend.active():
                # idle until the next arrival: advance the lane clock
                nxt = ln.pend.next_arrival()
                ln.total = max(ln.total, nxt)
                ln.log.append((ln.total, "idle"))
                self.stats["idle_ffwd"] += 1
                self.stats["admitted"] += ln.pend.admit_until(ln.total)
        actions = [self._decide(ln) for ln in active]
        for a in actions:
            nxt = a.lane.pend.next_arrival()
            if nxt is not None:
                a.cap = nxt - a.lane.total    # > 0: nxt was unadmitted
            if np.isfinite(a.lane.cap_at):
                # controller ceiling (preempt/pause): never negative, so a
                # stale cap_at cannot roll a lane clock backwards
                a.cap = min(a.cap, max(a.lane.cap_at - a.lane.total, 0.0))
            self._probe_cap(a)
        self._resolve_lookups(actions)
        co = [a for a in actions if a.kind == "co"]
        solo = [a for a in actions if a.kind == "solo"]
        self.stats["charged"] += len(actions)
        self.stats["charge_batches"] += (1 if co else 0) + (1 if solo else 0)
        if co:
            t, d1, d2, sl, t_ex, e, pwt = self._charge_co(co)
            for j, a in enumerate(co):
                ln = a.lane
                ln.pend.begin_phase(ln.total)
                ln.pend.drain(a.n1, d1[j])
                ln.pend.drain(a.n2, d2[j])
                ln.total = ln.total + t[j]
                ln.energy_j += float(e[j])
                if t_ex[j] > 0:
                    # zero-length phases (cap already reached) never set
                    # the peak: nothing actually drew the pair watts
                    ln.max_watts = max(ln.max_watts, float(pwt[j]))
                if a.count:
                    ln.n_cos += 1
                    ln.n_slices = ln.n_slices + sl[j]
                ln.log.append((ln.total, a.event))
                ln.pend.pop_completed(ln.total)
                self._observe(a, t_ex[j], d1[j], d2[j])
        if solo:
            t, n_sl, d, t_ex, e, pwt = self._charge_solo(solo)
            for j, a in enumerate(solo):
                ln = a.lane
                ln.pend.begin_phase(ln.total)
                ln.pend.drain(a.n1, d[j])
                ln.total = ln.total + t[j]
                ln.energy_j += float(e[j])
                if t_ex[j] > 0:
                    ln.max_watts = max(ln.max_watts, float(pwt[j]))
                if a.count:
                    ln.n_slices = ln.n_slices + n_sl[j]
                ln.log.append((ln.total, a.event))
                ln.pend.pop_completed(ln.total)
                self._observe(a, t_ex[j], d[j])
        return [ln for ln in active if ln.live()]

    # ---- online learning hooks (adaptive lanes only) ---- #
    @staticmethod
    def _probe_cap(a: _Action) -> None:
        """Truncate the phase to a probe window while any of its kernels'
        estimates are unsettled: a wrong prior costs a short slice, the
        observation lands, and the next decision re-fires against the
        refined profile — the existing arrival/preemption cap machinery
        as the preemption point. The window is a fraction of the
        *predicted* phase duration (never of an arrival time), so the
        t=0 == backlog pin extends to adaptive lanes."""
        est = a.lane.est
        if est is None or a.pr1 is None:
            return
        names = (a.n1,) if a.n2 is None else (a.n1, a.n2)
        if all(est.settled(n) for n in names):
            return
        pred_t = a.b1 / max(a.pr1, 1e-12)
        if a.n2 is not None:
            pred_t = min(pred_t, a.b2 / max(a.pr2, 1e-12))
        a.cap = min(a.cap, est.probe_window(pred_t))

    @staticmethod
    def _observe(a: _Action, t_ex: float, d1: float,
                 d2: Optional[float] = None) -> None:
        """Refine the lane's estimator from one charged phase: observed
        throughput is drained blocks over pre-overhead execution time —
        exact in the simulator, since phases drain at the truth table's
        rate. Counts a re-decision when an estimate moved past the
        re-slice threshold (the next phase decides differently)."""
        est = a.lane.est
        if est is None or a.pr1 is None or not t_ex > 0.0:
            return
        changed = est.observe(a.n1, d1 / t_ex, a.pr1)
        if a.n2 is not None:
            changed = est.observe(a.n2, d2 / t_ex, a.pr2) or changed
        if changed:
            a.lane.est_redecisions += 1

    def run(self, specs: Sequence[LaneSpec]) -> List[WorkloadResult]:
        """Drain every lane; returns one ``WorkloadResult`` per spec, in
        order — each bit-identical to ``run_policy_reference`` on the same
        configuration (arrival-timed lanes: on the t=0 schedule)."""
        lanes = self.start(specs)
        active = [ln for ln in lanes if ln.live()]
        while active:
            active = self.step(active)
        return [ln.result() for ln in lanes]


def run_lanes(specs: Sequence[LaneSpec]) -> List[WorkloadResult]:
    """One-shot convenience: a fresh engine over ``specs``."""
    return WorkloadEngine().run(specs)


class DealPolicy:
    """Assigns every entry of one arrival stream to a fleet GPU.

    ``assign`` returns one GPU index per ``order`` entry; ``run_fleet``
    splits the stream accordingly. ``gpus`` (one ``GPUSpec`` per fleet
    lane, parallel to the GPU indices) is passed on heterogeneous fleets
    so load-aware deals can weigh per-GPU speed; policies written before
    it existed (``gpu`` only) keep working — ``run_fleet`` inspects the
    signature. Subclass to plug in custom placement (affinity, …)."""

    name = "deal"

    def assign(self, order: Sequence[str],
               arrivals: Optional[Sequence[float]], n_gpus: int, *,
               profiles: Dict[str, KernelProfile],
               gpu: GPUSpec,
               gpus: Optional[Sequence[GPUSpec]] = None) -> List[int]:
        raise NotImplementedError


class RoundRobinDeal(DealPolicy):
    """The paper-era arrival-blind deal: instance i goes to GPU
    ``i % n_gpus`` (exactly the former ``order[g::n_gpus]`` split). Counts
    are balanced; work is not — a stream whose heavy kernels recur with a
    period sharing a factor with ``n_gpus`` pins them all to one GPU."""

    name = "round_robin"

    def assign(self, order, arrivals, n_gpus, *, profiles, gpu, gpus=None):
        return [i % n_gpus for i in range(len(order))]


# (gpu digest, kernel name, profile digest) -> predicted solo service
# cycles per instance. Module-level so repeated plan_fleet/assign calls —
# and every LeastBacklogDeal instance — stay warm: the Markov solve and
# _solo_phase arithmetic behind a prediction run once per content identity
# per process, not once per assign() call.
_SERVICE_MEMO: Dict[tuple, float] = {}


class LeastBacklogDeal(DealPolicy):
    """Greedy least-predicted-backlog dealing: each arrival goes to the
    GPU with the smallest predicted outstanding work at its timestamp,
    whose ledger is then charged the instance's predicted service time
    *on that GPU* — on a heterogeneous fleet a fast pod's ledger grows
    more slowly, so it correctly absorbs more of a skewed stream.

    The default predictor is a one-phase engine replay per kernel type —
    ``_solo_phase`` (the engine's own solo arithmetic) on the Markov
    model's solo IPC — computed per distinct ``GPUSpec`` and memoized
    module-wide by (gpu digest, name, profile digest), so repeated
    ``plan_fleet`` calls do zero extra Markov solves. Pass ``predictor``
    to plug in a different estimate: either ``name -> cycles`` (applied
    to every GPU) or ``(name, gpu_spec) -> cycles`` (per-GPU)."""

    name = "least_backlog"

    def __init__(self, predictor=None):
        self.predictor = predictor

    @staticmethod
    def _default_service(profiles: Dict[str, KernelProfile],
                         spec: GPUSpec) -> Dict[str, float]:
        """name -> memoized predicted solo service cycles on ``spec``."""
        gd = content_digest(spec)
        out, model, vg = {}, None, None
        for n, p in profiles.items():
            key = (gd, n, content_digest(p))
            val = _SERVICE_MEMO.get(key)
            if val is None:
                if model is None:     # build the model only on a memo miss
                    vg = spec.virtual()
                    model = MarkovModel(vg, three_state=True)
                ipc = model.single_ipc(p, p.active_units(vg))
                val = _solo_phase(p, p.num_blocks, ipc, spec)[0]
                _SERVICE_MEMO[key] = val
            out[n] = val
        return out

    def assign(self, order, arrivals, n_gpus, *, profiles, gpu, gpus=None):
        specs = list(gpus) if gpus is not None else [gpu] * n_gpus
        if len(specs) != n_gpus:
            raise ValueError("gpus must carry one GPUSpec per fleet lane")
        user = self.predictor
        if user is not None:
            pos = [p for p in inspect.signature(user).parameters.values()
                   if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                                 p.VAR_POSITIONAL)]
            per_gpu = (len(pos) >= 2
                       or any(p.kind is p.VAR_POSITIONAL for p in pos))

            def pred(n, g):
                return user(n, specs[g]) if per_gpu else user(n)
        else:
            by_digest: Dict[str, Dict[str, float]] = {}
            lane_svc = []
            for s in specs:
                d = content_digest(s)
                if d not in by_digest:
                    by_digest[d] = self._default_service(profiles, s)
                lane_svc.append(by_digest[d])

            def pred(n, g):
                return lane_svc[g][n]

        ts = arrivals if arrivals is not None else [0.0] * len(order)
        busy = np.zeros(n_gpus, dtype=np.float64)
        out = [0] * len(order)
        # greedy pass in arrival-time order (stable on ties, matching
        # _Pending's admission sort): the stream API accepts unsorted
        # timestamps everywhere else, and charging the ledgers out of
        # time order would make the backlog prediction arbitrary.
        # argmin returns the first index among equal minima — the same
        # lowest-index tie-break as the scalar min((backlog, k)) it
        # replaces, vectorized so thousand-lane fleets deal in one pass.
        for i in sorted(range(len(order)), key=lambda j: (ts[j], j)):
            t, n = ts[i], order[i]
            g = int(np.argmin(np.maximum(busy - t, 0.0)))
            out[i] = g
            busy[g] = max(busy[g], t) + pred(n, g)
        return out


_DEALS = {"round_robin": RoundRobinDeal, "least_backlog": LeastBacklogDeal}


def resolve_deal(deal: Union[str, DealPolicy],
                 arrivals: Optional[Sequence[float]]) -> DealPolicy:
    """``"auto"`` (the default) deals least-predicted-backlog when the
    stream is arrival-timed and round-robin in backlog mode (which keeps
    the backlog fleet pins bit-identical to the pre-DealPolicy split)."""
    if isinstance(deal, DealPolicy):
        return deal
    if deal == "auto":
        deal = "least_backlog" if arrivals is not None else "round_robin"
    try:
        return _DEALS[deal]()
    except KeyError:
        raise ValueError(f"unknown deal policy {deal!r}: "
                         f"expected 'auto', one of {sorted(_DEALS)}, or a "
                         "DealPolicy instance") from None


def _fleet_gpus(gpu, n_gpus, gpus) -> List[GPUSpec]:
    """Resolve the fleet's per-lane specs. ``gpus`` (or a sequence passed
    as ``gpu``) makes the fleet heterogeneous; a scalar ``gpu`` is the
    compat alias expanding to ``n_gpus`` copies."""
    if gpus is None and not isinstance(gpu, GPUSpec):
        gpu, gpus = None, gpu                 # sequence in the gpu slot
    if gpus is not None:
        if gpu is not None and not isinstance(gpu, GPUSpec):
            raise ValueError("pass per-lane specs either positionally or "
                             "as gpus=, not both")
        specs = list(gpus)
        if not specs:
            raise ValueError("gpus must be non-empty")
        if not all(isinstance(s, GPUSpec) for s in specs):
            raise ValueError("gpus must be a sequence of GPUSpec")
        if n_gpus is not None and n_gpus != len(specs):
            raise ValueError(f"n_gpus={n_gpus} but {len(specs)} gpus given")
        return specs
    if n_gpus is None:
        raise ValueError("n_gpus is required with a scalar gpu")
    if n_gpus < 1:
        raise ValueError("n_gpus must be >= 1")
    return [gpu] * n_gpus


def _fleet_tables(specs: Sequence[GPUSpec],
                  truth: IPCTable) -> List[IPCTable]:
    """One shared measurement table per *distinct* spec content: lanes on
    equal specs share one ``IPCTable`` object, so the engine's per-content
    lookup batching sweeps each distinct GPU's physics exactly once per
    step. ``truth`` serves specs whose virtual GPU matches its content
    (the homogeneous fleet keeps sharing it verbatim — the FLEET_GOLDEN
    contract) and acts as the seed/rounds/persistence template for the
    tables the other specs get."""
    tables = {truth.content_key: truth}
    out = []
    for s in specs:
        key = (content_digest(s.virtual()), truth.seed, truth.rounds)
        tbl = tables.get(key)
        if tbl is None:
            tbl = IPCTable(s.virtual(), seed=truth.seed,
                           rounds=truth.rounds, persist=truth.persisted)
            tables[key] = tbl
        out.append(tbl)
    return out


def run_fleet(policy: str, profiles: Dict[str, KernelProfile],
              order: List[str],
              gpu: Union[GPUSpec, Sequence[GPUSpec]], truth: IPCTable,
              n_gpus: Optional[int] = None, *,
              alpha_p: float = 0.4, alpha_m: float = 0.1,
              cp_margin: Optional[float] = None, seed: int = 0,
              engine: Optional[WorkloadEngine] = None,
              arrivals: Optional[Sequence[float]] = None,
              slo_deadline: Optional[float] = None,
              deadlines: Optional[Sequence[float]] = None,
              interpolate: bool = True,
              deal: Union[str, DealPolicy] = "auto",
              gpus: Optional[Sequence[GPUSpec]] = None,
              power_cap: Optional[float] = None) -> FleetResult:
    """Replay one arrival stream over a fleet of GPUs: the stream is split
    by ``deal`` (see ``resolve_deal`` — round-robin in backlog mode,
    least-predicted-backlog under arrivals, or any ``DealPolicy``
    instance) and, via the engine, every lane shares one scheduler
    decision cache per decision identity. The fleet makespan — the
    slowest GPU's total — is the workload metric.

    Homogeneous fleets pass a scalar ``gpu`` plus ``n_gpus``; every lane
    then shares ``truth`` (one measurement service), exactly the
    pre-heterogeneity behavior. Heterogeneous fleets pass ``gpus`` (or a
    ``GPUSpec`` sequence in the ``gpu`` slot): lane g runs on ``gpus[g]``
    with one shared ``IPCTable`` per *distinct* spec content —
    ``truth`` serves matching specs and is the seed/rounds/persistence
    template for the rest — and the engine still charges all lanes in one
    vectorized pass per step (lookups batch per distinct table content).

    Lanes that deal zero instances (``n_gpus > len(order)``) replay empty:
    their ``total_cycles`` is 0.0 (they never bind the makespan) and they
    contribute no completions to the pooled latency metrics.

    With ``arrivals`` (timestamps parallel to ``order``, dealt with it)
    every lane replays arrival-timed, and the result additionally carries
    the pooled latency metrics (p50/p95 wait, and SLO attainment when
    ``slo_deadline`` is given). ``deadlines`` (absolute, parallel to
    ``order``) feed EDF-KERNELET lanes per-instance deadlines.

    MC lanes draw from per-lane streams spawned via
    ``np.random.SeedSequence(seed).spawn``, so no two (seed, lane) pairs
    can collide the way the old ``seed + g`` derivation did.

    ``power_cap`` (watts, per GPU) arms POWERCAP lanes' co-scheduling
    gate; the result always carries pooled energy metrics
    (``FleetResult.energy``) regardless of policy or cap."""
    lane_gpus = _fleet_gpus(gpu, n_gpus, gpus)
    n_gpus = len(lane_gpus)
    if n_gpus < 1:
        raise ValueError("n_gpus must be >= 1")
    if arrivals is not None and len(arrivals) != len(order):
        raise ValueError("arrivals must parallel order")
    if deadlines is not None and len(deadlines) != len(order):
        raise ValueError("deadlines must parallel order")
    homogeneous = all(s == lane_gpus[0] for s in lane_gpus)
    lane_tables = ([truth] * n_gpus
                   if homogeneous and isinstance(gpu, GPUSpec)
                   and lane_gpus[0] == gpu
                   else _fleet_tables(lane_gpus, truth))
    dealer = resolve_deal(deal, arrivals)
    deal_kwargs = {"profiles": profiles, "gpu": lane_gpus[0]}
    deal_params = inspect.signature(dealer.assign).parameters
    if ("gpus" in deal_params
            or any(p.kind is p.VAR_KEYWORD for p in deal_params.values())):
        deal_kwargs["gpus"] = tuple(lane_gpus)
    assign = dealer.assign(order, arrivals, n_gpus, **deal_kwargs)
    parts = [[] for _ in range(n_gpus)]      # per-GPU entry indices
    for i, g in enumerate(assign):
        parts[g].append(i)
    eng = engine if engine is not None else WorkloadEngine()
    # collision-free per-lane MC streams: seed=0/lane 1 and seed=1/lane 0
    # must never share a generator state (the old ``seed + g`` bug)
    mc_rngs = ([np.random.default_rng(c) for c in
                np.random.SeedSequence(seed).spawn(n_gpus)]
               if policy == "MC" else [None] * n_gpus)
    specs = [LaneSpec(policy=policy, profiles=profiles,
                      order=[order[i] for i in part], gpu=lane_gpus[g],
                      truth=lane_tables[g],
                      alpha_p=alpha_p, alpha_m=alpha_m,
                      cp_margin=cp_margin, seed=seed,
                      mc_rng=mc_rngs[g], label=f"gpu{g}",
                      arrivals=(None if arrivals is None
                                else [arrivals[i] for i in part]),
                      slo_deadline=slo_deadline,
                      deadlines=(None if deadlines is None
                                 else [deadlines[i] for i in part]),
                      interpolate=interpolate, power_cap=power_cap)
             for g, part in enumerate(parts)]
    results = eng.run(specs)
    return FleetResult(
        lanes=results,
        makespan=float(max((r.total_cycles for r in results),
                           default=0.0)),
        total_cycles=float(sum(r.total_cycles for r in results)),
        n_coschedules=sum(r.n_coschedules for r in results),
        n_slices=float(sum(r.n_slices for r in results)),
        latency=(aggregate_latency(results, slo_deadline)
                 if arrivals is not None else None),
        deal=dealer.name,
        gpus=list(lane_gpus),
        energy=aggregate_energy(results))
