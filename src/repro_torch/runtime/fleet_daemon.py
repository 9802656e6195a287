"""Pod fleet runtime: N serving daemons over ONE shared job store.

Kernelet's dispatcher becomes production-shaped here: instead of a
single synchronous ``run_until_idle`` drive, a ``PodFleet`` runs N
``ServingDaemon`` pods (worker threads, each with its own SQLite
connection and wall clock) against one store, coordinated only through
the durable lease table:

  * **Work-stealing.** An idle pod calls ``serve_once`` — a scan of the
    shared queued table gated by ``acquire_lease`` — so any pod may
    claim any queued job and exactly one wins each. There is no central
    dispatcher to die.
  * **Event-driven monitor loop.** An idle pod polls ``PRAGMA
    data_version`` (bumps only when a *sibling* connection commits) and
    rescans immediately on a delta; otherwise it sleeps a jittered,
    exponentially backed-off interval. No change, no table scans.
  * **Dead-pod failover.** Every loop requeues expired leases
    (``JobStore.requeue_expired``): a job a dead pod left ``running``
    rejoins the queue after its TTL, resumes from its last checkpoint
    on whichever pod steals it, and the dead pod's fencing epoch is
    invalidated so a zombie waking later gets ``StaleLease``.
  * **Graceful overload degradation.** A Moore–Hodgson drop pass over
    the queued deadline jobs (EDD order, evict the largest service on
    infeasibility) sheds provably-hopeless work to ``cancelled`` with a
    durable event — bounded queues instead of silent deadline misses.
    Jobs opt in via ``deadline_at`` (+ optional ``est_service_s``) in
    their spec; jobs without a deadline are never shed.
  * **Respawn.** The controller replaces killed pods (fresh pod id,
    fresh connection) up to ``max_respawns`` — the chaos harness kills
    every pod in some schedules and the fleet still drains.

The chaos harness (``repro.runtime.chaos``) plugs in per pod: a skewed
``ChaosClock``, a fault-injecting ``FaultyStore`` wrapper, and a
``PodKilled`` mid-phase kill — ``tests/test_pod_fleet.py`` pins that
any seeded schedule leaves every job finished exactly once with pooled
results bit-identical to a single uninterrupted pod.

CLI (multi-pod drill; same jobs format as ``repro.runtime.daemon``)::

  PYTHONPATH=src python -m repro.runtime.fleet_daemon \
      --store pod.sqlite --jobs jobs.json --pods 3 [--out results.json]

Exit code is nonzero if any job ends ``failed`` or fails to reach a
terminal state before ``--timeout``. ``--kill-after-phases K`` SIGKILLs
the whole fleet process after K engine phases (fault drill; rerun the
command to recover). Numpy-only by design: no jax import chain.
"""
from __future__ import annotations

import argparse
import heapq
import itertools
import json
import os
import random
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.jobstore import (CANCELLED, FAILED, PAUSED, QUEUED,
                                 RUNNING, TERMINAL_STATES,
                                 IllegalTransition, JobStore,
                                 JobStoreError)
from repro_torch.runtime.chaos import ChaosClock, FaultyStore, PodChaos, \
    PodKilled
from repro_torch.runtime.daemon import ServingDaemon, _env_float

ENV_FLEET_POLL = "REPRO_FLEET_POLL"
ENV_FLEET_POLL_CAP = "REPRO_FLEET_POLL_CAP"

_FLEET_SEQ = itertools.count()


def moore_hodgson_shed(jobs, now: float,
                       capacity: float = 1.0) -> List[str]:
    """Moore–Hodgson drop pass: given queued ``(job_id, est_service_s,
    deadline_at)`` rows, return the ids to shed so the REST all meet
    their deadlines — the classic 1||ΣU_j sweep: walk jobs in EDD
    order accumulating completion time at ``capacity`` (jobs served
    concurrently by the fleet); on an overrun, evict the scheduled job
    with the largest service (frees the most time per drop). The
    evicted set is exactly the minimum number of late jobs.

    Jobs that are individually hopeless — they would miss their deadline
    even starting right now with the whole fleet (notably zero/missing
    ``est_service_s`` rows whose deadline already passed) — are shed
    directly and never enter the eviction sweep. The classic rule would
    otherwise keep the doomed job and evict the largest-service
    *feasible* job in its place: eviction frees time proportional to
    service, so dropping a zero-estimate job can never repair the
    overrun it caused, and a job that would have met its deadline gets
    cancelled for nothing.

    Garbage estimates cannot corrupt the sweep: services clamp to
    ``>= 0`` (a negative estimate would *subtract* fictional load from
    the completion sum, hiding real overruns — and once services go
    negative the self-eviction invariant above breaks, so a zero/bogus
    estimate could then evict a feasible real-estimate job), NaN
    services count as zero, and a NaN deadline reads as +inf (never
    shed, but its load still counts)."""
    drop: List[str] = []
    heap: List[tuple] = []            # (-service, job_id) max-heap
    completion = 0.0
    cap = max(capacity, 1e-9)
    for jid, service, deadline in sorted(jobs,
                                         key=lambda r: (r[2], r[0])):
        s = float(service)
        if not s >= 0.0:              # negative or NaN: clamp
            s = 0.0
        d = float(deadline)
        if d != d:                    # NaN deadline: never shed
            d = float("inf")
        if now + s / cap > d:
            drop.append(jid)          # hopeless alone: shed, don't evict
            continue
        heapq.heappush(heap, (-s, jid))
        completion += s / cap
        if now + completion > d and heap:
            neg_s, evicted = heapq.heappop(heap)
            completion += neg_s / cap          # neg_s < 0: time freed
            drop.append(evicted)
    return drop


class _Pod:
    """One fleet worker: identity, clock, chaos share, and its thread."""

    def __init__(self, pod_id: str, clock, chaos: Optional[PodChaos],
                 rng: random.Random):
        self.pod_id = pod_id
        self.clock = clock
        self.chaos = chaos
        self.rng = rng
        self.thread: Optional[threading.Thread] = None
        self.store = None               # raw JobStore (for contention)
        self.daemon: Optional[ServingDaemon] = None
        self.killed = False
        self.replaced = False
        self.phases = 0
        self.served: List[tuple] = []


class PodFleet:
    """N-pod fleet controller over one SQLite job store.

    The controller thread only spawns/respawns pods and watches for
    fleet-idle; all coordination between pods is durable state (leases,
    the queued table). ``chaos`` assigns ``PodChaos`` entries to the
    first ``len(chaos)`` pods spawned (respawned pods beyond the
    schedule run clean)."""

    def __init__(self, store_path: str, n_pods: int = 2, *,
                 lease_ttl: float = 5.0,
                 ckpt_every: int = 1,
                 poll_s: Optional[float] = None,
                 poll_cap_s: Optional[float] = None,
                 max_retries: int = 4,
                 backoff_base: float = 0.005,
                 backoff_cap: float = 0.05,
                 respawn: bool = True,
                 max_respawns: Optional[int] = None,
                 shed: bool = True,
                 default_service_s: float = 1.0,
                 kill_process_after_phases: Optional[int] = None,
                 chaos: Optional[List[PodChaos]] = None,
                 seed: int = 0,
                 clock=time.time):
        self.store_path = store_path
        # THE fleet clock: every controller-side comparison (run timeout,
        # journal stamps, lease-expiry scans, the shed pass) runs on this
        # one injected clock. Pod clocks may be chaos-skewed — that models
        # per-machine wall-clock drift, and fencing epochs keep pod *writes*
        # safe — but irreversible fleet decisions (shedding a queued job to
        # ``cancelled`` is not fence-protected) must never run on a skewed
        # pod clock: a fast pod would cancel jobs whose deadlines are in
        # fact comfortably meetable. Mixing ``time.monotonic()`` into the
        # wait loops was the same bug in the other direction.
        self.clock = clock
        self.n_pods = max(1, int(n_pods))
        self.lease_ttl = float(lease_ttl)
        self.ckpt_every = max(1, int(ckpt_every))
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float(ENV_FLEET_POLL, 0.02))
        self.poll_cap_s = (poll_cap_s if poll_cap_s is not None
                           else _env_float(ENV_FLEET_POLL_CAP, 0.25))
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.respawn = bool(respawn)
        self.max_respawns = (2 * self.n_pods if max_respawns is None
                             else int(max_respawns))
        self.shed = bool(shed)
        self.default_service_s = float(default_service_s)
        self.kill_process_after_phases = kill_process_after_phases
        self.chaos = chaos
        self.seed = int(seed)
        self.name = f"fleet{next(_FLEET_SEQ)}-{os.getpid()}"
        self.pods: List[_Pod] = []
        self.journal: List[tuple] = []  # (t_fleet, pod_id, kind, payload)
        self.stats = {"store_faults": 0, "requeues": 0, "shed": 0,
                      "respawns": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._spawn_idx = 0
        self._total_phases = 0
        self._store = JobStore(store_path, clock=clock)

    # ---- store access (controller thread / external callers) ---- #
    def open_store(self) -> JobStore:
        """A fresh, un-chaosed connection to the fleet's store (callers
        own it and must close it)."""
        return JobStore(self.store_path, clock=self.clock)

    def submit(self, job_id: str, spec: dict) -> None:
        self._store.create_job(job_id, spec)

    def close(self) -> None:
        self._store.close()

    # ---- journal ---- #
    def _note(self, pod_id: str, kind: str, payload) -> None:
        with self._lock:
            self.journal.append(
                (self.clock(), pod_id, kind, payload))

    # ---- pod lifecycle ---- #
    def _spawn(self) -> _Pod:
        idx = self._spawn_idx
        self._spawn_idx += 1
        chaos = (self.chaos[idx]
                 if self.chaos is not None and idx < len(self.chaos)
                 else None)
        # pod skew is relative to the fleet clock, so an injected fleet
        # clock (tests) shifts the whole fleet coherently
        clock = (ChaosClock(chaos.clock_skew_s, base=self.clock)
                 if chaos is not None and chaos.clock_skew_s else
                 self.clock)
        pod = _Pod(f"{self.name}-p{idx}", clock, chaos,
                   random.Random((self.seed << 8) ^ idx))
        pod.thread = threading.Thread(target=self._worker, args=(pod,),
                                      name=pod.pod_id, daemon=True)
        self.pods.append(pod)
        self._note(pod.pod_id, "spawn", idx)
        pod.thread.start()
        return pod

    def _open_pod_store(self, pod: _Pod):
        store = JobStore(self.store_path, clock=pod.clock)
        pod.store = store
        if pod.chaos is not None and (pod.chaos.fault_at_op is not None
                                      or pod.chaos.latency_s > 0):
            return FaultyStore(store, pod.chaos)
        return store

    def _phase_hook(self, pod: _Pod):
        def hook(daemon, job_id, phase):
            pod.phases += 1
            with self._lock:
                self._total_phases += 1
                total = self._total_phases
            k = self.kill_process_after_phases
            if k is not None and total >= k:
                os.kill(os.getpid(), signal.SIGKILL)
            if (pod.chaos is not None
                    and pod.chaos.kill_after_phases is not None
                    and pod.phases >= pod.chaos.kill_after_phases):
                raise PodKilled(pod.pod_id)
        return hook

    # ---- overload shedding ---- #
    def _live_pods(self) -> int:
        return sum(1 for p in self.pods
                   if p.thread is not None and p.thread.is_alive()
                   and not p.killed)

    def _shed_pass(self, store, now: float) -> List[str]:
        if not self.shed:
            return []
        cand = []
        for jid, _ in store.jobs(QUEUED):
            spec = store.spec(jid)
            deadline = spec.get("deadline_at")
            if deadline is None:
                continue
            # an explicit null / unparsable estimate reads as "missing"
            # (-> default), never as a TypeError that kills the monitor
            # loop of whichever pod happens to scan the job first
            est = spec.get("est_service_s")
            try:
                est = (self.default_service_s if est is None
                       else float(est))
            except (TypeError, ValueError):
                est = self.default_service_s
            try:
                deadline = float(deadline)
            except (TypeError, ValueError):
                continue                  # unparsable deadline: never shed
            cand.append((jid, est, deadline))
        if not cand:
            return []
        drop = moore_hodgson_shed(cand, now,
                                  capacity=float(max(1,
                                                     self._live_pods())))
        shed = []
        for jid in drop:
            try:
                store.transition(
                    jid, CANCELLED,
                    "shed: overload, deadline unmeetable "
                    "(moore-hodgson)")
                shed.append(jid)
            except (IllegalTransition, KeyError, JobStoreError):
                pass                      # raced: a sibling got it first
        if shed:
            with self._lock:
                self.stats["shed"] += len(shed)
        return shed

    # ---- the monitor loop (one per pod) ---- #
    def _fleet_idle(self, store) -> bool:
        """No more work the fleet could ever pick up: every job is
        terminal or deliberately parked (``paused`` belongs to whoever
        paused it, not the fleet)."""
        states = store.jobs()
        return all(st in TERMINAL_STATES or st == PAUSED
                   for _, st in states)

    def _worker(self, pod: _Pod) -> None:
        try:
            store = self._open_pod_store(pod)
        except JobStoreError:
            pod.killed = True
            self._note(pod.pod_id, "killed", "store unopenable")
            return
        daemon = ServingDaemon(
            self.store_path, store=store, pod_id=pod.pod_id,
            lease_ttl=self.lease_ttl, ckpt_every=self.ckpt_every,
            max_retries=self.max_retries,
            backoff_base=self.backoff_base,
            backoff_cap=self.backoff_cap, clock=pod.clock,
            on_phase=self._phase_hook(pod))
        pod.daemon = daemon
        backoff = self.poll_s
        last_dv = None
        try:
            while not self._stop.is_set():
                progressed = False
                try:
                    # expiry is judged on the fleet clock, not this pod's
                    # (possibly skewed) store clock: a fast pod must not
                    # steal leases that have not actually expired
                    expired = store.requeue_expired(now=self.clock())
                    if expired:
                        self._note(pod.pod_id, "requeue",
                                   [j for j, _, _ in expired])
                        with self._lock:
                            self.stats["requeues"] += len(expired)
                        progressed = True
                    # shedding cancels jobs irreversibly (no fencing on the
                    # queued->cancelled edge), so "now" is the fleet clock
                    if self._shed_pass(store, self.clock()):
                        progressed = True
                    served = daemon.serve_once()
                    if served is not None:
                        pod.served.append(served)
                        self._note(pod.pod_id, "served", served)
                        progressed = True
                except JobStoreError:
                    with self._lock:
                        self.stats["store_faults"] += 1
                if progressed:
                    backoff = self.poll_s
                    continue
                try:
                    if self._fleet_idle(store):
                        return
                    dv = store.data_version()
                except JobStoreError:
                    with self._lock:
                        self.stats["store_faults"] += 1
                    dv = None
                if dv is not None and dv != last_dv:
                    last_dv = dv          # a sibling committed: rescan
                    continue
                time.sleep(backoff * (0.5 + pod.rng.random()))
                backoff = min(backoff * 2.0, self.poll_cap_s)
        except PodKilled:
            pod.killed = True
            self._note(pod.pod_id, "killed", pod.phases)
        finally:
            daemon.close()

    # ---- controller ---- #
    def _recover_orphans(self) -> None:
        """Running jobs with NO lease holder (a pre-fleet daemon died,
        or a fleet process was killed between transition and lease
        write — impossible by construction, but durable state outlives
        construction) can never expire: take the recover edge now."""
        for jid, _ in self._store.jobs(RUNNING):
            lease = self._store.lease_of(jid)
            if lease is None or lease[0] == "":
                try:
                    self._store.transition(jid, QUEUED,
                                           "recovered (orphan lease)")
                except (IllegalTransition, KeyError, JobStoreError):
                    pass

    def run(self, timeout_s: float = 120.0) -> dict:
        """Spawn the pods, respawn killed ones while budget remains,
        return the fleet summary once every job is terminal/parked (or
        the timeout passes — summary says which)."""
        t_end = self.clock() + float(timeout_s)
        self._stop.clear()
        self._recover_orphans()
        for _ in range(self.n_pods):
            self._spawn()
        try:
            while self.clock() < t_end:
                if self._fleet_idle(self._store):
                    break
                if self.respawn:
                    for pod in list(self.pods):
                        if (pod.killed and not pod.replaced
                                and self.stats["respawns"]
                                < self.max_respawns):
                            pod.replaced = True
                            with self._lock:
                                self.stats["respawns"] += 1
                            self._spawn()
                if not any(p.thread.is_alive() for p in self.pods):
                    if self._fleet_idle(self._store):
                        break
                    if (not self.respawn or self.stats["respawns"]
                            >= self.max_respawns):
                        break             # budget gone, work remains
                time.sleep(self.poll_s)
        finally:
            self._stop.set()
            for p in self.pods:
                if p.thread is not None:
                    p.thread.join(timeout=30.0)
        return self.summary()

    def summary(self) -> dict:
        states = dict(self._store.jobs())
        counts: Dict[str, int] = {}
        for _, _, kind, _ in self.journal:
            counts[kind] = counts.get(kind, 0) + 1
        contention = int(self._store.contention) + sum(
            int(getattr(p.store, "contention", 0) or 0)
            for p in self.pods if p.store is not None)
        return {
            "jobs": states,
            "results": {jid: self._store.result(jid)
                        for jid in states},
            "served_by": {p.pod_id: [j for j, _ in p.served]
                          for p in self.pods},
            "stats": dict(self.stats, store_contention=contention),
            "journal_counts": counts,
            "n_pods_spawned": self._spawn_idx,
            "idle": self._fleet_idle(self._store),
        }


# ---------------------------------------------------------------- #
# CLI — the multi-pod drill / SIGKILL fault harness
# ---------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Pod fleet: N lease-coordinated serving daemons "
                    "over one shared job store.")
    ap.add_argument("--store", required=True)
    ap.add_argument("--jobs", required=True,
                    help="JSON file: {job_id: spec, ...} (idempotent)")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", action="store_true",
                    help="print a one-line JSON fleet summary")
    ap.add_argument("--lease-ttl", type=float, default=2.0)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--kill-after-phases", type=int, default=None,
                    help="SIGKILL the whole fleet process after K "
                         "engine phases (fault drill)")
    args = ap.parse_args(argv)

    fleet = PodFleet(args.store, n_pods=args.pods,
                     lease_ttl=args.lease_ttl,
                     ckpt_every=args.checkpoint_every,
                     kill_process_after_phases=args.kill_after_phases)
    with open(args.jobs) as f:
        jobs = json.load(f)
    for jid, spec in jobs.items():
        if fleet._store.state(jid) is None:
            fleet.submit(jid, spec)
    summary = fleet.run(timeout_s=args.timeout)

    store = fleet._store
    out = {jid: {"state": st,
                 "result": store.result(jid),
                 "events": [[e[2], e[3], e[4]]
                            for e in store.events(jid)]}
           for jid, st in store.jobs()}
    payload = json.dumps(out, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    else:
        print(payload)
    if args.json:
        print(json.dumps(
            {"fleet": fleet.name, "jobs": summary["jobs"],
             "stats": summary["stats"],
             "pods": summary["n_pods_spawned"],
             "idle": summary["idle"]}, sort_keys=True, default=str))
    states = summary["jobs"]
    bad = [jid for jid, st in states.items()
           if st == FAILED or st not in TERMINAL_STATES]
    fleet.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
