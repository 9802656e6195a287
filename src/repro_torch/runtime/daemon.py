"""Durable serving daemon: resumable drains over the workload engine.

Kernelet's dispatcher is a long-lived service — jobs arrive, get sliced
and co-scheduled, and the process serving them must survive restarts
without losing or silently re-running work. ``ServingDaemon`` is that
dispatcher for the repro's replay lanes:

  * **Jobs are lanes.** A job spec is a JSON description of one
    ``LaneSpec`` (policy, profiles, order, GPU, measurement-table
    identity, arrival schedule); the daemon builds the lane and drains it
    with ``WorkloadEngine.step`` — one decision/charge phase at a time,
    so every step ends at a phase boundary.
  * **Phase-boundary checkpoints.** Every ``ckpt_every`` phases the
    lane's full mutable state (drained blocks, ``_Pending`` ledgers,
    event log, MC RNG state) is serialized into the job store. Floats
    survive the JSON round trip exactly, so a drain resumed from a
    checkpoint replays the identical IEEE-754 sequence — kill/restart is
    bit-identical to an uninterrupted run (pinned by
    ``tests/test_daemon_recovery.py`` for all six policies).
  * **Leases, not locks.** Dispatch is lease-gated: ``serve_once`` claims
    a queued job with ``JobStore.acquire_lease`` (the atomic
    ``queued → running`` gate), getting back a fencing epoch. Every
    checkpoint renews the lease (heartbeat) and every store write the
    drain makes is fenced with ``(pod_id, epoch)`` — if the lease
    expired and the job was requeued/stolen by a sibling pod, the write
    raises ``StaleLease`` and the daemon abandons the job (counted
    ``lost``) instead of double-finishing it. A single daemon is just a
    fleet of one; the multi-pod controller is
    ``repro.runtime.fleet_daemon.PodFleet``.
  * **Crash recovery.** On restart, ``recover()`` requeues every job the
    dead process left ``running`` (the ``running → queued`` edge, logged
    as ``recovered``); ``run_until_idle`` then resumes each from its last
    checkpoint. In a live fleet the same edge is taken per-job by
    ``JobStore.requeue_expired`` when a dead pod's lease TTL passes.
  * **Retry with backoff.** Transient failures (``JobStoreError``,
    injected ``HostFailure``) re-enter the drain from the last
    checkpoint, sleeping ``min(cap, base * 2^attempt)`` between tries;
    exhausting ``max_retries`` transitions the job to ``failed`` — never
    a hang.
  * **Cancel / pause / preempt.** Control requests take effect at the
    next phase boundary; ``preempt(job_id, at)`` additionally sets the
    lane's ``cap_at`` so the engine truncates the *running* phase at that
    clock value — the PR 4 arrival-truncation cap reused as the
    block-granularity preemption point (Pai et al., arXiv 1406.6037).
  * **Read-only degrade.** If the durable store cannot be opened the
    daemon falls back to an in-memory ``MemoryJobStore`` and keeps
    planning/serving (``read_only=True``); nothing survives the process,
    but nothing crashes either.

Env knobs (all overridable per-daemon via constructor arguments):

  ``REPRO_DAEMON_CKPT_EVERY``    phases between checkpoints (default 1)
  ``REPRO_DAEMON_MAX_RETRIES``   transient-failure retries (default 3)
  ``REPRO_DAEMON_BACKOFF_BASE``  first retry delay, seconds (default 0.05)
  ``REPRO_DAEMON_BACKOFF_CAP``   max retry delay, seconds (default 2.0)
  ``REPRO_DAEMON_LEASE_TTL``     lease heartbeat TTL, seconds (default 30)

CLI (used by the fault-injection tests and the CI recovery step)::

  python -m repro.runtime.daemon --store pod.sqlite --jobs jobs.json \
      [--out results.json] [--json] [--pod-id ID] \
      [--kill-after-checkpoints K]

``--kill-after-checkpoints K`` SIGKILLs the daemon's own process at the
K-th checkpoint — deterministic mid-drain crashes for the recovery
harness. Rerunning the same command without the flag recovers and
completes the replay. The exit code is nonzero when any job ends
``failed``; ``--json`` prints a one-line machine-readable summary
(state counts + daemon stats) to stdout for scripting.

This module is numpy-only by design (no jax import chain): it must be
importable in the tier-1 CI environment.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import signal
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import LaneSpec, WorkloadEngine
from repro_torch.core.online import AdaptConfig
from repro_torch.core.jobstore import (CANCELLED, FAILED, FINISHED, PAUSED,
                                 QUEUED, RUNNING, IllegalTransition,
                                 JobStore, JobStoreError, MemoryJobStore,
                                 StaleLease)
from repro_torch.core.profiles import C2050, GTX680, H100, TPU_V5E, \
    GPUSpec, KernelProfile
from repro_torch.core.simulator import IPCTable
from repro_torch.runtime.fault_tolerance import HostFailure

ENV_CKPT_EVERY = "REPRO_DAEMON_CKPT_EVERY"
ENV_MAX_RETRIES = "REPRO_DAEMON_MAX_RETRIES"
ENV_BACKOFF_BASE = "REPRO_DAEMON_BACKOFF_BASE"
ENV_BACKOFF_CAP = "REPRO_DAEMON_BACKOFF_CAP"
ENV_LEASE_TTL = "REPRO_DAEMON_LEASE_TTL"

# state a drain returns when its lease was stolen mid-flight: not a job
# state (the thief owns the job's real state), a serve-loop outcome
LOST = "lost"

_NAMED_GPUS = {g.name: g for g in (C2050, GTX680, TPU_V5E, H100)}

# distinct default pod ids within one process (fleets, tests, respawns)
_POD_SEQ = itertools.count()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def resolve_gpu(gpu) -> GPUSpec:
    """Job-spec GPU field: a known name (``"C2050"``) or a full
    ``GPUSpec`` field dict."""
    if isinstance(gpu, str):
        try:
            return _NAMED_GPUS[gpu]
        except KeyError:
            raise ValueError(
                f"unknown GPU {gpu!r}: expected one of "
                f"{sorted(_NAMED_GPUS)} or a GPUSpec field dict") from None
    return GPUSpec(**gpu)


class JobStoreCheckpoints:
    """``repro.checkpoint.store``-shaped adapter over ``JobStore``
    checkpoint rows, so ``ResilientLoop`` (fault_tolerance) can use the
    daemon's durable store instead of npz files: the ``ckpt_dir``
    argument is reinterpreted as the job id. States must be JSON-safe."""

    def __init__(self, store):
        self.store = store

    def save(self, job_id: str, step: int, state) -> None:
        self.store.save_checkpoint(job_id, int(step), {"state": state})

    def latest_step(self, job_id: str) -> Optional[int]:
        ck = self.store.load_checkpoint(job_id)
        return None if ck is None else ck[0]

    def restore(self, job_id: str, template):
        ck = self.store.load_checkpoint(job_id)
        if ck is None:
            raise FileNotFoundError(f"no checkpoint for job {job_id!r}")
        step, payload = ck
        return payload["state"], step


class ServingDaemon:
    """Synchronous durable dispatcher over one ``WorkloadEngine``.

    ``on_checkpoint(daemon, job_id, phase)`` fires right after every
    checkpoint write — the fault-injection hook (tests SIGKILL or raise
    ``HostFailure`` from it) and the natural place for controllers to
    request cancel/pause/preempt of the running job.
    ``on_phase(daemon, job_id, phase)`` fires after every engine step,
    *before* any checkpoint — the chaos harness kills pods there, so
    deaths land mid-phase with un-checkpointed work to replay.

    ``pod_id``/``lease_ttl``/``clock`` are the fleet identity: every
    job this daemon drains is claimed via ``acquire_lease`` and every
    durable write is fenced with this pod's (id, epoch). ``store``
    injects an already-open store (the chaos harness wraps one in a
    fault injector); ``store_path`` is ignored then."""

    def __init__(self, store_path: str, *,
                 ckpt_every: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 pod_id: Optional[str] = None,
                 lease_ttl: Optional[float] = None,
                 clock=time.time, store=None,
                 on_checkpoint=None, on_phase=None, sleep=time.sleep):
        self.ckpt_every = max(1, ckpt_every if ckpt_every is not None
                              else _env_int(ENV_CKPT_EVERY, 1))
        self.max_retries = max(0, max_retries if max_retries is not None
                               else _env_int(ENV_MAX_RETRIES, 3))
        self.backoff_base = (backoff_base if backoff_base is not None
                             else _env_float(ENV_BACKOFF_BASE, 0.05))
        self.backoff_cap = (backoff_cap if backoff_cap is not None
                            else _env_float(ENV_BACKOFF_CAP, 2.0))
        self.pod_id = (pod_id if pod_id is not None
                       else f"pod-{os.getpid()}-{next(_POD_SEQ)}")
        self.lease_ttl = (lease_ttl if lease_ttl is not None
                          else _env_float(ENV_LEASE_TTL, 30.0))
        self.clock = clock
        self.on_checkpoint = on_checkpoint
        self.on_phase = on_phase
        self.sleep = sleep
        self.read_only = False
        self._counts = {"claimed": 0, "finished": 0, "failed": 0,
                        "lost": 0}
        if store is not None:
            self.store = store
        else:
            try:
                self.store = JobStore(store_path, clock=clock)
            except JobStoreError:
                # read-only planning mode: serve from memory, survive
                # nothing
                self.store = MemoryJobStore(clock=clock)
                self.read_only = True
        self.engine = WorkloadEngine()
        self._truths: Dict[tuple, IPCTable] = {}
        self._control: Dict[str, str] = {}      # job_id -> cancel | pause
        self._preempt_at: Dict[str, float] = {}  # job_id -> lane clock cap

    def close(self) -> None:
        self.store.close()

    def stats(self) -> dict:
        """Serve counters plus the store's ``SQLITE_BUSY`` collision
        count (``store_contention``) — the multi-writer health signal."""
        return dict(self._counts, store_contention=int(
            getattr(self.store, "contention", 0)))

    # ---- job intake / control ---- #
    def submit(self, job_id: str, spec: dict) -> None:
        self.store.create_job(job_id, spec)

    def cancel(self, job_id: str) -> None:
        """Cancel a job: immediately when queued/paused; at the next
        phase boundary when running (set from an ``on_checkpoint``
        hook — the daemon is synchronous)."""
        st = self.store.state(job_id)
        if st in (QUEUED, PAUSED):
            self._control.pop(job_id, None)
            self.store.transition(job_id, CANCELLED, "cancelled")
        elif st == RUNNING:
            self._control[job_id] = "cancel"

    def pause(self, job_id: str) -> None:
        """Park a running job at the next phase boundary (checkpointed,
        resumable)."""
        if self.store.state(job_id) == RUNNING:
            self._control[job_id] = "pause"

    def preempt(self, job_id: str, at: float) -> None:
        """Preempt a running job once its lane clock reaches ``at``
        cycles: the engine truncates the in-flight phase there (the PR 4
        cap), the daemon checkpoints and parks the job ``paused``."""
        self._preempt_at[job_id] = float(at)

    def poll_control(self, job_id: str) -> Optional[str]:
        """Pop the pending cancel/pause request for ``job_id``. External
        dispatchers (jobs whose spec carries ``"external"``, e.g.
        ``SharedPodServer.drain``) call this at their own round
        boundaries to honor the same control requests the daemon applies
        at phase boundaries for the lanes it drains itself."""
        return self._control.pop(job_id, None)

    def resume(self, job_id: str) -> str:
        """Resume a paused job from its checkpoint (re-acquiring a fresh
        lease at the next epoch); returns the terminal state it
        reaches."""
        epoch = self.store.acquire_lease(
            job_id, self.pod_id, self.lease_ttl, from_state=PAUSED,
            info="resumed")
        if epoch is None:
            raise IllegalTransition(
                f"resume: job {job_id!r} is not paused "
                f"(state {self.store.state(job_id)!r})")
        return self._retry_drain(job_id, self.store.spec(job_id), epoch)

    # ---- crash recovery ---- #
    def recover(self) -> List[str]:
        """Requeue every job a dead process left ``running`` (their
        checkpoints stay: the next dispatch resumes, not restarts).
        Returns the requeued job ids."""
        requeued = [jid for jid, _ in self.store.jobs(RUNNING)]
        for jid in requeued:
            self.store.transition(jid, QUEUED, "recovered")
        return requeued

    def serve_once(self) -> Optional[tuple]:
        """Claim and drain ONE queued job via the lease gate; the
        work-stealing primitive — any idle pod may call this against a
        shared store and exactly one pod wins each job. Returns
        ``(job_id, outcome)`` or ``None`` when nothing was claimable.
        Jobs whose spec carries ``"external"`` (state tracked by an
        outside dispatcher, e.g. ``SharedPodServer.drain``) are never
        claimed."""
        for jid, _ in self.store.jobs(QUEUED):
            spec = self.store.spec(jid)
            if spec.get("external"):
                continue
            epoch = self.store.acquire_lease(jid, self.pod_id,
                                             self.lease_ttl)
            if epoch is None:
                continue                  # a sibling pod won the race
            self._counts["claimed"] += 1
            return jid, self._retry_drain(jid, spec, epoch)
        return None

    def run_until_idle(self) -> Dict[str, str]:
        """Dispatch queued jobs (submission order) until none remain;
        returns {job_id: outcome} for everything dispatched."""
        out = {}
        while True:
            served = self.serve_once()
            if served is None:
                return out
            out[served[0]] = served[1]

    # ---- lane construction ---- #
    def _truth_for(self, gpu: GPUSpec, seed: int, rounds: int,
                   persist: bool) -> IPCTable:
        key = (gpu, seed, rounds, persist)
        t = self._truths.get(key)
        if t is None:
            t = IPCTable(gpu.virtual(), seed=seed, rounds=rounds,
                         persist=persist)
            self._truths[key] = t
        return t

    def lane_spec(self, spec: dict) -> LaneSpec:
        """Build the ``LaneSpec`` a job spec describes. Measurement truth
        is shared across jobs per (gpu, seed, rounds) identity — one
        measurement service per daemon, exactly like ``run_fleet``."""
        profiles = {n: KernelProfile(**f)
                    for n, f in spec["profiles"].items()}
        gpu = resolve_gpu(spec.get("gpu", "C2050"))
        truth = self._truth_for(gpu, int(spec.get("table_seed", 0)),
                                int(spec.get("rounds", 12000)),
                                bool(spec.get("persist", True)))
        # unknown kernels (PR 9): ``priors`` carries a guessed profile
        # per name — decisions predict from it while charging keeps the
        # calibrated physics above; ``adapt`` turns on online learning
        priors = spec.get("priors")
        if priors:
            priors = {n: KernelProfile(**f) for n, f in priors.items()}
        # adaptation knobs ride an AdaptConfig since PR 10; the JSON spec
        # keeps the flat legacy field names for wire compatibility
        adapt = bool(spec.get("adapt", False))
        if adapt:
            adapt = AdaptConfig(
                alpha=float(spec.get("adapt_alpha", 0.5)),
                reslice_threshold=float(spec.get("reslice_threshold",
                                                 0.05)),
                min_confidence=int(spec.get("adapt_min_conf", 2)),
                probe_frac=float(spec.get("probe_frac", 0.25)))
        pcap = spec.get("power_cap")
        return LaneSpec(
            policy=spec["policy"], profiles=profiles,
            order=list(spec["order"]), gpu=gpu, truth=truth,
            alpha_p=float(spec.get("alpha_p", 0.4)),
            alpha_m=float(spec.get("alpha_m", 0.1)),
            seed=int(spec.get("seed", 0)),
            cp_margin=spec.get("cp_margin"),
            arrivals=spec.get("arrivals"),
            slo_deadline=spec.get("slo_deadline"),
            deadlines=spec.get("deadlines"),
            interpolate=bool(spec.get("interpolate", True)),
            adapt=adapt,
            priors=priors or None,
            power_cap=None if pcap is None else float(pcap))

    # ---- drain machinery ---- #
    @staticmethod
    def _result_dict(lane, phases: int, partial: bool = False) -> dict:
        res = lane.result()
        out = {"policy": res.policy,
               "total_cycles": float(res.total_cycles),
               "n_coschedules": int(res.n_coschedules),
               "n_slices": float(res.n_slices),
               "time_line": [[float(t), e] for t, e in res.time_line],
               "completions": [[n, float(a), float(c)]
                               for n, a, c in res.completions],
               "energy_j": float(res.energy_j),
               "avg_watts": float(res.avg_watts),
               "max_watts": float(res.max_watts),
               "phases": int(phases), "partial": bool(partial)}
        if res.adapt_stats is not None:
            out["adapt_stats"] = res.adapt_stats
        return out

    def _checkpoint(self, job_id: str, phase: int, lane,
                    fence=None) -> None:
        if fence is not None:
            # heartbeat: a healthy drain keeps its lease alive for at
            # least one more TTL window per checkpoint
            self.store.renew_lease(job_id, fence[0], fence[1],
                                   self.lease_ttl)
        self.store.save_checkpoint(job_id, phase,
                                   lane.state_json(fence=fence),
                                   fence=fence)
        if self.on_checkpoint is not None:
            self.on_checkpoint(self, job_id, phase)

    def _retry_drain(self, job_id: str, spec: dict,
                     epoch: Optional[int] = None) -> str:
        """Drain with capped-exponential-backoff retries on transient
        failures; exhausting the budget fails the job (never hangs).
        ``StaleLease`` is terminal-for-this-pod, never retried: the job
        was requeued after lease expiry and belongs to whoever claims
        it next — this pod walks away (outcome ``"lost"``)."""
        fence = None if epoch is None else (self.pod_id, epoch)
        attempt = 0
        while True:
            try:
                st = self._drain(job_id, spec, fence)
                if st == FINISHED:
                    self._counts["finished"] += 1
                return st
            except StaleLease:
                self._counts["lost"] += 1
                return LOST
            except (ValueError, KeyError, TypeError) as e:
                # bad spec / config error: permanent, not transient —
                # fail the job instead of crashing the serve loop
                try:
                    self.store.transition(job_id, FAILED,
                                          f"bad spec: {e}", fence=fence)
                except (JobStoreError, KeyError, StaleLease,
                        IllegalTransition):
                    pass
                self._counts["failed"] += 1
                return FAILED
            except (JobStoreError, HostFailure) as e:
                attempt += 1
                if attempt > self.max_retries:
                    try:
                        self.store.transition(
                            job_id, FAILED, f"retries exhausted: {e}",
                            fence=fence)
                    except (JobStoreError, KeyError):
                        pass             # store gone too: job is lost anyway
                    except StaleLease:
                        self._counts["lost"] += 1
                        return LOST
                    self._counts["failed"] += 1
                    return FAILED
                self.sleep(min(self.backoff_cap,
                               self.backoff_base * (2.0 ** (attempt - 1))))

    def _drain(self, job_id: str, spec: dict, fence=None) -> str:
        lane = self.engine.start([self.lane_spec(spec)])[0]
        ck = self.store.load_checkpoint(job_id)
        phase = 0
        if ck is not None:
            phase, payload = ck
            lane.load_state(payload)
        active = [lane] if lane.live() else []
        while active:
            ctl = self._control.pop(job_id, None)
            if ctl in ("cancel", "pause"):
                self._checkpoint(job_id, phase, lane, fence)
                if ctl == "cancel":
                    self.store.transition(
                        job_id, CANCELLED, "cancelled at phase boundary",
                        result=self._result_dict(lane, phase,
                                                 partial=True),
                        fence=fence)
                    return CANCELLED
                self.store.transition(job_id, PAUSED,
                                      "paused at phase boundary",
                                      fence=fence)
                return PAUSED
            cap = self._preempt_at.get(job_id)
            if cap is not None and lane.total >= cap:
                # the truncated phase has been charged: park the job
                self._preempt_at.pop(job_id, None)
                self._checkpoint(job_id, phase, lane, fence)
                self.store.transition(
                    job_id, PAUSED, f"preempted at {float(lane.total)!r}",
                    fence=fence)
                return PAUSED
            lane.cap_at = cap if cap is not None else np.inf
            active = self.engine.step(active)
            phase += 1
            if self.on_phase is not None:
                self.on_phase(self, job_id, phase)
            if phase % self.ckpt_every == 0 or not active:
                self._checkpoint(job_id, phase, lane, fence)
        self.store.transition(job_id, FINISHED, "drained",
                              result=self._result_dict(lane, phase),
                              fence=fence)
        self.store.drop_checkpoint(job_id)
        return FINISHED


# ---------------------------------------------------------------- #
# CLI — the fault-injection harness entry point
# ---------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Durable serving daemon: drain job specs with "
                    "phase-boundary checkpoints and crash recovery.")
    ap.add_argument("--store", required=True,
                    help="SQLite job-store path (created if missing)")
    ap.add_argument("--jobs", required=True,
                    help="JSON file: {job_id: spec, ...} (idempotent: "
                         "already-known job ids are skipped)")
    ap.add_argument("--out", default=None,
                    help="write results JSON here (default: stdout)")
    ap.add_argument("--json", action="store_true",
                    help="print a one-line JSON status summary (state "
                         "counts + daemon stats) to stdout")
    ap.add_argument("--pod-id", default=None,
                    help="fleet identity for leases (default: "
                         "pod-<pid>-<seq>)")
    ap.add_argument("--lease-ttl", type=float, default=None,
                    help="lease heartbeat TTL in seconds")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--kill-after-checkpoints", type=int, default=None,
                    help="SIGKILL this process at the K-th checkpoint "
                         "(fault injection)")
    args = ap.parse_args(argv)

    hook = None
    if args.kill_after_checkpoints is not None:
        k = max(1, args.kill_after_checkpoints)
        seen = {"n": 0}

        def hook(daemon, job_id, phase):
            seen["n"] += 1
            if seen["n"] >= k:
                os.kill(os.getpid(), signal.SIGKILL)

    daemon = ServingDaemon(args.store,
                           ckpt_every=args.checkpoint_every,
                           pod_id=args.pod_id,
                           lease_ttl=args.lease_ttl,
                           on_checkpoint=hook)
    with open(args.jobs) as f:
        jobs = json.load(f)
    for jid, spec in jobs.items():
        if daemon.store.state(jid) is None:
            daemon.submit(jid, spec)
    daemon.recover()
    daemon.run_until_idle()

    states = daemon.store.jobs()
    out = {jid: {"state": st,
                 "result": daemon.store.result(jid),
                 "events": [[e[2], e[3], e[4]]
                            for e in daemon.store.events(jid)]}
           for jid, st in states}
    payload = json.dumps(out, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    else:
        print(payload)
    n_failed = sum(1 for _, st in states if st == FAILED)
    if args.json:
        by_state: Dict[str, int] = {}
        for _, st in states:
            by_state[st] = by_state.get(st, 0) + 1
        print(json.dumps({"pod": daemon.pod_id, "jobs": len(states),
                          "states": by_state, "stats": daemon.stats()},
                         sort_keys=True))
    daemon.close()
    # a job that exhausted its retries is an operational failure: make
    # the exit code say so instead of reporting success regardless
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
