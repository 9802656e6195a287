"""Chaos-injection harness for the pod fleet: seeded fault schedules.

The fleet's correctness claim is strong — *any* interleaving of pod
deaths, store faults, latency spikes, and clock skew leaves every
submitted job ``finished`` exactly once, with pooled results
bit-identical to an uninterrupted single-pod run. This module makes
that claim testable by turning "operational mess" into a deterministic,
seed-addressable schedule:

  * **``PodKilled``** — raised from the daemon's ``on_phase`` hook to
    kill a pod *mid-phase* (between checkpoints, with un-checkpointed
    work). Derived from ``BaseException`` so it sails through the
    daemon's transient-retry net exactly like a SIGKILL would: no
    cleanup, no final transition, the lease left dangling until its TTL
    expires and a sibling requeues the job.
  * **``ChaosClock``** — a per-pod wall clock with a fixed skew. Lease
    TTL arithmetic runs on the *local* clock, so skewed pods write
    early/late expiry stamps and may requeue a healthy sibling's lease;
    the fencing epochs (not clock agreement) are what keep that safe.
  * **``FaultyStore``** — wraps a ``JobStore`` connection; every call
    counts as one op, and a scheduled burst of consecutive ops raises
    ``JobStoreError`` (plus optional per-op latency). Bursts are kept
    within the daemon's retry budget so injected faults degrade, never
    fail, a job.
  * **``make_schedule(seed, n_pods)``** — the seed-addressable fault
    plan: which pods die after how many phases, their clock skew, and
    where their store-fault burst lands.

The verification half (``finished_exactly_once``, ``results_equal``)
is what the chaos tests and the CI ``pod-fleet-chaos`` job assert; the
``__main__`` runs one full seeded scenario end-to-end (reference run,
chaos fleet run, comparison) and exits nonzero on any violation::

  PYTHONPATH=src python -m repro.runtime.chaos --seed 0 --pods 3

This module is numpy-only (no jax import chain) and must stay
importable in the minimal CI environment.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.jobstore import FINISHED, JobStoreError


class PodKilled(BaseException):
    """In-process stand-in for SIGKILL: raised from ``on_phase``, it
    escapes every ``except Exception``-shaped net (daemon retries
    included) and unwinds the pod's worker thread without any cleanup
    transition — the lease dangles until TTL expiry, exactly like a
    real dead process."""


class ChaosClock:
    """A wall clock with a constant skew, injected per pod: lease
    stamps and expiry checks run on local (wrong) time while fencing
    epochs keep cross-pod writes safe."""

    def __init__(self, skew_s: float = 0.0, base=time.time):
        self.skew_s = float(skew_s)
        self.base = base

    def __call__(self) -> float:
        return self.base() + self.skew_s


@dataclasses.dataclass
class PodChaos:
    """One pod's share of a fault schedule. ``kill_after_phases`` is
    cumulative across every job the pod drains; ``fault_at_op`` starts
    a burst of ``fault_burst`` consecutive store-op failures (must stay
    ≤ the daemon's retry budget); ``latency_s`` sleeps before every
    store op; ``clock_skew_s`` offsets the pod's wall clock."""
    kill_after_phases: Optional[int] = None
    clock_skew_s: float = 0.0
    fault_at_op: Optional[int] = None
    fault_burst: int = 0
    latency_s: float = 0.0


class FaultyStore:
    """Fault-injecting proxy over a ``JobStore``: every public call is
    one op; ops inside the scheduled burst raise ``JobStoreError``
    before touching the inner store. Attribute access (``path``,
    ``contention``) and ``close`` pass through un-faulted."""

    _PASSTHROUGH = frozenset(("close",))

    def __init__(self, inner, chaos: PodChaos, sleep=time.sleep):
        self._inner = inner
        self._chaos = chaos
        self._sleep = sleep
        self.ops = 0
        self.faults = 0

    def _tick(self, name: str) -> None:
        self.ops += 1
        if self._chaos.latency_s > 0:
            self._sleep(self._chaos.latency_s)
        at = self._chaos.fault_at_op
        if (at is not None
                and at <= self.ops < at + self._chaos.fault_burst):
            self.faults += 1
            raise JobStoreError(
                f"chaos: injected store fault (op {self.ops}, "
                f"burst at {at}+{self._chaos.fault_burst})")

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr) or name in self._PASSTHROUGH \
                or name.startswith("_"):
            return attr

        def wrapped(*args, **kwargs):
            self._tick(name)
            return attr(*args, **kwargs)
        return wrapped


def make_schedule(seed: int, n_pods: int, *,
                  p_kill: float = 0.6,
                  kill_phase_lo: int = 1, kill_phase_hi: int = 6,
                  max_skew_s: float = 0.3,
                  p_fault: float = 0.5,
                  fault_op_lo: int = 5, fault_op_hi: int = 60,
                  max_burst: int = 3,
                  latency_s: float = 0.0) -> List[PodChaos]:
    """Seed-addressable fault plan for ``n_pods`` initial pods. Every
    draw comes from one ``random.Random(seed)`` stream, so a seed IS
    the scenario: the same kills, skews, and fault bursts every run.
    ``max_burst`` must not exceed the fleet daemons' retry budget."""
    rng = random.Random(seed)
    plan = []
    for _ in range(n_pods):
        kill = (rng.randrange(kill_phase_lo, kill_phase_hi + 1)
                if rng.random() < p_kill else None)
        skew = rng.uniform(-max_skew_s, max_skew_s)
        fault_at = (rng.randrange(fault_op_lo, fault_op_hi)
                    if rng.random() < p_fault else None)
        burst = rng.randint(1, max_burst) if fault_at is not None else 0
        plan.append(PodChaos(kill_after_phases=kill, clock_skew_s=skew,
                             fault_at_op=fault_at, fault_burst=burst,
                             latency_s=latency_s))
    return plan


# ---------------------------------------------------------------- #
# verification: exactly-once + bit-identical pooled results
# ---------------------------------------------------------------- #

def finished_exactly_once(store, job_ids) -> None:
    """Assert every job is terminal-``finished`` and took the
    ``-> finished`` edge exactly once in its durable event log (the
    exactly-once guarantee under kills/steals/zombies)."""
    for jid in job_ids:
        st = store.state(jid)
        if st != FINISHED:
            raise AssertionError(f"job {jid!r}: state {st!r}, expected "
                                 f"{FINISHED!r}")
        n = sum(1 for e in store.events(jid) if e[3] == FINISHED)
        if n != 1:
            raise AssertionError(
                f"job {jid!r}: {n} '-> finished' events, expected 1")


def results_equal(got: dict, ref: dict) -> List[str]:
    """Bit-identity comparison of two ``_result_dict`` payloads;
    returns a list of mismatch descriptions (empty = identical)."""
    bad = []
    for k in ("policy", "total_cycles", "n_coschedules", "n_slices"):
        if got.get(k) != ref.get(k):
            bad.append(f"{k}: {got.get(k)!r} != {ref.get(k)!r}")
    if got.get("time_line") != ref.get("time_line"):
        bad.append("time_line differs")
    if got.get("completions") != ref.get("completions"):
        bad.append("completions differ")
    return bad


# ---------------------------------------------------------------- #
# demo workload (shared by tests, the CLI, and the benchmark)
# ---------------------------------------------------------------- #

_PROFILES = {
    "A": {"name": "A", "rm": 0.2, "coal": 1.0,
          "insns_per_block": 9.0e4, "num_blocks": 64, "occupancy": 1.0},
    "B": {"name": "B", "rm": 0.8, "coal": 0.6,
          "insns_per_block": 1.1e5, "num_blocks": 64, "occupancy": 1.0},
    "C": {"name": "C", "rm": 0.5, "coal": 0.8,
          "insns_per_block": 8.0e4, "num_blocks": 48, "occupancy": 0.75},
    "D": {"name": "D", "rm": 0.35, "coal": 0.9,
          "insns_per_block": 1.0e5, "num_blocks": 56, "occupancy": 1.0},
}

ALL_POLICIES = ("BASE", "MC", "KERNELET", "OPT", "EDF-KERNELET",
                "PWAIT-CP")


def demo_jobs(policies=ALL_POLICIES, *, rounds: int = 600,
              n_instances: int = 8, seed: int = 7) -> Dict[str, dict]:
    """One job per policy over a shared kernel mix — the chaos tests'
    standard workload (mirrors ``tests/test_daemon_recovery.py``).
    Arrival-aware policies get a Poisson arrival schedule + SLO."""
    rng = np.random.default_rng(seed)
    order = [("A", "B", "C", "D")[i % 4] for i in range(n_instances)]
    arrivals = np.cumsum(rng.exponential(4.0e5, size=len(order)))
    jobs = {}
    for pol in policies:
        spec = {"policy": pol, "profiles": _PROFILES, "order": order,
                "gpu": "C2050", "table_seed": 0, "rounds": rounds,
                "persist": False, "alpha_p": 0.4, "alpha_m": 0.1}
        if pol in ("EDF-KERNELET", "PWAIT-CP"):
            spec["arrivals"] = [float(a) for a in arrivals]
            spec["slo_deadline"] = 2.0e6
        jobs[f"job-{pol}"] = spec
    return jobs


# ---------------------------------------------------------------- #
# CLI: one seeded scenario end-to-end (the CI seed matrix entry)
# ---------------------------------------------------------------- #

def run_scenario(seed: int, *, n_pods: int = 3, rounds: int = 600,
                 lease_ttl: float = 0.4, ckpt_every: int = 2,
                 workdir: Optional[str] = None,
                 verbose: bool = True) -> dict:
    """Reference single-pod run vs a chaos fleet run on the same jobs;
    asserts exactly-once + bit-identical pooled results. Returns the
    fleet summary (raises AssertionError on any violation)."""
    import os
    import tempfile

    from repro_torch.runtime.daemon import ServingDaemon
    from repro_torch.runtime.fleet_daemon import PodFleet

    own = None
    if workdir is None:
        own = tempfile.TemporaryDirectory(prefix="repro-chaos-")
        workdir = own.name
    try:
        jobs = demo_jobs(rounds=rounds)
        ref = ServingDaemon(os.path.join(workdir, f"ref-{seed}.sqlite"))
        for jid, spec in jobs.items():
            ref.submit(jid, spec)
        ref.run_until_idle()
        ref_results = {jid: ref.store.result(jid) for jid in jobs}
        ref.close()

        fleet = PodFleet(os.path.join(workdir, f"fleet-{seed}.sqlite"),
                         n_pods=n_pods, lease_ttl=lease_ttl,
                         ckpt_every=ckpt_every,
                         chaos=make_schedule(seed, n_pods), seed=seed)
        for jid, spec in jobs.items():
            fleet.submit(jid, spec)
        summary = fleet.run()
        fleet.close()
        store = fleet.open_store()
        try:
            finished_exactly_once(store, jobs)
            for jid in jobs:
                bad = results_equal(store.result(jid), ref_results[jid])
                if bad:
                    raise AssertionError(
                        f"job {jid!r} diverged from the uninterrupted "
                        f"reference: {bad}")
        finally:
            store.close()
        if verbose:
            ev = summary["journal_counts"]
            print(f"seed {seed}: OK — {len(jobs)} jobs exactly-once, "
                  f"bit-identical ({summary['n_pods_spawned']} pods, "
                  f"{ev.get('killed', 0)} killed, "
                  f"{ev.get('requeue', 0)} requeues, "
                  f"{summary['stats']['store_faults']} store faults)")
        return summary
    finally:
        if own is not None:
            own.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Seeded chaos scenario over a pod fleet: kills, "
                    "store faults, clock skew; asserts exactly-once + "
                    "bit-identical results.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pods", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--lease-ttl", type=float, default=0.4)
    ap.add_argument("--ckpt-every", type=int, default=2)
    args = ap.parse_args(argv)
    try:
        run_scenario(args.seed, n_pods=args.pods, rounds=args.rounds,
                     lease_ttl=args.lease_ttl,
                     ckpt_every=args.ckpt_every)
    except AssertionError as e:
        print(f"seed {args.seed}: FAIL — {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
