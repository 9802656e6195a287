"""Fault tolerance & straggler mitigation for 1000+-node operation.

Three mechanisms, all exercised by tests with injected failures:

 1. checkpoint/restart — `ResilientLoop` checkpoints every N steps and
    resumes bit-exactly after a (simulated or real) crash.
 2. straggler mitigation — Kernelet's balanced-ratio idea (Eq. 8) applied
    to heterogeneous *device speeds*: per-host slice shares are re-balanced
    from an EMA of per-slice step latencies, so a slow host gets
    proportionally fewer microbatch slices instead of gating every step.
 3. elastic scaling — on permanent host loss the mesh is rebuilt from
    survivors (checkpoints are mesh-agnostic; DP dimension shrinks).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


class HostFailure(RuntimeError):
    pass


@dataclasses.dataclass
class ResilientLoop:
    """Checkpoint-every-N training wrapper with crash recovery.

    ``store`` is any object with the ``repro.checkpoint.store`` surface
    (``save(dir, step, state)`` / ``latest_step(dir)`` /
    ``restore(dir, template) -> (state, step)``); it defaults to that
    module, resolved lazily so numpy-only callers (the serving daemon's
    job-store-backed adapter, tier-1 CI) never pull in the jax import
    chain just by importing this module."""
    step_fn: Callable            # (state, batch) -> (state, metrics)
    state: object                # pytree (params, opt state, ...)
    loader: object               # .load(step) -> batch
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    store: object = None         # checkpoint backend (None: npz module)

    def _store(self):
        if self.store is None:
            from repro_torch.checkpoint import store as npz_store
            self.store = npz_store
        return self.store

    def run(self, num_steps: int, *, fail_at: Optional[dict] = None,
            start_step: int = 0):
        """fail_at: {step: n_times} injected HostFailures (testing)."""
        fail_at = dict(fail_at or {})
        store = self._store()
        step = start_step
        retries = 0
        while step < num_steps:
            try:
                if fail_at.get(step, 0) > 0:
                    fail_at[step] -= 1
                    raise HostFailure(f"injected failure at step {step}")
                batch = self.loader.load(step)
                self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                retries = 0
                if step % self.ckpt_every == 0 or step == num_steps:
                    store.save(self.ckpt_dir, step, self.state)
            except HostFailure:
                retries += 1
                if retries > self.max_retries:
                    raise
                # restart: reload last checkpoint (or initial state)
                last = store.latest_step(self.ckpt_dir)
                if last is not None:
                    self.state, step = store.restore(self.ckpt_dir,
                                                     self.state)
                else:
                    step = start_step
        return self.state, step


class StragglerBalancer:
    """Kernelet Eq. 8 on device speeds: rebalance slice shares so all hosts
    finish their microbatch slices simultaneously."""

    def __init__(self, n_hosts: int, total_slices: int, ema: float = 0.3):
        self.n = n_hosts
        self.total = total_slices
        self.ema = ema
        self.latency = np.ones(n_hosts)          # per-slice latency EMA
        self.shares = np.full(n_hosts, total_slices // n_hosts)
        self._fix_shares()

    def _fix_shares(self):
        # proportional to speed = 1/latency; keep sum == total, min 1
        speed = 1.0 / self.latency
        raw = speed / speed.sum() * self.total
        shares = np.maximum(np.floor(raw).astype(int), 1)
        # distribute remainder to fastest hosts
        order = np.argsort(-(raw - shares))
        i = 0
        while shares.sum() < self.total:
            shares[order[i % self.n]] += 1
            i += 1
        while shares.sum() > self.total:
            j = order[-1 - (i % self.n)]
            if shares[j] > 1:
                shares[j] -= 1
            i += 1
        self.shares = shares

    def observe(self, host: int, slice_seconds: float):
        self.latency[host] = ((1 - self.ema) * self.latency[host]
                              + self.ema * slice_seconds)

    def rebalance(self):
        self._fix_shares()
        return self.shares.copy()

    def makespan(self) -> float:
        """Predicted step time: slowest host's share x its slice latency."""
        return float(np.max(self.shares * self.latency))


def elastic_mesh_shape(n_alive_hosts: int, devices_per_host: int,
                       model_parallel: int):
    """Largest (data, model) mesh from surviving hosts; DP shrinks, TP is
    preserved (model groups must stay intact)."""
    total = n_alive_hosts * devices_per_host
    if total < model_parallel:
        raise RuntimeError("not enough devices for the model-parallel group")
    data = total // model_parallel
    return (data, model_parallel)
