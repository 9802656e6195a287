"""Deterministic synthetic data pipeline.

Generates reproducible token streams (hash-seeded per shard/step) so that
multi-host training is data-parallel-correct without any external dataset.
The ``patches``/``audio`` entries are the modality-frontend stubs required
by the assignment (precomputed patch/frame embeddings).

Also hosts the synthetic *workload* generators for arrival-timed replays
(``poisson_arrivals`` / ``make_timed_workload`` / ``make_skewed_workload``):
pure numpy, so the engine-side consumers (benchmarks, fleet replays) never
import jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

VLM_PATCHES = 256


def poisson_arrivals(rate: float, n: int, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """``n`` arrival timestamps of a homogeneous Poisson process with
    ``rate`` events per simulated cycle (i.i.d. exponential gaps of mean
    1/rate, cumulatively summed from ``start``)."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    if n < 0:
        raise ValueError("n must be >= 0")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate, size=n))


def make_timed_workload(names, instances: int = 1000, lam: float = 1.0,
                        seed: int = 0):
    """Arrival-timed counterpart of ``repro.core.queue.make_workload``:
    each application submits ``instances`` kernels on its own Poisson
    stream at rate ``lam`` (paper §5.1, same RNG consumption order as
    ``make_workload``), and the merged stream is returned as
    ``(order, arrivals)`` — the two parallel lists an arrival-timed
    ``LaneSpec`` takes. ``make_workload(... same args ...)`` returns
    exactly this ``order``."""
    rng = np.random.default_rng(seed)
    events = []
    for n in names:
        t = 0.0
        for _ in range(instances):
            t += rng.exponential(1.0 / lam)
            events.append((t, n))
    events.sort()
    return [n for _, n in events], [t for t, _ in events]


def make_skewed_workload(names, instances: int = 10, gap: float = 1.0,
                         start: float = 0.0):
    """Deterministic periodic stream — the adversarial case for
    arrival-blind fleet dealing: instance i is ``names[i % len(names)]``
    arriving at ``start + i * gap``. Round-robin dealing maps instance i
    to GPU ``i % n_gpus``, so whenever ``len(names)`` and ``n_gpus``
    share a factor every occurrence of a heavy kernel lands on the same
    GPU (counts balanced, work maximally skewed); least-predicted-backlog
    dealing spreads the heavy kernels instead. Returns ``(order,
    arrivals)`` like ``make_timed_workload``."""
    if instances < 0:
        raise ValueError("instances must be >= 0")
    if not names and instances > 0:
        # fail loudly instead of the modulo-by-zero a caller would get:
        # an empty stream is requested with instances=0, never with no
        # kernel names (fleet benches build these streams from config)
        raise ValueError("names must be non-empty when instances > 0")
    order = [names[i % len(names)] for i in range(instances * len(names))]
    arrivals = [start + i * float(gap) for i in range(len(order))]
    return order, arrivals


def make_drifting_workload(profiles, instances: int = 10, lam: float = 1.0,
                           seed: int = 0, drift: float = 0.5,
                           jitter: float = 0.0):
    """Arrival stream of *unknown* kernels: the online-adaptation case.

    Every kernel's prior profile misestimates its per-block cost by a
    deterministic multiplicative drift — alternating direction by name
    order (kernel 0 believed ``(1+drift)``x cheaper per block than it
    is, kernel 1 ``(1+drift)``x dearer, ...), which maximally scrambles
    the *relative* speeds the slice balancing and the EDF/PWAIT service
    predictions depend on. ``jitter`` adds a seeded uniform factor in
    ``[1-jitter, 1+jitter]`` on top. Returns ``(order, arrivals,
    priors)``: the Poisson stream of ``make_timed_workload`` plus the
    prior ``KernelProfile`` map a ``LaneSpec(priors=...)`` (or daemon
    job spec ``"priors"``) takes — an adaptive lane must learn back the
    per-kernel throughput scale the drift took away."""
    if drift < 0.0:
        raise ValueError("drift must be >= 0")
    if not 0.0 <= jitter < 1.0:
        raise ValueError("jitter must be in [0, 1)")
    names = sorted(profiles)
    order, arrivals = make_timed_workload(names, instances=instances,
                                          lam=lam, seed=seed)
    rng = np.random.default_rng(seed + 1)
    priors = {}
    for i, n in enumerate(names):
        # prior *underestimates* cost for even names (believed faster
        # than real), overestimates for odd — the estimator's learned
        # scale converges near 1/f
        f = (1.0 / (1.0 + drift)) if i % 2 == 0 else (1.0 + drift)
        if jitter:
            f *= rng.uniform(1.0 - jitter, 1.0 + jitter)
        p = profiles[n]
        priors[n] = dataclasses.replace(
            p, insns_per_block=p.insns_per_block * f)
    return order, arrivals, priors


def batch_keys(cfg) -> tuple:
    keys = ("tokens", "labels")
    if cfg.frontend == "vision_stub":
        keys += ("patches",)
    if cfg.frontend == "audio_stub":
        keys += ("audio",)
    return keys


def make_batch(cfg, batch: int, seq: int, seed: int = 0, step: int = 0):
    """Training batch: dict of np arrays (host-side; shard before device put)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision_stub":
        npatch = min(VLM_PATCHES, seq // 2)
        out["patches"] = rng.standard_normal(
            (batch, npatch, cfg.d_model), dtype=np.float32) * 0.02
        out["labels"][:, :npatch] = -1
    if cfg.frontend == "audio_stub":
        out["audio"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32) * 0.02
    return out


@dataclasses.dataclass
class SyntheticLoader:
    """Sharded, prefetching loader. Each host materializes only its shard."""
    cfg: object
    global_batch: int
    seq: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count

    def __iter__(self):
        step = 0
        while True:
            yield self.load(step)
            step += 1

    def load(self, step: int):
        full = make_batch(self.cfg, self.global_batch, self.seq,
                          self.seed, step)
        lo = self.host_index * self.local_batch
        return {k: v[lo:lo + self.local_batch] for k, v in full.items()}
