"""Online profile learning (PR 9): per-kernel throughput-scale estimation.

An unknown kernel enters the system with a *prior* profile — a guess at
its per-block cost (cf. Pai et al., arXiv 1406.6037: predict runtime from
the first thread blocks, then preempt at block granularity). Every charged
phase is also a measurement: the ``_Pending`` ledger records how many
blocks drained and the charge pass knows the pre-overhead execution time,
so the observed throughput ``drained / t_exec`` is exact. The estimator
keeps one multiplicative correction per kernel name,

    predicted_thr_corrected = scale * predicted_thr_model,

refined by an exponentially-weighted update after each observation. A
single scale is the right shape here because co-scheduling profit (Eq. 1)
is invariant under per-kernel IPC scaling — ``c_i/i_i`` cancels the scale
— so learning moves slice sizes, occupancy-balanced splits, min-slice
floors, and the EDF/PWAIT service predictions, never the CP arithmetic
itself.

While a kernel's estimate is unsettled the engine *probes*: phases are
truncated (via the existing arrival/preemption ``cap`` machinery) to a
fraction of their predicted duration, so a wrong prior costs a short
slice, an observation lands, and the pair/slice decision is re-taken
against the refined profile. Probe windows are functions of predicted
durations only — never of arrival timestamps — which is what keeps the
t=0 == backlog bit-identity pin intact for adaptive lanes.

Scales fold into decision-cache identity via ``scales_digest``: the
scheduler prefixes persistent keys with ``est|<digest>|`` (ranked:
``ranked|est|<digest>|``), so a refined profile can never replay a stale
cached decision, and a fresh estimator (no observations yet — empty
effective scales) shares the plain family byte-for-byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Online-adaptation knobs, grouped (PR 10 API consolidation).

    One value object instead of four loose ``adapt_*`` kwargs on
    ``LaneSpec``/``run_policy``: construct with any subset overridden —
    ``AdaptConfig(alpha=0.3)`` — and pass as ``LaneSpec(adapt=cfg)``.
    Frozen so a config can sit inside the (hashable, comparable)
    ``LaneSpec`` identity and be shared across lanes safely. Field
    semantics are exactly ``ProfileEstimator``'s ctor knobs; defaults
    are the historical ones, so ``AdaptConfig() == adapt=True``
    bit-for-bit."""
    alpha: float = 0.5
    reslice_threshold: float = 0.05
    min_confidence: int = 2
    probe_frac: float = 0.25

    def estimator(self, tracked: Iterable[str]) -> "ProfileEstimator":
        return ProfileEstimator(
            tracked, alpha=self.alpha,
            reslice_threshold=self.reslice_threshold,
            min_confidence=self.min_confidence,
            probe_frac=self.probe_frac)


def effective_scales(scales: Optional[Dict[str, float]]
                     ) -> Optional[Dict[str, float]]:
    """Drop the identity entries; ``None`` when nothing deviates from 1.0.

    The scheduler keys decisions on this normal form, so an estimator
    that has learned nothing yet (every scale exactly 1.0) is
    indistinguishable — in both the memo and the persistent store — from
    no estimator at all."""
    if not scales:
        return None
    out = {n: float(s) for n, s in scales.items() if s != 1.0}
    return out or None


def scales_digest(scales: Dict[str, float]) -> str:
    """Deterministic content digest of a non-trivial scale map. ``hex()``
    round-trips the exact float64, so two estimators differing in the
    last ulp get distinct decision-cache families."""
    blob = ",".join(f"{n}={float(s).hex()}" for n, s in sorted(scales.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class ProfileEstimator:
    """EWMA estimator of per-kernel multiplicative throughput scales.

    ``tracked`` names start at scale 1.0 with zero confidence. Each
    ``observe(name, observed_thr, predicted_thr)`` — where
    ``predicted_thr`` already includes the current scale — moves the
    scale toward ``scale * observed/predicted`` with weight ``alpha``
    and bumps the confidence count. A kernel is *settled* once it has
    ``min_confidence`` observations and its last relative step stayed
    within ``reslice_threshold``; until then the engine truncates its
    phases to ``probe_frac`` of their predicted duration so observations
    land early and decisions re-fire on the refined profile.

    Deterministic by construction: observations in the simulator are
    exact (phases drain at the truth table's throughput), so replaying
    the same lane replays the same estimate trajectory bit-for-bit —
    which is what lets ``state_json`` checkpoints round-trip.
    """

    def __init__(self, tracked: Iterable[str], *, alpha: float = 0.5,
                 reslice_threshold: float = 0.05, min_confidence: int = 2,
                 probe_frac: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if reslice_threshold < 0.0:
            raise ValueError("reslice_threshold must be >= 0")
        if min_confidence < 1:
            raise ValueError("min_confidence must be >= 1")
        if not 0.0 < probe_frac <= 1.0:
            raise ValueError("probe_frac must be in (0, 1]")
        self.alpha = float(alpha)
        self.reslice_threshold = float(reslice_threshold)
        self.min_confidence = int(min_confidence)
        self.probe_frac = float(probe_frac)
        self._scale: Dict[str, float] = {n: 1.0 for n in sorted(tracked)}
        self._conf: Dict[str, int] = {n: 0 for n in self._scale}
        # last relative estimate step; inf = never observed (unsettled)
        self._last_rel: Dict[str, float] = {n: float("inf")
                                            for n in self._scale}
        self.n_updates = 0
        # per-name traces, one entry per observation: the scale after the
        # update, and the raw prediction error |obs/pred - 1| before it —
        # the convergence series the adaptation bench asserts on
        self.trace: Dict[str, list] = {n: [] for n in self._scale}
        self.err_trace: Dict[str, list] = {n: [] for n in self._scale}

    # ---- queries ---- #
    def tracks(self, name: str) -> bool:
        return name in self._scale

    def scale(self, name: str) -> float:
        return self._scale.get(name, 1.0)

    def confidence(self, name: str) -> int:
        return self._conf.get(name, 0)

    def settled(self, name: str) -> bool:
        """Untracked kernels are trivially settled (never probed)."""
        if name not in self._scale:
            return True
        return (self._conf[name] >= self.min_confidence
                and self._last_rel[name] <= self.reslice_threshold)

    def scales(self) -> Optional[Dict[str, float]]:
        """Decision-time scale map in the scheduler's normal form (see
        ``effective_scales``): ``None`` until something was learned."""
        return effective_scales(self._scale)

    def digest(self) -> Optional[str]:
        sc = self.scales()
        return None if sc is None else scales_digest(sc)

    def probe_window(self, predicted_t: float) -> float:
        """Cap for a phase whose kernels are not all settled: a fraction
        of the predicted phase duration. Arrival-agnostic on purpose —
        see the module docstring's t=0 == backlog note."""
        return max(float(predicted_t) * self.probe_frac, 1e-9)

    # ---- learning ---- #
    def observe(self, name: str, observed_thr: float,
                predicted_thr: float) -> bool:
        """Fold one phase's observation in; returns True when the
        estimate moved past ``reslice_threshold`` (the engine counts
        these as re-decisions: the next phase's pair/slice choice is
        re-taken against a materially different profile)."""
        if name not in self._scale:
            return False
        if self.settled(name):
            # freeze on settle: the physics behind a run is static, so a
            # settled estimate is calibrated — later observations from a
            # *different* co-execution context (other partner/weights)
            # would otherwise keep nudging the scale and churn decisions
            # for the rest of the run
            return False
        # plain floats in, plain floats stored: observations arrive as
        # numpy scalars from the vectorized charge pass, and estimator
        # state must stay JSON-able (daemon results / checkpoints)
        observed_thr = float(observed_thr)
        predicted_thr = float(predicted_thr)
        if not (observed_thr > 0.0 and predicted_thr > 0.0):
            return False            # empty/zero-length phase: no signal
        s_old = self._scale[name]
        ratio = observed_thr / predicted_thr
        self.err_trace[name].append(abs(ratio - 1.0))
        target = s_old * ratio      # predicted_thr already carries s_old
        s_new = self.alpha * target + (1.0 - self.alpha) * s_old
        rel = abs(s_new - s_old) / max(abs(s_old), 1e-12)
        self._scale[name] = s_new
        self._conf[name] += 1
        self._last_rel[name] = rel
        self.n_updates += 1
        self.trace[name].append(s_new)
        return rel > self.reslice_threshold

    # ---- checkpoint serialization ---- #
    def to_json(self) -> dict:
        return {
            "alpha": self.alpha,
            "reslice_threshold": self.reslice_threshold,
            "min_confidence": self.min_confidence,
            "probe_frac": self.probe_frac,
            "scale": {n: float(s) for n, s in self._scale.items()},
            "conf": {n: int(c) for n, c in self._conf.items()},
            # inf is not JSON: None marks the never-observed state
            "last_rel": {n: (None if r == float("inf") else float(r))
                         for n, r in self._last_rel.items()},
            "n_updates": int(self.n_updates),
            "trace": {n: [float(v) for v in t]
                      for n, t in self.trace.items()},
            "err_trace": {n: [float(v) for v in t]
                          for n, t in self.err_trace.items()},
        }

    @classmethod
    def from_json(cls, raw: dict) -> "ProfileEstimator":
        est = cls(raw["scale"], alpha=raw["alpha"],
                  reslice_threshold=raw["reslice_threshold"],
                  min_confidence=raw["min_confidence"],
                  probe_frac=raw["probe_frac"])
        est._scale = {n: float(s) for n, s in raw["scale"].items()}
        est._conf = {n: int(c) for n, c in raw["conf"].items()}
        est._last_rel = {n: (float("inf") if r is None else float(r))
                         for n, r in raw["last_rel"].items()}
        est.n_updates = int(raw["n_updates"])
        est.trace = {n: [float(v) for v in t]
                     for n, t in raw["trace"].items()}
        est.err_trace = {n: [float(v) for v in t]
                         for n, t in raw["err_trace"].items()}
        return est
