"""Kernelet scheduling (paper §4.2-4.3): greedy co-scheduling with PUR/MUR
pruning, plus the BASE / OPT / MC comparison policies of §5.

Decision path (Kernelet): Markov-model cIPC -> CP (Eq. 1) -> best pair +
occupancy split; slice sizes from the balanced ratio (Eq. 8) subject to the
2% overhead minimum (§4.1). Execution is charged against the *simulator*
IPC table (the hardware stand-in), so a wrong model decision costs real
simulated time — exactly the paper's prediction/measurement separation.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.core import ipc_cache, slicing
from repro_torch.core.markov import (MARKOV_SCHEMA, MarkovModel,
                               balanced_slice_sizes, co_scheduling_profit)
from repro_torch.core.online import effective_scales, scales_digest
from repro_torch.core.profiles import GPUSpec, KernelProfile, content_digest
from repro_torch.core.simulator import IPCTable

# ---- persistent decision cache ---- #
# ``find_coschedule`` is a pure function of (gpu, profiles, active set,
# alphas, overhead budget, decision mode), so decisions are content-
# addressable exactly like IPC measurements and Markov solves: persisting
# them lets a cold process skip the candidate search entirely.
ENV_DECISION_CACHE = "REPRO_DECISION_CACHE"

# bump when the search logic changes in a way that alters decisions
DECISION_SCHEMA = 1

# the store's effective version folds in the physics layers decisions are
# derived from (Markov solves in model mode, simulator measurements in
# oracle mode), so a physics bump can never serve a stale decision — same
# pattern as calibrate.CALIB_STORE_SCHEMA; ipc_cache.live_schemas() reads
# this for GC. One composed version for both modes keeps GC to a single
# live generation per family (a Markov bump over-invalidates oracle files,
# which only costs a re-search).
DECISION_STORE_SCHEMA = (DECISION_SCHEMA * 1_000_000
                         + MARKOV_SCHEMA * 1000 + ipc_cache._SCHEMA)


def decision_cache_enabled() -> bool:
    """Persistent decision caching toggle: on by default, disabled by
    ``REPRO_DECISION_CACHE=0|off|none`` (storage shares the artifact-cache
    directory, so ``REPRO_TORCH_IPC_CACHE=0`` disables it too)."""
    raw = os.environ.get(ENV_DECISION_CACHE, "1")
    return raw.strip().lower() not in ("", "0", "off", "none", "disable")


@functools.lru_cache(maxsize=64)
def _decision_store_at(tag: str, dirname: str,
                       backend: str) -> ipc_cache.ArtifactStore:
    return ipc_cache.open_store(
        f"decisions_{tag}", ("coschedule",), schema=DECISION_STORE_SCHEMA,
        dirname=dirname, backend=backend)


@dataclasses.dataclass
class CoSchedule:
    k1: str
    k2: Optional[str]
    w1: int
    w2: int
    s1: int                  # slice sizes (blocks)
    s2: int
    cp: float                # predicted co-scheduling profit
    cipc1: float
    cipc2: float

    @staticmethod
    def _num(x):
        """JSON-safe number that round-trips the exact value: slice sizes
        are ints everywhere today, but a float must survive as a float (a
        truncating int() here would break the replayed-decision
        bit-identity contract)."""
        xi = int(x)
        return xi if xi == x else float(x)

    def to_json(self) -> dict:
        return {"k1": self.k1, "k2": self.k2,
                "w1": self._num(self.w1), "w2": self._num(self.w2),
                "s1": self._num(self.s1), "s2": self._num(self.s2),
                "cp": float(self.cp), "cipc1": float(self.cipc1),
                "cipc2": float(self.cipc2)}

    @classmethod
    def from_json(cls, raw: dict) -> "CoSchedule":
        return cls(raw["k1"], raw["k2"], raw["w1"], raw["w2"],
                   raw["s1"], raw["s2"], float(raw["cp"]),
                   float(raw["cipc1"]), float(raw["cipc2"]))


class KerneletScheduler:
    """FindCoSchedule (Alg. 1) with pruning and the Eq. 8 balanced ratio."""

    def __init__(self, gpu: GPUSpec, profiles: Dict[str, KernelProfile],
                 *, alpha_p: float = 0.4, alpha_m: float = 0.1,
                 three_state: bool = True,
                 decision_table: Optional[IPCTable] = None,
                 p_overhead: float = 2.0, cp_margin: float = None):
        self.gpu = gpu
        self.vgpu = gpu.virtual()
        self.profiles = profiles
        self.alpha_p = alpha_p
        self.alpha_m = alpha_m
        self.model = MarkovModel(self.vgpu, three_state=three_state)
        # decision_table != None -> oracle mode (OPT): decide on measured IPCs
        self.decision_table = decision_table
        self.p_overhead = p_overhead
        # minimum predicted CP to justify a co-schedule: slices run within
        # the p% overhead budget (§4.1), so profits below that budget are
        # not worth chasing
        self.cp_margin = (p_overhead / 100.0
                          if cp_margin is None else cp_margin)
        self._solo_cache: Dict = {}
        self._pair_cache: Dict = {}
        self._pairw_cache: Dict = {}
        self._minslice_cache: Dict = {}
        # memoized decisions keyed on the frozen active set: successive
        # run_policy / drain iterations with an unchanged pending set skip
        # the search entirely (profiles are fixed for a scheduler's lifetime,
        # so the active set fully determines the decision)
        self._decision_cache: Dict = {}
        # persistent-store identity: decisions depend on the GPU, the model
        # variant (or, in oracle mode, the measurement table's identity) and
        # the search parameters; the per-entry key carries the active set's
        # profile contents
        if decision_table is not None:
            mode = (f"oracle_{content_digest(decision_table.gpu)}"
                    f"_s{decision_table.seed}_r{decision_table.rounds}")
        else:
            mode = "model3s" if three_state else "model2s"
        self._store_tag = f"{content_digest(gpu)}_{mode}"
        self._param_key = (f"ap{self.alpha_p!r}_am{self.alpha_m!r}"
                           f"_po{self.p_overhead!r}_cm{self.cp_margin!r}")

    # ---- persistent decision-store plumbing ---- #
    def _decision_store(self) -> Optional[ipc_cache.ArtifactStore]:
        """Resolved per call so env changes (tests, tooling) take effect."""
        if not decision_cache_enabled():
            return None
        base = ipc_cache.cache_dir()
        if base is None:
            return None
        return _decision_store_at(self._store_tag, base,
                                  ipc_cache.store_backend())

    def _decision_skey(self, names) -> str:
        profs = "|".join(f"{n}:{content_digest(self.profiles[n])}"
                         for n in names)
        return f"{profs}|{self._param_key}"

    @staticmethod
    def _scale_fn(scales):
        """name -> multiplicative IPC scale (identity when no estimates).
        Scaling is applied to decision-side IPCs only — solo and pair
        cIPCs — after the (scale-independent, memoized) Markov solves, so
        a re-decision under refined estimates costs arithmetic, never a
        new solve."""
        if scales is None:
            return lambda n: 1.0
        return lambda n: scales.get(n, 1.0)

    # ---- decision-side IPCs (model, or table for OPT) ---- #
    def solo_ipc(self, name: str, w: Optional[int] = None) -> float:
        prof = self.profiles[name]
        w = w if w is not None else prof.active_units(self.vgpu)
        key = (name, w)
        if key not in self._solo_cache:
            if self.decision_table is not None:
                v = self.decision_table.solo(prof, w)
            else:
                v = self.model.single_ipc(prof, w)
            self._solo_cache[key] = v
        return self._solo_cache[key]

    def pair_ipc(self, n1: str, w1: int, n2: str, w2: int):
        key = (n1, w1, n2, w2)
        if key not in self._pair_cache:
            self._eval_pairs([key])
        return self._pair_cache[key]

    def _eval_pairs(self, keys) -> None:
        """Evaluate a batch of (n1, w1, n2, w2) candidates into the pair
        cache. In oracle mode the whole batch is measured in one
        ``simulate_many`` sweep via ``IPCTable.pair_many``; in model mode
        the (cheap, memoized) Markov solves run per candidate."""
        missing = [k for k in keys if k not in self._pair_cache]
        if not missing:
            return
        configs = [(self.profiles[n1], w1, self.profiles[n2], w2)
                   for n1, w1, n2, w2 in missing]
        if self.decision_table is not None:
            vals = self.decision_table.pair_many(configs)
        else:
            vals = self.model.pair_ipc_many(configs)
        self._pair_cache.update(zip(missing, vals))

    def _pair_power(self, n1: str, w1: int, n2: str, w2: int) -> float:
        """Decision-side draw of a pair config (watts, one virtual SM):
        the measured value in oracle mode (cached next to the IPCs the
        batch sweep already produced), the Markov-predicted one in model
        mode. Used only by the power-cap gate in ``_search``."""
        key = (n1, w1, n2, w2)
        if key not in self._pairw_cache:
            p1, p2 = self.profiles[n1], self.profiles[n2]
            if self.decision_table is not None:
                v = self.decision_table.pair_watts(p1, w1, p2, w2)
            else:
                v = self.model.pair_power(p1, w1, p2, w2)
            self._pairw_cache[key] = v
        return self._pairw_cache[key]

    def min_slice(self, name: str, scale: float = 1.0) -> int:
        # scale != 1.0 (online estimates) keys separately: a faster
        # believed kernel amortizes its launch overhead over fewer
        # blocks, so the 2%-budget floor genuinely moves with the scale
        key = name if scale == 1.0 else (name, scale)
        if key not in self._minslice_cache:
            prof = self.profiles[name]
            self._minslice_cache[key] = slicing.min_slice_size(
                prof, self.gpu, self.solo_ipc(name) * scale,
                self.p_overhead)
        return self._minslice_cache[key]

    # ---- pruning (§4.3) ---- #
    def prune(self, pairs):
        """Keep pairs complementary in PUR or MUR: prune when BOTH
        |ΔPUR| < α_p and |ΔMUR| < α_m (Table 6 semantics)."""
        kept = []
        for a, b in pairs:
            pa, pb = self.profiles[a], self.profiles[b]
            if abs(pa.pur - pb.pur) < self.alpha_p and \
               abs(pa.mur - pb.mur) < self.alpha_m:
                continue
            kept.append((a, b))
        return kept

    def pruned_count(self, names) -> int:
        pairs = list(itertools.combinations(sorted(names), 2))
        return len(pairs) - len(self.prune(pairs))

    def _prefetch_solo(self, names) -> None:
        """Batch decision-side solo IPCs for every name not yet cached (one
        simulate_many sweep in oracle mode)."""
        todo = []
        for n in names:
            w = self.profiles[n].active_units(self.vgpu)
            if (n, w) not in self._solo_cache:
                todo.append((n, w))
        if not todo:
            return
        if self.decision_table is not None:
            vals = self.decision_table.solo_many(
                [(self.profiles[n], w) for n, w in todo])
            self._solo_cache.update(zip(todo, vals))
        else:
            for n, _ in todo:
                self.solo_ipc(n)

    # ---- FindCoSchedule ---- #
    def find_coschedule(self, pending, *, scales=None,
                        power_cap=None) -> Optional[CoSchedule]:
        """pending: iterable of kernel names with blocks remaining.

        Decisions are memoized on the active *set*: profiles are fixed, so
        the pending names fully determine the result, and drain loops that
        call this every iteration pay for the search only when the set
        changes.

        ``scales`` (online profile estimates: name -> multiplicative IPC
        scale) folds into both cache keys — memo entries carry the scale
        map, persistent keys take an ``est|<digest>|`` prefix — so a
        refined estimate can never replay a decision taken under a stale
        one, and scale-free callers keep their exact historical keys
        (an all-1.0 map normalizes to scale-free).

        ``power_cap`` (watts, whole GPU) gates the *co-scheduling*
        candidates: a pair whose decision-side draw exceeds the cap is
        skipped, and when nothing fits the head kernel runs solo (solo
        execution is never gated — the cap trades co-scheduling
        throughput for power, it does not deny service). A finite cap
        folds into both cache keys (``pcap|<cap>|`` persistent prefix);
        ``None``/non-finite caps keep the exact historical keys."""
        names = sorted(set(pending))
        if not names:
            return None
        if power_cap is not None and not np.isfinite(power_cap):
            power_cap = None
        scales = effective_scales(scales)
        dg = None if scales is None else scales_digest(scales)
        key = (frozenset(names) if dg is None
               else (frozenset(names), dg))
        if power_cap is not None:
            key = ("pcap", power_cap, key)
        hit = self._decision_cache.get(key)
        if hit is None:
            store = self._decision_store()
            skey = self._decision_skey(names) if store is not None else None
            if skey is not None and dg is not None:
                skey = f"est|{dg}|{skey}"
            if skey is not None and power_cap is not None:
                skey = f"pcap|{power_cap!r}|{skey}"
            if store is not None:
                raw = store.get("coschedule", skey)
                if raw is not None:
                    hit = CoSchedule.from_json(raw)
            if hit is None:
                hit = self._search(names, scales=scales,
                                   power_cap=power_cap)
                # persist any fresh Markov solves this search produced: the
                # module-level solve cache already dedupes across the
                # per-run_policy scheduler instances, the store dedupes
                # across processes (no-op when nothing new was solved)
                self.model.flush()
                if store is not None:
                    # save eagerly: direct callers (serving dispatch, the
                    # latency bench) have no end-of-run flush hook, and a
                    # process sees only a handful of distinct active sets.
                    # If that ever stops holding, batch like model.flush()
                    # (ROADMAP: decision-store sharding / batched saves).
                    store.put("coschedule", skey, hit.to_json())
                    store.save()
            self._decision_cache[key] = hit
        return hit

    # ---- urgency-ranked FindCoSchedule (arrival-aware policies) ---- #
    def find_coschedule_ranked(self, ranked, *,
                               scales=None) -> Optional[CoSchedule]:
        """Deadline/wait-aware variant of ``find_coschedule``: ``ranked``
        is the active set ordered by urgency, head first (EDF slack, or
        predicted wait — computed by the caller). The head kernel is
        always served this phase; the partner and occupancy split are
        chosen by max CP among head-containing candidates, with ties
        resolved toward the more urgent partner. Falls back to the head
        solo (sliced) when no pair clears ``cp_margin``.

        Decisions are memoized — and persisted — on the full *ordered*
        tuple, so the deadline/wait inputs that produced the ranking fold
        into both cache keys: a replay with different deadlines can never
        be served a stale decision (the ``ranked|`` prefix also keeps
        these entries disjoint from the unordered ``find_coschedule``
        family). ``scales`` compounds exactly like in ``find_coschedule``
        (``ranked|est|<digest>|`` persistent prefix)."""
        ranked = tuple(ranked)
        if not ranked:
            return None
        scales = effective_scales(scales)
        dg = None if scales is None else scales_digest(scales)
        key = (("ranked", ranked) if dg is None
               else ("ranked", ranked, dg))
        hit = self._decision_cache.get(key)
        if hit is None:
            store = self._decision_store()
            skey = (f"ranked|{self._decision_skey(ranked)}"
                    if store is not None else None)
            if skey is not None and dg is not None:
                skey = f"ranked|est|{dg}|{self._decision_skey(ranked)}"
            if store is not None:
                raw = store.get("coschedule", skey)
                if raw is not None:
                    hit = CoSchedule.from_json(raw)
            if hit is None:
                hit = self._search_ranked(ranked, scales=scales)
                self.model.flush()
                if store is not None:
                    store.put("coschedule", skey, hit.to_json())
                    store.save()
            self._decision_cache[key] = hit
        return hit

    def _solo_schedule(self, name: str, scales=None) -> CoSchedule:
        sc = self._scale_fn(scales)
        w = self.profiles[name].active_units(self.vgpu)
        return CoSchedule(name, None, w, 0,
                          self.min_slice(name, sc(name)), 0, 0.0,
                          self.solo_ipc(name) * sc(name), 0.0)

    def _search_ranked(self, ranked, scales=None) -> CoSchedule:
        sc = self._scale_fn(scales)
        head = ranked[0]
        if len(ranked) == 1:
            return self._solo_schedule(head, scales)
        W = self.vgpu.units_per_sm
        wh_max = self.profiles[head].active_units(self.vgpu)
        # candidates in urgency order: strict `>` selection below keeps the
        # first (most urgent) partner on CP ties. No PUR/MUR prune — the
        # head pin already cuts the space to (n-1)*(W-1) candidates, and
        # urgency must not lose a profitable pair to a complementarity
        # heuristic.
        cand = []
        for b in ranked[1:]:
            wb_max = self.profiles[b].active_units(self.vgpu)
            for wh in range(1, W):
                wb = min(W - wh, wb_max)
                if wh > wh_max or wb < 1:
                    continue
                cand.append((head, wh, b, wb))
        self._prefetch_solo(ranked)
        self._eval_pairs(cand)
        best, best_cp = None, -np.inf
        for h, wh, b, wb in cand:
            ih = self.solo_ipc(h) * sc(h)
            ib = self.solo_ipc(b) * sc(b)
            c1, c2 = self._pair_cache[(h, wh, b, wb)]
            c1, c2 = c1 * sc(h), c2 * sc(b)
            cp = co_scheduling_profit((ih, ib), (c1, c2))
            if cp > best_cp:
                s1, s2 = balanced_slice_sizes(
                    self.profiles[h], c1, self.profiles[b], c2,
                    self.min_slice(h, sc(h)), self.min_slice(b, sc(b)),
                    self.gpu.n_sm, w1=wh, w2=wb)
                best = CoSchedule(h, b, wh, wb, s1, s2, cp, c1, c2)
                best_cp = cp
        if best is None or best.cp <= self.cp_margin:
            return self._solo_schedule(head, scales)
        return best

    def _search(self, names, scales=None, power_cap=None) -> CoSchedule:
        sc = self._scale_fn(scales)
        if len(names) == 1:
            n = names[0]
            w = self.profiles[n].active_units(self.vgpu)
            ipc = self.solo_ipc(n) * sc(n)
            return CoSchedule(n, None, w, 0, self.min_slice(n, sc(n)), 0,
                              0.0, ipc, 0.0)
        pairs = list(itertools.combinations(names, 2))
        kept = self.prune(pairs)
        alpha_p, alpha_m = self.alpha_p, self.alpha_m
        while not kept:                       # paper: relax thresholds
            alpha_p *= 0.5
            alpha_m *= 0.5
            kept = [
                (a, b) for a, b in pairs
                if abs(self.profiles[a].pur - self.profiles[b].pur)
                >= alpha_p
                or abs(self.profiles[a].mur - self.profiles[b].mur)
                >= alpha_m]
            if alpha_p < 1e-4:
                kept = pairs
        W = self.vgpu.units_per_sm
        # enumerate every candidate (pair, split) first, then evaluate the
        # whole batch in one call (a single measurement sweep in oracle
        # mode) before the cheap arithmetic selection pass
        cand = []
        for a, b in kept:
            wa_max = self.profiles[a].active_units(self.vgpu)
            wb_max = self.profiles[b].active_units(self.vgpu)
            for wa in range(1, W):
                wb = min(W - wa, wb_max)
                if wa > wa_max or wb < 1:
                    continue
                cand.append((a, wa, b, wb))
        self._prefetch_solo(names)
        self._eval_pairs(cand)
        if power_cap is not None:
            # gate after the batch IPC sweep: oracle-mode watts are already
            # cached from the same simulate_many runs, so this pass is pure
            # lookups. Filtering the candidate list (rather than special-
            # casing the selection loop) keeps the head-solo fallback below
            # as the natural "nothing fits under the cap" outcome.
            cand = [c for c in cand
                    if self._pair_power(*c) * self.gpu.n_sm <= power_cap]
        best, best_cp = None, -np.inf
        for a, wa, b, wb in cand:
            ia = self.solo_ipc(a) * sc(a)
            ib = self.solo_ipc(b) * sc(b)
            c1, c2 = self._pair_cache[(a, wa, b, wb)]
            c1, c2 = c1 * sc(a), c2 * sc(b)
            cp = co_scheduling_profit((ia, ib), (c1, c2))
            if cp > best_cp:
                s1, s2 = balanced_slice_sizes(
                    self.profiles[a], c1, self.profiles[b], c2,
                    self.min_slice(a, sc(a)), self.min_slice(b, sc(b)),
                    self.gpu.n_sm, w1=wa, w2=wb)
                best = CoSchedule(a, b, wa, wb, s1, s2, cp, c1, c2)
                best_cp = cp
        if best is None or best.cp <= self.cp_margin:
            # no pair predicted profitable -> run the head kernel solo
            n = names[0]
            w = self.profiles[n].active_units(self.vgpu)
            return CoSchedule(n, None, w, 0, self.min_slice(n, sc(n)), 0,
                              0.0, self.solo_ipc(n) * sc(n), 0.0)
        return best
