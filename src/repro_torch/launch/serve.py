"""Multi-tenant shared-pod serving — Kernelet as a first-class feature.

PyTorch counterpart of ``repro/launch/serve.py``. Tenants submit jobs
(arch x phase); each job's step is sliced into microbatch slices (the
thread-block analogue). Every job gets a two-resource profile (PUR/MUR)
from the analytic cost of its full configuration; the KerneletScheduler
picks the complementary pair with the largest predicted CP and the balanced
slice ratio (Eq. 8), and the dispatcher interleaves their slices.

On the card each round issues the pair's slices on two CUDA streams, one
per job, and synchronises at the end of the round: the two jobs' kernels
share the SMs, which is the paper's concurrent kernel execution. On the
CPU the slices run in order. A decode tenant's step is the same kernels
on the same buffers at every call, so on the card ``submit`` captures it
once into a CUDA graph and every slice replays the graph: one launch where
the eager step makes thousands.

The hardware model is the caller's: ``gpu_spec`` and ``profile_fn``
default to ``TPU_V5E`` and ``tpu_profile_from_costs``, exactly as in the
reference, so the ``rounds`` list equals the reference server's; the card's
own model is ``gpu_spec=H100, profile_fn=h100_profile_from_costs`` (what
``demo()`` and ``chip_smoke.py`` pass). A job's slice is one step of its
model, which covers every SM once, so its profile has ``num_slices x n_sm``
blocks: the engine's plan, the scheduler's s1:s2 (multiples of ``n_sm``) and
the drain's rounds (``s / n_sm`` slices) then count the same thing.

Spans (``repro_torch.spans``) name the work of a drain in a profiler's
trace: ``serve.drain`` around the whole call, ``serve.plan`` (the engine's
plan), ``serve.decide`` (each ``find_coschedule``), ``serve.round``, one
``serve.step.<phase>`` a slice, ``serve.sync`` (the round's synchronize),
and inside a step ``serve.replay`` around a captured step's replay, or
the model's ``model.embed``, ``model.views``, ``model.mixer``,
``model.ffn`` and ``model.head``. They exist only while a
profiler records: run drains under ``torch.profiler.profile`` (with
``ProfilerActivity.CUDA`` on the card), call ``export_chrome_trace`` and
read the ``serve.*`` and ``model.*`` names, each kernel tied to the span
that launched it by its ``correlation`` id.

  PYTHONPATH=src python -m repro_torch.launch.serve --demo
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.costs import cell_cost
from repro_torch.core.engine import LaneSpec, WorkloadEngine, run_fleet
from repro_torch.core.profiles import (H100, TPU_V5E, GPUSpec, KernelProfile,
                                       h100_profile_from_costs,
                                       tpu_profile_from_costs)
from repro_torch.core.simulator import IPCTable
from repro_torch.data.synthetic import make_batch, poisson_arrivals
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.runtime.daemon import DrainLease

# the scheduler's smoothing and CP margin, the drain's and every plan's
SCHED_ARGS = {"alpha_p": 0.2, "alpha_m": 0.2, "cp_margin": 0.0}
PLAN_POLICY = "KERNELET"
PLAN_ROUNDS = 1500          # simulated rounds of the plans' IPC table
PLAN_SEED = 0               # of the plans' Poisson arrivals
MAX_ROUNDS = 10000          # a drain longer than this did not drain
DRAIN_JOB = "serve-drain"   # the drain's job under a daemon


@dataclasses.dataclass
class Job:
    name: str
    arch: str
    phase: str                  # "prefill" | "decode" | "train"
    num_slices: int             # microbatch slices pending
    batch_per_slice: int = 2
    seq: int = 64


def job_profile(job: Job, spec: GPUSpec,
                profile_fn=tpu_profile_from_costs) -> KernelProfile:
    """A tenant's profile for the scheduler on ``spec``. It is taken at FULL
    scale: the tenant's real job is the full config, whose analytic
    FLOPs/bytes give the PUR/MUR the scheduler reasons about (reduced-config
    costs would all look memory-bound). One slice is ``spec.n_sm`` blocks,
    one a SM."""
    shape = SHAPES[{"prefill": "prefill_32k", "decode": "decode_32k",
                    "train": "train_4k"}[job.phase]]
    cost = cell_cost(get_config(job.arch), shape)
    blocks = job.num_slices * spec.n_sm
    prof = profile_fn(job.name, cost["flops"], cost["hbm_bytes"],
                      num_blocks=blocks)
    return dataclasses.replace(prof, insns_per_block=1000.0,
                               num_blocks=blocks)


class SharedPodServer:
    """Kernelet executor over a queue of tenant jobs."""

    def __init__(self, *, gpu_spec=TPU_V5E,
                 profile_fn=tpu_profile_from_costs, seed: int = 0,
                 use_reduced: bool = True, device=None):
        self.spec = gpu_spec
        self.profile_fn = profile_fn
        self.jobs: Dict[str, Job] = {}
        self.profiles: Dict[str, KernelProfile] = {}
        self._exec: Dict[str, Callable] = {}
        self.seed = seed
        self.use_reduced = use_reduced
        self.device = resolve_device(device)
        self.log: List[tuple] = []
        self._plan_truth: Optional[IPCTable] = None
        self._streams: Dict[str, torch.cuda.Stream] = {}
        # a decode tenant's capture on the card: None, or why it failed
        self.captures: Dict[str, Optional[str]] = {}

    # ---- job admission: build, warm up, profile, register ---- #
    def submit(self, job: Job, params=None, cfg=None):
        """Build the job's step and run it once (which also builds and
        loads the kernels on first use). ``params`` defaults to fresh
        weights from the server's seed, the same for every job as in the
        reference. ``cfg`` is the config the step runs, by default the
        arch's reduced or full one (``use_reduced``): a depth-cut config
        lets a model too large for the card run at full width. The
        scheduler's profile is the full arch's whatever ``cfg`` is. On the
        card a decode tenant's step, whose batch, token and position are
        fixed here, then runs as one CUDA graph (``_replayed``)."""
        if cfg is None:
            full_cfg = get_config(job.arch)
            cfg = reduced(full_cfg) if self.use_reduced else full_cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = T.init_params(cfg, gen, device=self.device)
        raw = make_batch(cfg, job.batch_per_slice, job.seq)
        if job.phase == "decode":
            # tokens only, as the reference's: a cross cache stays unfilled
            caches = T.init_decode_caches(cfg, job.batch_per_slice, job.seq,
                                          device=self.device)
            tok = torch.as_tensor(raw["tokens"][:, 0], device=self.device)

            def run(params=params, cfg=cfg, caches=caches, tok=tok):
                logits, _ = T.decode_step(params, cfg, caches, tok,
                                          job.seq // 2)
                return logits
        else:
            # every key but the labels: the frontend stubs (patches, audio)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in raw.items() if k != "labels"}

            def run(params=params, cfg=cfg, batch=batch):
                logits, _, _ = T.forward(params, cfg, batch)
                return logits
        if job.phase == "decode" and self.device.type == "cuda":
            run = self._replayed(job.name, run, params, caches, tok)
        else:
            run()                           # warm-up: builds the kernels
        self._sync()
        prof = job_profile(job, self.spec, self.profile_fn)
        self.jobs[job.name] = job
        self.profiles[job.name] = prof
        self._exec[job.name] = run
        self.log.append(("submit", job.name, prof.pur, prof.mur, prof.rm))

    def _replayed(self, name: str, step: Callable, params, caches, tok):
        """A decode tenant's ``step`` as a CUDA graph replay. The step runs
        once on a side stream (the warm-up, which also loads its kernels and
        cuBLAS handles) and is then captured there; a capture launches
        nothing, so the caches stay one step on and ``ops.LAUNCHES`` is put
        back to what it was before it. The graph reads ``params``, ``tok``
        and ``caches`` where they lie and writes the caches in place, its
        activations in a memory pool of its own; each call replays it on the
        caller's stream, adds to ``ops.LAUNCHES`` the launches its capture
        counted, and returns a copy of its logits, which the next replay
        overwrites. A step that cannot be captured (one that waits on the
        host) stays eager; ``captures[name]`` is None or its error."""
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            step()
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        rng = torch.cuda.default_generators[side.device.index]
        rng_state = rng.clone_state()
        try:
            with torch.cuda.graph(graph, stream=side):
                logits = step()
        except RuntimeError as e:
            # a failed capture leaves its stream current and the card's
            # generator in capture mode: put both back
            torch.cuda.set_stream(caller)
            rng.graphsafe_set_state(rng_state)
            cause = e.__context__ or e
            first = str(cause).split("\n", 1)[0]
            self.captures[name] = f"{type(cause).__name__}: {first}"
            return step
        finally:
            counted = {k: n - before[k] for k, n in ops.LAUNCHES.items()
                       if n != before[k]}
            ops.LAUNCHES.update(before)
        self.captures[name] = None

        def replay(graph=graph, logits=logits, params=params, caches=caches,
                   tok=tok):
            with spans.span(spans.REPLAY):
                graph.replay()
            for k, n in counted.items():
                ops.LAUNCHES[k] += n
            with torch.inference_mode():
                return logits.clone()
        return replay

    def capture_report(self) -> str:
        """One line: the decode tenants whose step runs as one CUDA graph,
        and those whose capture failed, with why."""
        done = [f"{n} ({self.jobs[n].arch})"
                for n, err in self.captures.items() if err is None]
        failed = [f"{n} ({self.jobs[n].arch}): {err}"
                  for n, err in self.captures.items() if err is not None]
        return ("decode steps as one CUDA graph: " + (", ".join(done) or
                "none") + "; eager, the capture failed: " +
                ("; ".join(failed) or "none"))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- engine-backed planning ---- #
    def _pending(self) -> Dict[str, int]:
        """The jobs with slices left, in submission order: their slices."""
        return {n: j.num_slices for n, j in self.jobs.items()
                if j.num_slices > 0}

    def _truth(self) -> IPCTable:
        """One measurement table for the server's lifetime: entries are
        keyed by profile content, so repeated plans re-simulate nothing."""
        if self._plan_truth is None:
            self._plan_truth = IPCTable(self.spec.virtual(),
                                        rounds=PLAN_ROUNDS, persist=False)
        return self._plan_truth

    def plan(self, engine: WorkloadEngine) -> dict:
        """Simulated drain of the pending jobs as one engine replay lane:
        predicts the fleet-style makespan and — because the lane shares the
        engine's scheduler for this (spec, profiles, alphas) identity —
        pre-warms every drain decision the dispatcher is about to make."""
        order = list(self._pending())
        if not order:
            return {"predicted_makespan_cycles": 0.0, "time_line": [],
                    "n_coschedules": 0}
        lane = LaneSpec(PLAN_POLICY, self.profiles, order, self.spec,
                        self._truth(), **SCHED_ARGS)
        res = engine.run([lane])[0]
        return {"predicted_makespan_cycles": float(res.total_cycles),
                "time_line": res.time_line,
                "n_coschedules": res.n_coschedules}

    def plan_arrivals(self, engine: WorkloadEngine, rate: float, *,
                      slo_deadline: Optional[float] = None) -> dict:
        """Arrival-timed drain plan: jobs land on a Poisson stream at
        ``rate`` (events per simulated cycle) and the engine lane admits,
        truncates and fast-forwards accordingly — predicting per-job queue
        wait, tail latency, and SLO attainment at ``slo_deadline`` in
        addition to the makespan. Like ``plan``, the replay warms the
        shared decision cache for the real dispatcher. Another policy or
        arrival seed is a ``LaneSpec`` of its own through ``engine.run``."""
        order = list(self._pending())
        if not order:
            return {"predicted_makespan_cycles": 0.0, "time_line": [],
                    "n_coschedules": 0, "latency": {}, "energy": {},
                    "completions": []}
        arrivals = poisson_arrivals(rate, len(order), seed=PLAN_SEED)
        lane = LaneSpec(PLAN_POLICY, self.profiles, order, self.spec,
                        self._truth(), **SCHED_ARGS,
                        arrivals=list(arrivals), slo_deadline=slo_deadline)
        res = engine.run([lane])[0]
        return {"predicted_makespan_cycles": float(res.total_cycles),
                "time_line": res.time_line,
                "n_coschedules": res.n_coschedules,
                "policy": PLAN_POLICY,
                "latency": dict(res.latency_metrics(slo_deadline)),
                "energy": dict(res.energy_metrics()),
                "completions": res.completions}

    def plan_fleet(self, n_pods: int, rate: float) -> dict:
        """Fleet-dealing plan: replays the pending jobs' Poisson stream
        over ``n_pods`` simulated pods of the server's spec through
        ``run_fleet``, dealing by least predicted backlog (``"auto"``).
        Returns the pooled latency prediction plus the per-pod split. A
        mixed-pod fleet, another policy or deal goes to ``run_fleet``
        itself, as ``examples/multi_tenant_serving.py`` does."""
        order = list(self._pending())
        if not order:
            return {"predicted_makespan_cycles": 0.0, "latency": {},
                    "energy": {}, "per_pod": [], "pods": [], "deal": None}
        arrivals = list(poisson_arrivals(rate, len(order), seed=PLAN_SEED))
        fleet = run_fleet(PLAN_POLICY, self.profiles, order, self.spec,
                          self._truth(), n_pods, **SCHED_ARGS,
                          arrivals=arrivals)
        return {"predicted_makespan_cycles": float(fleet.makespan),
                "latency": dict(fleet.latency),
                "energy": dict(fleet.energy),
                "per_pod": [[n for n, _, _ in lane.completions]
                            for lane in fleet.lanes],
                "pods": [s.name for s in fleet.gpus],
                "deal": fleet.deal,
                "policy": PLAN_POLICY}

    # ---- scheduling + interleaved dispatch ---- #
    def _round(self, pairs):
        """Run one round, ``pairs`` = [(job, n_slices), ...], and wait for
        it. On the card every job gets its own CUDA stream and the slices
        are issued interleaved, job by job, as the reference issues them
        asynchronously; on the CPU they run in that order. Every output is
        kept until the round's synchronize."""
        with spans.span(spans.ROUND):
            cuda = self.device.type == "cuda"
            if cuda:
                cur = torch.cuda.current_stream(self.device)
                for name, _ in pairs:
                    if name not in self._streams:
                        self._streams[name] = torch.cuda.Stream(self.device)
                    # submit()'s allocations and the last round come first
                    self._streams[name].wait_stream(cur)
            outs = []
            for i in range(max(n for _, n in pairs)):
                for name, n in pairs:
                    if i >= n:
                        continue
                    with spans.span(spans.STEP[self.jobs[name].phase]):
                        if cuda:
                            with torch.cuda.stream(self._streams[name]):
                                outs.append(self._exec[name]())
                        else:
                            outs.append(self._exec[name]())
            with spans.span(spans.SYNC):
                self._sync()
            return outs

    def drain(self, *, plan_first: bool = True, daemon=None):
        """Dispatch every pending job: ``plan_first`` plans the drain
        first (``plan``, which also warms the dispatcher's decisions).

        ``daemon`` (a ``ServingDaemon``) routes the drain through the
        durable job path: the dispatch runs as the ``external`` job
        ``"serve-drain"`` under a ``runtime.daemon.DrainLease``, which
        checkpoints its remaining slices every round and honors
        ``daemon.cancel`` / ``daemon.pause`` at round boundaries. The
        result gains ``job_id`` and ``state`` (``finished`` /
        ``cancelled`` / ``paused`` / ``"lost"`` if the lease was
        stolen)."""
        missing = sorted(n for n in self._pending()
                         if n not in self._exec or n not in self.profiles)
        if missing:
            raise ValueError(
                f"pending jobs with no registered profile/executable: "
                f"{missing} — submit() must complete for every job "
                "before drain()")
        with spans.span(spans.DRAIN):
            engine = WorkloadEngine()
            sched = engine.scheduler_for(self.spec, self.profiles,
                                         **SCHED_ARGS)
            plan = None
            if plan_first:
                with spans.span(spans.PLAN):
                    plan = self.plan(engine)
            lease = (None if daemon is None
                     else DrainLease(daemon, DRAIN_JOB, self._pending()))
            t0 = time.perf_counter()
            executed = []
            stopped = None
            while pending := self._pending():
                if lease is not None:
                    stopped = lease.check(len(executed), pending)
                    if stopped is not None:
                        break
                with spans.span(spans.DECIDE):
                    cs = sched.find_coschedule(list(pending))
                if cs.k2 is None:
                    n_run = min(self.jobs[cs.k1].num_slices, 8)
                    self._round([(cs.k1, n_run)])
                    self.jobs[cs.k1].num_slices -= n_run
                    executed.append((cs.k1, None, n_run, 0, 0.0))
                    continue
                # balanced interleave: s1:s2 slices a round, one stream each
                r1 = max(1, round(cs.s1 / self.spec.n_sm))
                r2 = max(1, round(cs.s2 / self.spec.n_sm))
                j1, j2 = self.jobs[cs.k1], self.jobs[cs.k2]
                n1 = min(r1, j1.num_slices)
                n2 = min(r2, j2.num_slices)
                self._round([(cs.k1, n1), (cs.k2, n2)])
                j1.num_slices -= n1
                j2.num_slices -= n2
                executed.append((cs.k1, cs.k2, n1, n2, cs.cp))
                if len(executed) > MAX_ROUNDS:
                    raise RuntimeError("scheduler did not drain")
            wall = time.perf_counter() - t0
            out = {"rounds": executed, "wall_s": wall,
                   "predicted_gain": self._predicted_gain(executed),
                   "plan": plan}
            if lease is not None:
                out["job_id"] = lease.job_id
                out["state"] = stopped if stopped is not None else \
                    lease.finish({"rounds": len(executed), "wall_s": wall,
                                  "predicted_gain": out["predicted_gain"]})
            return out

    def _predicted_gain(self, executed) -> float:
        """Aggregate modeled co-scheduling profit over executed rounds."""
        cps, weights = [], []
        for k1, k2, n1, n2, cp in executed:
            if k2 is not None:
                cps.append(cp)
                weights.append(n1 + n2)
        if not cps:
            return 0.0
        return float(np.average(cps, weights=weights))


def card_spec(device) -> GPUSpec:
    """``H100`` with the card's own SM count where a card is present."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return dataclasses.replace(H100, n_sm=n_sm)


# the reference's demo tenants (repro/launch/serve.py:399-404), in its order
DEMO_JOBS = (("tenantA-phi3-prefill", "phi3-mini-3.8b", "prefill", 24),
             ("tenantB-dsv2-decode", "deepseek-v2-236b", "decode", 24),
             ("tenantC-rwkv-prefill", "rwkv6-1.6b", "prefill", 16),
             ("tenantD-sc2-decode", "starcoder2-15b", "decode", 16))


def demo(device=None):
    """The reference's four demo tenants, reduced, on the H100 model.
    Returns the drain's result."""
    dev = resolve_device(device)
    server = SharedPodServer(gpu_spec=card_spec(dev),
                             profile_fn=h100_profile_from_costs, device=dev)
    for job in DEMO_JOBS:
        server.submit(Job(*job))
    for ev in server.log:
        print("submitted", ev[1],
              f"PUR={ev[2]:.2f} MUR={ev[3]:.2f} R_m={ev[4]:.2f}")
    if dev.type == "cuda":
        print(server.capture_report())
    res = server.drain()
    if res["plan"]:
        print(f"engine plan (H100 model): predicted makespan "
              f"{res['plan']['predicted_makespan_cycles']:.0f} cycles over "
              f"{len(res['plan']['time_line'])} phases "
              f"({res['plan']['n_coschedules']} co-scheduled)")
    for k1, k2, n1, n2, cp in res["rounds"]:
        print(f"co-schedule {k1} x {k2}: slices {n1}:{n2}  "
              f"H100-model predicted CP={cp:+.3f}")
    print(f"drained in {res['wall_s']:.1f}s; mean H100-model predicted "
          f"co-scheduling profit {res['predicted_gain']:+.1%}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args()
    demo(args.device)
