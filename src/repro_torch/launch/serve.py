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
CPU the slices run in order.

The hardware model is the caller's: ``gpu_spec`` and ``profile_fn``
default to ``TPU_V5E`` and ``tpu_profile_from_costs``, exactly as in the
reference, so the ``rounds`` list equals the reference server's; the card's
own model is ``gpu_spec=H100, profile_fn=h100_profile_from_costs`` (what
``demo()`` and ``chip_smoke.py`` pass). A job's slice is one step of its
model, which covers every SM once, so its profile has ``num_slices x n_sm``
blocks: the engine's plan, the scheduler's s1:s2 (multiples of ``n_sm``) and
the drain's rounds (``s / n_sm`` slices) then count the same thing.

  PYTHONPATH=src python -m repro_torch.launch.serve --demo
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.costs import cell_cost
from repro_torch.core.engine import LaneSpec, WorkloadEngine, run_fleet
from repro_torch.core.jobstore import (CANCELLED, FINISHED, PAUSED, QUEUED,
                                       RUNNING, JobStoreError, StaleLease)
from repro_torch.core.markov import MarkovModel
from repro_torch.core.profiles import (H100, TPU_V5E, GPUSpec, KernelProfile,
                                       h100_profile_from_costs,
                                       tpu_profile_from_costs)
from repro_torch.core.simulator import IPCTable
from repro_torch.data.synthetic import make_batch, poisson_arrivals
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


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
        self.model = MarkovModel(gpu_spec.virtual(), three_state=True)
        self.jobs: Dict[str, Job] = {}
        self.profiles: Dict[str, KernelProfile] = {}
        self._exec: Dict[str, Callable] = {}
        self.seed = seed
        self.use_reduced = use_reduced
        self.device = resolve_device(device)
        self.log: List[tuple] = []
        self._plan_truth: Optional[IPCTable] = None
        self._streams: Dict[str, torch.cuda.Stream] = {}

    # ---- job admission: build, warm up, profile, register ---- #
    def submit(self, job: Job, params=None):
        """Build the job's step and run it once (which also builds and
        loads the kernels on first use). ``params`` defaults to fresh
        weights from the server's seed, the same for every job as in the
        reference."""
        full_cfg = get_config(job.arch)
        cfg = reduced(full_cfg) if self.use_reduced else full_cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = T.init_params(cfg, gen, device=self.device)
        raw = make_batch(cfg, job.batch_per_slice, job.seq)
        tokens = torch.as_tensor(raw["tokens"], device=self.device)
        if job.phase == "decode":
            caches = T.init_decode_caches(cfg, job.batch_per_slice, job.seq,
                                          device=self.device)
            tok = tokens[:, 0]

            def run(params=params, cfg=cfg, caches=caches, tok=tok):
                logits, _ = T.decode_step(params, cfg, caches, tok,
                                          job.seq // 2)
                return logits
        else:
            def run(params=params, cfg=cfg, batch={"tokens": tokens}):
                logits, _, _ = T.forward(params, cfg, batch)
                return logits
        run()                               # warm-up: builds the kernels
        self._sync()
        prof = job_profile(job, self.spec, self.profile_fn)
        self.jobs[job.name] = job
        self.profiles[job.name] = prof
        self._exec[job.name] = run
        self.log.append(("submit", job.name, prof.pur, prof.mur, prof.rm))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- engine-backed planning ---- #
    def plan(self, engine: WorkloadEngine, *, rounds: int = 1500) -> dict:
        """Simulated drain of the pending jobs as one engine replay lane:
        predicts the fleet-style makespan and — because the lane shares the
        engine's scheduler for this (spec, profiles, alphas) identity —
        pre-warms every drain decision the dispatcher is about to make."""
        order = [n for n, j in self.jobs.items() if j.num_slices > 0]
        if not order:
            return {"predicted_makespan_cycles": 0.0, "time_line": [],
                    "n_coschedules": 0}
        # one measurement table for the server's lifetime: entries are
        # keyed by profile content, so repeated drains re-simulate nothing
        if self._plan_truth is None:
            self._plan_truth = IPCTable(self.spec.virtual(), rounds=rounds,
                                        persist=False)
        lane = LaneSpec("KERNELET", self.profiles, order, self.spec,
                        self._plan_truth,
                        alpha_p=0.2, alpha_m=0.2, cp_margin=0.0)
        res = engine.run([lane])[0]
        return {"predicted_makespan_cycles": float(res.total_cycles),
                "time_line": res.time_line,
                "n_coschedules": res.n_coschedules}

    def plan_arrivals(self, engine: WorkloadEngine, rate: float, *,
                      seed: int = 0, slo_deadline: Optional[float] = None,
                      rounds: int = 1500,
                      policy: str = "KERNELET") -> dict:
        """Arrival-timed drain plan: jobs land on a Poisson stream at
        ``rate`` (events per simulated cycle) and the engine lane admits,
        truncates and fast-forwards accordingly — predicting per-job queue
        wait, tail latency, and SLO attainment at ``slo_deadline`` in
        addition to the makespan. Like ``plan``, the replay warms the
        shared decision cache for the real dispatcher. ``policy`` selects
        the planning policy (``"EDF-KERNELET"``, ``"PWAIT-CP"``, ...)."""
        order = [n for n, j in self.jobs.items() if j.num_slices > 0]
        if not order:
            return {"predicted_makespan_cycles": 0.0, "time_line": [],
                    "n_coschedules": 0, "latency": {}, "energy": {},
                    "completions": []}
        if self._plan_truth is None:
            self._plan_truth = IPCTable(self.spec.virtual(), rounds=rounds,
                                        persist=False)
        arrivals = poisson_arrivals(rate, len(order), seed=seed)
        lane = LaneSpec(policy, self.profiles, order, self.spec,
                        self._plan_truth, alpha_p=0.2, alpha_m=0.2,
                        cp_margin=0.0, arrivals=list(arrivals),
                        slo_deadline=slo_deadline)
        res = engine.run([lane])[0]
        return {"predicted_makespan_cycles": float(res.total_cycles),
                "time_line": res.time_line,
                "n_coschedules": res.n_coschedules,
                "policy": policy,
                "latency": dict(res.latency_metrics(slo_deadline)),
                "energy": dict(res.energy_metrics()),
                "completions": res.completions}

    def plan_fleet(self, n_pods: int, rate: float, *,
                   pod_specs=None, seed: int = 0,
                   slo_deadline: Optional[float] = None,
                   rounds: int = 1500, policy: str = "KERNELET",
                   deal="auto") -> dict:
        """Fleet-dealing plan: replays the pending jobs' Poisson stream
        over ``n_pods`` simulated pods through ``run_fleet``, dealing with
        ``deal`` (``"auto"`` = least-predicted-backlog under arrivals).
        ``pod_specs`` (one ``GPUSpec`` per pod) plans a mixed-pod fleet.
        Returns the pooled latency prediction plus the per-pod split."""
        order = [n for n, j in self.jobs.items() if j.num_slices > 0]
        if not order:
            return {"predicted_makespan_cycles": 0.0, "latency": {},
                    "energy": {}, "per_pod": [], "pods": [], "deal": None}
        if pod_specs is not None:
            pod_specs = list(pod_specs)
            if len(pod_specs) != n_pods:
                raise ValueError(f"n_pods={n_pods} but {len(pod_specs)} "
                                 "pod_specs given")
        if self._plan_truth is None:
            self._plan_truth = IPCTable(self.spec.virtual(), rounds=rounds,
                                        persist=False)
        arrivals = list(poisson_arrivals(rate, len(order), seed=seed))
        fleet = run_fleet(policy, self.profiles, order, self.spec,
                          self._plan_truth, n_pods, alpha_p=0.2,
                          alpha_m=0.2, cp_margin=0.0, arrivals=arrivals,
                          slo_deadline=slo_deadline, deal=deal,
                          gpus=pod_specs)
        return {"predicted_makespan_cycles": float(fleet.makespan),
                "latency": dict(fleet.latency),
                "energy": dict(fleet.energy),
                "per_pod": [[n for n, _, _ in lane.completions]
                            for lane in fleet.lanes],
                "pods": [s.name for s in fleet.gpus],
                "deal": fleet.deal,
                "policy": policy}

    # ---- daemon-backed drain control ---- #
    def _register_drain_job(self, daemon, job_name: str,
                            plan_policy: str):
        """Register this drain as an ``external`` job in the daemon's
        durable store and take its lease — the single-writer
        ``queued → running`` gate, so the dispatch below is cancellable,
        pausable and visible exactly like a daemon-drained lane (fleet
        pods never steal it: ``serve_once`` skips external specs). A
        previously paused drain re-acquires from ``paused`` and resumes
        the remaining slices."""
        pending = {n: j.num_slices for n, j in self.jobs.items()
                   if j.num_slices > 0}
        st = daemon.store.state(job_name)
        if st is None:
            daemon.submit(job_name, {
                "external": True, "kind": "serve-drain",
                "policy": plan_policy, "pending": pending})
            st = QUEUED
        epoch = daemon.store.acquire_lease(
            job_name, daemon.pod_id, daemon.lease_ttl,
            from_state=PAUSED if st == PAUSED else QUEUED,
            info=f"serve-drain dispatch ({len(pending)} tenants)")
        if epoch is None:
            raise RuntimeError(
                f"drain job {job_name!r} is not claimable "
                f"(state {daemon.store.state(job_name)!r})")
        return job_name, (daemon.pod_id, epoch)

    def _drain_control(self, daemon, job_id: str, fence,
                       round_idx: int) -> Optional[str]:
        """One round-boundary control check: honor pending cancel/pause
        requests, heartbeat the lease, checkpoint remaining slices.
        Returns the state the drain stopped in (``cancelled``,
        ``paused``, or ``"lost"`` when the lease was stolen), or None to
        keep dispatching."""
        pod_id, epoch = fence

        def ckpt():
            daemon.store.save_checkpoint(
                job_id, round_idx,
                {"pending": {n: j.num_slices
                             for n, j in self.jobs.items()
                             if j.num_slices > 0}},
                fence=fence)
        try:
            ctl = daemon.poll_control(job_id)
            st = daemon.store.state(job_id)
            if st != RUNNING:
                return st      # requeued/cancelled behind our back
            if ctl == "cancel":
                ckpt()
                daemon.store.transition(
                    job_id, CANCELLED,
                    f"cancelled at round {round_idx}", fence=fence)
                return CANCELLED
            if ctl == "pause":
                ckpt()
                daemon.store.transition(
                    job_id, PAUSED, f"paused at round {round_idx}",
                    fence=fence)
                return PAUSED
            daemon.store.renew_lease(job_id, pod_id, epoch,
                                     daemon.lease_ttl)
            ckpt()
        except StaleLease:
            return "lost"
        except JobStoreError:
            return None    # transient store trouble never stops work
        return None

    # ---- scheduling + interleaved dispatch ---- #
    def _round(self, pairs):
        """Run one round, ``pairs`` = [(job, n_slices), ...], and wait for
        it. On the card every job gets its own CUDA stream and the slices
        are issued interleaved, job by job, as the reference issues them
        asynchronously; on the CPU they run in that order. Every output is
        kept until the round's synchronize."""
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
                if cuda:
                    with torch.cuda.stream(self._streams[name]):
                        outs.append(self._exec[name]())
                else:
                    outs.append(self._exec[name]())
        self._sync()
        return outs

    def drain(self, *, max_rounds: int = 10000, plan_first: bool = True,
              arrival_rate: Optional[float] = None,
              slo_deadline: Optional[float] = None,
              plan_policy: str = "KERNELET", daemon=None,
              job_name: str = "serve-drain"):
        """Dispatch every pending job. ``arrival_rate`` switches the
        planning stage to the arrival-timed replay (``plan_arrivals``);
        ``plan_policy`` selects the planning policy.

        ``daemon`` (a ``ServingDaemon``) routes the drain through the
        durable job path: the dispatch runs under a lease-gated
        ``external`` job named ``job_name``, checkpoints its remaining
        slices every round, and honors ``daemon.cancel`` /
        ``daemon.pause`` at round boundaries. The result gains ``job_id``
        and ``state`` (``finished`` / ``cancelled`` / ``paused`` /
        ``"lost"`` if the lease was stolen)."""
        missing = sorted(n for n, j in self.jobs.items() if j.num_slices > 0
                         and (n not in self._exec or n not in self.profiles))
        if missing:
            raise ValueError(
                f"pending jobs with no registered profile/executable: "
                f"{missing} — submit() must complete for every job "
                "before drain()")
        engine = WorkloadEngine()
        sched = engine.scheduler_for(self.spec, self.profiles,
                                     alpha_p=0.2, alpha_m=0.2, cp_margin=0.0)
        plan = None
        if plan_first:
            plan = (self.plan_arrivals(engine, arrival_rate,
                                       slo_deadline=slo_deadline,
                                       policy=plan_policy)
                    if arrival_rate is not None else self.plan(engine))
        jid = fence = None
        if daemon is not None:
            jid, fence = self._register_drain_job(daemon, job_name,
                                                  plan_policy)
        t0 = time.time()
        executed = []
        while any(j.num_slices > 0 for j in self.jobs.values()):
            if daemon is not None:
                stopped = self._drain_control(daemon, jid, fence,
                                              len(executed))
                if stopped is not None:
                    return {"rounds": executed,
                            "wall_s": time.time() - t0,
                            "predicted_gain":
                                self._predicted_gain(executed),
                            "plan": plan, "job_id": jid,
                            "state": stopped}
            act = [n for n, j in self.jobs.items() if j.num_slices > 0]
            cs = sched.find_coschedule(act)
            if cs.k2 is None:
                n_run = min(self.jobs[cs.k1].num_slices, 8)
                self._round([(cs.k1, n_run)])
                self.jobs[cs.k1].num_slices -= n_run
                executed.append((cs.k1, None, n_run, 0, 0.0))
                continue
            # balanced interleave: s1:s2 slices per round, one stream each
            r1 = max(1, round(cs.s1 / self.spec.n_sm))
            r2 = max(1, round(cs.s2 / self.spec.n_sm))
            j1, j2 = self.jobs[cs.k1], self.jobs[cs.k2]
            n1 = min(r1, j1.num_slices)
            n2 = min(r2, j2.num_slices)
            self._round([(cs.k1, n1), (cs.k2, n2)])
            j1.num_slices -= n1
            j2.num_slices -= n2
            executed.append((cs.k1, cs.k2, n1, n2, cs.cp))
            if len(executed) > max_rounds:
                raise RuntimeError("scheduler did not drain")
        wall = time.time() - t0
        out = {"rounds": executed, "wall_s": wall,
               "predicted_gain": self._predicted_gain(executed),
               "plan": plan}
        if daemon is not None:
            out["job_id"] = jid
            try:
                daemon.store.transition(
                    jid, FINISHED, "drained",
                    result={"rounds": len(executed), "wall_s": wall,
                            "predicted_gain": out["predicted_gain"]},
                    fence=fence)
                out["state"] = FINISHED
            except StaleLease:
                out["state"] = "lost"
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


def demo(device=None):
    """The reference's demo tenants on the H100 model (``tenantB-dsv2-
    decode`` waits for MoE and MLA, ROADMAP items 7 and 9)."""
    dev = resolve_device(device)
    server = SharedPodServer(gpu_spec=card_spec(dev),
                             profile_fn=h100_profile_from_costs, device=dev)
    server.submit(Job("tenantA-phi3-prefill", "phi3-mini-3.8b", "prefill", 24))
    server.submit(Job("tenantC-rwkv-prefill", "rwkv6-1.6b", "prefill", 16))
    server.submit(Job("tenantD-sc2-decode", "starcoder2-15b", "decode", 16))
    for ev in server.log:
        print("submitted", ev[1],
              f"PUR={ev[2]:.2f} MUR={ev[3]:.2f} R_m={ev[4]:.2f}")
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args()
    demo(args.device)
