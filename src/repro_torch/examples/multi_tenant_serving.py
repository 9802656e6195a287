"""Shared-pod multi-tenant serving with Kernelet slicing/co-scheduling.

PyTorch counterpart of ``examples/multi_tenant_serving.py``. Four tenants
submit jobs with different compute/memory profiles; the scheduler pairs
complementary ones and interleaves their microbatch slices. The default
path serves them for real on the card (``launch.serve.demo``), planned on
the H100 model. ``--fleet``, ``--arrivals`` and ``--pods`` replay the same
tenant mix over a simulated fleet of pods on the H100 model (``H100``,
``h100_profile_from_costs``) where the reference's replay uses the TPU
v5e's; the replay runs no kernel, and every number it prints is the
model's.

  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving
  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \\
      --fleet 4
  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \\
      --arrivals 1e-5
  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \\
      --pods h100,h100-2x --arrivals 1e-5
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.core.profiles import H100, h100_profile_from_costs

# the demo() mix: (name, arch, phase, slices)
TENANTS = (("tenantA-phi3-prefill", "phi3-mini-3.8b", "prefill", 24),
           ("tenantB-dsv2-decode", "deepseek-v2-236b", "decode", 24),
           ("tenantC-rwkv-prefill", "rwkv6-1.6b", "prefill", 16),
           ("tenantD-sc2-decode", "starcoder2-15b", "decode", 16))
SHAPE_OF = {"prefill": "prefill_32k", "decode": "decode_32k",
            "train": "train_4k"}


def _pod_spec(token: str, spec=H100):
    """Resolve a ``--pods`` token to a GPUSpec: ``h100`` is ``spec`` (the
    stem is ``spec``'s name in lower case), ``h100-<k>x`` a generation
    with k times the SMs (e.g. ``h100-2x``), the mixed-pod
    capacity-planning knob."""
    stem = spec.name.lower()
    if token == stem:
        return spec
    if token.startswith(stem + "-") and token.endswith("x"):
        k = int(token[len(stem) + 1:-1])
        if k < 1:
            raise ValueError(f"pod scale must be >= 1: {token!r}")
        return dataclasses.replace(spec, name=f"{spec.name}-{k}x",
                                   n_sm=spec.n_sm * k)
    raise ValueError(f"unknown pod spec {token!r}: expected '{stem}' or "
                     f"'{stem}-<k>x'")


def fleet_replay(n_pods: int, arrival_rate: float = 0.0,
                 policy: str = "KERNELET", deal: str = "auto",
                 pods: str = "", *, spec=H100,
                 profile_fn=h100_profile_from_costs):
    """Replay the demo tenant mix over a simulated fleet of shared pods on
    the hardware model ``spec`` (profiles from ``profile_fn``): one engine
    batch, one measurement service, one decision cache. The profiles come
    from the analytic cell costs, so no model is built.

    With ``arrival_rate`` > 0 the replay is arrival-timed: tenant jobs land
    on a Poisson stream at that rate (events per simulated cycle), and the
    result reports per-job queue wait and SLO attainment beside the
    makespan. ``policy`` picks the per-pod schedule and ``deal`` how the
    stream is split over pods. Returns the fleet result."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.costs import cell_cost
    from repro_torch.core.engine import WorkloadEngine, run_fleet
    from repro_torch.core.simulator import IPCTable
    from repro_torch.data.synthetic import poisson_arrivals

    profiles = {}
    for name, arch, phase, slices in TENANTS:
        cost = cell_cost(get_config(arch), SHAPES[SHAPE_OF[phase]])
        prof = profile_fn(name, cost["flops"], cost["hbm_bytes"],
                          num_blocks=slices)
        profiles[name] = dataclasses.replace(
            prof, insns_per_block=1000.0, num_blocks=slices)
    truth = IPCTable(spec.virtual(), rounds=1500, persist=False)
    order = [name for name, *_ in TENANTS]
    pod_specs = None
    if pods:
        pod_specs = [_pod_spec(tok.strip(), spec) for tok in pods.split(",")]
        n_pods = len(pod_specs)
    arrivals = None
    slo = None
    if arrival_rate > 0:
        arrivals = list(poisson_arrivals(arrival_rate, len(order), seed=0))
        slo = 2.0 / arrival_rate          # two mean interarrival gaps
    engine = WorkloadEngine()
    t0 = time.perf_counter()
    fleet = run_fleet(policy, profiles, order, spec, truth, n_pods,
                      alpha_p=0.2, alpha_m=0.2, engine=engine,
                      arrivals=arrivals, slo_deadline=slo, deal=deal,
                      gpus=pod_specs)
    dt = time.perf_counter() - t0
    mix = ("" if pod_specs is None
           else " [" + ", ".join(s.name for s in fleet.gpus) + "]")
    print(f"fleet of {n_pods} pods{mix} ({policy}, {fleet.deal} dealing): "
          f"{spec.name}-model makespan {fleet.makespan:.0f} cycles, "
          f"{fleet.n_coschedules} co-schedules, replay took {dt * 1e3:.1f}ms")
    for g, lane in enumerate(fleet.lanes):
        events = ", ".join(ev for _, ev in lane.time_line)
        print(f"  pod{g} ({fleet.gpus[g].name}): "
              f"{lane.total_cycles:.0f} cycles  [{events}]")
    if fleet.latency is not None:
        lat = fleet.latency
        print(f"arrival-timed (rate={arrival_rate:g}/cycle): "
              f"wait p50 {lat['wait_p50']:.0f} / p95 {lat['wait_p95']:.0f} "
              f"cycles; SLO({lat['slo_deadline']:.0f}) attainment "
              f"{lat['slo_attainment']:.0%}")
        for name, arr, comp in sorted(
                (c for lane in fleet.lanes for c in lane.completions),
                key=lambda c: c[2]):
            print(f"  {name}: arrived {arr:.0f}, done {comp:.0f} "
                  f"(wait {comp - arr:.0f})")
    print(f"engine: {engine.stats['steps']} steps, "
          f"{engine.stats['pair_lookups']} pair + "
          f"{engine.stats['solo_lookups']} solo lookups batched, "
          f"{engine.stats['idle_ffwd']} idle fast-forwards")
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the real dispatch (default: cuda)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N_PODS",
                    help="simulated multi-pod fleet replay instead of "
                         "real dispatch")
    ap.add_argument("--arrivals", type=float, default=0.0, metavar="RATE",
                    help="arrival-timed replay: tenant jobs land on a "
                         "Poisson stream at RATE events per simulated "
                         "cycle (implies --fleet 1 unless given)")
    ap.add_argument("--policy", default="KERNELET",
                    choices=["BASE", "KERNELET", "OPT", "MC",
                             "EDF-KERNELET", "PWAIT-CP"],
                    help="per-pod scheduling policy for the simulated "
                         "replay (EDF-KERNELET / PWAIT-CP are "
                         "arrival-aware)")
    ap.add_argument("--deal", default="auto",
                    choices=["auto", "round_robin", "least_backlog"],
                    help="fleet dealing policy (auto = least-predicted-"
                         "backlog under arrivals, round-robin otherwise)")
    ap.add_argument("--pods", default="", metavar="SPEC,SPEC,...",
                    help="mixed-pod fleet: comma-separated pod specs "
                         "('h100' or 'h100-<k>x', e.g. h100,h100-2x); "
                         "overrides --fleet's pod count")
    args = ap.parse_args(argv)
    if args.fleet or args.arrivals or args.pods:
        return fleet_replay(max(args.fleet, 1), arrival_rate=args.arrivals,
                            policy=args.policy, deal=args.deal,
                            pods=args.pods)
    from repro_torch.launch.serve import demo
    return demo(args.device)


if __name__ == "__main__":
    main()
