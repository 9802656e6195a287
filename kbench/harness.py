"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to it is found by name: its configuration in
``kbench/configs/<config>.json`` (the served model's sizes, the port's arch
that the scheduler profiles, the reference module, the kernels to build),
its traffic in ``kbench/workloads/<traffic>.json`` (the tenants' queue for
one drain), its limits in ``kbench/limits/<cell>.json``, and each metric's
reader in ``kbench/metrics/<metric>.py``.

The system under test is ``repro_torch.launch.serve.SharedPodServer`` on
the H100 model, as the port's ``demo()`` builds it. Set-up makes the
weights on the device from the seed, submits every tenant, writes a
decode tenant's context into its caches (every row but the one its steps
write, drawn from the seed), and runs one drain. The window re-queues the
cell's slices and calls ``drain()`` until ``seconds`` have passed; a
traced run puts a serial pass (each tenant drained alone, one after
another) beside each drain, then profiles a few drains more. The check
then reads each tenant's output through the executable the drains ran,
frees the server, rebuilds the weights and the context and compares with
the plain float32 reference.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kbench import trace as tracing
from kbench import weights, work
from kbench.reference.common import (Precision, exact_f32, rel_err,
                                     worst_row_rel_err)

KBENCH = Path(__file__).resolve().parent
ROOT = KBENCH.parent
PROFILED_DRAINS = 3
# the server draws every tenant's tokens itself, with make_batch's seed 0
TOKEN_SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: object
    metrics: list          # [(entry in BENCHMARK.json, reader)]


def _reader(name: str):
    path = KBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, trace: bool, bench=None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with the
    metrics a run with or without ``trace`` reports in it."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    config = _json(KBENCH / "configs" / f"{entry['config']}.json")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=_json(KBENCH / "workloads"
                              / f"{entry['traffic']}.json"),
                limits=_json(KBENCH / "limits" / f"{name}.json"),
                reference=importlib.import_module(
                    f"kbench.reference.{config['reference']}"),
                metrics=[(m, _reader(m["name"])) for m in metrics])


def port_config(config: dict):
    """The port's ``ModelConfig`` for ``config``: its arch's, with every
    size the file states put in."""
    from repro_torch.configs import get_config
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["model"].items()}
    return dataclasses.replace(get_config(config["arch"]), **fields)


def tenant_tokens(vocab: int, batch: int, seq: int) -> np.ndarray:
    """The (batch, seq) tokens the server draws for a tenant (a frozen
    copy of ``data.synthetic.make_batch``'s draw at seed 0, step 0); a
    decode tenant feeds column 0."""
    rng = np.random.default_rng(np.uint64(TOKEN_SEED * 1_000_003 + 0))
    return rng.integers(0, vocab, (batch, seq), dtype=np.int32)


def power_limit_w():
    """The card's power limit, or None where ``nvidia-smi`` cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_caches(server, name: str):
    """The decode caches that tenant ``name``'s step reads and writes in
    place: the server hands them out nowhere, so they are taken from the
    default argument its step closure was built with."""
    step = server._exec[name]
    try:
        return inspect.signature(step).parameters["caches"].default
    except (KeyError, TypeError, ValueError) as e:
        raise RuntimeError(
            f"tenant {name!r}: the server's decode step no longer carries "
            "its caches as a default argument; the check cannot reach "
            "the decode state") from e


class Served:
    """The system under test for one run: the server with the cell's
    tenants submitted, and a decode tenant's caches filled with the
    context its traffic states. Every step a tenant runs is counted from
    the rounds the drains return."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.core.profiles import h100_profile_from_costs
        from repro_torch.kernels import _build
        from repro_torch.launch.serve import Job, SharedPodServer, card_spec
        self.device = device
        self.tenants = cell.traffic["tenants"]
        if device.type == "cuda":
            _build.build(tuple(cell.config["kernels"]))
        cfg = port_config(cell.config)
        m, ref = cell.config["model"], cell.reference
        self.params = weights.build(ref.leaves(m), seed, device)
        self.server = SharedPodServer(
            gpu_spec=card_spec(device), profile_fn=h100_profile_from_costs,
            use_reduced=False, device=device)
        self.caches, self.steps = {}, {}
        for t in self.tenants:
            name = t["name"]
            self.server.submit(Job(name, cell.config["arch"], t["phase"],
                                   t["slices"], t["batch"], t["seq"]),
                               params=self.params, cfg=cfg)
            self.steps[name] = 1         # submit's warm-up run
            if t["phase"] == "decode":
                self.caches[name] = decode_caches(self.server, name)
                ref.fill_past(self.caches[name], m,
                              work.decode_position(t["seq"]), t.get("past"),
                              seed)
        _sync(device)
        self.queue = {t["name"]: t["slices"] for t in self.tenants}
        self.tokens = {t["name"]: work.slice_tokens(t["phase"], t["batch"],
                                                    t["seq"])
                       for t in self.tenants}
        self.flops = {t["name"]: ref.slice_flops(m, t["phase"], t["batch"],
                                                 t["seq"])
                      for t in self.tenants}
        self.attempted = self.failed = 0

    def drain(self, only=None) -> dict:
        """Re-queue the cell's slices (only tenant ``only``'s, if given)
        and drain them, host clock around the whole call."""
        queue = {name: n if only in (None, name) else 0
                 for name, n in self.queue.items()}
        for name, n in queue.items():
            self.server.jobs[name].num_slices = n
        queued = sum(queue.values())
        self.attempted += queued
        t0 = time.perf_counter()
        try:
            res = self.server.drain()
        except Exception:
            self.failed += queued
            raise
        call = time.perf_counter() - t0
        ran = dict.fromkeys(self.queue, 0)
        for k1, k2, n1, n2, _ in res["rounds"]:
            ran[k1] += n1
            if k2 is not None:
                ran[k2] += n2
        for name, n in ran.items():
            self.steps[name] += n
        self.failed += queued - sum(ran.values())
        return {"call_s": call, "wall_s": res["wall_s"],
                "tokens": sum(ran[n] * self.tokens[n] for n in ran),
                "flops": sum(ran[n] * self.flops[n] for n in ran),
                "rounds": len(res["rounds"])}

    def serial(self) -> dict:
        """Every tenant's slices alone, one tenant after another: a drain
        with only that tenant queued, which runs its slices on its own
        stream. ``slices``: (phase, the drain's dispatch time a slice)."""
        slices = []
        for t in self.tenants:
            d = self.drain(only=t["name"])
            slices.append((t["phase"], d["wall_s"] / t["slices"], d))
        return {"total_s": sum(d["wall_s"] for _, _, d in slices),
                "slices": [(ph, s) for ph, s, _ in slices]}

    def output(self, name: str):
        """Tenant ``name``'s output: one more call of the step its drains
        ran (``drain()`` hands back none), counted."""
        self.steps[name] += 1
        return self.server._exec[name]()


def _window(served: Served, seconds: float, trace: bool):
    """The measured window: (drains, serial passes, window seconds). A
    traced run puts a serial pass beside each drain, in turns."""
    drains, passes = [], []
    start = time.perf_counter()
    while True:
        if trace:
            first_serial = len(drains) % 2 == 1
            s = served.serial() if first_serial else None
            d = served.drain()
            s = s if first_serial else served.serial()
            s["drain_wall_s"] = d["wall_s"]
            passes.append(s)
        else:
            d = served.drain()
        drains.append(d)
        if time.perf_counter() - start >= seconds:
            return drains, passes, time.perf_counter() - start


def _profiled(served: Served):
    """A few drains under ``torch.profiler``, each marked by a span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if served.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED_DRAINS):
                with torch.profiler.record_function(tracing.SPAN):
                    served.drain()
            _sync(served.device)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return tracing.summarize(tracing.load(path))


def _outputs(served: Served, cell: Cell, seed: int) -> dict:
    """Each tenant's output through the executable its drains ran (one
    more call, counted), and a decode tenant's state after it, with the
    count of cache rows it changed that no step should write."""
    m, ref = cell.config["model"], cell.reference
    out = {}
    for t in served.tenants:
        name = t["name"]
        got = {"logits": served.output(name), "steps": served.steps[name]}
        if t["phase"] == "decode":
            got["state"], got["exact"] = ref.program_state(
                served.caches[name], m, work.decode_position(t["seq"]),
                t.get("past"), seed)
        out[name] = got
    _sync(served.device)
    return out


def _reference_outputs(cell: Cell, w, prec, got, device, seed) -> dict:
    """The reference's output for each tenant, at the tenant's sizes."""
    m, ref = cell.config["model"], cell.reference
    want = {}
    for t in cell.traffic["tenants"]:
        name = t["name"]
        toks = torch.as_tensor(tenant_tokens(m["vocab_size"], t["batch"],
                                             t["seq"]),
                               device=device).long()
        if t["phase"] == "prefill":
            want[name] = {"logits": ref.prefill(w, m, toks, prec)}
        else:
            logits, state = ref.decode(w, m, toks[:, 0],
                                       work.decode_position(t["seq"]),
                                       got[name]["steps"], prec,
                                       t.get("past"), seed)
            want[name] = {"logits": logits, "state": state}
    return want


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, by short name: each tenant's logits (the
    whole tensor's and the worst row's relative error), a decode tenant's
    state (the worst leaf and layer's relative error) and its exact
    counts."""
    numbers = {}
    for name, w in want.items():
        g = got[name]
        numbers[f"{name}.rel"] = rel_err(g["logits"], w["logits"])
        numbers[f"{name}.row"], where = worst_row_rel_err(g["logits"],
                                                          w["logits"])
        log(f"[kbench] {name}: the worst logits row is {where}")
        if g["logits"].dim() == 3:                   # (B, S, V): by position
            rows = ((g["logits"].float() - w["logits"].float()).norm(dim=-1)
                    / w["logits"].float().norm(dim=-1).clamp_min(1e-30))
            log(f"[kbench] {name}: rows at position 0 up to "
                f"{float(rows[:, 0].max()):.4f}, at 1-31 up to "
                f"{float(rows[:, 1:32].max()):.4f}, from 32 on median "
                f"{float(rows[:, 32:].median()):.4f}")
        if "state" in w:
            numbers[f"{name}.state"] = max(
                rel_err(gl, wl) for key in w["state"]
                for gl, wl in zip(g["state"][key], w["state"][key]))
            for key, value in g.get("exact", {}).items():
                numbers[f"{name}.{key}"] = value
    return numbers


def check(cell: Cell, seed: int, got: dict, device, control: bool = False):
    """(numbers of the program, numbers of the control or None): the
    program's outputs against the reference's, rebuilt from the seed in
    float32 with TF32 off; with ``control``, the reference computed one
    precision lower put in the program's place, against the same."""
    m, ref = cell.config["model"], cell.reference
    tree = weights.build(ref.leaves(m), seed, device)
    with exact_f32(), torch.inference_mode():
        w = ref.prepare(tree, m, Precision())
        want = _reference_outputs(cell, w, Precision(), got, device, seed)
        numbers = compare(got, want)
        ctl = None
        if control:
            del w
            wc = ref.prepare(tree, m, Precision(control=True))
            fake = _reference_outputs(cell, wc, Precision(control=True), got,
                                      device, seed)
            for name, g in got.items():
                fake[name]["exact"] = g.get("exact", {})
            ctl = compare(fake, want)
    return numbers, ctl


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, control: bool = False) -> dict:
    """One run; returns the result line's object. ``started``: the
    process's start on ``time.perf_counter``, where set-up begins."""
    device = torch.device(device)
    served = Served(cell, seed, device)
    served.drain()                                   # the warm drain
    served.attempted = served.failed = 0
    _sync(device)
    setup_s = time.perf_counter() - started
    log(f"[kbench] {cell.name}: set-up {setup_s:.3f} s")
    error = None
    drains, passes, window_s, summary = [], [], 0.0, None
    try:
        drains, passes, window_s = _window(served, seconds, trace)
        if trace:
            summary = _profiled(served)
    except Exception as e:                          # noqa: BLE001
        error = f"{type(e).__name__}: {e}"
        log(f"[kbench] the window stopped: {error}")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log(f"[kbench] {len(drains)} drains in {window_s:.3f} s, "
        f"{sum(d['rounds'] for d in drains)} rounds; "
        f"{served.attempted} slices queued, {served.failed} not run")
    if len(drains) >= 3:
        calls = sorted(d["call_s"] for d in drains)
        thirds = [drains[i * len(drains) // 3:(i + 1) * len(drains) // 3]
                  for i in range(3)]
        log("[kbench] drain() call s: min {:.4f} p10 {:.4f} p50 {:.4f} "
            "p90 {:.4f} max {:.4f}; tokens/s by third of the window: {}"
            .format(calls[0], calls[len(calls) // 10],
                    calls[len(calls) // 2], calls[9 * len(calls) // 10],
                    calls[-1], [round(sum(d["tokens"] for d in t)
                                      / sum(d["call_s"] for d in t))
                                for t in thirds]))
    for phase in ("prefill", "decode"):
        times = sorted(s for p in passes for ph, s in p["slices"]
                       if ph == phase)
        if times:
            log(f"[kbench] {phase} slice alone: median "
                f"{1e3 * times[len(times) // 2]:.3f} ms over {len(times)}")
    rec = {"cell": cell.name, "tenants": served.tenants,
           "model": cell.config["model"], "setup_s": setup_s,
           "drains": drains, "serial": passes, "window_s": window_s,
           "trace": summary}
    got = _outputs(served, cell, seed) if error is None else None
    attempted, failed = served.attempted, served.failed
    del served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ctl = check(cell, seed, got, device, control) \
        if got is not None else ({}, None)
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in numbers.items()}
    unmatched = sorted(set(checks) ^ set(cell.limits))
    if unmatched:
        log(f"[kbench] numbers and limits do not pair up: {unmatched}")
    correct = (error is None and failed == 0 and bool(checks)
               and not unmatched
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for entry, read in cell.metrics:
        value = read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if device.type == "cuda"
           else None}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    if ctl is not None:
        result["control"] = ctl
    result["checks"] = checks
    return result
