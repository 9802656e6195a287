#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds the hand-written kernels, holds each against its plain PyTorch
version, drives the port's main path, and prints what it measured.

  python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each asserting (a failure exits non-zero and prints no result):
  1. device check, ``nvidia-smi`` name and power limit, parallel nvcc build;
  2. each kernel against its plain version on the card, on the CPU tests'
     small grids and at the main path's shapes, with kernel, plain and
     library times (CUDA events) and the bound from the card's peak rates;
  3. the main path, with the launch counters set to 0 just before it:
     the scheduler-to-kernel handoff (``balanced_slice_sizes`` drives
     ``ops.coschedule``), ``ops.sliced_matmul`` at its default slice size,
     and ``SharedPodServer(use_reduced=False)`` serving two full-width
     phi3-mini-3.8b tenants (a prefill job and a decode job);
  4. one JSON line of the kernels, the card line, and the final JSON line.

Predicted CP and makespan come from the scheduler's TPU v5e model and are
labelled so; every time printed here is the card's own.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet; dense rates) for the bounds
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16_TOL = dict(atol=2e-2, rtol=2e-2)     # tests/test_kernels.py:17-19
F32_TOL = dict(atol=2e-4, rtol=2e-4)
# K3 at the main shape, beside the allclose: the error's norm relative to
# the plain version's, over the whole output and over each query row. A late
# row's |out| is small, so a row norm sees a wrong key tile that the
# absolute tolerance would not.
K3_REL_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype: str):
    """Least time the card could take: (ms, 'operations' | 'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def max_err(torch, got, want, tol) -> float:
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), **tol)
    assert ok, f"kernel disagrees with its plain version: max err {err}"
    return err


def rel_errs(got, want):
    """(||got - want|| / ||want|| over the whole tensor, the same ratio at
    its worst last-axis row)."""
    g, w = got.float(), want.float()
    diff = g - w
    whole = float(diff.norm() / w.norm())
    rows = float((diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
    return whole, rows


def main() -> int:
    if not __debug__:
        sys.exit("chip_smoke: its checks are asserts; run it without -O")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.calibrate import calibrated_benchmarks
    from repro_torch.core.markov import MarkovModel, balanced_slice_sizes
    from repro_torch.core.profiles import C2050
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import coschedule as CS
    from repro_torch.kernels import sliced_matmul as SM
    from repro_torch.launch.serve import Job, SharedPodServer

    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # ---- phase 1: device and build -------------------------------------
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(card)
    t0 = time.time()
    _build.build()
    log(f"[build] {len(_build.NAMES)} kernels, nvcc in parallel, "
        f"{time.time() - t0:.1f} s")
    for name in _build.NAMES:
        text = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    rows = {}

    # ---- phase 2a: K3 flash_attention -----------------------------------
    for (b, h, s, d, causal) in [(1, 2, 256, 64, True), (2, 1, 128, 128, True),
                                 (1, 2, 256, 64, False), (1, 2, 100, 96, True)]:
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v = (randn((b, h, s, d), dt) for _ in range(3))
            err = max_err(torch, ops.flash_attention(q, k, v, causal=causal),
                          ref.flash_attention(q, k, v, causal=causal), tol)
            log(f"[K3 grid] {(b, h, s, d)} causal={causal} {dt} err {err:.3e}")
    shape = (1, 32, 2048, 96)
    q, k, v = (randn(shape, torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    err = max_err(torch, got, want, BF16_TOL)
    rel_whole, rel_row = rel_errs(got, want)
    assert rel_whole < K3_REL_TOL and rel_row < K3_REL_TOL, \
        f"K3 relative error {rel_whole:.3e} whole, {rel_row:.3e} worst row"
    del got, want
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True), 20)
    plain = time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True), 5)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    bsz, heads, s, d = shape
    pairs = s * (s + 1) // 2
    b_ms, b_by = bound(4.0 * d * pairs * bsz * heads,
                       4 * q.numel() * q.element_size(), "bfloat16")
    rows["flash_attention"] = dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:56", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        rel_err=rel_whole, row_rel_err=rel_row)
    log(f"[K3] {shape} bf16 causal: err {err:.3e} (tol atol=rtol=2e-2), "
        f"relative {rel_whole:.3e} whole and {rel_row:.3e} worst row (tol "
        f"{K3_REL_TOL:g}); "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del q, k, v

    # ---- phase 2b: K1 sliced_matmul -------------------------------------
    for (m, kk, n, ss) in [(256, 128, 256, 1), (128, 256, 384, 3),
                           (384, 128, 128, 4)]:
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a, bm = randn((m, kk), dt), randn((kk, n), dt)
            err = max_err(torch, ops.sliced_matmul(a, bm, slice_size=ss),
                          ref.matmul(a, bm), tol)
            log(f"[K1 grid] {(m, kk, n)} slice {ss} {dt} err {err:.3e}")

    def one_launch(a, bm):
        out = torch.empty(a.shape[0], bm.shape[1], dtype=a.dtype, device=dev)
        SM.matmul_slice(a, bm, out, offset=0,
                        slice_size=(a.shape[0] // 128) * (bm.shape[1] // 128))
        return out

    a, bm = (randn((2048, 2048), torch.bfloat16) for _ in range(2))
    whole = one_launch(a, bm)
    for ss in (1, 3, 4):
        assert torch.equal(ops.sliced_matmul(a, bm, slice_size=ss), whole), \
            f"slice size {ss} is not bitwise equal to one launch"
    log("[K1 bitwise] 2048^3 bf16: slice sizes 1, 3, 4 == one launch, bitwise")
    n = 8192
    a, bm = randn((n, n), torch.bfloat16), randn((n, n), torch.bfloat16)
    mm_want = ref.matmul(a, bm)
    err = max_err(torch, ops.sliced_matmul(a, bm), mm_want, BF16_TOL)
    ms = time_ms(torch, lambda: ops.sliced_matmul(a, bm), 2)
    ms_one = time_ms(torch, lambda: one_launch(a, bm), 3)
    plain = time_ms(torch, lambda: ref.matmul(a, bm), 3)
    lib = time_ms(torch, lambda: torch.matmul(a, bm), 10)
    b_ms, b_by = bound(2.0 * n ** 3, 3 * n * n * 2, "bfloat16")
    rows["sliced_matmul"] = dict(
        source="src/repro_torch/csrc/sliced_matmul.cu",
        replaces="src/repro/kernels/sliced_matmul.py:44", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        one_launch_ms=ms_one)
    log(f"[K1] 8192^3 bf16: err {err:.3e} (tol atol=rtol=2e-2) kernel "
        f"slice_size=4 {ms:.3f} ms, one launch {ms_one:.3f} ms, plain "
        f"{plain:.3f} ms, torch.matmul {lib:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")

    # ---- phase 2c: K2 coschedule ----------------------------------------
    for run_a, run_b in [(1, 1), (2, 1), (1, 3)]:
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a2, b2 = randn((256, 128), dt), randn((128, 256), dt)
            x2 = randn((1024, 256), dt)
            mm, st = ops.coschedule(a2, b2, x2, run_a=run_a, run_b=run_b)
            mref, sref = ref.coschedule(a2, b2, x2, 2.0)
            e = max(max_err(torch, mm, mref, tol),
                    max_err(torch, st, sref, tol))
            log(f"[K2 grid] runs {run_a}:{run_b} {dt} err {e:.3e}")
    profs = calibrated_benchmarks(C2050)
    model = MarkovModel(C2050.virtual())
    pc, tea = profs["PC"], profs["TEA"]
    c1, c2 = model.pair_ipc(pc, 2, tea, 2)
    s1, s2 = balanced_slice_sizes(pc, c1, tea, c2, 14, 14, 14)
    run_a = min(max(1, round(s1 / 14)), 8)
    run_b = min(max(1, round(s2 / 14)), 8)
    x = randn((65536, 8192), torch.bfloat16)
    st_want = ref.streaming_scale(x, 2.0)
    mm, st = ops.coschedule(a, bm, x, run_a=run_a, run_b=run_b)
    err = max(max_err(torch, mm, mm_want, BF16_TOL),
              max_err(torch, st, st_want, BF16_TOL))
    del mm, st
    n_a, n_b = (n // 128) ** 2, 65536 // 256
    ms = time_ms(torch, lambda: ops.coschedule(a, bm, x, run_a=run_a,
                                               run_b=run_b), 3)
    mm_only = time_ms(torch, lambda: CS.launch(
        a, bm, x, CS.make_schedule(n_a, 0), scale=2.0, bx=256), 3)
    st_only = time_ms(torch, lambda: CS.launch(
        a, bm, x, CS.make_schedule(0, n_b), scale=2.0, bx=256), 3)
    plain = time_ms(torch, lambda: ref.coschedule(a, bm, x, 2.0), 3)
    st_bytes = 2 * x.numel() * x.element_size()
    b_ms, b_by = bound(2.0 * n ** 3 + x.numel(), 3 * n * n * 2 + st_bytes,
                       "bfloat16")
    serial_bound = (bound(2.0 * n ** 3, 3 * n * n * 2, "bfloat16")[0]
                    + 1e3 * st_bytes / HBM_BYTES_PER_S)
    rows["coschedule"] = dict(
        source="src/repro_torch/csrc/coschedule.cu",
        replaces="src/repro/kernels/coschedule.py:73", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        serial_ms=mm_only + st_only)
    log(f"[K2] 8192^3 + 65536x8192 bf16, runs {run_a}:{run_b} from "
        f"balanced_slice_sizes (s1={s1}, s2={s2}): err {err:.3e} "
        f"(tol atol=rtol=2e-2) fused {ms:.3f} ms, matmul alone "
        f"{mm_only:.3f} ms + stream alone {st_only:.3f} ms = serial "
        f"{mm_only + st_only:.3f} ms (fused/serial "
        f"{ms / (mm_only + st_only):.4f}), plain {plain:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; serial bound {serial_bound:.4f} ms)")

    # ---- phase 3: the main path, counted ---------------------------------
    ops.reset_launches()
    mm, st = ops.coschedule(a, bm, x, run_a=run_a, run_b=run_b)
    max_err(torch, mm, mm_want, BF16_TOL)
    max_err(torch, st, st_want, BF16_TOL)
    max_err(torch, ops.sliced_matmul(a, bm), mm_want, BF16_TOL)
    del mm, st, x, st_want, a, bm, mm_want, whole
    torch.cuda.empty_cache()
    log(f"[handoff] scheduler runs {run_a}:{run_b} -> coschedule, and "
        "sliced_matmul at slice_size=4: both agree with their plain versions")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    srv = SharedPodServer(use_reduced=False, device="cuda")
    prefill = Job("tenantA-phi3-prefill", "phi3-mini-3.8b", "prefill", 4, 1,
                  2048)
    decode = Job("tenantB-phi3-decode", "phi3-mini-3.8b", "decode", 8, 8,
                 4096)
    srv.submit(prefill)
    srv.submit(decode)
    t_submit = time.time() - t0
    res = srv.drain()
    launches = dict(ops.LAUNCHES)
    rounds = res["rounds"]
    assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
    assert any(k2 is not None for _, k2, _, _, _ in rounds), \
        "no co-scheduled round"
    prefill_runs = 1 + sum(n1 if k1 == prefill.name else
                           (n2 if k2 == prefill.name else 0)
                           for k1, k2, n1, n2, _ in rounds)
    n_layers = get_config("phi3-mini-3.8b").num_layers
    assert launches["flash_attention"] == n_layers * prefill_runs, \
        (launches, prefill_runs)
    for name in _build.NAMES:
        assert launches[name] > 0, f"{name} never launched on the main path"
    logits = {name: srv._exec[name]() for name in srv.jobs}
    torch.cuda.synchronize()
    assert logits[prefill.name].shape == (1, 2048, 32064)
    assert logits[decode.name].shape == (8, 32064)
    for name, lg in logits.items():
        assert bool(torch.isfinite(lg.float()).all()), f"{name}: non-finite"
    log(f"[serve] phi3-mini-3.8b full width (32 layers, d_model 3072), bf16, "
        f"seeded random weights; {len(srv.jobs)} tenants submitted in "
        f"{t_submit:.2f} s (warm-up included); drain wall_s "
        f"{res['wall_s']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k1, k2, n1, n2, cp in rounds:
        log(f"[serve] round {k1} x {k2}: slices {n1}:{n2}, v5e-model "
            f"predicted CP {cp:+.4f}")
    log(f"[serve] v5e-model predicted gain {res['predicted_gain']:+.4f}, "
        f"v5e-model predicted makespan "
        f"{res['plan']['predicted_makespan_cycles']:.0f} cycles; "
        f"flash_attention launches {launches['flash_attention']} = "
        f"{n_layers} x {prefill_runs} prefill slices (warm-up included)")
    log(f"[main path] launches {launches}")

    # the same slices one after the other on one stream, from each job's
    # step timed alone: what the drain's two streams are held against. The
    # main path's drain was the first on its streams (their allocator pools
    # start empty); a second drain of the same slices is the warm one.
    solo = {name: time_ms(torch, srv._exec[name], 3) for name in srv.jobs}
    ran = {name: sum(n1 * (k1 == name) + n2 * (k2 == name)
                     for k1, k2, n1, n2, _ in rounds) for name in srv.jobs}
    serial_s = sum(ran[name] * solo[name] for name in srv.jobs) / 1e3
    for name, n in ran.items():
        srv.jobs[name].num_slices = n
    warm = srv.drain()
    assert warm["rounds"] == rounds
    log("[serve] step alone: " + ", ".join(
        f"{name} {solo[name]:.3f} ms x {ran[name]} slices" for name in
        srv.jobs) + f"; serial sum {serial_s:.4f} s; drain wall_s first "
        f"{res['wall_s']:.4f} (drain/serial {res['wall_s'] / serial_s:.4f}),"
        f" warm {warm['wall_s']:.4f} (drain/serial "
        f"{warm['wall_s'] / serial_s:.4f})")
    from torch.profiler import ProfilerActivity, profile
    for name in srv.jobs:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            srv._exec[name]()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in evs)
        assert total > 0, f"{name}: the profiler saw no device time"
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
        log(f"[profile {name}] device time {total / 1e3:.3f} ms in "
            f"{sum(e.count for e in evs)} kernels; top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                f"x{e.count}" for e in top))

    # ---- phase 4: results ------------------------------------------------
    kernels = []
    for name in ("sliced_matmul", "coschedule", "flash_attention"):
        row = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        **{k: row[k] for k in ("one_launch_ms", "serial_ms",
                                               "rel_err", "row_rel_err")
                           if k in row}})
    for row in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(row[key]), (row["name"], key)
    log(f"[total] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
