"""The metric readers and the trace reader on small synthetic records."""
from __future__ import annotations

import json

import pytest

from kbench import harness, trace, work


def _read(name, rec):
    return harness._reader(name)(rec)


def _rec(**kw):
    rec = {"cell": "t", "model": {"num_heads": 32, "num_kv_heads": 32,
                                  "head_dim": 96, "d_model": 3072},
           "tenants": [{"name": "prefill", "phase": "prefill", "slices": 2,
                        "batch": 1, "seq": 2048},
                       {"name": "decode", "phase": "decode", "slices": 4,
                        "batch": 8, "seq": 4096}],
           "setup_s": 12.5, "window_s": 2.0, "serial": [], "trace": None,
           "drains": [{"call_s": 0.1 * (i + 1), "wall_s": 0.1 * (i + 1)
                       - 0.001 * (i + 1), "tokens": 100, "flops": 1e12}
                      for i in range(10)]}
    rec.update(kw)
    return rec


def test_host_clock_readers():
    rec = _rec()
    assert _read("setup_s", rec) == 12.5
    assert _read("tokens_per_s", rec) == pytest.approx(500.0)
    assert _read("drain_p90_s", rec) == pytest.approx(0.9)     # 9th of 10
    assert _read("sched_ms", rec) == pytest.approx(5.5)
    assert _read("mfu", rec) == pytest.approx(
        100 * 10e12 / 5.5 / work.PEAK_FLOPS["bfloat16"])


def test_serial_pass_readers():
    rec = _rec(serial=[
        {"total_s": 0.4, "drain_wall_s": 0.38,
         "slices": [("prefill", 0.1), ("decode", 0.05)]},
        {"total_s": 0.5, "drain_wall_s": 0.45,
         "slices": [("prefill", 0.1), ("decode", 0.07)]},
        {"total_s": 0.4, "drain_wall_s": 0.44,
         "slices": [("decode", 0.06)]}])
    assert _read("coschedule_ratio", rec) == pytest.approx(0.95)
    assert _read("decode_step_ms", rec) == pytest.approx(60.0)
    solo = _rec(serial=rec["serial"], tenants=rec["tenants"][1:])
    assert _read("coschedule_ratio", solo) is None


def _events():
    """Two marked drains of 100 us; kernels on streams 7 and 8."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": 1, "args": args}
    return [
        x("user_annotation", trace.SPAN, 0, 100),
        x("user_annotation", trace.SPAN, 200, 100),
        x("cpu_op", "aten::mm", 0, 30),
        x("cuda_runtime", "cudaLaunchKernel", 12, 2),
        x("cpu_op", "aten::copy_", 60, 40),
        x("kernel", "void flash_fwd_wgmma_kernel<96>(Params)", 10, 20,
          stream=7),
        x("kernel", "void decode_attention_kernel<4, 1>(...)", 20, 20,
          stream=8),
        x("kernel", "decode_combine_kernel", 40, 5, stream=8),
        x("kernel", "void flash_fwd_wgmma_kernel<96>(Params)", 210, 20,
          stream=7),
        x("kernel", "outside", 150, 20, stream=7),
        x("gpu_memcpy", "Memcpy HtoD", 290, 20, stream=7),
    ]


def test_summarize_reads_busy_overlap_kernels_and_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    s = trace.summarize(trace.load(path))
    assert s["window_s"] == pytest.approx(200e-6)
    # [10, 45) and [210, 230), [290, 300): the kernel outside is left out
    assert s["busy_s"] == pytest.approx(65e-6)
    assert s["overlap_s"] == pytest.approx(10e-6)              # [20, 30)
    assert s["kernels"]["void flash_fwd_wgmma_kernel<96>(Params)"] == \
        pytest.approx([40e-6, 2])
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0, 10) in aten::mm; [45, 100), named at its middle, in aten::copy_;
    # [200, 210) and [230, 290) in nothing
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["aten::copy_"] == pytest.approx(55e-6)
    assert gaps["no host event"] == pytest.approx(70e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["Memcpy HtoD"] == pytest.approx(10e-6)
    rec = _rec(trace=s)
    assert _read("device_idle", rec) == pytest.approx(100 * (1 - 65 / 200))
    assert _read("stream_overlap", rec) == pytest.approx(100 * 10 / 65)
    k3 = work.bound(*work.k3_work((1, 32, 2048, 96), True), "bfloat16")[0]
    assert _read("k3_roofline", rec) == pytest.approx(100 * k3 / 0.020)
    d1 = work.bound(*work.decode_work(8, 32, 32, 2049, 96, 2),
                    "bfloat16")[0]
    assert _read("d1_roofline", rec) == pytest.approx(100 * d1 / 0.025)
    assert _read("k4_roofline", rec) is None


def test_no_trace_no_device_metrics():
    rec = _rec()
    for name in ("device_idle", "stream_overlap", "k3_roofline",
                 "d1_roofline", "k4_roofline"):
        assert _read(name, rec) is None, name
