"""The program's spans in a profiler trace (``kbench.spans``) and the four
readers that take them, on synthetic traces and in a traced run at toy
size."""
from __future__ import annotations

import json
import time

import pytest

from kbench import harness, spans, trace
from kbench.tests import tiny
from kbench.tests.test_kbench_metrics import _events, _read, _rec

SPAN_READERS = ("decode_launches", "decode_device_ms", "idle_in_step",
                "decide_ms")


def _load(events, tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_loading_a_span_reader_makes_summarize_add_spans(name, monkeypatch):
    monkeypatch.setattr(trace, "summarize", spans._summarize)
    harness._reader(name)
    assert trace.summarize is spans.summarize


def test_summarize_keeps_every_key_it_had(tmp_path):
    """The program's spans add one key; the rest read as before on the
    same events, and a trace with no program span has none."""
    events = _load(_events(), tmp_path)
    s = spans.summarize(events)
    assert s.pop("spans") == {}
    assert s == spans._summarize(events)
    assert spans.summarize([]) is None


def _span_events():
    """One marked drain [0, 100) whose program spans hold a plan, a
    decision, a round of two decode steps and a prefill step, and a sync;
    runtime and driver calls tied to their device operations by
    ``correlation``. Busy: [15, 25), [26, 28), [45, 55), [58, 60),
    [74, 80), [88, 89)."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    def launch(ts, corr, api="cudaLaunchKernel", cat="cuda_runtime",
               tid=1):
        return x(cat, api, ts, 1, tid, correlation=corr)

    def kernel(ts, dur, corr):
        return x("kernel", f"k{corr}", ts, dur, 7, stream=7,
                 correlation=corr)
    return [
        x("user_annotation", trace.SPAN, 0, 100),
        x("user_annotation", "serve.drain", 2, 96),
        x("user_annotation", "serve.plan", 3, 5),
        x("user_annotation", "serve.decide", 8, 2),
        x("user_annotation", "serve.round", 10, 80),
        x("user_annotation", "serve.step.decode", 10, 30),
        x("user_annotation", "model.mixer", 12, 18),
        x("user_annotation", "serve.step.decode", 40, 30),
        x("user_annotation", "serve.step.prefill", 70, 15),
        x("user_annotation", "serve.sync", 85, 5),
        x("user_annotation", "serve.drain", 150, 10),   # outside the window
        x("user_annotation", "elsewhere", 20, 10, tid=2),
        launch(12, 1), kernel(15, 10, 1),
        launch(20, 5, "cuLaunchKernel", "cuda_driver"), kernel(26, 2, 5),
        # a graph launch: one call, three kernels
        launch(42, 2, "cudaGraphLaunch"), kernel(45, 5, 2), kernel(50, 5, 2),
        kernel(58, 2, 2),
        launch(44, 3, "cudaEventRecord"),               # no device operation
        launch(72, 4), kernel(74, 6, 4),
        launch(50, 6, tid=2), kernel(88, 1, 6),         # another thread's
    ]


def test_summarize_reads_the_program_spans(tmp_path):
    s = spans.summarize(_load(_span_events(), tmp_path))
    assert s["busy_s"] == pytest.approx(31e-6)
    sp = s["spans"]
    assert set(sp) == {"serve.drain", "serve.plan", "serve.decide",
                       "serve.round", "serve.step.decode",
                       "serve.step.prefill", "serve.sync", "model.mixer"}

    def check(name, count, host, idle, launches, device):
        got = sp[name]
        assert got["count"] == count, name
        assert got["host_s"] == pytest.approx(host * 1e-6), name
        assert got["idle_s"] == pytest.approx(idle * 1e-6), name
        assert got["launches"] == launches, name
        assert got["device_s"] == pytest.approx(device * 1e-6), name
    # idle in [10, 70): [10, 15), [25, 26), [28, 45), [55, 58), [60, 70)
    check("serve.step.decode", 2, 60, 36, 3, 24)
    check("serve.step.prefill", 1, 15, 9, 1, 6)
    check("model.mixer", 1, 18, 6, 2, 12)
    check("serve.drain", 1, 96, 65, 4, 30)
    check("serve.plan", 1, 5, 5, 0, 0)
    check("serve.sync", 1, 5, 4, 0, 0)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert "no host event" not in gaps
    rec = _rec(trace=s)
    assert _read("decode_launches", rec) == pytest.approx(1.5)
    assert _read("decode_device_ms", rec) == pytest.approx(0.012)
    assert _read("idle_in_step", rec) == pytest.approx(45.0)
    assert _read("idle_in_step", rec) <= _read("device_idle", rec)
    assert _read("decide_ms", rec) == pytest.approx(0.007)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_without_their_spans(name, tmp_path):
    assert _read(name, _rec()) is None
    # a summary without the key, as trace.summarize alone gives it
    assert _read(name, _rec(trace=spans._summarize(
        _load(_events(), tmp_path)))) is None
    assert _read(name, _rec(trace=spans.summarize(
        _load(_events(), tmp_path)))) is None
    events = [e for e in _span_events()
              if not e["name"].startswith("serve.")]
    assert _read(name, _rec(trace=spans.summarize(
        _load(events, tmp_path)))) is None


def test_a_traced_run_reports_the_scheduler_spans(tmp_path, monkeypatch):
    """On the CPU the profiled drains hold the port's spans and no device
    work: ``decide_ms`` reads, the device span metrics find nothing."""
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))
    res = harness.run_cell(tiny.cell(tiny.DENSE, metrics=("per_layer",)),
                           2**31 + 101, 0.3, True, "cpu",
                           time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["decide_ms"]["value"] > 0
    for name in ("decode_launches", "decode_device_ms", "idle_in_step"):
        assert name not in res["metrics"], name
