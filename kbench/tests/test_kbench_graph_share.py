"""``decode_graph_share`` on synthetic traces: the share of the port's
``serve.step.decode`` spans that hold a ``serve.replay`` span."""
from __future__ import annotations

import json

import pytest

from kbench import harness, spans, trace
from kbench.tests.test_kbench_metrics import _events, _read, _rec


def _load(events, tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def _drain(replayed):
    """One marked drain [0, 100) of a round with two decode steps and a
    prefill step; each decode step holds a ``serve.replay`` span and one
    graph launch where ``replayed`` says so, else the model's spans and
    two kernel launches."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    events = [x("user_annotation", trace.SPAN, 0, 100),
              x("user_annotation", "serve.drain", 2, 96),
              x("user_annotation", "serve.round", 10, 80),
              x("user_annotation", "serve.step.prefill", 70, 15),
              x("cuda_runtime", "cudaLaunchKernel", 72, 1, correlation=9),
              x("kernel", "k9", 74, 6, 7, correlation=9)]
    for i, start in enumerate((10, 40)):
        events.append(x("user_annotation", "serve.step.decode", start, 30))
        if replayed[i]:
            events += [
                x("user_annotation", "serve.replay", start + 1, 5),
                x("cuda_runtime", "cudaGraphLaunch", start + 2, 1,
                  correlation=i + 1),
                x("kernel", "d1", start + 5, 10, 7, correlation=i + 1),
                x("kernel", "gemm", start + 15, 5, 7, correlation=i + 1)]
        else:
            events += [
                x("user_annotation", "model.mixer", start + 1, 20),
                x("cuda_runtime", "cudaLaunchKernel", start + 2, 1,
                  correlation=i + 1),
                x("cuda_runtime", "cudaLaunchKernel", start + 10, 1,
                  correlation=i + 3),
                x("kernel", "d1", start + 5, 5, 7, correlation=i + 1),
                x("kernel", "gemm", start + 12, 5, 7, correlation=i + 3)]
    return events


@pytest.mark.parametrize("replayed,share", [((True, True), 100.0),
                                            ((True, False), 50.0),
                                            ((False, False), 0.0)])
def test_the_share_of_decode_steps_replayed(replayed, share, tmp_path):
    rec = _rec(trace=spans.summarize(_load(_drain(replayed), tmp_path)))
    assert _read("decode_graph_share", rec) == pytest.approx(share)


def test_no_spans_read_nothing(tmp_path):
    assert _read("decode_graph_share", _rec()) is None
    # a summary without the key, as trace.summarize alone gives it
    assert _read("decode_graph_share", _rec(trace=spans._summarize(
        _load(_events(), tmp_path)))) is None
    # spans, but no decode step among them
    assert _read("decode_graph_share", _rec(trace=spans.summarize(
        _load(_events(), tmp_path)))) is None
    events = [e for e in _drain((True, True))
              if e["name"] != "serve.step.decode"]
    assert _read("decode_graph_share", _rec(trace=spans.summarize(
        _load(events, tmp_path)))) is None


def test_the_reader_is_listed_in_the_decode_cells():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "decode_graph_share"]
    assert {"phi3-mixed", "rwkv6-mixed", "phi3-decode-solo"} \
        <= set(entry["workloads"])
    assert entry["layer"] == "models/transformer.py decode_step"
