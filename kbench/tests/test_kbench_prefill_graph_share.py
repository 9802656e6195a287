"""``prefill_graph_share`` on synthetic traces: the share of the port's
``serve.step.prefill`` spans that hold a ``serve.replay.prefill`` span."""
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
    """One marked drain [0, 100) of a round with two prefill steps and a
    decode step replayed in ``serve.replay``; each prefill step holds a
    ``serve.replay.prefill`` span and one graph launch where ``replayed``
    says so, else the model's spans and two kernel launches."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    events = [x("user_annotation", trace.SPAN, 0, 100),
              x("user_annotation", "serve.drain", 2, 96),
              x("user_annotation", "serve.round", 10, 80),
              x("user_annotation", "serve.step.decode", 70, 15),
              x("user_annotation", "serve.replay", 71, 5),
              x("cuda_runtime", "cudaGraphLaunch", 72, 1, correlation=9),
              x("kernel", "d1", 74, 6, 7, correlation=9)]
    for i, start in enumerate((10, 40)):
        events.append(x("user_annotation", "serve.step.prefill", start, 30))
        if replayed[i]:
            events += [
                x("user_annotation", "serve.replay.prefill", start + 1, 5),
                x("cuda_runtime", "cudaGraphLaunch", start + 2, 1,
                  correlation=i + 1),
                x("kernel", "k3", start + 5, 10, 7, correlation=i + 1),
                x("kernel", "gemm", start + 15, 5, 7, correlation=i + 1)]
        else:
            events += [
                x("user_annotation", "model.mixer", start + 1, 20),
                x("cuda_runtime", "cudaLaunchKernel", start + 2, 1,
                  correlation=i + 1),
                x("cuda_runtime", "cudaLaunchKernel", start + 10, 1,
                  correlation=i + 3),
                x("kernel", "k3", start + 5, 5, 7, correlation=i + 1),
                x("kernel", "gemm", start + 12, 5, 7, correlation=i + 3)]
    return events


@pytest.mark.parametrize("replayed,share", [((True, True), 100.0),
                                            ((True, False), 50.0),
                                            ((False, False), 0.0)])
def test_the_share_of_prefill_steps_replayed(replayed, share, tmp_path):
    rec = _rec(trace=spans.summarize(_load(_drain(replayed), tmp_path)))
    assert _read("prefill_graph_share", rec) == pytest.approx(share)
    # the decode step's replay is decode_graph_share's, never this one's
    assert _read("decode_graph_share", rec) == pytest.approx(100.0)


def test_no_spans_read_nothing(tmp_path):
    assert _read("prefill_graph_share", _rec()) is None
    # a summary without the key, as trace.summarize alone gives it
    assert _read("prefill_graph_share", _rec(trace=spans._summarize(
        _load(_events(), tmp_path)))) is None
    # spans, but no prefill step among them
    assert _read("prefill_graph_share", _rec(trace=spans.summarize(
        _load(_events(), tmp_path)))) is None
    events = [e for e in _drain((True, True))
              if e["name"] != "serve.step.prefill"]
    assert _read("prefill_graph_share", _rec(trace=spans.summarize(
        _load(events, tmp_path)))) is None


def test_the_reader_is_listed_in_the_cells_with_a_prompt():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "prefill_graph_share"]
    cells = {w["name"]: w["traffic"] for w in bench["workloads"]}
    prompted = {
        name for name, traffic in cells.items()
        if any(t["phase"] == "prefill" for t in json.loads(
            (harness.KBENCH / "workloads" / f"{traffic}.json").read_text())
            ["tenants"])}
    assert set(entry["workloads"]) == prompted == {
        "phi3-mixed", "rwkv6-mixed", "dsv2lite-mixed", "mellum2-mixed",
        "phi3-prefill-solo"}
    assert entry["layer"] == "models/transformer.py forward (prefill step)"
    assert (entry["source"], entry["moves"], entry["unit"]) == \
        ("program_span", "tokens_per_s", "%")
