"""The harness end to end on the CPU at toy size: a sound run is correct,
and each fault a serving cell can have, planted in the port underneath the
timed path, turns ``correct`` false. The look for a chip is skipped: the
run goes straight to the harness on the CPU."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from kbench import faults, harness
from kbench.tests import tiny

SECONDS = 0.3
SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def _store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))


def _run(cell, trace=False, control=False):
    return harness.run_cell(cell, SEED, SECONDS, trace, "cpu",
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.RWKV6],
                         ids=["dense", "rwkv6"])
def test_a_sound_run_is_correct(config):
    res = _run(tiny.cell(config))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"tokens_per_s", "drain_p90_s", "setup_s"}
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_traced_run_reports_the_host_metrics():
    res = _run(tiny.cell(tiny.DENSE, metrics=("per_layer",)), trace=True)
    assert res["correct"], res["checks"]
    for name in ("sched_ms", "coschedule_ratio", "decode_step_ms", "mfu"):
        assert res["metrics"][name]["value"] > 0, name
    # no device on the CPU: the device metrics find nothing to read
    for name in ("device_idle", "k3_roofline", "d1_roofline"):
        assert name not in res["metrics"], name
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


CASES = [(config, fault) for config in ("dense", "rwkv6")
         for fault in sorted(faults.FAULTS)
         if config == "dense" or fault not in faults.ATTENTION]


@pytest.mark.parametrize("config,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_a_planted_fault_is_not_correct(config, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    res = _run(tiny.cell(tiny.DENSE if config == "dense" else tiny.RWKV6))
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", faults.ATTENTION)
def test_an_attention_fault_fails_the_cells_limits(fault, monkeypatch):
    """In the phi3 cells' bfloat16 and with their context in the caches,
    a decode attention that is zero, drops a split, or reads past the
    last row breaks the limits the cells hold at full size."""
    faults.FAULTS[fault](monkeypatch.setattr)
    path = harness.KBENCH / "limits" / "phi3-decode-solo.json"
    cell = tiny.cell(tiny.DENSE, traffic=tiny.DENSE_DECODE, dtype="bfloat16",
                     limits=json.loads(path.read_text()))
    res = _run(cell)
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_limits():
    """The reference one precision lower (fp8 products) in the program's
    place reads above every limit of the float32 toy cell."""
    res = _run(tiny.cell(tiny.DENSE), control=True)
    assert res["correct"]
    assert all(res["control"][k] > c["limit"]
               for k, c in res["checks"].items() if c["limit"] > 0)


@pytest.mark.parametrize("config,limits", [
    (tiny.DENSE, "phi3-mixed"), (tiny.RWKV6, "rwkv6-mixed")],
    ids=["dense", "rwkv6"])
def test_the_control_fails_the_cells_limits_where_bf16_passes(config,
                                                               limits):
    """At toy size in the cells' own bfloat16, the served model keeps
    within the limits the cell holds at full size, and the control (fp8
    products) reads above at least one of them."""
    path = harness.KBENCH / "limits" / f"{limits}.json"
    cell = tiny.cell(config, dtype="bfloat16",
                     limits=json.loads(path.read_text()))
    res = _run(cell, control=True)
    assert res["correct"], res["checks"]
    assert any(res["control"][k] > c["limit"]
               for k, c in res["checks"].items())


def test_a_drain_that_raises_is_counted_and_not_correct(monkeypatch):
    from repro_torch.launch import serve
    rounds = serve.SharedPodServer._round
    calls = []

    def broken(self, pairs):       # the warm drain's round runs; then none
        calls.append(pairs)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return rounds(self, pairs)
    monkeypatch.setattr(serve.SharedPodServer, "_round", broken)
    res = _run(tiny.cell(tiny.DENSE))
    assert not res["correct"]
    assert res["failed"] > 0 and res["checks"] == {}


def test_run_py_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.KBENCH / "run.py"), "--workload",
         "phi3-mixed", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr
