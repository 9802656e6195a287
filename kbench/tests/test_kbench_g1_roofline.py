"""g1_roofline on synthetic traces at dsv2lite-mixed's shape."""
from __future__ import annotations

import json

import pytest

from kbench import harness, work
from kbench.metrics import g1_roofline

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _rec(kernels):
    cell = harness.load_cell("dsv2lite-mixed", trace=True)
    return {"cell": cell.name, "model": cell.config["model"],
            "tenants": cell.traffic["tenants"],
            "trace": {"kernels": kernels}}


def test_the_work_of_one_layer_at_the_cells_shape():
    """4096 tokens x top-6 pairs x 3 products of 2048 x 1408: 425.2
    GFLOP, 0.430 ms at 989 TFLOP/s, above the 1.107 GB of experts and the
    pairs' 201 MB of rows in and out (0.390 ms)."""
    rec = _rec({})
    pre = rec["tenants"][0]
    assert (pre["phase"], pre["batch"], pre["seq"]) == ("prefill", 1, 4096)
    flops, nbytes = g1_roofline.call_work(4096, rec["model"])
    assert flops == pytest.approx(425.2e9, rel=1e-4)
    assert 3 * 64 * 2048 * 1408 * 2 == pytest.approx(1.107e9, rel=1e-3)
    assert nbytes == 3 * 64 * 2048 * 1408 * 2 + 2 * 4096 * 6 * 2048 * 2
    ms, by = work.bound(flops, nbytes, "bfloat16")
    assert by == "operations" and ms == pytest.approx(0.42995, rel=1e-4)


def test_the_share_reads_both_kernels_a_call():
    """52 calls (26 MoE layers x 2 prompts) of 0.55 ms gate/up and 0.30 ms
    down: 0.85 ms a call; the down kernel's launches are not calls."""
    rec = _rec({"(anonymous namespace)::grouped_gate_up_kernel(...)":
                [52 * 550e-6, 52],
                "(anonymous namespace)::grouped_down_kernel(...)":
                [52 * 300e-6, 52],
                "mla_decode_kernel": [1.0, 27]})
    bound = 425.2e9 / work.PEAK_FLOPS["bfloat16"] * 1e3
    assert harness._reader("g1_roofline")(rec) == \
        pytest.approx(100 * bound / 0.85, rel=1e-4)


def test_no_g1_kernel_no_share():
    """The parent's trace (the bucketed products) reads nothing."""
    assert g1_roofline.read(_rec({"nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT":
                                  [1.0, 400]})) is None
    assert g1_roofline.read(dict(_rec({}), trace=None)) is None


def test_the_entry_is_listed_for_dsv2lite_mixed_only():
    entry, = (m for m in BENCH["per_layer"] if m["name"] == "g1_roofline")
    assert entry["workloads"] == ["dsv2lite-mixed"]
    assert entry["moves"] == "tokens_per_s" and entry["unit"] == "%"
    assert entry["source"] == "device_trace" and entry["better"] == "higher"
    assert entry["layer"] == "models/moe.py routed experts (dropless route)"
