"""d2_roofline on synthetic traces at dsv2lite-mixed's shape."""
from __future__ import annotations

import json

import pytest

from kbench import harness, work
from kbench.metrics import d2_roofline

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _rec(kernels):
    cell = harness.load_cell("dsv2lite-mixed", trace=True)
    return {"cell": cell.name, "model": cell.config["model"],
            "tenants": cell.traffic["tenants"],
            "trace": {"kernels": kernels}}


def test_the_bytes_of_one_call_at_the_cells_shape():
    """48 sequences x 8193 rows of 512 + 64 bf16 latents: 453.04 MB, which
    bounds the call at 0.1352 ms (13.7 GFLOP take 0.0138 ms)."""
    rec = _rec({})
    dec = rec["tenants"][1]
    rows = work.decode_position(dec["seq"]) + 1
    assert (dec["batch"], rows) == (48, 8193)
    flops, nbytes = d2_roofline.call_work(48, rec["model"]["num_heads"], rows,
                                          rec["model"]["mla"])
    assert nbytes == 453_040_128
    assert flops == pytest.approx(13.69e9, rel=1e-3)
    ms, by = work.bound(flops, nbytes, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.13524, rel=1e-4)


def test_the_share_reads_the_kernel_and_its_merge_a_call():
    """27 calls of 0.160 ms and their merges of 0.010 ms: 0.170 ms a call."""
    rec = _rec({"mla_decode_kernel": [27 * 160e-6, 27],
                "mla_combine_kernel": [27 * 10e-6, 27],
                "void decode_attention_kernel<4, 1>(...)": [1.0, 5]})
    bound = 453_040_128 / work.HBM_BYTES_PER_S * 1e3
    assert harness._reader("d2_roofline")(rec) == \
        pytest.approx(100 * bound / 0.170)


def test_no_d2_kernel_no_share():
    assert d2_roofline.read(_rec({"flash_fwd_wgmma_kernel<192>": [1.0, 3]})) \
        is None
    assert d2_roofline.read(dict(_rec({}), trace=None)) is None


def test_the_entry_is_listed_for_dsv2lite_mixed_only():
    entry, = (m for m in BENCH["per_layer"] if m["name"] == "d2_roofline")
    assert entry["workloads"] == ["dsv2lite-mixed"]
    assert entry["moves"] == "tokens_per_s" and entry["unit"] == "%"
    assert entry["source"] == "device_trace" and entry["better"] == "higher"
