"""The frozen work counts, pinned to the bounds the port's kernels were
held to on the card (PERF.md's table of kernels), and the FLOPs a drain
counts for ``mfu``."""
from __future__ import annotations

import json

import pytest

from kbench import harness, work
from kbench.reference import dense, rwkv6


def _model(name):
    path = harness.KBENCH / "configs" / f"{name}.json"
    return json.loads(path.read_text())["model"]


def test_k3_bound_at_phi3_prefill():
    ms, what = work.bound(*work.k3_work((1, 32, 2048, 96), True), "bfloat16")
    assert (round(ms, 4), what) == (0.0261, "operations")


def test_d1_bound_at_phi3_decode():
    flops, nbytes = work.decode_work(8, 32, 32, 2049, 96, 2)
    ms, what = work.bound(flops, nbytes, "bfloat16")
    assert (round(ms, 4), what, round(nbytes / 1e6, 1)) == \
        (0.0602, "bytes", 201.6)


def test_k4_bound_at_rwkv6_prefill():
    products, other, nbytes = work.wkv6_work(4, 2048, 32, 64, 2)
    ms, what = work.wkv6_bound_ms(products, other, nbytes)
    assert (round(ms, 4), what, round(nbytes / 1e6, 1)) == \
        (0.0714, "bytes", 239.1)


def test_slice_flops_from_the_shapes():
    m = _model("phi3-mini-3.8b")
    per_layer = 4 * 3072 * 3072 + 3 * 3072 * 8192
    dense_part = 2.0 * (32 * per_layer + 3072 * 32064) * 2048
    attn = 32 * 4.0 * 32 * 96 * (2048 * 2049 // 2)
    assert dense.slice_flops(m, "prefill", 1, 2048) == \
        pytest.approx(dense_part + attn, rel=1e-12)
    assert dense.slice_flops(m, "decode", 8, 4096) == pytest.approx(
        2.0 * (32 * per_layer + 3072 * 32064) * 8
        + 32 * 4.0 * 32 * 96 * 8 * 2049, rel=1e-12)
    r = _model("rwkv6-1.6b")
    assert rwkv6.slice_flops(r, "prefill", 4, 2048) / 1e12 == \
        pytest.approx(22.467, abs=1e-3)
    assert rwkv6.slice_flops(r, "decode", 32, 4096) / 1e9 == \
        pytest.approx(87.711, abs=1e-3)


def test_tokens_a_slice():
    assert work.slice_tokens("prefill", 4, 2048) == 8192
    assert work.slice_tokens("decode", 32, 4096) == 32
    assert work.decode_position(4096) == 2048
