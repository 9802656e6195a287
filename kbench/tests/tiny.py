"""Toy-size cells for the CPU tests: the served model at a few layers and
narrow widths, run through the same harness on the CPU's plain paths."""
from __future__ import annotations

import importlib
import json

from kbench import harness

DENSE = {"name": "tiny-dense", "arch": "phi3-mini-3.8b",
         "reference": "dense", "kernels": [],
         "model": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                   "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                   "vocab_size": 256, "rope_theta": 10000.0,
                   "dtype": "float32"}}
RWKV6 = {"name": "tiny-rwkv6", "arch": "rwkv6-1.6b", "reference": "rwkv6",
         "kernels": [],
         "model": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                   "num_kv_heads": 4, "head_dim": 16, "rwkv_head_dim": 16,
                   "d_ff": 128, "vocab_size": 256, "attention_kind": "none",
                   "pos_kind": "none", "act": "relu2", "norm": "layernorm",
                   "block_pattern": ["rwkv6"], "dtype": "float32"}}
MIXED = {"tenants": [
    {"name": "prefill", "phase": "prefill", "slices": 2, "batch": 2,
     "seq": 64},
    {"name": "decode", "phase": "decode", "slices": 4, "batch": 3,
     "seq": 64}]}
# the phi3 cells' context in a dense decode tenant's caches
PAST = {"k_std": 2.5, "v_std": 1.0, "after_std": 64.0}
DENSE_MIXED = {"tenants": [MIXED["tenants"][0],
                           dict(MIXED["tenants"][1], past=PAST)]}
DENSE_DECODE = {"tenants": DENSE_MIXED["tenants"][1:]}
# float32 against float32: the port's plain CPU path and the reference
# differ by summation order, ~1e-6 at these sizes (measured)
LIMITS = {"prefill.rel": 1e-4, "prefill.row": 1e-4, "decode.rel": 1e-4,
          "decode.row": 1e-4, "decode.state": 1e-4}
DENSE_LIMITS = dict(LIMITS, **{"decode.changed": 0})


def cell(config=DENSE, traffic=None, limits=None, dtype=None,
         metrics=("end_to_end",)) -> harness.Cell:
    config = json.loads(json.dumps(config))
    if traffic is None:
        traffic = DENSE_MIXED if config["reference"] == "dense" else MIXED
    if limits is None:
        limits = DENSE_LIMITS if config["reference"] == "dense" else LIMITS
    if dtype:
        config["model"]["dtype"] = dtype
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = [m for key in metrics for m in bench[key]]
    return harness.Cell(
        name=config["name"], chips=1, config=config, traffic=traffic,
        limits=dict(limits),
        reference=importlib.import_module(
            f"kbench.reference.{config['reference']}"),
        metrics=[(m, harness._reader(m["name"])) for m in entries])
