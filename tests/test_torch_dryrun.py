"""The port's dry run (``repro_torch.launch.dryrun``): ``run_cell`` on
reduced configs writes a record with the counted FLOPs, per-device argument
bytes and the analytic costs beside them (the counterpart of
``tests/test_integration.py``'s dry run on a host mesh), a failing override
writes a failed record, and the EP cell's all-to-all bytes follow its send
buffers."""
import dataclasses
import json

import pytest

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.models import sharding as SH


@pytest.fixture
def reduced_cells(monkeypatch):
    """``run_cell`` on reduced configs, train_4k cut to 4 x 64 tokens."""
    monkeypatch.setattr(DR, "get_config", lambda a: reduced(get_config(a)))
    monkeypatch.setitem(DR.SHAPES, "train_4k", dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=4))


@pytest.mark.parametrize("arch,shape,layout", [
    ("stablelm-3b", "train_4k", "fsdp"),
    ("deepseek-v2-236b", "decode_32k", "2d")])
def test_run_cell_writes_a_record(tmp_path, reduced_cells, arch, shape,
                                  layout):
    assert DR.run_cell(arch, shape, False, str(tmp_path))
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod1.json").read_text())
    assert rec["ok"] and rec["arch"] == arch and rec["shape"] == shape
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["layout"] == layout
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["model_flops"] > 0
    # the counted FLOPs against the analytic count of the same cell
    assert abs(rec["cost"]["flops"] / rec["flops"] - 1) < 0.1, rec
    assert set(rec["not_counted"]) >= {"temp_size_in_bytes", "collectives"}
    assert "a2a" not in rec                # decode: S = 1 takes no EP
    assert DR.run_cell(arch, shape, False, str(tmp_path))      # [skip]


def test_argument_bytes_divide_by_the_shards(tmp_path, reduced_cells):
    """The same cell on both meshes: resident weights replicate over
    'data', so the 512-way mesh holds as many bytes a device as the
    256-way one, less what its 'pod' axis splits of the batch-sharded
    caches."""
    for mp in (False, True):
        assert DR.run_cell("phi3-mini-3.8b", "decode_32k", mp,
                           str(tmp_path))
    one, two = (json.loads((tmp_path / f"phi3-mini-3.8b__decode_32k__{p}"
                                       ".json").read_text())
                for p in ("pod1", "pod2"))
    assert two["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert 0 < two["memory"]["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"]
    assert two["cost"]["flops"] == one["cost"]["flops"]


def test_failing_override_writes_a_failed_record(tmp_path, reduced_cells):
    assert not DR.run_cell("stablelm-3b", "train_4k", False, str(tmp_path),
                           overrides={"no_such_field": "1"}, variant="bad")
    rec = json.loads((tmp_path / "stablelm-3b__train_4k__pod1__bad.json")
                     .read_text())
    assert rec["ok"] is False and "no_such_field" in rec["error"]
    assert "Traceback" in rec["traceback"]


def test_nested_override_reaches_the_moe(tmp_path, reduced_cells):
    assert DR.run_cell("deepseek-v2-236b", "decode_32k", False,
                       str(tmp_path), overrides={"moe.a2a_dtype": "int8"},
                       variant="int8")
    rec = json.loads((tmp_path / "deepseek-v2-236b__decode_32k__pod1__int8"
                                 ".json").read_text())
    assert rec["ok"] and rec["overrides"] == {"moe.a2a_dtype": "int8"}


def test_inapplicable_shape_writes_nothing(tmp_path):
    assert DR.run_cell("phi3-mini-3.8b", "long_500k", False, str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_ep_step_on_the_shape_only_mesh():
    """Reduced deepseek-v2's prefill on a (1, 4) shape-only mesh takes the
    EP route (every shard in this process), and its all-to-all bytes are
    the send buffers': 2 x (4, cap, D) bf16 rows and the int32 ids a MoE
    layer."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    mesh = SH.ShapeMesh(("data", "model"), (1, 4))
    assert DR.uses_ep(cfg, shape, mesh)
    assert not DR.uses_ep(cfg, SHAPES["decode_32k"], mesh)
    assert not DR.uses_ep(dataclasses.replace(cfg, moe_impl="dense"), shape,
                          mesh)
    arg_bytes, flops = DR.run_step(cfg, shape, mesh)
    assert arg_bytes > 0 and flops > 0
    a2a = DR.a2a_bytes(cfg, shape, mesh)
    tokens = 2 * 64 // 4
    cap = -(-tokens * cfg.moe.top_k * 5 // (4 * 4))      # x 1.25, ceil
    assert a2a["moe_layers"] == 1 and a2a["counted_from"]
    assert a2a["bytes"] == 2 * 4 * cap * cfg.d_model * 2 + 4 * cap * 4


@pytest.mark.parametrize("s", [32, 256])
def test_meta_scans_count_the_loops_flops(s):
    """On meta tensors ``rwkv6_chunked`` runs its chunks at once and
    ``rglru_scan`` without its loop (the dry run's 32k and 500k cells would
    spend minutes in Python steps): the same shapes, and ``FlopCounterMode``
    counts the same FLOPs forward and backward as for the loops on the
    CPU."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import recurrent as R
    b, h, n = 2, 4, 32
    counts = {}
    for dev in ("cpu", "meta"):
        g = torch.Generator().manual_seed(0)

        def mk(*shape, sign=1.0):
            t = sign * torch.rand(*shape, generator=g)
            return t.to(dev).requires_grad_()
        xs = [mk(b, s, h, n), mk(b, s, h, n), mk(b, s, h, n),
              mk(b, s, h, n, sign=-1.0), mk(h, n),
              torch.zeros(b, h, n, n, device=dev)]
        lru = [mk(b, s, 64), mk(b, s, 64, sign=-1.0),
               torch.zeros(b, 64, device=dev)]
        with FlopCounterMode(display=False) as fwd:
            out, fin = R.rwkv6_chunked(*xs, chunk=32)
            hh, last = R.rglru_scan(*lru)
        with FlopCounterMode(display=False) as bwd:
            (out.sum() + fin.sum() + hh.sum() + last.sum()).backward()
        counts[dev] = (tuple(out.shape), tuple(fin.shape), tuple(hh.shape),
                       tuple(last.shape), fwd.get_total_flops(),
                       bwd.get_total_flops(),
                       [x.grad is not None for x in xs[:5] + lru[:2]])
    assert counts["meta"] == counts["cpu"]
    assert all(counts["meta"][-1])
