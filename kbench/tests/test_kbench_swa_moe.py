"""The sliding-window + MoE reference (``kbench/reference/swa_moe.py``)
against the port's CPU path at toy size, float32 both sides, on the same
weights (``kbench.weights``) and tokens; the context ``fill_past`` writes
and ``program_state`` reads back; its weights' layout against the port's;
its FLOPs against their formula; ``k3w_roofline``'s work at the cell's
shape; and one sound run of the harness on it. The port is imported here;
the reference never imports it."""
from __future__ import annotations

import importlib.util
import json
import time

import pytest
import torch

from kbench import harness, weights, work
from kbench.reference import swa_moe
from kbench.reference.common import Precision
from kbench.tests import tiny

# Mellum2's block at toy widths: 8 layers (two periods of three window
# layers and one full), GQA 4 / 2, a window of 8, YaRN at the published
# factors on the full layers (a rope of 16 dims: its ramp runs from pair 2
# to 5), 8 experts, top-2, renormalised
SWA_MOE = {"name": "tiny-swa-moe", "arch": "mellum2-12b-a2.5b",
           "reference": "swa_moe", "kernels": [],
           "model": {"num_layers": 8, "d_model": 64, "num_heads": 4,
                     "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                     "vocab_size": 256, "local_window": 8,
                     "rope_theta": 500000.0,
                     "rope_scaling": {"type": "yarn", "factor": 16,
                                      "original_max_position_embeddings":
                                      8192, "beta_fast": 32, "beta_slow": 1,
                                      "mscale": 1, "mscale_all_dim": 1},
                     "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
                             "num_shared_experts": 0, "first_dense_layers": 0,
                             "capacity_factor": 0, "norm_topk_prob": True},
                     "block_pattern": ["local", "local", "local", "attn"],
                     "dtype": "float32"}}
# the cell's context: keys of std 1.5, values of 1 before t
PAST = {"k_std": 1.5, "v_std": 1.0, "after_std": 64.0}
# float32 against float32: the port's plain CPU path and the reference
# differ by summation order (~1e-6 measured); routing near a tie could
# flip, which these sizes and seeds do not reach
TOL = 1e-4
SEED = 2**31 + 47


def _setup(seed=SEED, **model):
    m = dict(SWA_MOE["model"], **model)
    tree = weights.build(swa_moe.leaves(m), seed, "cpu")
    return m, tree, harness.port_config(dict(SWA_MOE, model=m))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _tokens(m, b, s):
    return torch.as_tensor(harness.tenant_tokens(m["vocab_size"], b, s)
                           ).long()


def _prefill(tree, m, toks):
    return swa_moe.prefill(swa_moe.prepare(tree, m, Precision()), m, toks,
                           Precision())


@pytest.mark.parametrize("batch", [2, 3], ids=["static", "read-back"])
def test_prefill_matches_the_port(batch):
    """128 prompt tokens route in buckets as deep as the tokens, 192 in
    buckets of a depth chosen from the counts read back; both keep every
    pair."""
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    toks = _tokens(m, batch, 64)
    got, _, _ = T.forward(tree, cfg, {"tokens": toks})
    want = _prefill(tree, m, toks)
    assert _rel(got, want) < TOL
    # YaRN's frequencies and softmax gain, and the window, enter it
    assert _rel(_prefill(tree, dict(m, rope_scaling=None), toks), want) > 1e-3
    for w in (7, 9):
        assert _rel(_prefill(tree, dict(m, local_window=w), toks), want) \
            > 100 * TOL


def test_decode_over_a_written_context_matches_the_port():
    """The full layers' rows and the rings' slots set-up writes are read
    back by the reference, in blocks of sequences, and the port's decode
    through both cache kinds gives its logits, the full caches' row t and
    the rings' slot t mod W."""
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    b, seq, steps = swa_moe.DECODE_BLOCK + 3, 64, 3
    t = seq // 2
    tok = _tokens(m, b, seq)[:, 0]
    caches = T.init_decode_caches(cfg, b, seq, device="cpu")
    swa_moe.fill_past(caches, m, t, PAST, SEED)
    for _ in range(steps):
        got, _ = T.decode_step(tree, cfg, caches, tok, t)
    w = swa_moe.prepare(tree, m, Precision())
    want, state = swa_moe.decode(w, m, tok, t, steps, Precision(), PAST,
                                 SEED)
    assert _rel(got, want) < TOL
    zero, _ = swa_moe.decode(w, m, tok, t, steps, Precision())
    assert _rel(zero, want) > 0.1             # the context is read
    prog, exact = swa_moe.program_state(caches, m, t, PAST, SEED)
    assert set(prog) == set(state) == set(swa_moe.STATE) and exact == {}
    assert prog["k"].shape == (2, b, 2, 16)
    assert prog["ring_v"].shape == (6, b, 2, 16)
    for key, value in state.items():
        assert prog[key].shape == value.shape
        assert _rel(prog[key], value) < TOL, key
    # a row after t is far larger than any read: the step reads none
    assert float(caches["stage0"]["sub3"]["k"][:, :, t + 1:].abs().max()) \
        > 100


def test_fill_past_and_program_state_round_trip():
    """Before any step the rings hold the positions t - W .. t - 1 (slot t
    mod W the stale t - W, drawn as a row no step reads), the full caches
    every row but t, and ``program_state`` reads back what was drawn
    there."""
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    b, seq, t, w = 2, 64, 37, 8
    caches = T.init_decode_caches(cfg, b, seq, device="cpu")
    swa_moe.fill_past(caches, m, t, PAST, SEED)
    ring = caches["stage0"]["sub1"]
    assert ring["pos"].shape == (2, w)          # two repeats of the period
    assert sorted(ring["pos"][0].tolist()) == list(range(t - w, t))
    assert int(ring["pos"][0, t % w]) == t - w
    for slot, p in enumerate(ring["pos"][1].tolist()):
        assert p % w == slot
    full = caches["stage0"]["sub3"]["v"][0]
    drawn = swa_moe.past_rows(m, PAST, SEED, 3, "v", "before",
                              (b, t, 2, 16), "cpu")
    assert torch.equal(full[:, :t], drawn)
    assert not full[:, t].any()                # row t is the step's
    state, _ = swa_moe.program_state(caches, m, t, PAST, SEED)
    assert torch.equal(state["k"][0], caches["stage0"]["sub3"]["k"][0, :, t])
    stale = swa_moe.past_rows(m, PAST, SEED, 4, "k", "after", (b, 2, 16),
                              "cpu")
    assert torch.equal(state["ring_k"][3], stale)        # layer 4's slot
    assert torch.equal(caches["stage0"]["sub0"]["k"][1, :, t % w], stale)
    assert float(state["ring_k"].abs().max()) > 100


def test_the_leaves_load_into_the_port():
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    port = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mine, theirs = {}, {}

    def flat(tree, out, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, out, prefix + (k,))
            else:
                out[prefix + (k,)] = tuple(v.shape)
    flat(tree, mine)
    flat(port, theirs)
    assert mine == theirs
    stacks, order = swa_moe.stages(m)
    assert stacks == [
        (("stage0", "sub0"), "local", 2), (("stage0", "sub1"), "local", 2),
        (("stage0", "sub2"), "local", 2), (("stage0", "sub3"), "attn", 2)]
    assert order[7] == (("stage0", "sub3"), 1)
    with pytest.raises(ValueError, match="whole periods"):
        swa_moe.stages(dict(m, num_layers=6))


def test_slice_flops_is_its_formula():
    m = SWA_MOE["model"]
    d, h, kv, hd, w = 64, 4, 2, 16, 8
    active = 8 * (2 * d * h * hd + 2 * d * kv * hd + d * 8
                  + 2 * 3 * d * 32) + d * 256
    assert swa_moe.active_params(m) == active
    window = sum(min(q + 1, w) for q in range(64))
    assert swa_moe.slice_flops(m, "prefill", 2, 64) == \
        2.0 * active * 128 + 4.0 * h * hd * 2 * (2 * 64 * 65 / 2 + 6 * window)
    assert swa_moe.slice_flops(m, "decode", 5, 64) == \
        2.0 * active * 5 + 4.0 * h * hd * 5 * (2 * 33 + 6 * 8)
    # at the published sizes: the port's 2.44 B active parameters less the
    # embedding's 0.23 B, which a token looks up and does not multiply by
    full = json.loads((harness.KBENCH / "configs"
                       / "mellum2-12b-a2.5b.json").read_text())["model"]
    assert swa_moe.active_params(full) == pytest.approx(2.21e9, rel=0.01)


def test_k3w_roofline_counts_the_cells_window():
    """One windowed call at the cell's (1, 32, 16384, 128), W 1024: 4 D H
    (1024 x 1025 / 2 + 15360 x 1024) = 266.3 GFLOP by hand, 0.269 ms on
    the tensor cores; its q and o at 32 heads and k and v at 4 are 302 MB,
    0.090 ms, so it is bound by its operations."""
    spec = importlib.util.spec_from_file_location(
        "k3w", harness.KBENCH / "metrics" / "k3w_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flops, nbytes = mod.call_work((1, 32, 16384, 128), 1024, 4)
    assert flops == 4 * 128 * 32 * (1024 * 1025 // 2 + 15360 * 1024)
    assert flops == pytest.approx(266.3e9, rel=1e-3)
    assert nbytes == 2 * (32 + 4) * 16384 * 128 * 2
    ms, kind = work.bound(flops, nbytes, "bfloat16")
    assert (round(ms, 3), kind) == (0.269, "operations")
    # a window past the prompt is the causal count
    assert mod.call_work((1, 2, 64, 16), 100, 2)[0] == \
        work.k3_work((1, 2, 64, 16), True)[0]
    full = {"void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(...)":
            [7 * 2e-3, 7]}
    both = dict(full, **{
        "void (anonymous namespace)::flash_fwd_window_kernel<128>(...)":
            [21 * 0.5e-3, 21]})
    rec = {"trace": {"kernels": both},
           "model": {"num_heads": 32, "num_kv_heads": 4, "head_dim": 128,
                     "local_window": 1024},
           "tenants": [{"phase": "prefill", "batch": 1, "seq": 16384}]}
    read = harness._reader("k3w_roofline")
    assert read(rec) == pytest.approx(100 * ms / 0.5)
    # k3_roofline reads the full calls alone, the windowed ones beside them
    k3 = harness._reader("k3_roofline")
    assert k3(rec) == k3(dict(rec, trace={"kernels": full}))
    rec["trace"] = {"kernels": full}
    assert read(rec) is None               # no windowed call: nothing


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))
    traffic = {"tenants": [
        {"name": "prefill", "phase": "prefill", "slices": 2, "batch": 1,
         "seq": 64},
        {"name": "decode", "phase": "decode", "slices": 4, "batch": 3,
         "seq": 64, "past": PAST}]}
    limits = {k: v for k, v in tiny.LIMITS.items()}
    cell = tiny.cell(SWA_MOE, traffic=traffic, limits=limits)
    res = harness.run_cell(cell, SEED, 0.3, False, "cpu",
                           time.perf_counter(), control=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(limits)
    # the control, every product through fp8, is far off
    assert max(res["control"].values()) > 100 * TOL


def _span(count, device_s=0.0):
    return {"count": count, "host_s": 0.0, "idle_s": 0.0, "launches": 0,
            "device_s": device_s}


def test_the_window_reader():
    """Per prefill step, and nothing where the program marks no window
    layer (a parent without the span) or ran no device."""
    found = {"serve.step.prefill": _span(6),
             "model.window": _span(126, device_s=0.03)}
    rec = {"trace": {"busy_s": 1.0, "window_s": 2.0, "spans": found}}
    read = harness._reader("window_prefill_ms")
    assert read(rec) == pytest.approx(5.0)
    bare = {"serve.step.prefill": found["serve.step.prefill"]}
    assert read({"trace": dict(rec["trace"], spans=bare)}) is None
    assert read({"trace": dict(rec["trace"], busy_s=0.0)}) is None
    assert read({"trace": None}) is None
