"""The MLA + MoE reference (``kbench/reference/mla_moe.py``) against the
port's CPU path at toy size, float32 both sides, on the same weights
(``kbench.weights``) and tokens; its weights' layout against the port's;
its FLOPs against their formula; and one sound run of the harness on it.
The port is imported here; the reference never imports it."""
from __future__ import annotations

import json
import time

import pytest
import torch

from kbench import harness, weights
from kbench.reference import mla_moe
from kbench.reference.common import Precision
from kbench.tests import tiny

# DeepSeek-V2-Lite's block at toy widths: a direct query projection, YaRN
# at the published factors (a rope of 8 dims: its ramp runs from pair 1 to
# 3), one dense layer, then MoE layers of 8 experts, top-2, 2 shared
MLA_MOE = {"name": "tiny-mla-moe", "arch": "deepseek-v2-lite",
           "reference": "mla_moe", "kernels": [],
           "model": {"num_layers": 3, "d_model": 64, "num_heads": 4,
                     "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                     "vocab_size": 256, "rope_theta": 10000.0,
                     "mla": {"kv_lora_rank": 32, "q_lora_rank": 0,
                             "qk_nope_dim": 16, "qk_rope_dim": 8,
                             "v_head_dim": 16},
                     "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
                             "num_shared_experts": 2, "first_dense_layers": 1,
                             "capacity_factor": 0, "norm_topk_prob": False},
                     "rope_scaling": {"type": "yarn", "factor": 40,
                                      "original_max_position_embeddings":
                                      4096, "beta_fast": 32, "beta_slow": 1,
                                      "mscale": 0.707,
                                      "mscale_all_dim": 0.707},
                     "dtype": "float32"}}
# the cell's context: latents and rope keys of std 1.5 before t
PAST = {"ckv_std": 1.5, "krope_std": 1.5, "after_std": 64.0}
# float32 against float32: the port's plain CPU path and the reference
# differ by summation order and the latent-space decode (~1e-6 measured);
# routing near a tie could flip, which these sizes and seeds do not reach
TOL = 1e-4
SEED = 2**31 + 43


def _setup(seed=SEED):
    m = MLA_MOE["model"]
    tree = weights.build(mla_moe.leaves(m), seed, "cpu")
    return m, tree, harness.port_config(MLA_MOE)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _tokens(m, b, s):
    return torch.as_tensor(harness.tenant_tokens(m["vocab_size"], b, s)
                           ).long()


@pytest.mark.parametrize("batch", [2, 3], ids=["static", "read-back"])
def test_prefill_matches_the_port(batch):
    """128 prompt tokens route in buckets as deep as the tokens, 192 in
    buckets of a depth chosen from the counts read back; both keep every
    pair."""
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    toks = _tokens(m, batch, 64)
    got, _, _ = T.forward(tree, cfg, {"tokens": toks})
    want = mla_moe.prefill(mla_moe.prepare(tree, m, Precision()), m, toks,
                           Precision())
    assert _rel(got, want) < TOL
    # the softmax gain and YaRN's frequencies both enter the reference
    plain = dict(m, rope_scaling=None)
    other = mla_moe.prefill(mla_moe.prepare(tree, plain, Precision()), plain,
                            toks, Precision())
    assert _rel(other, want) > 1e-2


def test_decode_over_a_written_context_matches_the_port():
    """The latents and rope keys set-up writes are read back by the
    reference's expanded decode, in blocks of sequences, and the port's
    latent-space decode gives its logits and the cache rows t."""
    from repro_torch.models import transformer as T
    m, tree, cfg = _setup()
    b, seq, steps = mla_moe.DECODE_BLOCK + 3, 64, 3
    t = seq // 2
    tok = _tokens(m, b, seq)[:, 0]
    caches = T.init_decode_caches(cfg, b, seq, device="cpu")
    mla_moe.fill_past(caches, m, t, PAST, SEED)
    for _ in range(steps):
        got, _ = T.decode_step(tree, cfg, caches, tok, t)
    w = mla_moe.prepare(tree, m, Precision())
    want, state = mla_moe.decode(w, m, tok, t, steps, Precision(), PAST,
                                 SEED)
    assert _rel(got, want) < TOL
    zero, _ = mla_moe.decode(w, m, tok, t, steps, Precision())
    assert _rel(zero, want) > 0.1             # the context is read
    prog, exact = mla_moe.program_state(caches, m, t, PAST, SEED)
    assert set(prog) == set(state) == {"ckv", "krope"} and exact == {}
    for key, value in state.items():
        assert prog[key].shape == value.shape == (3, b, value.shape[-1])
        assert _rel(prog[key], value) < TOL, key
    # a row after t is far larger than any read: the step reads none
    assert float(caches["stage1"]["sub0"]["ckv"][:, :, t + 1:].abs().max()) \
        > 100


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
    assert mla_moe.stages(m) == [
        (("stage0", "sub0"), 1, False), (("stage1", "sub0"), 2, True)]


def test_slice_flops_is_its_formula():
    m = MLA_MOE["model"]
    d, h, r, dn, dr, dv = 64, 4, 32, 16, 8, 16
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    dense = 3 * d * 128
    moe = d * 8 + (2 + 2) * 3 * d * 32
    active = 3 * attn + dense + 2 * moe + d * 256
    assert mla_moe.active_params(m) == active
    assert mla_moe.slice_flops(m, "prefill", 2, 64) == \
        2.0 * active * 128 + 3 * 2.0 * h * (dn + dr + dv) * 2 * 64 * 65 / 2
    assert mla_moe.slice_flops(m, "decode", 5, 64) == \
        2.0 * active * 5 + 3 * 2.0 * h * (dn + dr + dv) * 5 * 33
    # at the published sizes: the port's 2.66 B active parameters less the
    # embedding's 0.21 B, which a token looks up and does not multiply by
    full = json.loads((harness.KBENCH / "configs"
                       / "deepseek-v2-lite.json").read_text())["model"]
    assert mla_moe.active_params(full) == pytest.approx(2.45e9, rel=0.01)


def test_yarn_is_the_closed_form():
    m = dict(MLA_MOE["model"], rope_theta=10000.0)
    freqs, rot, soft = mla_moe.yarn(dict(m, rope_scaling=dict(
        m["rope_scaling"])), 64)
    plain, one, also_one = mla_moe.yarn(dict(m, rope_scaling=None), 64)
    assert (one, also_one, rot) == (1.0, 1.0, pytest.approx(1.0))
    assert soft == pytest.approx(1.5896, abs=1e-4)
    assert torch.allclose(freqs[:11], plain[:11])
    assert torch.allclose(freqs[23:], plain[23:] / 40)


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))
    traffic = {"tenants": [
        {"name": "prefill", "phase": "prefill", "slices": 2, "batch": 1,
         "seq": 64},
        {"name": "decode", "phase": "decode", "slices": 4, "batch": 3,
         "seq": 64, "past": PAST}]}
    limits = {k: v for k, v in tiny.LIMITS.items()}
    cell = tiny.cell(MLA_MOE, traffic=traffic, limits=limits)
    res = harness.run_cell(cell, SEED, 0.3, False, "cpu",
                           time.perf_counter(), control=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(limits)
    # the control, every product through fp8, is far off
    assert max(res["control"].values()) > 100 * TOL


def _span(count, idle_s=0.0, device_s=0.0):
    return {"count": count, "host_s": 0.0, "idle_s": idle_s, "launches": 0,
            "device_s": device_s}


@pytest.mark.parametrize("name,want", [("experts_prefill_ms", 10.0),
                                       ("route_idle_ms", 2.0)])
def test_the_moe_readers(name, want):
    """Both read per prefill step, and nothing where the program marks no
    route or experts (a parent without the spans) or ran no device."""
    found = {"serve.step.prefill": _span(6),
             "model.experts": _span(130, device_s=0.06),
             "model.route": _span(130, idle_s=0.012)}
    rec = {"trace": {"busy_s": 1.0, "window_s": 2.0, "spans": found}}
    read = harness._reader(name)
    assert read(rec) == pytest.approx(want)
    bare = {k: v for k, v in found.items() if not k.startswith("model.")}
    assert read({"trace": dict(rec["trace"], spans=bare)}) is None
    assert read({"trace": dict(rec["trace"], busy_s=0.0)}) is None
    assert read({"trace": None}) is None
