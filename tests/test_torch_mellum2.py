"""Mellum2-12B-A2.5B in the port, on the CPU at a reduced size: its
configuration against the published numbers, the layer pattern, YaRN on
the full layers only, a prompt then decode steps through both cache kinds
(rings and full caches) against the full forward, a window one off either
way against the plain reference, and K3's window on its CPU route.

  PYTHONPATH=src python -m pytest -q tests/test_torch_mellum2.py
"""
import dataclasses
import math

import pytest
import torch

from kbench import harness, weights
from kbench.reference import swa_moe
from kbench.reference.common import Precision
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "mellum2-12b-a2.5b"
W = 8                   # the reduced window: prompts and t run past it
# float32 both sides: the port's plain CPU path against the reference or
# itself differs by summation order, ~1e-6 at these sizes (measured)
TOL = 1e-4


def _tiny():
    """The reduced arch (8 layers: two periods) in float32 at window W."""
    return dataclasses.replace(reduced(get_config(ARCH)), dtype="float32",
                               local_window=W)


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu", dtype=torch.float32)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_the_config_is_the_published_one():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (28, 2304, 32, 4, 128, 98304)
    assert (cfg.local_window, cfg.rope_theta, cfg.attention_kind) == \
        (1024, 500000.0, "full")
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.num_shared_experts,
            m.first_dense_layers, m.capacity_factor, m.norm_topk_prob,
            m.router_act) == (64, 8, 896, 0, 0, 0.0, True, "softmax")
    rs = cfg.rope_scaling
    assert (rs.factor, rs.original_max_position_embeddings, rs.beta_fast,
            rs.beta_slow) == (16.0, 8192, 32.0, 1.0)
    # the published attention_factor, on cos and sin of q and k alike
    a = 0.1 * math.log(16) + 1
    assert a == pytest.approx(1.2772588722239782)
    assert rs.softmax_gain == pytest.approx(a * a)
    assert not cfg.tie_embeddings and cfg.mtp is False
    assert cfg.param_count() == pytest.approx(12.15e9, rel=1e-3)
    assert cfg.param_count(active_only=True) == pytest.approx(2.44e9,
                                                              rel=1e-2)


def test_window_layers_three_of_four_full_every_fourth():
    kinds = get_config(ARCH).layer_kinds()
    assert kinds.count("local") == 21 and kinds.count("attn") == 7
    assert [i for i, k in enumerate(kinds) if k == "attn"] == \
        list(range(3, 28, 4))
    plan = T.stage_plan(get_config(ARCH))
    assert len(plan) == 1 and plan[0].repeats == 7
    assert [sig for sig in plan[0].cycle] == [("local", True)] * 3 + \
        [("attn", True)]


def _rotations(monkeypatch, cfg, params, tokens):
    """The ``scaling`` of every RoPE a forward applies, in order."""
    seen = []
    real = L.apply_rope

    def spy(x, positions, theta=10000.0, scaling=None):
        seen.append((theta, scaling))
        return real(x, positions, theta, scaling)
    monkeypatch.setattr(L, "apply_rope", spy)
    T.forward(params, cfg, {"tokens": tokens})
    return seen


def test_yarn_on_the_full_layers_only(monkeypatch):
    """q and k of each full layer rotate under YaRN, of each window layer
    by plain RoPE at the same theta; a GQA arch with no scaling (Phi-3)
    keeps plain RoPE everywhere."""
    cfg = _tiny()
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(2))
    seen = _rotations(monkeypatch, cfg, _params(cfg), tokens)
    want = []
    for kind in cfg.layer_kinds():
        want += [(cfg.rope_theta, cfg.rope_scaling if kind == "attn"
                  else None)] * 2
    assert seen == want
    phi3 = reduced(get_config("phi3-mini-3.8b"))
    assert {s for _, s in _rotations(monkeypatch, phi3, _params(phi3),
                                     tokens)} == {None}
    # YaRN moves the full layers' rotations and only theirs
    d = cfg.head_dim
    plain = L.rope_frequencies(d, cfg.rope_theta)
    yarn = L.rope_frequencies(d, cfg.rope_theta, cfg.rope_scaling)
    assert not torch.equal(torch.as_tensor(plain), torch.as_tensor(yarn))


def test_prompt_then_decode_through_both_cache_kinds():
    """A 12-token prompt into rings of W = 8 slots and full caches, then
    decode steps at t = 12 .. 17, each against the full forward's logits
    at that position: the rings wrap and drop keys older than the
    window."""
    cfg = _tiny()
    params = _params(cfg)
    b, s, n = 2, 12, 6
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n),
                           generator=torch.Generator().manual_seed(3))
    full, _, _ = T.forward(params, cfg, {"tokens": tokens})
    caches = T.init_decode_caches(cfg, b, s + n, device="cpu")
    logits, _ = T.prefill(params, cfg, {"tokens": tokens[:, :s]}, caches)
    assert _rel(logits, full[:, :s]) < TOL
    ring = caches["stage0"]["sub0"]
    assert ring["k"].shape[2] == W and sorted(ring["pos"][0].tolist()) == \
        list(range(s - W, s))
    assert caches["stage0"]["sub3"]["k"].shape[2] == s + n
    for t in range(s, s + n):
        step, _ = T.decode_step(params, cfg, caches, tokens[:, t], t)
        assert _rel(step, full[:, t]) < TOL, t
    assert sorted(ring["pos"][1].tolist()) == list(range(s + n - W, s + n))


@pytest.mark.parametrize("window", [W - 1, W + 1])
def test_a_window_one_off_is_caught(window):
    """The port at W against the plain reference agrees; at W - 1 or W + 1
    it is off by far more than the tolerance, in the prompt's logits."""
    m = {"num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "local_window": W,
         "rope_theta": 500000.0,
         "rope_scaling": {"type": "yarn", "factor": 16,
                          "original_max_position_embeddings": 8192,
                          "beta_fast": 32, "beta_slow": 1, "mscale": 1,
                          "mscale_all_dim": 1},
         "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
                 "num_shared_experts": 0, "first_dense_layers": 0,
                 "capacity_factor": 0, "norm_topk_prob": True},
         "block_pattern": ["local", "local", "local", "attn"],
         "dtype": "float32"}
    tree = weights.build(swa_moe.leaves(m), 35, "cpu")
    toks = torch.as_tensor(harness.tenant_tokens(256, 2, 40)).long()
    want = swa_moe.prefill(swa_moe.prepare(tree, m, Precision()), m, toks,
                           Precision())
    config = {"arch": ARCH, "model": m}
    got, _, _ = T.forward(tree, harness.port_config(config),
                          {"tokens": toks})
    assert _rel(got, want) < TOL
    off = harness.port_config({"arch": ARCH,
                               "model": dict(m, local_window=window)})
    bad, _, _ = T.forward(tree, off, {"tokens": toks})
    assert _rel(bad, want) > 100 * TOL


@pytest.mark.parametrize("s,window", [(40, 8), (37, 5), (20, 64)],
                         ids=["tiles", "ragged", "past-the-prompt"])
def test_the_window_on_k3s_cpu_route(s, window):
    """``ops.flash_attention(window=)`` on the CPU is the plain windowed
    attention the model's plain routes compute; a window needs a causal
    call; and the model takes K3's window on the card only."""
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, s, 4, 16, generator=g) for _ in range(3))
    got = ops.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                              causal=True, bq=s, bk=s, window=window)
    want = A.full_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.transpose(1, 2), want, atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(A._flash_fwd(q, k, v, causal=True, window=window),
                       got.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, causal=False, bq=s, bk=s, window=8)
    assert not A.takes_window_kernel(q.bfloat16(), k.bfloat16(),
                                     v.bfloat16())
