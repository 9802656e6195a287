"""DeepSeek-V2-Lite in the port, on the CPU at a reduced size: nested
sizes given as mappings, its parameter count, YaRN's frequencies and
softmax scale, unnormalised and dropless routing (against a loop over the
pairs), the direct query projection of its MLA through a cache, and the
``model.route`` / ``model.experts`` spans of a profiled forward.

  PYTHONPATH=src python -m pytest -q tests/test_torch_deepseek_lite.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import (ARCH_IDS, MLAConfig, MoEConfig, RopeScaling,
                                 get_config, reduced)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ARCH = "deepseek-v2-lite"


def _tiny(**moe):
    """The reduced arch in float32, its MoE fields changed by ``moe``."""
    cfg = reduced(get_config(ARCH))
    return dataclasses.replace(cfg, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, **moe))


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu", dtype=torch.float32)


def test_nested_sizes_given_as_mappings_become_their_dataclasses():
    cfg = get_config(ARCH)
    again = dataclasses.replace(
        cfg, moe=dataclasses.asdict(cfg.moe), mla=dataclasses.asdict(cfg.mla),
        rope_scaling=dataclasses.asdict(cfg.rope_scaling))
    assert again == cfg
    assert isinstance(again.moe, MoEConfig)
    assert isinstance(again.mla, MLAConfig)
    assert isinstance(again.rope_scaling, RopeScaling)
    assert again.mla.q_lora_rank == 0 and again.moe.capacity_factor == 0
    assert not again.moe.norm_topk_prob


def test_the_parameter_count_is_the_published_one():
    assert get_config(ARCH).param_count() == pytest.approx(15.7e9, rel=0.01)
    # the reduced model keeps the direct query projection
    assert reduced(get_config(ARCH)).mla.q_lora_rank == 0
    p = _params(_tiny())
    attn = p["stage0"]["sub0"]["attn"]
    assert "wq" in attn and "wq_a" not in attn and "q_norm" not in attn


def test_yarn_frequencies_and_softmax_gain_have_their_closed_form():
    cfg = get_config(ARCH)
    rs, dr, theta = cfg.rope_scaling, cfg.mla.qk_rope_dim, cfg.rope_theta
    assert rs.correction_range(dr, theta) == (10, 23)
    got = L.rope_frequencies(dr, theta, rs)
    plain = theta ** (-np.arange(0, dr, 2) / dr)
    i = np.arange(dr // 2)
    np.testing.assert_allclose(got[:11], plain[:11], rtol=1e-6)
    np.testing.assert_allclose(got[23:], plain[23:] / 40, rtol=1e-6)
    ramp = (i[11:23] - 10) / 13
    np.testing.assert_allclose(
        got[11:23], plain[11:23] * (1 - ramp) + plain[11:23] / 40 * ramp,
        rtol=1e-6)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert rs.softmax_gain == pytest.approx(mscale ** 2)
    assert rs.softmax_gain == pytest.approx(1.5896, abs=1e-4)
    # a ratio of mscales other than 1 would scale cos and sin: refused
    with pytest.raises(ValueError, match="mscale"):
        dataclasses.replace(rs, mscale=1.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_without_scaling_every_arch_keeps_its_rope_tables(arch):
    """The frequencies and rotations of RoPE with no scaling are bit for
    bit the formula they were before YaRN came in."""
    cfg = get_config(arch)
    # YaRN: DeepSeek-V2-Lite's MLA, and Mellum2's full attention layers
    assert (cfg.rope_scaling is not None) == (
        arch in (ARCH, "mellum2-12b-a2.5b"))
    d = cfg.mla.qk_rope_dim if cfg.mla is not None else cfg.head_dim
    before = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float32)
                                       / d))
    assert np.array_equal(L.rope_frequencies(d, cfg.rope_theta), before)
    x = torch.randn(2, 5, 3, d, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)[None].expand(2, 5)
    ang = pos[..., :, None, None].float() * torch.as_tensor(before)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    assert torch.equal(L.apply_rope(x, pos, cfg.rope_theta), want)


def test_unnormalised_routing_weights_pairs_by_their_raw_probabilities():
    cfg = _tiny()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(10, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.moe.num_experts,
                         generator=g) / cfg.d_model ** 0.5
    scores, top_w, top_i = M._top_k(x, router, cfg.moe)
    probs = torch.softmax(x @ router, dim=-1)
    assert torch.allclose(scores, probs)
    assert torch.allclose(top_w, probs.gather(-1, top_i))
    assert bool((top_w.sum(-1) < 1 - 1e-3).all())
    _, normed, _ = M._top_k(x, router, dataclasses.replace(
        cfg.moe, norm_topk_prob=True))
    assert torch.allclose(normed.sum(-1), torch.ones(10))


def _per_pair(x2d, p, cfg):
    """The routed experts and the shared ones, one (token, choice) pair at
    a time, nothing dropped."""
    _, top_w, top_i = M._top_k(x2d, p["router"], cfg.moe)
    out = L.mlp(x2d, p["shared"], cfg.act)
    for tok in range(x2d.shape[0]):
        for w, e in zip(top_w[tok], top_i[tok]):
            h = x2d[tok] @ p["wi"][e]
            h = torch.nn.functional.silu(x2d[tok] @ p["wg"][e]) * h
            out[tok] = out[tok] + w * (h @ p["wo"][e])
    return out


@pytest.mark.parametrize("tokens", [40, M.STATIC_DEPTH + 72],
                         ids=["static", "read-back"])
def test_the_dropless_route_keeps_every_pair(tokens):
    """Every token chooses the same two experts: a capacity of 1.25 drops
    most of their pairs, the dropless route none of them, in buckets as
    deep as the tokens (few tokens) or as deep as the counts read back
    give (more)."""
    cfg = _tiny()
    p = T._tree_map(lambda a: a[0], _params(cfg)["stage1"]["sub0"]["moe"])
    x = torch.randn(2, tokens // 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).abs()
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 5], p["router"][:, 2] = 0.05, 0.02      # every token: 5, 2
    want = _per_pair(x.reshape(-1, cfg.d_model), p, cfg)
    got, _ = M.moe_ffn(x, p, cfg)
    # float32, the bucketed products and the loop sum in other orders
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want,
                               rtol=1e-4, atol=1e-4)
    dropped, _ = M.moe_ffn(x, p, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25)))
    assert (dropped.reshape(-1, cfg.d_model) - want).abs().max() > 1e-2


@pytest.mark.parametrize("sizes,depth", [
    ([3000, 10, 10, 10, 10, 10, 10, 10], 10),      # one hot expert: its own
    ([40, 38, 41, 39, 42, 40, 40, 40], 42),        # even: every pair batched
    ([0, 0, 700, 0, 0, 0, 20, 0], 20),             # the hot one's rest alone
    ([0, 0, 3000, 0, 0, 0, 0, 0], 0)])             # no buckets at all
def test_the_dropless_split_computes_every_pair(sizes, depth):
    """Buckets of the chosen depth and the hot experts' other pairs on
    their own give each pair its expert's products."""
    cfg = _tiny()
    p = T._tree_map(lambda a: a[0], _params(cfg)["stage1"]["sub0"]["moe"])
    assert M._dropless_depth(sizes) == depth
    seg = torch.repeat_interleave(torch.arange(len(sizes)),
                                  torch.tensor(sizes))
    starts = torch.cumsum(torch.tensor(sizes), 0) - torch.tensor(sizes)
    pos = torch.arange(len(seg)) - starts[seg]
    xs = torch.randn(len(seg), cfg.d_model,
                     generator=torch.Generator().manual_seed(5))
    got = M._dropless_expert_compute(xs, seg, pos, sizes, p["wi"], p["wg"],
                                     p["wo"], cfg.act)
    want = torch.stack([
        (torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wi"][e]))
        @ p["wo"][e] for x, e in zip(xs, seg)])
    # float32, the batched and the row-by-row products sum in other orders
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_counts_are_read_back_only_for_many_tokens():
    counts = torch.tensor([0, 3, 250, 1])
    assert M._dropless_sizes(counts, M.STATIC_DEPTH) is None
    assert M._dropless_sizes(counts, 300) == [0, 3, 250, 1]
    assert M._dropless_sizes(counts.to("meta"), 300) is None


@pytest.mark.parametrize("mla_decode", ["absorbed", "expand"])
def test_a_prompt_then_decode_through_the_cache_is_the_forward(mla_decode):
    """The direct-``wq`` MLA with YaRN, dropless MoE: a 16-token prompt into
    the cache, then 8 decode steps, each equal to the full forward's row
    (float32; the routes sum in other orders, ~1e-6)."""
    cfg = dataclasses.replace(_tiny(), mla_decode=mla_decode)
    p = _params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(4))
    full, _, _ = T.forward(p, cfg, {"tokens": toks})
    caches = T.init_decode_caches(cfg, 2, 32, dtype=torch.float32,
                                  device="cpu")
    logits, caches = T.prefill(p, cfg, {"tokens": toks[:, :16]}, caches)
    torch.testing.assert_close(logits, full[:, :16], rtol=1e-5, atol=1e-5)
    for t in range(16, 24):
        logits, caches = T.decode_step(p, cfg, caches, toks[:, t], t)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)
    # YaRN's softmax gain enters: without it the logits move
    plain, _, _ = T.forward(p, dataclasses.replace(cfg, rope_scaling=None),
                            {"tokens": toks})
    assert (plain - full).abs().max() > 1e-3


def test_a_profiled_forward_names_the_route_and_the_experts():
    cfg = _tiny()
    p = _params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.forward(p, cfg, {"tokens": toks})
    names = [e.name for e in prof.events()]
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    assert names.count(spans.ROUTE) == names.count(spans.EXPERTS) == n_moe
    assert {spans.ROUTE, spans.EXPERTS} <= spans.NAMES
