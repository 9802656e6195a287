"""G1's plain version (``ops.grouped_experts`` on the CPU) against a loop
over the pairs and the bucketed dropless route, on reduced DeepSeek-V2-Lite
shapes, and the route ``_moe_tokens`` takes: G1 for a served prompt on the
card, the buckets elsewhere.

  PYTHONPATH=src python -m pytest -q tests/test_torch_grouped_experts.py
"""
import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import grouped_experts as GE
from repro_torch.kernels import ops
from repro_torch.models import moe as M
from repro_torch.models import transformer as T


def _tiny(**moe):
    """Reduced DeepSeek-V2-Lite in float32 (8 experts of 64, D 128, top-2),
    its MoE fields changed by ``moe``."""
    cfg = reduced(get_config("deepseek-v2-lite"))
    return dataclasses.replace(cfg, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, **moe))


def _experts(cfg):
    """One MoE layer's parameters of ``cfg``, float32 on the CPU."""
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    return T._tree_map(lambda a: a[0], params["stage1"]["sub0"]["moe"])


# pairs an expert, sorted by expert: even, one expert with ~85% of the
# pairs, empty experts, and a count of pairs no multiple of BLOCK_ROWS
COUNTS = {"uniform": [32] * 8,
          "hot": [10, 870, 20, 30, 25, 15, 20, 10],
          "empty": [0, 200, 0, 0, 56, 0, 0, 0],
          "ragged": [37, 41, 0, 129, 3, 50, 1, 39]}


def _pairs(counts, d, seed):
    """xs (N, D) sorted by expert, each pair's expert, a permutation of the
    N flat slots and the pairs' weights in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    n = sum(counts)
    xs = torch.randn(n, d, generator=g)
    seg = torch.repeat_interleave(torch.arange(len(counts)),
                                  torch.tensor(counts))
    return xs, seg, torch.randperm(n, generator=g), torch.rand(n, generator=g)


@pytest.mark.parametrize("case", list(COUNTS))
def test_the_plain_version_is_the_loop_over_the_pairs(case):
    """Row sort_idx[i] is pair i's weighted expert output: against one
    pair at a time and against the bucketed dropless route weighted and
    put in slot order (float32; the products sum in other orders)."""
    cfg = _tiny()
    p = _experts(cfg)
    counts = COUNTS[case]
    xs, seg, sort_idx, w = _pairs(counts, cfg.d_model, len(case))
    assert GE.BLOCK_ROWS == 128 and (case != "ragged" or len(xs) % 128)
    got = ops.grouped_experts(xs, torch.tensor(counts), w, sort_idx,
                              p["wi"], p["wg"], p["wo"])
    loop = torch.empty_like(got)
    for i, (x, e) in enumerate(zip(xs, seg)):
        h = F.silu(x @ p["wg"][e]) * (x @ p["wi"][e])
        loop[sort_idx[i]] = w[i] * (h @ p["wo"][e])
    torch.testing.assert_close(got, loop, rtol=1e-4, atol=1e-4)
    starts = torch.cumsum(torch.tensor(counts), 0) - torch.tensor(counts)
    pos = torch.arange(len(seg)) - starts[seg]
    ys = M._dropless_expert_compute(xs, seg, pos, counts, p["wi"], p["wg"],
                                    p["wo"], cfg.act)
    flat = torch.empty_like(ys).index_copy_(0, sort_idx, ys * w[:, None])
    torch.testing.assert_close(got, flat, rtol=1e-4, atol=1e-4)


def test_the_plain_version_keeps_the_working_dtype():
    """bf16 in, bf16 out, within bf16's rounding of the f32 loop over the
    pairs (each h and each weighted row rounded once), as a whole."""
    cfg = _tiny()
    p = {k: v.bfloat16() for k, v in _experts(cfg).items()
         if k in ("wi", "wg", "wo")}
    counts = COUNTS["ragged"]
    xs, seg, sort_idx, w = _pairs(counts, cfg.d_model, 7)
    xs = xs.bfloat16()
    got = ops.grouped_experts(xs, torch.tensor(counts), w, sort_idx,
                              p["wi"], p["wg"], p["wo"])
    assert got.dtype == torch.bfloat16
    want = torch.empty(got.shape)
    for i, (x, e) in enumerate(zip(xs.float(), seg)):
        h = F.silu(x @ p["wg"][e].float()) * (x @ p["wi"][e].float())
        want[sort_idx[i]] = w[i] * (h @ p["wo"][e].float())
    # two roundings to bf16 (8 bits) of every element: ~2^-9 relative each
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


@pytest.mark.parametrize("bad", ["d", "counts", "wo", "none", "dtype"])
def test_what_the_kernels_do_not_take_is_refused_on_every_device(bad):
    cfg = _tiny()
    p = _experts(cfg)
    xs, _, sort_idx, w = _pairs(COUNTS["uniform"], cfg.d_model, 1)
    counts = torch.tensor(COUNTS["uniform"])
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if bad == "d":                      # rows not on 16 bytes
        xs, wi, wg, wo = xs[:, :-4], wi[:, :-4], wg[:, :-4], wo[..., :-4]
    elif bad == "counts":
        counts = counts[:-1]
    elif bad == "wo":
        wo = wo.transpose(1, 2)
    elif bad == "none":
        xs, sort_idx, w = xs[:0], sort_idx[:0], w[:0]
    else:
        counts = counts.float()
    with pytest.raises(ValueError, match="grouped_experts"):
        ops.grouped_experts(xs, counts, w, sort_idx, wi, wg, wo)


def _like(is_cuda=True):
    """A stand-in for x2d with what ``_grouped`` reads of it."""
    return types.SimpleNamespace(is_cuda=is_cuda, requires_grad=False)


def test_g1_is_taken_only_by_a_served_dropless_prompt_on_the_card():
    """Dropless, more than STATIC_DEPTH tokens, no token block, on the
    card, no autograd graph, bf16 SwiGLU experts: G1. Any one of them
    otherwise: the buckets (the decode batch's static depth, capacity
    routes, training's read-back route, f32 and the CPU)."""
    cfg = _tiny()
    p = {k: v.bfloat16() for k, v in _experts(cfg).items()
         if k in ("wi", "wg", "wo")}
    t = M.STATIC_DEPTH + 1
    with torch.inference_mode():
        assert M._grouped(_like(), p, cfg, None, t)
        assert not M._grouped(_like(), p, cfg, None, M.STATIC_DEPTH)
        assert not M._grouped(_like(is_cuda=False), p, cfg, None, t)
        assert not M._grouped(torch.zeros(t, cfg.d_model), p, cfg, None, t)
        assert not M._grouped(_like(), p, cfg, object(), t)
        assert not M._grouped(_like(), p, _tiny(capacity_factor=1.25), None,
                              t)
        assert not M._grouped(_like(), p, dataclasses.replace(cfg,
                                                              act="geglu"),
                              None, t)
        f32 = {k: v.float() for k, v in p.items()}
        assert not M._grouped(_like(), f32, cfg, None, t)
    trained = {k: v.detach().requires_grad_() for k, v in p.items()}
    assert not M._grouped(_like(), trained, cfg, None, t)
    with torch.no_grad():
        assert M._grouped(_like(), trained, cfg, None, t)


def test_moe_tokens_on_the_g1_route_reads_no_count_back(monkeypatch):
    """With G1's route taken (here its plain version), ``moe_ffn`` of a
    prompt gives the bucketed route's output, calls ``ops.grouped_experts``
    once and never ``_dropless_sizes``, the read of the counts."""
    cfg = _tiny()
    p = _experts(cfg)
    x = torch.randn(2, M.STATIC_DEPTH, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want, want_aux = M.moe_ffn(x, p, cfg)
    calls, g1 = [], ops.grouped_experts

    def counted(*args):
        calls.append(args[1])
        return g1(*args)

    def refused(*args):
        raise AssertionError("the counts were read back")

    monkeypatch.setattr(M, "_grouped", lambda *args: True)
    monkeypatch.setattr(M, "_dropless_sizes", refused)
    monkeypatch.setattr(M.ops, "grouped_experts", counted)
    got, aux = M.moe_ffn(x, p, cfg)
    assert len(calls) == 1 and int(calls[0].sum()) == x.shape[0] * \
        x.shape[1] * cfg.moe.top_k
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(aux, want_aux)
