"""D2's route on the CPU: ``ops.mla_decode_attention`` (the plain version
``mla_decode.plain`` here) against the absorbed decode's earlier f32
arithmetic, kept below as ``_earlier_absorbed`` (the einsums over f32
copies of the latents and their masked softmax), at reduced
DeepSeek-V2-Lite's widths, whole and as the partials a rank merges; the
partials of two row blocks merged by ``split_k_combine``; the shapes
``check_shapes`` refuses on every device; and the split count. The kernel
itself runs in ``tests/test_torch_cuda.py`` and
``tests/test_torch_decode_graph.py`` on the card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import mla_decode as MLA
from repro_torch.kernels import ops
from repro_torch.models import attention as A

CFG = reduced(get_config("deepseek-v2-lite"))
B, T = 3, 37


def _earlier_absorbed(q_nope, q_rope, ckv, krope, wkv_b, dn, dtype,
                      valid=None, group=None, gain=1.0, combine=None):
    """The absorbed decode as the port computed it before D2: f32 copies of
    the latents, two einsums, the softmax masked by ``valid``; with
    ``group`` its partials go to ``combine``."""
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_k)
    scale = gain / np.sqrt(dn + q_rope.shape[-1])
    ckv_f = ckv.float()
    logits = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_f)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             krope.float())) * scale
    if valid is not None:
        logits = torch.where(valid, logits, A.NEG_INF)
    if group is None:
        o_lat = torch.einsum("bhst,btr->bhsr", torch.softmax(logits, dim=-1),
                             ckv_f)
    else:
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        o_lat = combine(m, p.sum(dim=-1), torch.einsum("bhst,btr->bhsr", p,
                                                       ckv_f), group)
    return torch.einsum("bshr,rhv->bshv", o_lat.transpose(1, 2).to(dtype),
                        w_v)


def _inputs(seed=0, t=T, dtype=torch.float32):
    m = CFG.mla
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g)).to(dtype)

    return dict(q_nope=randn(B, 1, CFG.num_heads, m.qk_nope_dim),
                q_rope=randn(B, 1, CFG.num_heads, m.qk_rope_dim),
                ckv=randn(B, t, m.kv_lora_rank, std=1.5),
                krope=randn(B, t, m.qk_rope_dim, std=1.5),
                wkv_b=randn(m.kv_lora_rank, CFG.num_heads,
                            m.qk_nope_dim + m.v_head_dim, std=0.2))


def _absorbed(x, **kw):
    return A._mla_absorbed_decode(x["q_nope"], x["q_rope"], x["ckv"],
                                  x["krope"], x["wkv_b"], CFG.mla.qk_nope_dim,
                                  x["q_nope"].dtype, **kw)


def _earlier(x, **kw):
    return _earlier_absorbed(x["q_nope"], x["q_rope"], x["ckv"], x["krope"],
                             x["wkv_b"], CFG.mla.qk_nope_dim,
                             x["q_nope"].dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_decode_equals_the_earlier_arithmetic(dtype):
    """Every row valid (the cache's first t + 1 rows, as a decode step
    without a mesh reads them): within 1e-5 in f32; in bf16 the output is
    rounded once, so within one bf16 step of 1."""
    x = _inputs(dtype=dtype)
    gain = CFG.rope_scaling.softmax_gain
    got = _absorbed(x, hi=T, gain=gain)
    want = _earlier(x, gain=gain)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("offset,hi", [(0, T), (16, 30), (40, 30), (0, 1)])
def test_the_group_form_merges_the_earlier_partials(monkeypatch, offset,
                                                    hi):
    """With a group, a rank's block of rows at ``offset`` whose positions
    below ``hi`` are valid: the (m, l, o) handed to ``split_k_combine``
    equal the earlier route's (no row valid: NEG_INF, 0, 0)."""
    x = _inputs(seed=1)
    seen = []

    def combine(m, l_sum, o, group):
        seen.append((m, l_sum, o.reshape(*m.shape, -1)))
        return o / l_sum.clamp_min(1e-30)[..., None]

    monkeypatch.setattr(A, "split_k_combine", combine)
    valid = offset + torch.arange(T) < hi
    gain = CFG.rope_scaling.softmax_gain
    _absorbed(x, hi=hi, offset=offset, group="model", gain=gain)
    _earlier(x, valid=valid, group="model", gain=gain, combine=combine)
    (m1, l1, o1), (m0, l0, o0) = seen
    torch.testing.assert_close(m1, m0[..., 0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l1, l0[..., 0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(o1, o0.reshape(o1.shape), atol=1e-5,
                               rtol=1e-5)
    if not bool(valid.any()):
        assert bool((m1 == A.NEG_INF).all()) and not l1.any() and not o1.any()


def test_two_row_blocks_merged_by_split_k_combine_equal_the_whole(
        monkeypatch):
    """The partials of rows [0, 20) and [20, 37), stacked as two ranks'
    and merged by ``split_k_combine`` (its all-reduces over the stack),
    equal one call over all the rows."""
    x = _inputs(seed=2)
    q_abs = torch.einsum("bshk,rhk->bhr", x["q_nope"],
                         x["wkv_b"][..., :CFG.mla.qk_nope_dim])
    kw = dict(hi=T, scale=0.3)
    whole = ops.mla_decode_attention(q_abs, x["q_rope"][:, 0], x["ckv"],
                                     x["krope"], **kw)
    parts = [ops.mla_decode_attention(q_abs, x["q_rope"][:, 0],
                                      x["ckv"][:, a:e], x["krope"][:, a:e],
                                      offset=a, **kw)
             for a, e in ((0, 20), (20, T))]

    def all_reduce(t, op=None, group=None):
        red = t.amax(0) if op == A.dist.ReduceOp.MAX else t.sum(0)
        t.copy_(red.expand_as(t))

    monkeypatch.setattr(A, "dist", types.SimpleNamespace(
        all_reduce=all_reduce, ReduceOp=A.dist.ReduceOp))
    merged = A.split_k_combine(*(torch.stack(p) for p in zip(*parts)),
                               group="model")
    torch.testing.assert_close(merged[0], whole[2] / whole[1][..., None],
                               atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(merged[0], merged[1])


def test_a_meta_call_gives_the_partials_shapes():
    """The dry run's tensors, shapes and no data, take the plain version."""
    meta = torch.device("meta")
    m, l_sum, o = ops.mla_decode_attention(
        torch.empty(4, 128, 512, device=meta),
        torch.empty(4, 128, 64, device=meta),
        torch.empty(4, 1024, 512, device=meta, dtype=torch.bfloat16),
        torch.empty(4, 1024, 64, device=meta, dtype=torch.bfloat16),
        hi=700, scale=0.1)
    assert (tuple(m.shape), tuple(l_sum.shape), tuple(o.shape)) == (
        (4, 128), (4, 128), (4, 128, 512))


@pytest.mark.parametrize("shapes,match", [
    (((2, 4, 36), (2, 4, 16), (2, 9, 36), (2, 9, 16)), "R = 36"),
    (((2, 4, 520), (2, 4, 16), (2, 9, 520), (2, 9, 16)), "R = 520"),
    (((2, 4, 32), (2, 4, 12), (2, 9, 32), (2, 9, 12)), "DR = 12"),
    (((2, 4, 32), (2, 4, 72), (2, 9, 32), (2, 9, 72)), "DR = 72"),
    (((2, 4, 32), (2, 4, 16), (2, 9, 32), (2, 8, 16)), "must agree"),
    (((2, 4, 32), (2, 4, 16), (3, 9, 32), (3, 9, 16)), "must agree"),
    (((2, 4, 32), (2, 4, 16), (2, 9, 32, 1), (2, 9, 16)), "3-d"),
])
def test_check_shapes_refuses_what_the_kernel_does_not_take(shapes, match):
    q_lat, q_rope, ckv, krope = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        ops.mla_decode_attention(q_lat, q_rope, ckv, krope, hi=3, scale=1.0)


def test_check_shapes_refuses_a_dtype_or_a_layout():
    q_lat, q_rope = torch.zeros(2, 4, 32), torch.zeros(2, 4, 16)
    ckv, krope = torch.zeros(2, 9, 32), torch.zeros(2, 9, 16)
    with pytest.raises(ValueError, match="float dtype"):
        ops.mla_decode_attention(q_lat, q_rope, ckv, krope.bfloat16(), hi=3,
                                 scale=1.0)
    with pytest.raises(ValueError, match="float dtype"):
        ops.mla_decode_attention(q_lat.long(), q_rope.long(), ckv, krope,
                                 hi=3, scale=1.0)
    with pytest.raises(ValueError, match="in place"):    # a stride along R
        ops.mla_decode_attention(q_lat, q_rope,
                                 torch.zeros(2, 9, 64)[..., ::2], krope,
                                 hi=3, scale=1.0)
    with pytest.raises(ValueError, match="in place"):    # rows off 16 bytes
        ops.mla_decode_attention(q_lat, q_rope, ckv,
                                 torch.zeros(2, 9, 18)[..., :16], hi=3,
                                 scale=1.0)
    # a view of the cache's first rows, as a decode step reads it, is taken
    ops.mla_decode_attention(q_lat, q_rope, torch.zeros(2, 20, 32)[:, :9],
                             torch.zeros(2, 20, 16)[:, :9], hi=3, scale=1.0)


def test_split_count_fills_the_card_in_whole_waves():
    """dsv2lite-mixed's call (48 (b, head tile)s, 8193 rows in 129 tiles of
    64, one CTA an SM of 132): 5 splits, 240 CTAs in two waves; 128 heads
    (8 head tiles) of 2 sequences over 700 rows: 6 splits of 2 tiles, one
    wave; and the degenerate ends."""
    assert MLA.split_count(48, 129, 132) == 5
    assert MLA.split_count(2 * 8, 11, 132) == 6
    assert MLA.split_count(1, 129, 132) == 129
    assert MLA.split_count(48, 0, 132) == 1
    assert MLA.split_count(48, 1, 132) == 1
