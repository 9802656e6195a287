"""Training in the port against the reference package, in f32 on the CPU:
the gradients of ``train_loss`` for every arch against ``jax.grad`` of the
reference's, the three kernels' autograd Functions (K3 ``FlashAttention``,
K4 ``WKV6``, K5 ``RGLRU``) against the reference's plain forms, and
``cfg.remat`` against no remat. The same inputs (numpy from a seed) and the
same weights (``repro_torch.convert.params_from_jax``) go to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.data.synthetic import make_batch
from repro.models import attention as JA
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _model(arch, **changes):
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    tcfg = dataclasses.replace(reduced(tconfigs.get_config(arch)), **changes)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return cfg, tcfg, jp, tp


def _port_grads(tp, tcfg, raw):
    """{key path: gradient} of the port's ``train_loss`` over every leaf."""
    live = {k: v.detach().requires_grad_() for k, v in _flat(tp).items()}
    tree = {}
    for key, leaf in live.items():
        node = tree
        *head, last = key.strip("/").split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = leaf
    loss, _ = T.train_loss(tree, tcfg, {k: torch.from_numpy(v)
                                        for k, v in raw.items()})
    grads = torch.autograd.grad(loss, list(live.values()))
    return dict(zip(live, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_gradients_match_reference(arch):
    """Every leaf's gradient of the loss (with the MoE aux loss and
    DeepSeek-V3's MTP loss) against ``jax.grad`` of the reference's: the
    max abs difference within 1e-4 of the leaf's max |grad|. Every leaf
    gets a gradient (``autograd.grad`` raises on an unused one)."""
    cfg, tcfg, jp, tp = _model(arch)
    raw = make_batch(cfg, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    want = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: JT.train_loss(p, cfg, jb)[0])(jp)))
    got = _port_grads(tp, tcfg, raw)
    assert got.keys() == want.keys()
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape, key
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, key


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small",
                                  "deepseek-v3-671b"])
def test_remat_gives_the_same_gradients(arch, monkeypatch):
    """``remat=True`` (each repeat's blocks and each encoder layer under
    ``torch.utils.checkpoint``) against ``remat=False``: every gradient
    within 1e-6, and each kernel op of a rematted layer run once more, in
    the recompute (as K3, K4 and K5 launch twice a layer on the card); the
    MTP block is outside the stages and runs once."""
    calls = {}
    for name in ("flash_attention", "rwkv6_scan", "rg_lru"):
        def spy(*a, _name=name, _real=getattr(ops, name), **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    cfg = reduced(get_config(arch))
    raw = make_batch(cfg, 2, 32)
    grads, runs = [], []
    for remat in (False, True):
        _, tcfg, _, tp = _model(arch, remat=remat)
        calls.clear()
        grads.append(_port_grads(tp, tcfg, raw))
        runs.append(dict(calls))
    for key, g in grads[0].items():
        assert torch.allclose(grads[1][key], g, atol=1e-6, rtol=1e-6), key
    kinds = cfg.layer_kinds()
    layers = {"flash_attention": kinds.count("attn") + cfg.encoder_layers,
              "rwkv6_scan": kinds.count("rwkv6"),
              "rg_lru": kinds.count("rglru")}
    for name, n in layers.items():
        assert runs[1].get(name, 0) - runs[0].get(name, 0) == n, (name, runs)
    assert sum(layers.values()) > 0


def _ref_plain_attention(q, k, v, causal):
    """The reference's choice with no cache (``attention.py:247-257``)."""
    s = q.shape[1]
    blk = JA._pick_block(s, k.shape[1])
    if s <= 2 * blk:
        return JA.full_attention(q, k, v, causal=causal)
    return JA.chunked_attention(q, k, v, causal=causal, q_block=blk,
                                kv_block=blk)


@pytest.mark.parametrize("b,s,h,kv,d,causal", [
    (2, 64, 4, 2, 32, True), (1, 48, 2, 2, 16, False),
    (1, 2560, 2, 1, 16, True)])     # S > 2 blocks: the chunked form
def test_flash_attention_function_matches_reference(b, s, h, kv, d, causal):
    """K3's Function: the forward is ``_flash``'s (the plain version here),
    the gradients of q, k and v those of the reference's plain attention
    (1e-5 of each one's max)."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    want_o, vjp = jax.vjp(lambda q, k, v: _ref_plain_attention(
        q, k, v, causal), q, k, v)
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = A._flash(*xs, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert torch.equal(out, A._flash_fwd(*xs, causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _wkv_inputs(rng, b, s, h, n, w_log=None):
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    if w_log is None:
        w_log = -np.exp(rng.standard_normal((b, s, h, n)) - 1.0)
    w_log = np.broadcast_to(w_log, r.shape).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    return r, k, v, w_log, u, s0


def test_wkv6_function_matches_reference():
    """K4's Function from a given state: out and the final state as
    ``rwkv6_chunked``'s, the gradients of r, k, v, w_log, u and the state
    those of the reference's ``rwkv6_chunked`` (1e-4 of each one's max),
    and the caller's state left as it was."""
    rng = np.random.default_rng(5)
    xs_np = _wkv_inputs(rng, 2, 64, 2, 16)
    g_out = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    g_st = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    (wo, ws), vjp = jax.vjp(lambda *a: JR.rwkv6_chunked(*a, chunk=32),
                            *xs_np)
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_st)))
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in xs_np]
    out, final = R.WKV6.apply(*xs, 32)
    assert torch.equal(xs[5].detach(), torch.from_numpy(xs_np[5]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wo),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(ws),
                               atol=1e-4, rtol=1e-4)
    got = torch.autograd.grad((out, final), xs, (torch.from_numpy(g_out),
                                                 torch.from_numpy(g_st)))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_wkv6_gradient_stays_finite_at_an_extreme_decay():
    """ROADMAP queue 3, item 4, in the backward: at a log decay of -4 a
    step, exp of the above-diagonal exponent would overflow; the port zeroes
    it before ``exp``, so the gradients are finite and equal autograd
    through the sequential oracle (1e-4 of each one's max)."""
    rng = np.random.default_rng(24)
    xs_np = _wkv_inputs(rng, 1, 64, 2, 16, w_log=-4.0)
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in xs_np]
    out, final = R.WKV6.apply(*xs, 32)
    got = torch.autograd.grad(out.sum() + final.sum(), xs)
    ys = [torch.from_numpy(x.copy()).requires_grad_() for x in xs_np]
    o2, f2 = ref.rwkv6(*ys)
    want = torch.autograd.grad(o2.sum() + f2.sum(), ys)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_rglru_function_matches_reference():
    """K5's Function from ``h0``: h as ``rglru_scan``'s, the gradients of
    x, a_log and h0 those of the reference's associative scan (1e-5 of
    each one's max)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 96, 24)).astype(np.float32)
    a_log = -np.exp(rng.standard_normal((2, 96, 24)) - 2.0).astype(
        np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    g = rng.standard_normal((2, 96, 24)).astype(np.float32)
    wh, vjp = jax.vjp(lambda *a: JR.rglru_scan(*a)[0], x, a_log, h0)
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(v).requires_grad_() for v in (x, a_log, h0)]
    h = R.RGLRU.apply(*xs)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(wh),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(h, xs, torch.from_numpy(g))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_functions_stay_out_of_inference():
    """With autograd off (serving runs under ``inference_mode``) the layers
    call the ops as before: no Function in the graph, and K4 overwrites the
    caller's state in place; with autograd on, the Functions return the new
    state and leave the caller's alone."""
    cfg = reduced(tconfigs.get_config("rwkv6-1.6b"))
    gen = torch.Generator().manual_seed(0)
    p = R.init_rwkv6(gen, cfg, 2, dtype=torch.float32)
    x = torch.randn(1, 32, cfg.d_model, generator=gen)
    h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    state = torch.zeros(1, h, n, n)
    with torch.inference_mode():
        out, (st, _) = R.rwkv6_forward(x, p, cfg, state=state)
    assert out.grad_fn is None and st is state and state.abs().sum() > 0
    state2 = torch.zeros(1, h, n, n)
    p["wk"].requires_grad_(True)
    out2, (st2, _) = R.rwkv6_forward(x, p, cfg, state=state2)
    assert st2 is not state2 and state2.abs().sum() == 0
    assert type(st2.grad_fn).__name__ == "WKV6Backward"
    torch.testing.assert_close(st2.detach(), state, atol=0, rtol=0)
    torch.testing.assert_close(out2.detach(), out, atol=0, rtol=0)
