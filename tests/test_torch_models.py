"""The port's model layers, attention and transformer against the reference
package on the same inputs (numpy from a seed) and the same weights
(``repro_torch.convert.params_from_jax``), in f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_batch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ["phi3-mini-3.8b", "starcoder2-15b"]   # rmsnorm/SwiGLU; layernorm/GELU, kv=4


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, reduced(tconfigs.get_config(request.param)), jp, tp


def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    bias = rng.standard_normal(64).astype(np.float32) * 0.1
    close(L.rmsnorm(t(x), t(scale)), JL.rmsnorm(x, scale), 1e-5)
    close(L.layernorm(t(x), t(scale), t(bias)),
          JL.layernorm(x, scale, bias), 1e-5)
    close(L.layernorm(t(x), t(scale)), JL.layernorm(x, scale), 1e-5)


@pytest.mark.parametrize("name", ["swiglu", "gelu", "geglu", "relu2"])
def test_activations_match(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    close(L.act_fn(name)(t(x)), JL.act_fn(name)(x), 1e-6)


def test_rope_rotates_split_halves():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 12)[None], (2, 7)).astype(np.int32)
    close(L.apply_rope(t(x), torch.from_numpy(pos.copy()), 10000.0),
          JL.apply_rope(x, pos, 10000.0), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(2)
    p = {"wi": rng.standard_normal((16, 24)), "wo": rng.standard_normal((24, 16)),
         "wg": rng.standard_normal((16, 24))}
    p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
    if not JL.is_gated(act):
        del p["wg"]
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    close(L.mlp(t(x), {k: t(v) for k, v in p.items()}, act),
          JL.mlp(x, p, act), 1e-5)


def test_forward_logits_match(model):
    cfg, tcfg, jp, tp = model
    raw = make_batch(cfg, 2, 32)
    want, _, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])})
    got, _, aux = T.forward(tp, tcfg, {"tokens": torch.from_numpy(raw["tokens"])})
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    close(got, want, 2e-4)


def test_decode_steps_match(model):
    """Prefill then decode token by token: each step's logits match the
    reference's step and the port's own teacher-forced forward
    (tests/test_archs.py:65-91)."""
    cfg, tcfg, jp, tp = model
    b, s, prompt = 2, 32, 16
    toks = make_batch(cfg, b, s)["tokens"]
    full, _, _ = T.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    jc = JT.init_decode_caches(cfg, b, s, dtype=jnp.float32)
    tc = T.init_decode_caches(tcfg, b, s, dtype=torch.float32, device="cpu")
    jl, jc = JT.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :prompt])}, jc)
    tl, tc = T.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :prompt])},
                       tc)
    close(tl, jl, 2e-4)
    close(tl[:, -1], full[:, prompt - 1], 5e-4)
    step = jax.jit(lambda p, c, tok, tt: JT.decode_step(p, cfg, c, tok, tt))
    for pos in range(prompt, s):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, pos]),
                               pos)
        close(tl, jl, 5e-4)
        close(tl, full[:, pos], 5e-4)


def _attn_inputs(model, s):
    cfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, s, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["stage0"]["sub0"]["attn"])
    tblk = {k: v[0] for k, v in tp["stage0"]["sub0"]["attn"].items()}
    return cfg, tcfg, x, pos, jblk, tblk


@pytest.mark.parametrize("s", [64, 4096])     # JAX: full_attention, chunked
def test_gqa_prefill_through_flash_matches(model, s):
    """The port's cache-free causal branch calls ops.flash_attention once;
    the reference takes full_attention at S <= 2 * _pick_block and
    chunked_attention above it."""
    cfg, tcfg, x, pos, jblk, tblk = _attn_inputs(model, s)
    assert (s > 2 * JA._pick_block(s, s)) == (s == 4096)
    ops.reset_launches()
    want, _ = JA.gqa_forward(jnp.asarray(x), jblk, cfg, jnp.asarray(pos))
    got, _ = A.gqa_forward(t(x), tblk, tcfg, torch.from_numpy(pos))
    close(got, want, 2e-4)


def test_gqa_prompt_into_cache_matches(model):
    cfg, tcfg, x, pos, jblk, tblk = _attn_inputs(model, 48)
    jc = JA.init_cache(cfg, 1, 64, dtype=jnp.float32)
    tc = A.init_cache(tcfg, 1, 64, dtype=torch.float32)
    want, jc = JA.gqa_forward(jnp.asarray(x), jblk, cfg, jnp.asarray(pos),
                              cache=jc, t=0)
    got, tc = A.gqa_forward(t(x), tblk, tcfg, torch.from_numpy(pos),
                            cache=tc, t=0)
    close(got, want, 2e-4)
    close(tc["k"], jc["k"], 1e-6)
    close(tc["v"], jc["v"], 1e-6)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                   (False, 0, 0),
                                                   (True, 24, 8)])
def test_plain_attention_functions_match(causal, window, q_offset):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64 + q_offset, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64 + q_offset, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    close(A.full_attention(t(q), t(k), t(v), **kw),
          JA.full_attention(q, k, v, **kw), 1e-5)
    close(A.chunked_attention(t(q), t(k), t(v), q_block=16, kv_block=8
                              + 8 * (q_offset == 0), **kw),
          JA.chunked_attention(q, k, v, q_block=16, kv_block=8
                               + 8 * (q_offset == 0), **kw), 1e-5)
    close(A.decode_attention(t(q[:, :1]), t(k), t(v), 40, window=window),
          JA.decode_attention(q[:, :1], k, v, 40, window=window), 1e-5)


def test_params_layout_and_init():
    tcfg = reduced(tconfigs.get_config("phi3-mini-3.8b"))
    cfg = reduced(get_config("phi3-mini-3.8b"))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = T.init_params(tcfg, gen, device="cpu")
    conv = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), tp))
    flat_c = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), conv))
    assert flat_t == flat_c
    assert T.count_params(tp) == sum(int(np.prod(a.shape)) for a in
                                     jax.tree_util.tree_leaves(jp))
    w = tp["stage0"]["sub0"]["attn"]["wq"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tcfg.d_model) + 1e-6
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 0.88) < 0.05


@pytest.mark.parametrize("arch,kv", [("stablelm-3b", 4), ("stablelm-12b", 2)])
def test_stablelm_logits_at_full_head_dims_match(arch, kv, monkeypatch):
    """Reduced stablelm-3b and stablelm-12b with their full head dims kept
    (80 and 160) and everything else narrow (12B keeps grouped KV: 4 heads
    over 2): logits against JAX ``forward`` on converted f32 weights
    (2e-4, as test_forward_logits_match), every layer's prefill through
    ``ops.flash_attention`` at that head dim."""
    full = get_config(arch)
    cfg = dataclasses.replace(reduced(full), head_dim=full.head_dim,
                              num_kv_heads=kv)
    tcfg = dataclasses.replace(reduced(tconfigs.get_config(arch)),
                               head_dim=full.head_dim, num_kv_heads=kv)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, *a, **kw:
                        calls.append(q.shape[-1]) or real(q, *a, **kw))
    raw = make_batch(cfg, 2, 32)
    want, _, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])})
    got, _, _ = T.forward(tp, tcfg,
                          {"tokens": torch.from_numpy(raw["tokens"])})
    assert calls == [full.head_dim] * cfg.num_layers
    close(got, want, 2e-4)


MLA_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")


def _k3_head_dim(cfg):
    """The head dim an ``attn`` block hands K3 at prefill (MLA: its q.k
    dim), or None where no block of the arch reaches K3 (``rwkv6`` and
    ``rglru`` blocks; ``local`` blocks run the plain windowed attention)."""
    if "attn" not in cfg.layer_kinds():
        return None
    if cfg.mla is not None:
        return cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
    return cfg.head_dim


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_k3_takes_every_full_width_head_dim_but_mla(arch):
    """Which archs' full-width prefill K3 takes on the card: every one but
    the MLA ones, whose q.k dim of 192 is ROADMAP queue 1, item 18."""
    d = _k3_head_dim(tconfigs.get_config(arch))
    assert (d is None or d in FA.HEAD_DIMS) == (arch not in MLA_ARCHS), d


@pytest.mark.parametrize("arch,reason", [("deepseek-v2-236b", "item 7"),
                                         ("deepseek-v3-671b", "item 7"),
                                         ("whisper-small", "item 10")])
def test_other_block_kinds_name_their_roadmap_item(arch, reason):
    with pytest.raises(NotImplementedError, match=reason):
        T.init_params(reduced(tconfigs.get_config(arch)),
                      torch.Generator(), device="cpu")


def test_params_from_jax_defaults_to_cuda(monkeypatch):
    """Like the port's other entry points, the conversion runs on ``cuda``
    unless the caller passes ``device="cpu"``, and raises with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree)
    assert params_from_jax(tree, device="cpu")["w"].device.type == "cpu"
