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
    """Which archs' full-width prefill K3 takes on the card: every one, the
    MLA ones at their q.k dim of 192 included (and at 48 when reduced); the
    name is kept from before K3 took 192."""
    cfg = tconfigs.get_config(arch)
    d = _k3_head_dim(cfg)
    assert d is None or d in FA.HEAD_DIMS, d
    if arch in MLA_ARCHS:
        assert (d, _k3_head_dim(reduced(cfg))) == (192, 48)


def _local_attn_model(arch, window):
    """Reduced ``arch`` with ``attention_kind="local"`` (a window inside its
    ``attn`` blocks) in both packages, and the reference's weights."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              attention_kind="local", local_window=window)
    tcfg = dataclasses.replace(reduced(tconfigs.get_config(arch)),
                               attention_kind="local", local_window=window)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _no_k3(*args, **kwargs):
    raise AssertionError("a windowed attn block reached K3")


@pytest.mark.parametrize("arch,reason", [("phi3-mini-3.8b", "item 18")])
def test_other_block_kinds_name_their_roadmap_item(arch, reason,
                                                   monkeypatch):
    """Fault 12: a window inside an ``attn`` block (``attention_kind=
    "local"``, window 5 below the 32-token sequence) runs the reference's
    plain windowed attention, and its logits match ``JT.forward`` within
    2e-4. K3 has no window (``reason``: ROADMAP item 18), so the call must
    not reach it."""
    assert reason == "item 18"
    cfg, tcfg, jp, tp = _local_attn_model(arch, 5)
    raw = make_batch(cfg, 2, 32)
    want, _, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])})
    monkeypatch.setattr(A, "_flash", _no_k3)
    got, _, _ = T.forward(tp, tcfg, {"tokens": torch.from_numpy(raw["tokens"])})
    close(got, want, 2e-4)
    unwindowed, _, _ = JT.forward(jp, dataclasses.replace(
        cfg, attention_kind="full"), {"tokens": jnp.asarray(raw["tokens"])})
    assert np.abs(np.asarray(unwindowed) - np.asarray(want)).max() > 1e-2


def test_local_attn_block_decode_matches(monkeypatch):
    """Fault 12, decode: a 16-token prompt into the cache (the plain
    ``chunked_attention`` with the window) and 8 decode steps over the
    window's last 5 keys (``decode_attention(window=)``), each against
    the reference's within 2e-4, K3 never reached."""
    cfg, tcfg, jp, tp = _local_attn_model("phi3-mini-3.8b", 5)
    b, s, prompt = 2, 24, 16
    toks = make_batch(cfg, b, s)["tokens"]
    monkeypatch.setattr(A, "_flash", _no_k3)
    jc = JT.init_decode_caches(cfg, b, s, dtype=jnp.float32)
    tc = T.init_decode_caches(tcfg, b, s, dtype=torch.float32, device="cpu")
    jl, jc = JT.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :prompt])}, jc)
    tl, tc = T.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :prompt])},
                       tc)
    close(tl, jl, 2e-4)
    step = jax.jit(lambda p, c, tok, tt: JT.decode_step(p, cfg, c, tok, tt))
    for pos in range(prompt, s):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, pos]),
                               pos)
        close(tl, jl, 2e-4)


def _mla_model(arch, **moe):
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **moe))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_deepseek_logits_match(arch, monkeypatch):
    """Reduced deepseek-v2 (softmax router) and -v3 (sigmoid router, 3
    dense layers cut to 1, MTP head) in f32: logits against JAX ``forward``
    within 2e-4 at the default capacity factor, the summed MoE aux loss
    within 1e-6, and every layer's prefill
    through ``ops.flash_attention`` once at the q.k dim 48."""
    cfg, tcfg, jp, tp = _mla_model(arch)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, *a, **kw:
                        calls.append(q.shape[-1]) or real(q, *a, **kw))
    raw = make_batch(cfg, 2, 32)
    want, _, jaux = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])})
    got, _, aux = T.forward(tp, tcfg,
                            {"tokens": torch.from_numpy(raw["tokens"])})
    assert calls == [48] * cfg.num_layers
    assert got.shape == (2, 32, cfg.vocab_size)
    close(got, want, 2e-4)
    assert float(jaux) > 0 and abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("mode", ["absorbed", "expand"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_deepseek_decode_steps_match(arch, mode):
    """Prefill 16 then decode token by token to 32 under each
    ``mla_decode``: every step within 5e-4 of ``JT.decode_step`` and of the
    port's own teacher-forced forward (capacity raised so that nothing
    drops, as tests/test_archs.py:68-70 does: drops depend on how many
    tokens a call routes)."""
    cfg, tcfg, jp, tp = _mla_model(arch, capacity_factor=8.0)
    cfg = dataclasses.replace(cfg, mla_decode=mode)
    tcfg = dataclasses.replace(tcfg, mla_decode=mode)
    b, s, prompt = 2, 32, 16
    toks = make_batch(cfg, b, s)["tokens"]
    full, _, _ = T.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    jc = JT.init_decode_caches(cfg, b, s, dtype=jnp.float32)
    tc = T.init_decode_caches(tcfg, b, s, dtype=torch.float32, device="cpu")
    jl, jc = JT.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :prompt])},
                        jc)
    tl, tc = T.prefill(tp, tcfg,
                       {"tokens": torch.from_numpy(toks[:, :prompt])}, tc)
    close(tl, jl, 2e-4)
    close(tl[:, -1], full[:, prompt - 1], 5e-4)
    step = jax.jit(lambda p, c, tok, tt: JT.decode_step(p, cfg, c, tok, tt))
    for pos in range(prompt, s):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, pos]),
                               pos)
        close(tl, jl, 5e-4)
        close(tl, full[:, pos], 5e-4)


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_deepseek_params_carry_across_leaf_for_leaf(arch):
    """The port's ``init_params`` and the reference's converted weights are
    one tree, leaf for leaf (``moe``, MLA's latent projections and norms,
    and -v3's ``mtp`` head included), and ``convert`` needs nothing new."""
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")

    def leaves(tree):
        return jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), a.dtype), tree))
    assert leaves(tp) == leaves(conv)
    assert ("mtp" in tp) == cfg.mtp == (arch == "deepseek-v3-671b")
    moe_subs = [sub for st in tp if st.startswith("stage")
                for sub in tp[st].values() if "moe" in sub]
    assert moe_subs and all("mlp" not in sub for sub in moe_subs)
    assert T.count_params(tp) == sum(int(np.prod(a.shape)) for a in
                                     jax.tree_util.tree_leaves(jp))


def test_params_from_jax_defaults_to_cuda(monkeypatch):
    """Like the port's other entry points, the conversion runs on ``cuda``
    unless the caller passes ``device="cpu"``, and raises with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree)
    assert params_from_jax(tree, device="cpu")["w"].device.type == "cpu"
