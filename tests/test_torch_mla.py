"""The port's MLA (``repro_torch.models.attention.mla_forward``) against the
reference's on the same inputs (numpy from a seed) and the same weights
(``params_from_jax``), in f32 on the CPU: the prompt through
``ops.flash_attention`` (its plain version here), decode token by token
under both ``mla_decode`` routes, ``_pad_v``, the causal-skip attention,
and the prompt at t > 0 that the reference gets wrong (ROADMAP queue 3,
fault 8)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import attention as A

ARCH = "deepseek-v2-236b"


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.fixture(scope="module")
def mla():
    """Reduced deepseek-v2's first attention block (q.k dim 32 + 16 = 48,
    v dim 32, 4 heads) in f32, in both packages."""
    cfg = reduced(get_config(ARCH))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["stage0"]["sub0"]["attn"])
    tblk = params_from_jax(jax.tree_util.tree_map(np.asarray, jblk),
                           device="cpu")
    return cfg, reduced(tconfigs.get_config(ARCH)), jblk, tblk


def _x(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, s, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    return x, pos


@pytest.mark.parametrize("cached", [False, True])
def test_mla_prompt_matches(mla, cached, monkeypatch):
    """The prompt (no cache, or into an empty cache at t = 0) within 2e-4,
    through ops.flash_attention once at the q.k dim with v padded to it;
    the latents written to the cache within 1e-6."""
    cfg, tcfg, jblk, tblk = mla
    x, pos = _x(cfg, 32)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw:
                        calls.append((q.shape, v.shape))
                        or real(q, k, v, **kw))
    jc = JA.init_cache(cfg, 2, 48, dtype=jnp.float32) if cached else None
    tc = A.init_cache(tcfg, 2, 48, dtype=torch.float32) if cached else None
    kw = dict(t=0) if cached else {}
    want, jc = JA.mla_forward(jnp.asarray(x), jblk, cfg, jnp.asarray(pos),
                              cache=jc, **kw)
    got, tc = A.mla_forward(t(x), tblk, tcfg, torch.from_numpy(pos),
                            cache=tc, **kw)
    close(got, want, 2e-4)
    assert calls == [((2, 4, 32, 48), (2, 4, 32, 48))]
    if cached:
        assert set(tc) == set(jc) == {"ckv", "krope"}
        for key in tc:
            assert tuple(tc[key].shape) == jc[key].shape
            close(tc[key], jc[key], 1e-6)


@pytest.mark.parametrize("mode", ["absorbed", "expand"])
def test_mla_decode_steps_match(mla, mode):
    """Prompt of 16, then one token a step to 32: every step within 5e-4 of
    the reference's step and of the port's own cache-free forward over the
    whole sequence (causal, so row i sees what step i sees)."""
    cfg, tcfg, jblk, tblk = mla
    cfg = dataclasses.replace(cfg, mla_decode=mode)
    tcfg = dataclasses.replace(tcfg, mla_decode=mode)
    s, prompt = 32, 16
    x, pos = _x(cfg, s, seed=1)
    full, _ = A.mla_forward(t(x), tblk, tcfg, torch.from_numpy(pos))
    jc = JA.init_cache(cfg, 2, s, dtype=jnp.float32)
    tc = A.init_cache(tcfg, 2, s, dtype=torch.float32)
    sl = slice(0, prompt)
    _, jc = JA.mla_forward(jnp.asarray(x[:, sl]), jblk, cfg,
                           jnp.asarray(pos[:, sl]), cache=jc, t=0)
    _, tc = A.mla_forward(t(x[:, sl]), tblk, tcfg,
                          torch.from_numpy(pos[:, sl]), cache=tc, t=0)
    for i in range(prompt, s):
        sl = slice(i, i + 1)
        want, jc = JA.mla_forward(jnp.asarray(x[:, sl]), jblk, cfg,
                                  jnp.asarray(pos[:, sl]), cache=jc, t=i)
        got, tc = A.mla_forward(t(x[:, sl]), tblk, tcfg,
                                torch.from_numpy(pos[:, sl]), cache=tc, t=i)
        close(got, want, 5e-4)
        close(got[:, 0], full[:, i], 5e-4)


def test_pad_v_matches():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    got = A._pad_v(t(v), 48)
    assert tuple(got.shape) == (2, 5, 3, 48)
    close(got, JA._pad_v(v, 48), 0)
    assert A._pad_v(t(v), 32).shape == (2, 5, 3, 32)


@pytest.mark.parametrize("groups", [1, 4])
def test_causal_skip_equals_dense_causal_attention(groups):
    """``chunked_attention_causal_skip`` against the port's dense causal
    attention and the reference's own causal-skip (1e-5)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 256, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 256, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 256, 2, 16)).astype(np.float32)
    kw = dict(q_block=32, kv_block=32, groups=groups)
    got = A.chunked_attention_causal_skip(t(q), t(k), t(v), **kw)
    close(got, A.full_attention(t(q), t(k), t(v), causal=True), 1e-5)
    close(got, JA.chunked_attention_causal_skip(q, k, v, **kw), 1e-5)


def test_reference_prompt_at_t_past_zero_is_wrong_and_the_port_raises(mla):
    """Fault 8: a prompt of 8 tokens into a cache at t = 8. The reference's
    MLA attends over the cache with q_offset 0, so query i sees rows 0..i
    rather than 0..8+i, and its output disagrees with its own cache-free
    forward over the 16 tokens; its GQA ignores the cache before t. The
    port refuses both."""
    cfg, tcfg, jblk, tblk = mla
    x, pos = _x(cfg, 16, seed=4)
    full, _ = JA.mla_forward(jnp.asarray(x), jblk, cfg, jnp.asarray(pos))
    jc = JA.init_cache(cfg, 2, 16, dtype=jnp.float32)
    _, jc = JA.mla_forward(jnp.asarray(x[:, :8]), jblk, cfg,
                           jnp.asarray(pos[:, :8]), cache=jc, t=0)
    late, _ = JA.mla_forward(jnp.asarray(x[:, 8:]), jblk, cfg,
                             jnp.asarray(pos[:, 8:]), cache=jc, t=8)
    err = float(np.abs(np.asarray(late) - np.asarray(full)[:, 8:]).max())
    assert err > 1e-2, err
    tc = A.init_cache(tcfg, 2, 16, dtype=torch.float32)
    A.mla_forward(t(x[:, :8]), tblk, tcfg, torch.from_numpy(pos[:, :8]),
                  cache=tc, t=0)
    with pytest.raises(ValueError, match="fault 8"):
        A.mla_forward(t(x[:, 8:]), tblk, tcfg, torch.from_numpy(pos[:, 8:]),
                      cache=tc, t=8)

    gcfg = reduced(get_config("phi3-mini-3.8b"))
    gp = JT.init_params(gcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    gblk = jax.tree_util.tree_map(lambda a: a[0], gp["stage0"]["sub0"]["attn"])
    xg = x[..., :gcfg.d_model]
    gfull, _ = JA.gqa_forward(jnp.asarray(xg), gblk, gcfg, jnp.asarray(pos))
    gc = JA.init_cache(gcfg, 2, 16, dtype=jnp.float32)
    _, gc = JA.gqa_forward(jnp.asarray(xg[:, :8]), gblk, gcfg,
                           jnp.asarray(pos[:, :8]), cache=gc, t=0)
    glate, _ = JA.gqa_forward(jnp.asarray(xg[:, 8:]), gblk, gcfg,
                              jnp.asarray(pos[:, 8:]), cache=gc, t=8)
    err = float(np.abs(np.asarray(glate) - np.asarray(gfull)[:, 8:]).max())
    assert err > 1e-2, err
    tg = params_from_jax(jax.tree_util.tree_map(np.asarray, gblk),
                         device="cpu")
    tgcfg = reduced(tconfigs.get_config("phi3-mini-3.8b"))
    tgc = A.init_cache(tgcfg, 2, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="fault 8"):
        A.gqa_forward(t(xg[:, 8:]), tg, tgcfg, torch.from_numpy(pos[:, 8:]),
                      cache=tgc, t=8)
