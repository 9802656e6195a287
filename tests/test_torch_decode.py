"""Decode attention in the port: the plain version of the kernel D1
(``ref.decode_attention``, the CPU route of ``ops.decode_attention``) and
the three model routes through it (GQA's cache, the ``local`` blocks' ring,
Whisper's cross cache) against the reference's plain ``decode_attention``
and ``_local_ring_attend``, on the same seeded numpy inputs, on the CPU.

D1 returns the partial softmax (m, l, o); o / l is the reference's output.
f32 is held to 1e-5 (as ``tests/test_torch_models.py`` holds the port's
decode attention), bf16 caches to the repo's bf16 2e-2
(``tests/test_kernels.py:17-19``).
"""
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
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

S = 37              # cache rows: neither 3 nor 8 splits divide them
F32_TOL = 1e-5
BF16_TOL = 2e-2


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _qkv(seed, b, h, kv, d, s=S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


def _normalised(m, l_sum, o):
    return o / l_sum[..., None]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("tt", [1, 17, S - 1, S])
@pytest.mark.parametrize("d", [32, 80, 96, 256])
@pytest.mark.parametrize("g", [1, 4, 7])
def test_plain_version_matches_the_reference(g, d, tt, window):
    """o / l of every split count equals the reference's decode_attention,
    as does the model's route; at t = 1 and with the window most of 8
    splits hold no valid row."""
    q, k, v = _qkv(1000 * g + d + tt, 2, 2 * g, 2, d)
    want = np.asarray(JA.decode_attention(q, k, v, tt, window=window))
    lo = tt - window if window else None
    for n in (1, 3, 8):
        parts = ops.decode_attention(t(q)[:, 0], t(k), t(v), lo=lo, hi=tt,
                                     n_splits=n)
        close(_normalised(*parts), want[:, 0], F32_TOL)
    close(A.decode_attention(t(q), t(k), t(v), tt, window=window), want,
          F32_TOL)


@pytest.mark.parametrize("g,d", [(1, 96), (4, 160), (7, 128)])
def test_bf16_caches_match_the_reference(g, d):
    """A bf16 q and cache through the model's route against the reference's
    bf16 decode_attention (both upcast to f32 and return bf16)."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(7 + g, 2, 2 * g, 2, d))
    want = JA.decode_attention(q, k, v, 30, window=12)
    got = A.decode_attention(*(t(a.astype(jnp.float32)).bfloat16()
                               for a in (q, k, v)), 30, window=12)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_splits_and_shards_merge_to_the_whole():
    """Partials of the cache's two row blocks (``offset``) merge to the
    whole; a block with no valid row, and every split of it, gives
    (NEG_INF, 0, 0); so does a split past the valid rows."""
    q, k, v = (t(a) for a in _qkv(3, 2, 8, 2, 64))
    q = q[:, 0]
    whole = ops.decode_attention(q, k, v, hi=30)
    top = ops.decode_attention(q, k[:, :20], v[:, :20], hi=30, n_splits=3)
    low = ops.decode_attention(q, k[:, 20:], v[:, 20:], hi=30, offset=20,
                               n_splits=8)
    m = torch.maximum(top[0], low[0])
    wt, wl = torch.exp(top[0] - m), torch.exp(low[0] - m)
    close(m, whole[0], F32_TOL)
    close(top[1] * wt + low[1] * wl, whole[1], F32_TOL)
    close(top[2] * wt[..., None] + low[2] * wl[..., None], whole[2], F32_TOL)
    for n in (1, 4):
        m, l_sum, o = ops.decode_attention(q, k[:, 30:], v[:, 30:], hi=30,
                                           offset=30, n_splits=n)
        assert bool((m == ref.NEG_INF).all()) and not l_sum.any() \
            and not o.any()
    assert ref.decode_rows(0, 30, 30, 7, False) == (0, 0)
    assert ref.decode_rows(25, 30, 20, 17, False) == (5, 10)
    assert ref.decode_rows(25, 30, 20, 17, True) == (0, 17)
    assert ref.decode_split(3, 8) == 1 and ref.decode_split(0, 2) == 0


def _ring(seed, window, upto, b=2, kv=1, g=4, d=32):
    """A ring of ``window`` slots (as ``init_decode_caches`` makes it)
    written one position at a time, 0..upto, by both packages."""
    rng = np.random.default_rng(seed)
    shape = (b, window, kv, d)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "pos": jnp.full((window,), -1, jnp.int32)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "pos": torch.full((window,), -1, dtype=torch.int32)}
    for p in range(upto + 1):
        kn = rng.standard_normal((b, 1, kv, d)).astype(np.float32)
        vn = rng.standard_normal((b, 1, kv, d)).astype(np.float32)
        jc = JT._local_ring_update(jc, kn, vn, jnp.asarray([p]))
        T._local_ring_update(tc, t(kn), t(vn), torch.tensor([p]))
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    return q, jc, tc


@pytest.mark.parametrize("slots,window,tt", [(8, 8, 5), (8, 8, 12),
                                             (8, 8, 20), (8, 12, 20),
                                             (16, 6, 21)])
def test_ring_route_matches_the_reference(slots, window, tt):
    """The ring's decode (``_local_ring_attend``) before and after the
    slots wrap, with the window the ring's length or longer (a ring cut to
    max_len) or shorter, against the reference's; and the kernel's plain
    version with the ring's ``pos`` at 3 splits."""
    q, jc, tc = _ring(tt + slots, slots, tt)
    close(tc["pos"], jc["pos"], 0)
    want = np.asarray(JT._local_ring_attend(q, jc, tt, window))
    close(T._local_ring_attend(t(q), tc, tt, window), want, F32_TOL)
    parts = ops.decode_attention(t(q)[:, 0], tc["k"], tc["v"],
                                 lo=tt - window + 1, hi=tt + 1, pos=tc["pos"],
                                 n_splits=3)
    close(_normalised(*parts), want[:, 0], F32_TOL)


def _whisper():
    cfg = reduced(get_config("whisper-small"))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    layer0 = (jax.tree_util.tree_map(lambda a: a[0], jp["stage0"]["sub0"]),
              T._tree_map(lambda a: a[0], tp["stage0"]["sub0"]))
    return cfg, reduced(tconfigs.get_config("whisper-small")), layer0


def test_cross_route_matches_the_reference():
    """Whisper's decoder block at decode (self-attention over its cache,
    then cross-attention over the cached encoder K/V, through
    ``decode_attention`` over every cross row) against the reference's
    block on the same weights and caches: its output, and the cross
    attention alone at Whisper's cross-cache shape (1500 frames of 64)."""
    cfg, tcfg, (jbp, tbp) = _whisper()
    rng = np.random.default_rng(5)
    b, rows, tt = 2, 16, 6
    shape = (b, rows, cfg.num_kv_heads, cfg.head_dim)
    cache = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ("k", "v", "xk", "xv")}
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    sig = ("attn", False)
    want, _, _ = JT.apply_block(jnp.asarray(x), jbp, cfg, sig,
                                jnp.full((b, 1), tt),
                                cache={k: jnp.asarray(a)
                                       for k, a in cache.items()}, t=tt)
    got, _, _ = T.apply_block(t(x), tbp, tcfg, sig,
                              torch.full((b, 1), tt),
                              cache={k: t(a) for k, a in cache.items()},
                              t=tt)
    close(got, np.asarray(want), F32_TOL)
    q, xk, xv = _qkv(6, 2, 12, 12, 64, 1500)
    close(A.decode_attention(t(q), t(xk), t(xv), 1500),
          np.asarray(JA.decode_attention(q, xk, xv, 1500)), F32_TOL)


@pytest.mark.parametrize("arch,per_step", [
    ("phi3-mini-3.8b", lambda c: c.num_layers),
    ("recurrentgemma-9b", lambda c: c.layer_kinds().count("local")),
    ("whisper-small", lambda c: 2 * c.num_layers),
    ("deepseek-v2-236b", lambda c: 0)])
def test_decode_steps_run_decode_attention_once_a_layer(arch, per_step,
                                                        monkeypatch):
    """A decode step calls ``ops.decode_attention`` once an attn or local
    layer, once more a cross-attention layer, and never for MLA's absorbed
    decode (it attends in the latent space)."""
    cfg = reduced(tconfigs.get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    caches = T.init_decode_caches(cfg, 2, 16, dtype=torch.float32,
                                  device="cpu")
    calls = []
    real = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention", lambda *a, **kw:
                        calls.append(a[1].shape) or real(*a, **kw))
    for pos in range(3):
        logits, caches = T.decode_step(params, cfg, caches,
                                       torch.tensor([1, 2]), pos)
        assert bool(torch.isfinite(logits).all())
    assert len(calls) == 3 * per_step(cfg), (arch, len(calls))


@pytest.mark.parametrize("q_shape,kv_shape,match", [
    ((2, 4, 264), (2, 9, 2, 264), "head dim 264"),
    ((2, 4, 36), (2, 9, 2, 36), "head dim 36"),
    ((2, 4, 4), (2, 9, 2, 4), "head dim 4"),
    ((2, 6, 32), (2, 9, 4, 32), "6 query heads over 4"),
    ((2, 34, 32), (2, 9, 2, 32), "at most 16"),
    ((2, 4, 32), (2, 9, 2, 40), "q must be"),
])
def test_check_shapes_refuses_what_the_kernel_does_not_take(q_shape,
                                                            kv_shape, match):
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(q, k, k, hi=3)


def test_check_shapes_refuses_mismatched_caches_and_pos():
    q, k = torch.zeros(2, 4, 32), torch.zeros(2, 9, 2, 32)
    with pytest.raises(ValueError, match="share one"):
        ops.decode_attention(q, k, torch.zeros(2, 9, 1, 32), hi=3)
    with pytest.raises(ValueError, match="pos must be"):
        ops.decode_attention(q, k, k, hi=3,
                             pos=torch.zeros(8, dtype=torch.int32))


def test_strides_read_in_place_or_refuse():
    """The kernel reads a cache where it lies: a whole cache and a slice of
    its kv heads give their strides; a view whose rows do not start on 16
    bytes, or with a stride along D, is refused, never copied."""
    big = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert DA._strides("k", big) == (2048, 256, 64)
    assert DA._strides("k", big[:, :, 1:3]) == (2048, 256, 64)
    with pytest.raises(ValueError, match="in place"):
        DA._strides("k", big[..., 4:36])
    with pytest.raises(ValueError, match="in place"):
        DA._strides("k", big.transpose(2, 3))


def test_split_count_fills_the_card():
    """Splits per (b, kv head) so that the grid covers 132 SMs twice,
    each split keeping 32 rows where the cache has them."""
    assert DA.split_count(8 * 32, 2049, 132) == 2       # phi3 decode
    assert DA.split_count(8 * 4, 2049, 132) == 9        # Qwen2-VL
    assert DA.split_count(8 * 1, 2048, 132) == 33       # RecurrentGemma's ring
    assert DA.split_count(32 * 12, 1500, 132) == 1      # Whisper's cross cache
    assert DA.split_count(8, 40, 132) == 1
    assert DA.split_count(8, 0, 132) == 1
