"""The port's recurrent slice against the reference package on the same
inputs (numpy from a seed): K4 ``rwkv6_scan`` and K5 ``rg_lru`` (the CPU
route, against the reference's Pallas kernels in interpret mode and its
sequential oracles), the RWKV6 and RG-LRU layers on the same weights, the
sliding-window ring cache, and reduced ``rwkv6-1.6b`` and
``recurrentgemma-9b`` end to end, in f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as LRU
from repro_torch.kernels import rwkv6_scan as WKV
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def pair(x, name):
    """The same f32 values for both packages, cast by each to ``name``."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def wkv_inputs(rng, b, s, h, n):
    """tests/test_kernels.py:63-77's distributions, drawn with numpy."""
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w_log = -np.exp(rng.standard_normal((b, s, h, n)) - 1.0).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
    return r, k, v, w_log, u


# --------------------------------------------------------------------- #
# K4 and K5, CPU route
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,n,chunk", [(2, 64, 2, 32, 16),
                                           (1, 128, 4, 64, 32)])
def test_rwkv6_scan_matches_reference(b, s, h, n, chunk, dtype):
    """Tolerance of tests/test_kernels.py:75-76: f32 1e-3, bf16 5e-2."""
    r, k, v, w_log, u = wkv_inputs(np.random.default_rng(20), b, s, h, n)
    (jr, tr), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (r, k, v))
    got = ops.rwkv6_scan(tr, tk, tv, t(w_log), t(u), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, n)
    tol = 5e-2 if dtype == "bfloat16" else 1e-3
    close(got, jax_ops.rwkv6_scan(jr, jk, jv, w_log, u, chunk=chunk), tol)
    close(got, jax_ref.rwkv6(jr, jk, jv, w_log, u)[0], tol)


@pytest.mark.parametrize("b,s,w,chunk,bw", [(2, 256, 512, 64, 256),
                                            (1, 128, 1024, 128, 512)])
def test_rg_lru_matches_reference(b, s, w, chunk, bw):
    """Tolerance of tests/test_kernels.py:88-89: 1e-4."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    a_log = -np.exp(rng.standard_normal((b, s, w))).astype(np.float32)
    got = ops.rg_lru(t(x), t(a_log), chunk=chunk, bw=bw)
    close(got, jax_ops.rg_lru(x, a_log, chunk=chunk, bw=bw), 1e-4)
    close(got, jax_ref.rg_lru(x, a_log), 1e-4)


def test_oracles_with_initial_state_match_reference():
    """ref.rwkv6 and ref.rg_lru against the reference's oracles, from a
    nonzero state; both sides are the same f32 recurrence (1e-5)."""
    rng = np.random.default_rng(22)
    r, k, v, w_log, u = wkv_inputs(rng, 2, 24, 2, 16)
    s0 = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    got, got_s = ref.rwkv6(t(r), t(k), t(v), t(w_log), t(u), t(s0))
    want, want_s = jax_ref.rwkv6(r, k, v, w_log, u, s0)
    close(got, want, 1e-5)
    close(got_s, want_s, 1e-5)
    x = rng.standard_normal((2, 40, 48)).astype(np.float32)
    a_log = -np.exp(rng.standard_normal((2, 40, 48))).astype(np.float32)
    h0 = rng.standard_normal((2, 48)).astype(np.float32)
    close(ref.rg_lru(t(x), t(a_log), t(h0)), jax_ref.rg_lru(x, a_log, h0),
          1e-5)
    close(ops.rg_lru(t(x), t(a_log), chunk=8, h0=t(h0)),
          jax_ref.rg_lru(x, a_log, h0), 1e-5)


# (B, S, W, tiling): S under one window and W ragged against the kernel's
# 32-channel block with W * 4 % 16 != 0 (its threads load the tiles); S over
# one window, ragged; and a small tiling (windows of 64) over three windows,
# the last ragged
LRU_CASES = [(2, 300, 42, {}), (1, 2100, 36, {}),
             (2, 150, 20, dict(steps=16, ranks=4, sub=4))]


def lru_inputs(rng, b, s, w):
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    a_log = -np.exp(rng.standard_normal((b, s, w))).astype(np.float32)
    return x, a_log, rng.standard_normal((b, w)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w,tiling", LRU_CASES)
def test_rg_lru_cluster_scan_matches_reference(b, s, w, tiling, dtype):
    """K5's decomposition (``LRU.cluster_scan``: windows, ranks,
    sub-segments, the rank chain and the window carry) against the
    reference's Pallas kernel in interpret mode (from zero) and its
    sequential oracle (from zero and from h0), x and a_log in ``dtype``
    widened to f32 by each side; 1e-4 (tests/test_kernels.py:88-89). The
    CPU route of ``ops.rg_lru`` takes the same ``dtype`` and returns f32."""
    x, a_log, h0 = lru_inputs(np.random.default_rng(27), b, s, w)
    (jx, tx), (ja, ta) = pair(x, dtype), pair(a_log, dtype)
    got = LRU.cluster_scan(tx, ta, **tiling)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    close(got, jax_ops.rg_lru(jx, ja, chunk=s, bw=w), 1e-4)
    close(got, jax_ref.rg_lru(jx, ja), 1e-4)
    want = jax_ref.rg_lru(jx, ja, h0)
    close(LRU.cluster_scan(tx, ta, t(h0), **tiling), want, 1e-4)
    got = ops.rg_lru(tx, ta, chunk=s, bw=w, h0=t(h0))
    assert got.dtype == torch.float32
    close(got, want, 1e-4)


def test_rg_lru_cluster_scan_chains_through_h0():
    """Two calls chained through h0, split at a window boundary, equal one
    call over both: the window carry is the last row of h as written. 1e-6:
    the same arithmetic on the same values, save exp over tensors of other
    sizes, which may round an ulp apart. The whole against the reference's
    oracle, 1e-4."""
    x, a_log, h0 = lru_inputs(np.random.default_rng(28), 2, 4100, 12)
    cut = LRU.RANKS * LRU.STEPS
    tx, ta = t(x), t(a_log)
    whole = LRU.cluster_scan(tx, ta, t(h0))
    first = LRU.cluster_scan(tx[:, :cut], ta[:, :cut], t(h0))
    second = LRU.cluster_scan(tx[:, cut:], ta[:, cut:], first[:, -1])
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               atol=1e-6, rtol=1e-6)
    close(whole, jax_ref.rg_lru(x, a_log, h0), 1e-4)


def test_rwkv6_chunked_with_state_matches_reference():
    """The plain version of K4 from a nonzero state: out and final state
    against the reference's rwkv6_chunked and the sequential oracle (f32,
    1e-4: chunked and sequential sums differ in order)."""
    rng = np.random.default_rng(23)
    r, k, v, w_log, u = wkv_inputs(rng, 2, 48, 3, 16)
    s0 = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    got, got_s = R.rwkv6_chunked(t(r), t(k), t(v), t(w_log), t(u), t(s0),
                                 chunk=16)
    want, want_s = JR.rwkv6_chunked(r, k, v, w_log, u, s0, chunk=16)
    close(got, want, 1e-5)
    close(got_s, want_s, 1e-5)
    seq, seq_s = jax_ref.rwkv6(r, k, v, w_log, u, s0)
    close(got, seq, 1e-4)
    state = t(s0)
    out = ops.rwkv6_scan(t(r), t(k), t(v), t(w_log), t(u), chunk=16,
                         state=state)
    close(out, seq, 1e-4)
    close(state, seq_s, 1e-4)          # overwritten with the final state


def test_rwkv6_chunked_stays_finite_where_reference_overflows():
    """ROADMAP queue 3, item 4: with a log decay of -4 per step, exp of the
    above-diagonal exponent (up to 4 * 31) overflows f32 in a 32-token
    chunk. The reference masks by multiplying (inf * 0 = NaN); the port
    masks with ``where``, as the TPU kernel does, and matches the
    sequential oracle (f32, 1e-4)."""
    rng = np.random.default_rng(24)
    r, k, v, _, u = wkv_inputs(rng, 1, 64, 2, 16)
    w_log = np.full_like(r, -4.0)
    s0 = np.zeros((1, 2, 16, 16), np.float32)
    want, _ = JR.rwkv6_chunked(r, k, v, w_log, u, s0, chunk=32)
    assert not np.isfinite(np.asarray(want)).all()
    got, _ = R.rwkv6_chunked(t(r), t(k), t(v), t(w_log), t(u), t(s0),
                             chunk=32)
    assert bool(torch.isfinite(got).all())
    close(got, jax_ref.rwkv6(r, k, v, w_log, u)[0], 1e-4)


def _two_pass(r, k, v, w_log, u, state=None):
    """WKV.two_pass, with the largest exponent it formed."""
    seen = []
    out, final = WKV.two_pass(r, k, v, w_log, u, state,
                              on_exponent=lambda x: seen.append(x.max()))
    return out, final, max(float(m) for m in seen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,n,chunk", [(2, 64, 2, 32, 16),
                                           (1, 128, 4, 64, 32)])
def test_rwkv6_two_pass_matches_reference(b, s, h, n, chunk, dtype):
    """K4's decomposition (chunk states first, then outputs, the scores
    factored across sub-chunks of 16) against the reference's Pallas kernel
    in interpret mode, with tests/test_kernels.py:75-76's tolerances (f32
    1e-3, bf16 5e-2), and against the port's plain chunked version on the
    same inputs (1e-4: both f32, summed in other orders). No exponent it
    forms is above 0."""
    r, k, v, w_log, u = wkv_inputs(np.random.default_rng(25), b, s, h, n)
    (jr, tr), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (r, k, v))
    got, got_s, top = _two_pass(tr, tk, tv, t(w_log), t(u))
    assert top <= 0.0
    tol = 5e-2 if dtype == "bfloat16" else 1e-3
    close(got, jax_ops.rwkv6_scan(jr, jk, jv, w_log, u, chunk=chunk), tol)
    plain, plain_s = R.rwkv6_chunked(tr, tk, tv, t(w_log), t(u),
                                     torch.zeros(b, h, n, n), chunk=chunk)
    close(got, plain, 1e-4)
    close(got_s, plain_s, 1e-4)


@pytest.mark.parametrize("s", [37, 80])
def test_rwkv6_two_pass_from_a_state_at_a_ragged_length(s):
    """A given initial state and a ragged last chunk (padded with zeros),
    out and final state against the reference's sequential oracle (f32,
    1e-4)."""
    rng = np.random.default_rng(26)
    r, k, v, w_log, u = wkv_inputs(rng, 2, s, 2, 32)
    s0 = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    got, got_s, top = _two_pass(t(r), t(k), t(v), t(w_log), t(u), t(s0))
    assert top <= 0.0
    want, want_s = jax_ref.rwkv6(r, k, v, w_log, u, s0)
    close(got, want, 1e-4)
    close(got_s, want_s, 1e-4)


def test_rwkv6_two_pass_stays_finite_at_extreme_decay():
    """The seed-24 input of a log decay of -4 a step, where the reference
    model overflows above the diagonal: the decomposition forms no exponent
    above 0, stays finite and matches the sequential oracle (f32, 1e-4)."""
    rng = np.random.default_rng(24)
    r, k, v, _, u = wkv_inputs(rng, 1, 64, 2, 16)
    w_log = np.full_like(r, -4.0)
    got, _, top = _two_pass(t(r), t(k), t(v), t(w_log), t(u))
    assert top <= 0.0
    assert bool(torch.isfinite(got).all())
    close(got, jax_ref.rwkv6(r, k, v, w_log, u)[0], 1e-4)


def test_shape_checks_match_the_reference():
    z = torch.zeros(1, 48, 2, 32)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(z, z, z, z, torch.zeros(2, 32))     # 48 % 32 != 0
    with pytest.raises(ValueError):
        ops.rwkv6_scan(z, z, z, z, torch.zeros(2, 16), chunk=16)
    ops.rwkv6_scan(z, z, z, z, torch.zeros(2, 32), chunk=16)
    x = torch.zeros(1, 128, 96)
    with pytest.raises(ValueError):
        ops.rg_lru(x, x, bw=64)                            # 96 % 64 != 0
    with pytest.raises(ValueError):
        ops.rg_lru(x, x[:, :64])
    ops.rg_lru(x, x, bw=32)


# --------------------------------------------------------------------- #
# layers on the same random weights
# --------------------------------------------------------------------- #
def _weights(init, cfg, seed):
    """The reference's init in f32, with its zero-initialised leaves (token
    mixes, bonus, output norm) replaced by seeded normals so that they are
    exercised too."""
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if not a.any() else a,
        jax.tree_util.tree_map(np.asarray, init(
            jax.random.PRNGKey(seed), cfg, cfg.num_layers, jnp.float32)))
    return jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_time_and_channel_mix_match_reference(carried):
    cfg = reduced(get_config("rwkv6-1.6b"))
    tcfg = reduced(tconfigs.get_config("rwkv6-1.6b"))
    jp, tp = _weights(JR.init_rwkv6, cfg, 30)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    st = x_last = None
    if carried:
        st = rng.standard_normal((2, h, n, n)).astype(np.float32)
        x_last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want, (ws, wx) = JR.rwkv6_forward(
        x, jp, cfg, state=st, x_last=x_last)
    got, (gs, gx) = R.rwkv6_forward(
        t(x), tp, tcfg, state=None if st is None else t(st),
        x_last=None if x_last is None else t(x_last))
    close(got, want, 1e-4)
    close(gs, ws, 1e-4)
    close(gx, wx, 0)
    one = x[:, :1]
    want1, (ws1, _) = JR.rwkv6_forward(one, jp, cfg, state=st, x_last=x_last)
    got1, (gs1, _) = R.rwkv6_forward(
        t(one), tp, tcfg, state=None if st is None else t(st),
        x_last=None if x_last is None else t(x_last))
    close(got1, want1, 1e-4)
    close(gs1, ws1, 1e-4)
    jc, tc = _weights(JR.init_rwkv6_cmix, cfg, 32)
    want, wl = JR.rwkv6_cmix(x, jc, x_last=x_last)
    got, gl = R.rwkv6_cmix(t(x), tc,
                           x_last=None if x_last is None else t(x_last))
    close(got, want, 1e-4)
    close(gl, wl, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype):
    """The taps are summed in x's dtype, in order: f32 1e-6; bf16 within
    one bf16 ulp at |y| < 4 (2^-6), for rounding placed differently."""
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 20, 24)).astype(np.float32)
    kern = (rng.standard_normal((R.CONV_WIDTH, 24)) * 0.5).astype(np.float32)
    cs = rng.standard_normal((2, R.CONV_WIDTH - 1, 24)).astype(np.float32)
    jx, tx = pair(x, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -6
    for state in (None, cs):
        want, wst = JR._causal_conv1d(jx, kern, state)
        got, gst = R._causal_conv1d(tx, t(kern),
                                    None if state is None else t(state))
        assert got.dtype == tx.dtype
        close(got.float(), np.asarray(want, np.float32), tol)
        close(gst, wst, 0)


@pytest.mark.parametrize("seq", [1, 24])
def test_rglru_forward_matches_reference(seq):
    cfg = reduced(get_config("recurrentgemma-9b"))
    tcfg = reduced(tconfigs.get_config("recurrentgemma-9b"))
    jp, tp = _weights(JR.init_rglru, cfg, 34)
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    w = cfg.lru_width
    for state in (None, {"h": rng.standard_normal((2, w)).astype(np.float32),
                         "conv": rng.standard_normal(
                             (2, R.CONV_WIDTH - 1, w)).astype(np.float32)}):
        want, ws = JR.rglru_forward(x, jp, cfg, state=state)
        got, gs = R.rglru_forward(
            t(x), tp, tcfg,
            state=None if state is None else {k: t(v) for k, v in
                                              state.items()})
        close(got, want, 1e-4)
        close(gs["h"], ws["h"], 1e-5)
        close(gs["conv"], ws["conv"], 1e-5)


# --------------------------------------------------------------------- #
# reduced models end to end
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, reduced(tconfigs.get_config(request.param)), jp, tp


def test_forward_logits_match(model):
    cfg, tcfg, jp, tp = model
    raw = make_batch(cfg, 2, 32)
    want, _, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])})
    got, _, _ = T.forward(tp, tcfg, {"tokens": torch.from_numpy(raw["tokens"])})
    assert got.shape == (2, 32, cfg.vocab_size)
    close(got, want, 2e-4)


def _decode_run(cfg, tcfg, jp, tp):
    """Prefill then decode token by token (tests/test_archs.py:65-91): each
    step's logits match the reference's step (5e-4) and the port's own
    teacher-forced forward (5e-4)."""
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
    jflat = jax.tree_util.tree_leaves(jc)
    tflat = jax.tree_util.tree_leaves(tc)
    for a, b_ in zip(jflat, tflat):
        close(b_, a, 5e-4)


def test_decode_steps_match(model):
    _decode_run(*model)


def test_local_ring_wraps_like_the_reference():
    """recurrentgemma at local_window=8: the 16-token prompt overflows the
    ring and every decode step overwrites a slot."""
    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-9b")),
                              local_window=8)
    tcfg = dataclasses.replace(
        reduced(tconfigs.get_config("recurrentgemma-9b")), local_window=8)
    jp = JT.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    _decode_run(cfg, tcfg, jp, tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_init(arch):
    """init_params has the reference's key paths, shapes and dtypes (f32
    leaves included), and params_from_jax carries them over unchanged."""
    cfg = reduced(get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = T.init_params(reduced(tconfigs.get_config(arch)),
                       torch.Generator().manual_seed(0), device="cpu")
    conv = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")

    def layout(tree):
        return jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree))

    assert layout(tp) == layout(conv) == layout(jp)
    assert T.count_params(tp) == JT.count_params(jp)
    sub = tp["stage0"]["sub0"]
    blk = sub["tmix"] if arch.startswith("rwkv") else sub["rec"]
    jblk = jp["stage0"]["sub0"]["tmix" if arch.startswith("rwkv") else "rec"]
    const = "w_base" if arch.startswith("rwkv") else "lam"
    close(blk[const], jblk[const], 0)
