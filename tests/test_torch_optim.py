"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
on the same trees of numpy inputs from a seed, in f32 on the CPU, and the
ports of the reference's own optimizer tests
(``tests/test_substrates.py:26-59``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.optim import adamw as TA

# a tree in the shapes of the model's leaves: a stack of layers, a bias,
# an embedding, a norm scale
SHAPES = {"stage0": {"w": (3, 64, 48), "b": (48,)},
          "embed": (100, 16), "norm": {"scale": (16,)}}


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _draw(rng, scale=1.0):
    return _tree(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32), SHAPES)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32))}


def _run_both(scale, steps=5, **kw):
    """``steps`` updates of both packages on the same gradients."""
    rng = np.random.default_rng(7)
    p0 = _draw(rng)
    grads = [_draw(rng, scale) for _ in range(steps)]
    jc = JA.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, **kw)
    tc = TA.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, **kw)
    jp = _tree(jnp.asarray, p0)
    tp = _tree(lambda a: torch.from_numpy(a.copy()), p0)
    js, ts = JA.init(jc, jp), TA.init(tc, tp)
    for g in grads:
        jp, js, jm = JA.update(jc, jp, _tree(jnp.asarray, g), js)
        tp, ts, tm = TA.update(tc, tp, _tree(torch.from_numpy, g), ts)
    return (jp, js, jm), (tp, ts, tm)


def _rel(a, b):
    """Each leaf's max abs difference over its max abs value, the worst."""
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return max(np.abs(fa[k] - fb[k]).max() / max(np.abs(fa[k]).max(), 1e-30)
               for k in fa)


def _state_parts(compress):
    return ("mu", "nu") + (("err",) if compress else ())


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_matches_reference(moments, compress):
    """Five steps under the clip norm (the clip factor is 1): params, mu,
    nu and err within 1e-6 relative, step an int32 0-d tensor, the metrics
    equal."""
    (jp, js, jm), (tp, ts, tm) = _run_both(
        1e-3, moment_dtype=moments, compress_grads=compress)
    assert float(jm["grad_norm"]) < 1.0
    assert _rel(jp, tp) < 1e-6
    for part in _state_parts(compress):
        assert _rel(js[part], ts[part]) < 1e-6, part
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert int(ts["step"]) == int(js["step"]) == 5
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-6 * float(jm["grad_norm"])


def _norm64(tree):
    """The global norm summed in float64, rounded once to f32."""
    return np.float32(np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                                  for a in _flat(tree).values())))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_clipped_update_matches_reference(moments, compress, monkeypatch):
    """Five steps above the clip norm. The global norm is a sum of ~20 k
    f32 squares whose order differs between XLA and torch (each is held to
    float64 in ``test_global_norm_schedule_and_compression_match``), and a
    last-bit difference in the clip factor would show in every element.
    So both packages take the norm from float64 here, and the rest of the
    update is held to 1e-6 relative as above."""
    monkeypatch.setattr(JA, "global_norm", lambda t: jnp.float32(_norm64(t)))
    monkeypatch.setattr(TA, "global_norm",
                        lambda t: torch.tensor(_norm64(t)))
    (jp, js, jm), (tp, ts, tm) = _run_both(
        1.0, moment_dtype=moments, compress_grads=compress)
    assert float(jm["grad_norm"]) > 1.0
    assert float(tm["grad_norm"]) == float(jm["grad_norm"])
    assert _rel(jp, tp) < 1e-6
    for part in _state_parts(compress):
        assert _rel(js[part], ts[part]) < 1e-6, part


def test_update_in_pieces_equals_whole(monkeypatch):
    """The update walks each leaf in pieces of at most ``PIECE`` elements;
    the result is bitwise the same as in one piece."""
    outs = []
    for piece in (1 << 30, 1000):
        monkeypatch.setattr(TA, "PIECE", piece)
        outs.append(_run_both(1.0, steps=3, moment_dtype="bfloat16")[1])
    (pa, sa, _), (pb, sb, _) = outs
    for a, b in ((pa, pb), (sa["mu"], sb["mu"]), (sa["nu"], sb["nu"])):
        fa, fb = _flat(a), _flat(b)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    monkeypatch.setattr(TA, "PIECE", 64 * 48 * 2)
    assert TA._pieces(torch.zeros(48))[0].shape == (48,)
    assert [p.shape[0] for p in TA._pieces(torch.zeros(5, 64, 48))] == \
        [2, 2, 1]


def test_global_norm_schedule_and_compression_match():
    cfg, tcfg = JA.OptConfig(warmup_steps=10, total_steps=40), \
        TA.OptConfig(warmup_steps=10, total_steps=40)
    for step in (0, 1, 5, 10, 11, 25, 40, 55):
        want = float(JA.schedule(cfg, jnp.int32(step)))
        got = TA.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7 * max(want, 1e-12), step
    rng = np.random.default_rng(3)
    tree = _draw(rng)
    exact = np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                        for a in _flat(tree).values()))
    ref = float(JA.global_norm(_tree(jnp.asarray, tree)))
    got = float(TA.global_norm(_tree(torch.from_numpy, tree)))
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(ref - exact) <= 1e-5 * exact
    g = rng.standard_normal((64, 48)).astype(np.float32)
    err = (rng.standard_normal((64, 48)) * 1e-3).astype(np.float32)
    jd, je = JA.compress_int8(jnp.asarray(g), jnp.asarray(err, jnp.bfloat16))
    td, te = TA.compress_int8(torch.from_numpy(g),
                              torch.from_numpy(err).bfloat16())
    assert te.dtype == torch.bfloat16 and td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(te.float().numpy(),
                               np.asarray(je.astype(jnp.float32)), rtol=1e-6,
                               atol=1e-7)


def test_init_state_layout():
    params = _tree(lambda s: torch.zeros(s, dtype=torch.bfloat16), SHAPES)
    st = TA.init(TA.OptConfig(moment_dtype="bfloat16", compress_grads=True),
                 params)
    assert set(st) == {"step", "mu", "nu", "err"}
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert st["mu"]["stage0"]["w"].dtype == torch.bfloat16
    assert st["err"]["embed"].dtype == torch.bfloat16
    assert set(TA.init(TA.OptConfig(), params)) == {"step", "mu", "nu"}
    assert TA.init(TA.OptConfig(), params)["nu"]["embed"].dtype == \
        torch.float32


# ---- ports of tests/test_substrates.py:26-59 --------------------------- #
def quad_problem():
    params = {"w": torch.ones((4, 4)) * 2.0, "b": torch.zeros((4,))}

    def loss(p, x):
        y = x @ p["w"] + p["b"]
        return torch.mean(torch.square(y))
    return params, loss


def _grads(loss, params, x):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    gs = torch.autograd.grad(loss(live, x), list(live.values()))
    return dict(zip(live, gs))


def test_adamw_reduces_loss():
    params, loss = quad_problem()
    cfg = TA.OptConfig(lr=5e-2, warmup_steps=1, total_steps=100)
    state = TA.init(cfg, params)
    x = torch.randn((16, 4), generator=torch.Generator().manual_seed(0))
    l0 = float(loss(params, x))
    for _ in range(50):
        params, state, m = TA.update(cfg, params, _grads(loss, params, x),
                                     state)
    assert float(loss(params, x)) < 0.2 * l0
    assert bool(torch.isfinite(m["grad_norm"]))


def test_adamw_bf16_moments_and_compression():
    params, loss = quad_problem()
    cfg = TA.OptConfig(lr=5e-2, warmup_steps=1, total_steps=100,
                       moment_dtype="bfloat16", compress_grads=True)
    state = TA.init(cfg, params)
    assert state["mu"]["w"].dtype == torch.bfloat16
    x = torch.randn((16, 4), generator=torch.Generator().manual_seed(0))
    l0 = float(loss(params, x))
    for _ in range(60):
        params, state, _ = TA.update(cfg, params, _grads(loss, params, x),
                                     state)
    assert float(loss(params, x)) < 0.3 * l0       # compression converges


def test_grad_compression_error_feedback():
    g = torch.tensor([[0.003, -1.5], [2.0, 1e-4]])
    err = torch.zeros_like(g, dtype=torch.bfloat16)
    deq, new_err = TA.compress_int8(g, err)
    # dequantized + residual == original (error feedback conserves signal)
    np.testing.assert_allclose((deq + new_err.float()).numpy(), g.numpy(),
                               atol=1e-2)
