"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same inputs (numpy from a seed) and the same
weights (``params_from_jax``), in f32 on the CPU: routing, the routed and
shared experts, the capacity drops and the aux loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as M

# softmax router, 2 shared experts; sigmoid router, 1 shared expert
ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _cfgs(arch, **moe):
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **moe))
    return cfg, tcfg


def _weights(cfg):
    jp = JM.init_moe(jax.random.PRNGKey(1), cfg, cfg.num_layers,
                     dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, n // 2, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(arch):
    """Scores, top-k, renormalised weights and the Switch aux loss (1e-6)."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(cfg)
    x = _tokens(cfg, 32).reshape(-1, cfg.d_model)
    jw, ji, jaux = JM._route(jnp.asarray(x), jp["router"], cfg.moe)
    tw, ti, taux = M._route(t(x), tp["router"], tcfg.moe)
    assert ti.tolist() == np.asarray(ji).tolist()
    close(tw, jw, 1e-6)
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_without_drops(arch):
    """``capacity_factor`` raised so that nothing drops, as
    tests/test_archs.py:68-70 does: output within 2e-4, aux within 1e-6."""
    cfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _weights(cfg)
    x = _tokens(cfg, 32, seed=1)
    want, jaux = JM.moe_ffn(jnp.asarray(x), jp, cfg)
    got, taux = M.moe_ffn(t(x), tp, tcfg)
    assert tuple(got.shape) == x.shape
    close(got, want, 2e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_groups_match(arch):
    """``group_size`` > 0: the reference's ``lax.scan`` over groups, each
    with its own capacity (default factor, so groups drop on their own),
    against the port's loop; aux is the groups' mean."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(cfg)
    x = _tokens(cfg, 64, seed=2)
    want, jaux = JM.moe_ffn(jnp.asarray(x), jp, cfg, group_size=16)
    got, taux = M.moe_ffn(t(x), tp, tcfg, group_size=16)
    close(got, want, 2e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6
    with pytest.raises(ValueError, match="groups of 24"):
        M.moe_ffn(t(x), tp, tcfg, group_size=24)


def _crowded_tokens(cfg, n, seed):
    """Tokens whose router logits are their first E features (the router
    weights are the identity there): every token's top-k is set by a wide
    margin (>= 1), and most tokens want expert 0 or 1, so both overflow
    their capacity."""
    rng = np.random.default_rng(seed)
    e = cfg.moe.num_experts
    x = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
    pref = rng.random((n, e)).astype(np.float32)          # in [0, 1)
    for i in range(n):
        first = 0 if i % 4 else int(rng.integers(e))
        second = 1 if i % 3 else int(rng.integers(2, e))
        pref[i, first] = 6.0
        pref[i, second] = 4.0 if second != first else 6.0
    x[:, :e] = pref
    router = np.zeros((cfg.d_model, e), np.float32)
    router[np.arange(e), np.arange(e)] = 1.0
    return x.reshape(2, n // 2, cfg.d_model), router


def _kept_pairs(module, calls):
    """Wrap ``module._bucketed_expert_compute`` to record each call's
    (token row, expert) pairs and which of them fit their capacity."""
    real = module._bucketed_expert_compute

    def spy(xs, seg, pos_in_seg, num_experts, capacity, *rest):
        calls.append((np.asarray(xs, np.float32), np.asarray(seg),
                      np.asarray(pos_in_seg) < capacity))
        return real(xs, seg, pos_in_seg, num_experts, capacity, *rest)
    return spy


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_keep_the_reference_pairs(arch, monkeypatch):
    """With capacity overflowing (default factor 1.25), the port keeps and
    drops exactly the reference's (token, expert) pairs: the stable sort
    puts earlier tokens first in each expert's bucket. Outputs within 2e-4,
    aux within 1e-6."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(cfg)
    x, router = _crowded_tokens(cfg, 48, seed=3)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=t(router))
    jcalls, tcalls = [], []
    monkeypatch.setattr(JM, "_bucketed_expert_compute",
                        _kept_pairs(JM, jcalls))
    monkeypatch.setattr(M, "_bucketed_expert_compute", _kept_pairs(M, tcalls))
    want, jaux = JM.moe_ffn(jnp.asarray(x), jp, cfg)
    got, taux = M.moe_ffn(t(x), tp, tcfg)
    rows = x.reshape(-1, cfg.d_model)

    def pairs(call):
        xs, seg, keep = call
        tok = [int(np.flatnonzero((rows == r).all(1))[0]) for r in xs]
        kept = {(i, int(e)) for i, e, k in zip(tok, seg, keep) if k}
        return kept, {(i, int(e)) for i, e in zip(tok, seg)} - kept

    (jkept, jdropped), (tkept, tdropped) = pairs(jcalls[0]), pairs(tcalls[0])
    assert len(jdropped) >= 8, jdropped          # the capacity overflowed
    assert (tkept, tdropped) == (jkept, jdropped)
    close(got, want, 2e-4)
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_layout_and_scale(arch):
    """The reference's leaves and shapes (the router in f32, a ``shared``
    MLP of F x num_shared_experts), each expert weight drawn at the
    reference's fan-in, its leading dim E."""
    cfg, tcfg = _cfgs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(0), cfg, cfg.num_layers)
    tp = M.init_moe(torch.Generator().manual_seed(0), tcfg, tcfg.num_layers,
                    lead=(3,))
    shapes = jax.tree_util.tree_map(lambda a: (3,) + tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tp) == shapes
    assert tp["router"].dtype == torch.float32
    assert tp["wi"].dtype == torch.bfloat16
    e = cfg.moe.num_experts
    w = tp["wg"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(e) + 1e-6
    assert abs(float(w.std()) * np.sqrt(e) - 0.88) < 0.05
