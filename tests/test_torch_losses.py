"""The port's losses against the reference package: ``softmax_xent`` (both
impls), ``_mtp_loss`` and ``train_loss`` for every arch, on the same inputs
(numpy from a seed) and the same weights
(``repro_torch.convert.params_from_jax``), in f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.data.synthetic import make_batch
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T


def _xent_inputs():
    rng = np.random.default_rng(21)
    logits = (rng.standard_normal((2, 9, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    labels[0, :4] = -1                  # masked rows, clipped to 0 first
    labels[1, -1] = -1
    mask = (labels >= 0).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_softmax_xent_matches(impl):
    logits, labels, mask = _xent_inputs()
    want = JT.softmax_xent(logits, labels, mask, impl)
    got = T.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(mask), impl)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))


def test_softmax_xent_impls_agree_and_mask_all():
    logits, labels, mask = (torch.from_numpy(a) for a in _xent_inputs())
    assert torch.allclose(T.softmax_xent(logits, labels, mask, "gather"),
                          T.softmax_xent(logits, labels, mask, "onehot"),
                          atol=1e-6, rtol=0)
    # bf16 logits are upcast first; an all-masked batch gives 0, not NaN
    bf = T.softmax_xent(logits.bfloat16(), labels, mask)
    assert bf.dtype == torch.float32
    zero = T.softmax_xent(logits, labels, torch.zeros_like(mask))
    assert float(zero) == 0.0


def _model(arch):
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_matches(arch):
    """Every arch's loss and metrics (ce, the MoE aux loss, DeepSeek-V3's
    MTP loss) against the reference's ``train_loss`` within 1e-4, with the
    frontend stubs and labels of ``make_batch`` (-1 over the patch rows and
    the last position)."""
    cfg, tcfg, jp, tp = _model(arch)
    raw = make_batch(cfg, 2, 32)
    want, wm = JT.train_loss(jp, cfg, {k: jnp.asarray(v)
                                       for k, v in raw.items()})
    got, gm = T.train_loss(tp, tcfg, {k: torch.from_numpy(v)
                                      for k, v in raw.items()})
    assert set(gm) == set(wm) == ({"ce", "aux", "mtp"} if cfg.mtp
                                  else {"ce", "aux"})
    for key in wm:
        assert abs(float(gm[key]) - float(wm[key])) < 1e-4, (key, gm, wm)
    assert abs(float(got) - float(want)) < 1e-4
    assert 0.5 * np.log(cfg.vocab_size) < float(gm["ce"]) < \
        2 * np.log(cfg.vocab_size)


def test_mtp_loss_matches():
    """DeepSeek-V3's multi-token prediction loss on the same final hidden
    state (the reference's, from ``forward(return_hidden=True)``)."""
    cfg, tcfg, jp, tp = _model("deepseek-v3-671b")
    raw = make_batch(cfg, 2, 32)
    _, _, _, h = JT.forward(jp, cfg, {"tokens": jnp.asarray(raw["tokens"])},
                            return_hidden=True)
    labels = raw["labels"]
    mask = (labels >= 0).astype(np.float32)
    want = JT._mtp_loss(jp, cfg, h, jnp.asarray(raw["tokens"]),
                        jnp.asarray(labels), jnp.asarray(mask))
    got = T._mtp_loss(tp, tcfg, torch.from_numpy(np.array(h)),
                      torch.from_numpy(raw["tokens"]),
                      torch.from_numpy(labels), torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < 1e-4


def test_forward_returns_the_hidden_state_and_wraps_the_body():
    """``forward(return_hidden=True)`` returns the final norm's output (the
    reference's within 2e-4); ``forward`` is ``_forward`` under
    ``inference_mode``, bitwise, and ``train_loss`` runs outside it, so a
    loss can carry a graph for the training slice."""
    cfg, tcfg, jp, tp = _model("phi3-mini-3.8b")
    raw = make_batch(cfg, 2, 32)
    _, _, _, want = JT.forward(jp, cfg, {"tokens": jnp.asarray(
        raw["tokens"])}, return_hidden=True)
    batch = {"tokens": torch.from_numpy(raw["tokens"])}
    logits, _, _, h = T.forward(tp, tcfg, batch, return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    assert h.is_inference() and logits.is_inference()
    body, _, _ = T._forward(tp, tcfg, batch)
    assert torch.equal(body, logits) and not body.is_inference()
    tp["lm_head"].requires_grad_(True)
    loss, _ = T.train_loss(tp, tcfg, dict(batch, labels=torch.from_numpy(
        raw["labels"])))
    assert loss.requires_grad


def test_train_loss_onehot_config_matches():
    """``xent_impl="onehot"`` through ``train_loss`` (the reference's
    vocab-sharded-safe lookup) gives the gather's loss."""
    cfg, tcfg, jp, tp = _model("qwen2-vl-7b")
    raw = make_batch(cfg, 2, 32)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    gather, _ = T.train_loss(tp, tcfg, batch)
    onehot, _ = T.train_loss(tp, dataclasses.replace(tcfg, xent_impl="onehot"),
                             batch)
    want, _ = JT.train_loss(jp, dataclasses.replace(cfg, xent_impl="onehot"),
                            {k: jnp.asarray(v) for k, v in raw.items()})
    assert abs(float(onehot) - float(gather)) < 1e-5
    assert abs(float(onehot) - float(want)) < 1e-4
