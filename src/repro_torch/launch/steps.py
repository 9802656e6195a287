"""Step functions (train / serve) shared by the trainer and the server.

PyTorch counterpart of ``repro/launch/steps.py``. The train step takes the
gradient of ``train_loss`` over every parameter leaf with
``torch.autograd.grad`` (through the kernels' autograd Functions on the
card) and applies ``adamw.update``, which writes the parameters and moments
in place. The expert-parallel MoE (``moe_group``) is ROADMAP queue 1,
item 14.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def make_train_step(cfg, opt_cfg, *, moe_group: int = 0):
    if moe_group:
        raise NotImplementedError("the expert-parallel MoE (moe_group): "
                                  "ROADMAP queue 1, item 14")

    def train_step(params, opt_state, batch):
        # leaves of the graph that share the parameters' storage, so the
        # caller's tensors never require a gradient
        live = T._tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = []
        T._tree_map(leaves.append, live)
        loss, metrics = T.train_loss(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        del live, leaves
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, params, T._tree_map(lambda _: next(grads), params),
            opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **opt_metrics)
        return params, opt_state, metrics
    return train_step


def make_serve_step(cfg):
    def serve_step(params, caches, token, t):
        logits, caches = T.decode_step(params, cfg, caches, token, t)
        return logits, caches
    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, caches, batch):
        logits, caches = T.prefill(params, cfg, batch, caches)
        return logits, caches
    return prefill_step
