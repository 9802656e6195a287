"""Step functions (train / serve) shared by the trainer and the server.

PyTorch counterpart of ``repro/launch/steps.py``. The train step takes the
gradient of ``train_loss`` over every parameter leaf with
``torch.autograd.grad`` (through the kernels' autograd Functions on the
card) and applies ``adamw.update``, which writes the parameters and moments
in place. ``moe_group`` > 0 routes each MoE block's tokens in groups of
that many, as the reference's step passes it to ``moe_ffn(group_size=)``.

Under a ``use_mesh`` mesh the step takes the global batch, as the
reference's does, and computes only this rank's token block of it
(``sharding.token_block``): its rows over the dp axes where the dp size
divides B, and its 1/m of the sequence where ``model``'s size m divides S
(the ``2d`` layout). The loss is this rank's share of the global one, and
the gradients are summed over the blocks before the update, one
all-reduce of a flat buffer a dtype over each axis that splits the batch.
So every rank ends the step with the same parameters, moments and metrics
(the global loss), and the reference's values. Where neither splits (no
mesh, a (1, 1) mesh, sizes that do not divide) every rank runs the whole
batch and nothing is exchanged.
"""
from __future__ import annotations

import torch

from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _cut(block, batch, mtp: bool):
    """``block``'s part of the global ``batch``: the rows of every entry;
    the sequence block of the (B, S) ones; of the patch prefix, its part
    inside the sequence block; Whisper's audio whole. With ``mtp`` the
    next tokens and labels (``transformer.next_targets``) are taken from
    the global batch first, so a block's last position sees the next
    block's first."""
    b, s = batch["tokens"].shape
    if mtp and block.seq_group is not None:
        batch = dict(batch, **T.next_targets(batch["tokens"],
                                             batch["labels"]))
    rows, seq = block.rows(b), block.share(s)
    out = {}
    for k, v in batch.items():
        v = v[rows]
        if k == "patches":
            v = v[:, seq.start:min(seq.stop, v.shape[1])]
        elif k != "audio":
            v = v[:, seq]
        out[k] = v
    return out


def _sum_over_blocks(block, tensors):
    """``tensors`` summed over the blocks: packed in order into one
    flat buffer a dtype, each all-reduced, and split back into views."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = block.sum_(torch.cat([tensors[i].reshape(-1) for i in idx]))
        parts = flat.split([tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view_as(tensors[i])
    return out


def make_train_step(cfg, opt_cfg, *, moe_group: int = 0):
    def train_step(params, opt_state, batch):
        block = SH.token_block(SH.current_mesh(), *batch["tokens"].shape)
        if block is not None:
            batch = _cut(block, batch, cfg.mtp)
        # leaves of the graph that share the parameters' storage, so the
        # caller's tensors never require a gradient
        live = T._tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = []
        T._tree_map(leaves.append, live)
        with SH.use_dp_block(block):
            loss, metrics = T.train_loss(live, cfg, batch,
                                         moe_group=moe_group)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        del live, leaves
        metrics = dict({k: v.detach() for k, v in metrics.items()},
                       loss=loss.detach())
        if block is not None:
            grads = _sum_over_blocks(block, grads)
            metrics = dict(zip(metrics, _sum_over_blocks(
                block, list(metrics.values()))))
        grads = iter(grads)
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, params, T._tree_map(lambda _: next(grads), params),
            opt_state)
        return params, opt_state, dict(metrics, **opt_metrics)
    return train_step


def make_serve_step(cfg, *, max_len: int = None):
    """One decode step. Under a ``use_mesh`` ``DeviceMesh`` it takes the
    global (B,) token, computes this rank's dp rows of it over the whole
    residual stream (one token is not split over the sequence), and reads
    and writes this rank's shards of the caches (``init_decode_caches``
    under the same mesh) of ``max_len`` rows: attention over an S-split
    cache combines the ranks' partial softmaxes, the recurrent scans run
    this rank's heads or channels. Returns this rank's (B/d, V) logits,
    whole over the vocabulary. ``max_len`` is needed where ``model`` > 1."""
    def serve_step(params, caches, token, t):
        mesh = SH.current_mesh()
        block = SH.token_block(mesh, token.shape[0], 1)
        if block is not None:
            token = token[block.rows(token.shape[0])]
        with SH.use_dp_block(block), \
                SH.use_cache_block(SH.cache_block(mesh, max_len)):
            logits, caches = T.decode_step(params, cfg, caches, token, t)
        return logits, caches
    return serve_step


def make_prefill_step(cfg, *, max_len: int = None):
    """The prompt into the caches. Under a ``use_mesh`` ``DeviceMesh`` it
    takes the global batch and computes this rank's token block of it, as
    the train step does (``sharding.token_block``, ``_cut``): attention
    on this rank's heads over the whole prompt, the scans on its heads or
    channels; each mixer writes only this rank's shards of the caches of
    ``max_len`` rows (``sharding.use_cache_block``). Returns this rank's
    (B/d, S/m, V) block of the logits, whole over the vocabulary (S/m: S
    where ``model`` does not divide the prompt). ``max_len`` is needed
    where ``model`` > 1."""
    def prefill_step(params, caches, batch):
        mesh = SH.current_mesh()
        block = SH.token_block(mesh, *batch["tokens"].shape)
        if block is not None:
            batch = _cut(block, batch, False)
        with SH.use_dp_block(block), \
                SH.use_cache_block(SH.cache_block(mesh, max_len)):
            logits, caches = T.prefill(params, cfg, batch, caches)
        return logits, caches
    return prefill_step
