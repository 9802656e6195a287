"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed, top-k).

PyTorch counterpart of ``repro/models/moe.py``'s single-device route,
``moe_ffn``. Dispatch is sort-based, as in the reference: a stable argsort
of the (token, choice) pairs by expert id, a capacity-bucketed scatter into
(E, C, D), dense per-expert products, and a weighted ``index_add_`` back to
the tokens. Pairs past an expert's capacity are dropped; which ones depends
on the sort order, so the sort is stable, as ``jnp.argsort`` is.

The expert products are plain batched einsums, which the reference leaves
to XLA outside any Pallas kernel. They touch every expert's weights
whatever the routing, so a decode step reads all E experts.

The expert-parallel routes (``moe_ffn_ep_sharded``, ``moe_ffn_ep`` and the
int8 row quantisation) need a mesh: ROADMAP queue 1, item 14.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L


def init_moe(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
             device="cpu", lead: tuple = ()):
    """Router in f32, ``wi``/``wg``/``wo`` of shape (E, D, F) / (E, F, D)
    with the reference's fan-in (its leading dim, E), and a ``shared`` MLP
    of width F x ``num_shared_experts``. Each expert is drawn on its own,
    so no f32 copy of a whole stack of experts is held."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    kw = dict(dtype=dtype, device=device, lead=tuple(lead) + (e,))
    p = {
        "router": L.dense_init(generator, (d, e), dtype=torch.float32,
                               device=device, lead=lead),
        "wi": L.dense_init(generator, (d, f), fan_in=e, **kw),
        "wg": L.dense_init(generator, (d, f), fan_in=e, **kw),
        "wo": L.dense_init(generator, (f, d), 1.0 / np.sqrt(2 * n_layers),
                           fan_in=e, **kw),
    }
    if m.num_shared_experts:
        p["shared"] = L.init_mlp(generator, d, f * m.num_shared_experts,
                                 cfg.act, n_layers, dtype=dtype,
                                 device=device, lead=lead)
    return p


def _route(x2d, router_w, m):
    """x2d: (T, D) -> (top_w, top_i) each (T, k), and the Switch-style
    load-balance aux loss."""
    logits = x2d.float() @ router_w.float()                    # (T, E)
    if m.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(scores, m.top_k, dim=-1)         # descending
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    probs_mean = scores.mean(dim=0)                            # (E,)
    counts = torch.bincount(top_i.reshape(-1),
                            minlength=m.num_experts).float()
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    aux = m.num_experts * torch.sum(frac * probs_mean) * m.aux_loss_coef
    return top_w, top_i, aux


def _bucketed_expert_compute(xs, seg, pos_in_seg, num_experts, capacity,
                             wi, wg, wo, act):
    """xs: (N, D) sorted pairs, seg: (N,) expert ids, pos_in_seg: (N,).

    Scatter into (E, C + 1, D), where row C takes every overflow pair and
    is dropped, run the dense expert products, and gather back (N, D) with
    the dropped pairs zeroed."""
    n, d = xs.shape
    keep = pos_in_seg < capacity
    slot = torch.where(keep, pos_in_seg, torch.full_like(pos_in_seg,
                                                         capacity))
    buf = torch.zeros(num_experts, capacity + 1, d, dtype=xs.dtype,
                      device=xs.device)
    buf[seg, slot] = xs              # only the dropped row C is written twice
    buf = buf[:, :capacity]                                    # (E, C, D)
    h = torch.einsum("ecd,edf->ecf", buf, wi)
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    h = L.act_fn(act)(g) * h
    y = torch.einsum("ecf,efd->ecd", h, wo)                    # (E, C, D)
    y = torch.nn.functional.pad(y, (0, 0, 0, 1))               # slot C = 0
    return y[seg, slot] * keep[:, None].to(y.dtype)            # (N, D)


def _moe_tokens(x2d, p, cfg):
    m = cfg.moe
    t, d = x2d.shape
    k = m.top_k
    top_w, top_i, aux = _route(x2d, p["router"], m)
    capacity = max(int(np.ceil(t * k / m.num_experts * m.capacity_factor)),
                   4)
    flat_e = top_i.reshape(-1)                                 # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    tok_idx = sort_idx // k
    seg = flat_e[sort_idx]
    xs = x2d[tok_idx]                                          # (T*k, D)
    counts = torch.bincount(flat_e, minlength=m.num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_seg = torch.arange(t * k, device=x2d.device) - starts[seg]
    ys = _bucketed_expert_compute(xs, seg, pos_in_seg, m.num_experts,
                                  capacity, p["wi"], p["wg"], p["wo"],
                                  cfg.act)
    w_sorted = top_w.reshape(-1)[sort_idx].to(ys.dtype)        # (T*k,)
    out = torch.zeros(t, d, dtype=ys.dtype, device=x2d.device)
    out.index_add_(0, tok_idx, ys * w_sorted[:, None])
    return out.to(x2d.dtype), aux


def moe_ffn(x, p, cfg, *, group_size: int = 0):
    """x: (B, S, D) -> (out, aux_loss). Routed + shared experts.

    ``group_size`` > 0 routes the tokens in groups of that many, one after
    the other (the reference's ``lax.scan``), each with its own capacity;
    the aux loss is the groups' mean."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    if group_size <= 0 or group_size >= t:
        out, aux = _moe_tokens(x2d, p, cfg)
    else:
        if t % group_size:
            raise ValueError(f"moe_ffn: {t} tokens do not divide into groups "
                             f"of {group_size}")
        outs, auxs = zip(*(_moe_tokens(xi, p, cfg)
                           for xi in x2d.split(group_size)))
        out, aux = torch.cat(outs), torch.stack(auxs).mean()
    if m.num_shared_experts:
        out = out + L.mlp(x2d, p["shared"], cfg.act)
    return out.reshape(b, s, d), aux
