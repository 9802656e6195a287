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

Expert parallelism: ``moe_ffn_ep`` is one rank's part of the reference's
``shard_map`` route — its token shard routed, bucketed by target expert
shard with a static per-shard capacity, sent with ``all_to_all_single``
over the mesh's ``model`` group (rows as int8 with f32 row scales under
``a2a_dtype="int8"``), bucketed by local expert, computed and sent back.
``moe_ffn_ep_sharded`` is the ``shard_map`` around it: global tokens in
and out. Both run on ``_ep_shards``, which carries a leading dim of shards;
a rank holds one, and on a ``ShapeMesh`` (the dry run, no process group)
one process holds every shard and the all-to-all is a transpose of the
shard and block dims, the same exchange without a network.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH


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


def _counts(idx, n: int):
    """``bincount`` of the last dim of ``idx`` (values < n) per leading
    index, as a scatter-add, which also runs on meta tensors."""
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.long,
                      device=idx.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx))


def _route(x2d, router_w, m):
    """x2d: (..., T, D) -> (top_w, top_i) each (..., T, k), and the
    Switch-style load-balance aux loss, one per leading index."""
    logits = x2d.float() @ router_w.float()                    # (T, E)
    if m.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(scores, m.top_k, dim=-1)         # descending
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    probs_mean = scores.mean(dim=-2)                           # (E,)
    counts = _counts(top_i.flatten(-2), m.num_experts).float()
    frac = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    aux = m.num_experts * torch.sum(frac * probs_mean, -1) * m.aux_loss_coef
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
    counts = _counts(flat_e, m.num_experts)
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


# --------------------------------------------------------------------- #
# Explicit expert parallelism
# --------------------------------------------------------------------- #
def _quant_rows(x):
    """Per-row symmetric int8 quantization: (q int8, scales f32).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q, sc


def _dequant_rows(q, sc, dtype):
    return (q.float() * sc).to(dtype)


def _exchange_group(group):
    """The all-to-all over ``group`` of a (1, n_sh, ...) buffer: block j
    goes to rank j, block i of the result came from rank i (the
    reference's ``lax.all_to_all(split 0, concat 0)``)."""
    def exchange(t):
        src = t[0].contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out[None]
    return exchange


def _exchange_local(n_dp: int, n_sh: int):
    """The same all-to-all with every shard in this process: the shards
    (dp-major, ``model``-minor) swap blocks within each dp group."""
    def exchange(t):
        rest = t.shape[2:]
        return t.reshape((n_dp, n_sh, n_sh) + rest).transpose(1, 2) \
                .reshape(t.shape)
    return exchange


def _a2a(t, exchange, quantize: bool, dtype):
    if quantize:
        q, sc = _quant_rows(t)
        return _dequant_rows(exchange(q), exchange(sc), dtype)
    return exchange(t)


def _ep_shards(x, p, cfg, *, n_sh: int, shard_id, exchange):
    """The reference's per-device ``moe_ffn_ep`` over a leading dim of
    shards. x: (R, T, D) each shard's tokens; ``p``'s ``wi``/``wg``/``wo``:
    (n_w, E_l, D, F) / (n_w, E_l, F, D), the experts of ``n_w`` shards of
    the ``model`` axis, with R a multiple of n_w (shard r holds expert
    shard r % n_w); ``shard_id``: (R, 1) each shard's index on ``model``;
    ``exchange``: the all-to-all of an (R, n_sh, ...) buffer. Returns
    (out (R, T, D), aux (R,))."""
    m = cfg.moe
    e_local = m.num_experts // n_sh
    r_, t, d = x.shape
    k = m.top_k
    dev = x.device
    rows = torch.arange(r_, device=dev)[:, None]
    top_w, top_i, aux = _route(x, p["router"], m)
    flat_e = top_i.reshape(r_, t * k)
    target = flat_e // e_local                                 # shard id

    # bucket by target shard with per-shard capacity
    cap = int(np.ceil(t * k / n_sh * m.capacity_factor))
    sort_idx = torch.argsort(target, dim=-1, stable=True)
    tok_idx = sort_idx // k
    tgt_sorted = target.gather(1, sort_idx)
    counts = _counts(target, n_sh)
    starts = torch.cumsum(counts, -1) - counts
    pos = torch.arange(t * k, device=dev) - starts.gather(1, tgt_sorted)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)

    send_x = x.new_zeros(r_, n_sh, cap + 1, d)
    send_x[rows, tgt_sorted, slot] = x[rows, tok_idx]
    send_e = torch.full((r_, n_sh, cap + 1), -1, dtype=torch.int32,
                        device=dev)
    send_e[rows, tgt_sorted, slot] = flat_e.gather(1, sort_idx).to(
        torch.int32)
    int8_a2a = m.a2a_dtype == "int8"
    recv_x = _a2a(send_x[:, :, :cap], exchange, int8_a2a, x.dtype)
    recv_e = exchange(send_e[:, :, :cap])
    rx = recv_x.reshape(r_, n_sh * cap, d)
    re = recv_e.reshape(r_, n_sh * cap).long()

    # local expert ids; invalid slots -> expert e_local (dropped)
    le = torch.where(re >= 0, re - shard_id * e_local, e_local)
    # bucket by local expert
    cap_e = int(np.ceil(n_sh * cap / e_local))
    s_idx = torch.argsort(le, dim=-1, stable=True)
    le_s = le.gather(1, s_idx)
    cnt = _counts(le, e_local + 1)
    st = torch.cumsum(cnt, -1) - cnt
    pe = torch.arange(n_sh * cap, device=dev) - st.gather(1, le_s)
    keep_e = (pe < cap_e) & (le_s < e_local)
    slot_e = torch.where(pe < cap_e, pe, cap_e)
    e_idx = torch.where(keep_e, le_s, e_local)
    buf = rx.new_zeros(r_, e_local + 1, cap_e + 1, d)
    buf[rows, e_idx, slot_e] = rx[rows, s_idx]

    # the experts: (groups, n_w) shards, each against its expert shard
    n_w = p["wi"].shape[0]
    buf = buf[:, :e_local, :cap_e].reshape(r_ // n_w, n_w, e_local, cap_e, d)
    h = torch.einsum("gsecd,sedf->gsecf", buf, p["wi"])
    g = torch.einsum("gsecd,sedf->gsecf", buf, p["wg"])
    y = torch.einsum("gsecf,sefd->gsecd", L.act_fn(cfg.act)(g) * h, p["wo"])
    y = torch.nn.functional.pad(y.reshape(r_, e_local, cap_e, d),
                                (0, 0, 0, 1, 0, 1))
    ye = y[rows, e_idx, slot_e]                                # sorted order
    # unsort back to recv order
    y_recv = torch.zeros_like(rx)
    y_recv[rows, s_idx] = ye
    y_send = _a2a(y_recv.reshape(r_, n_sh, cap, d), exchange, int8_a2a,
                  rx.dtype)

    # back on the source shard: slots -> tokens
    y_tok = torch.nn.functional.pad(y_send, (0, 0, 0, 1))
    y_flat = y_tok[rows, tgt_sorted, slot] * keep[..., None].to(y_tok.dtype)
    w_sorted = top_w.reshape(r_, t * k).gather(1, sort_idx).to(y_flat.dtype)
    out = torch.zeros(r_ * t, d, dtype=y_flat.dtype, device=dev)
    out.index_add_(0, (rows * t + tok_idx).reshape(-1),
                   (y_flat * w_sorted[..., None]).reshape(-1, d))
    out = out.reshape(r_, t, d)
    if m.num_shared_experts:
        out = out + L.mlp(x, p["shared"], cfg.act)
    return out.to(x.dtype), aux


def ep_send_bytes(cfg, tokens: int, n_sh: int, dtype_bytes: int) -> int:
    """Bytes one shard sends in one MoE layer's two all-to-alls, from the
    send buffers' shapes: 2 x (n_sh, cap, D) rows, in int8 with an f32
    scale a row under ``a2a_dtype="int8"``, plus the int32 expert ids."""
    m = cfg.moe
    cap = int(np.ceil(tokens * m.top_k / n_sh * m.capacity_factor))
    rows = n_sh * cap
    per_row = (cfg.d_model + 4) if m.a2a_dtype == "int8" else \
        cfg.d_model * dtype_bytes
    return 2 * rows * per_row + rows * 4


def moe_ffn_ep(x, p, cfg, *, group=None):
    """Expert-parallel MoE over the ranks of ``group`` (the mesh's
    ``model`` axis; None: the default group).

    x is this rank's token shard (B_l, S_l, D); the expert weights
    ``p['wi']`` etc. are this rank's expert shard (E_l, D, F). Tokens go to
    the rank that holds their expert with a static-capacity
    ``all_to_all_single``, are computed there and come back. The exchange
    carries no gradient, so this runs outside autograd."""
    if L.records_grad(x, *(p[n] for n in ("wi", "wg", "wo"))):
        raise NotImplementedError("expert parallelism across ranks runs "
                                  "forward only: its all-to-all carries no "
                                  "gradient")
    n_sh = dist.get_world_size(group)
    shard_id = torch.full((1, 1), dist.get_rank(group), device=x.device)
    b, s, d = x.shape
    w = {n: (v[None] if n in ("wi", "wg", "wo") else v) for n, v in p.items()}
    out, aux = _ep_shards(x.reshape(1, b * s, d), w, cfg, n_sh=n_sh,
                          shard_id=shard_id, exchange=_exchange_group(group))
    return out.reshape(b, s, d), aux[0]


def _dp_index(mesh, dp) -> int:
    """This rank's index over the dp axes, major to minor."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in dp:
        idx = idx * SH.axis_size(mesh, a) + coord[a]
    return idx


def _gather(t, mesh, axis: str, dim: int):
    """``t``'s blocks from every rank of the mesh's ``axis``, joined along
    ``dim`` in rank order."""
    group = mesh.get_group(axis)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def moe_ffn_ep_sharded(x, p, cfg, mesh):
    """The reference's ``shard_map`` around ``moe_ffn_ep``: x (B, S, D) is
    the global view (the port's model is replicated on each rank). Tokens
    split B over the dp axes and S over ``model``, experts E over
    ``model``; the output is gathered back over the same axes and the aux
    loss averaged over every axis (the reference's ``pmean``).

    On a ``ShapeMesh`` every shard runs in this process (the dry run)."""
    dp = SH.dp_axes(mesh)
    n_dp, n_sh = SH.axis_size(mesh, dp), SH.axis_size(mesh, "model")
    e_local = cfg.moe.num_experts // n_sh
    b, s, d = x.shape
    bl, sl = b // n_dp, s // n_sh
    if isinstance(mesh, SH.ShapeMesh):
        xs = x.reshape(n_dp, bl, n_sh, sl, d).transpose(1, 2) \
              .reshape(n_dp * n_sh, bl * sl, d)
        w = {n: (v.reshape((n_sh, e_local) + v.shape[1:])
                 if n in ("wi", "wg", "wo") else v) for n, v in p.items()}
        shard_id = (torch.arange(n_dp * n_sh, device=x.device) % n_sh)[:,
                                                                      None]
        out, aux = _ep_shards(xs, w, cfg, n_sh=n_sh, shard_id=shard_id,
                              exchange=_exchange_local(n_dp, n_sh))
        out = out.reshape(n_dp, n_sh, bl, sl, d).transpose(1, 2) \
                 .reshape(b, s, d)
        return out, aux.mean()
    mi = dist.get_rank(mesh.get_group("model"))
    di = _dp_index(mesh, dp)
    xl = x[di * bl:(di + 1) * bl, mi * sl:(mi + 1) * sl]
    pl = {n: (v[mi * e_local:(mi + 1) * e_local]
              if n in ("wi", "wg", "wo") else v) for n, v in p.items()}
    out, aux = moe_ffn_ep(xl, pl, cfg, group=mesh.get_group("model"))
    if n_sh > 1:
        out = _gather(out, mesh, "model", 1)
    for a in reversed(dp):                 # minor axis first
        if SH.axis_size(mesh, a) > 1:
            out = _gather(out, mesh, a, 0)
    aux = aux.clone()
    for a in SH.mesh_shape(mesh):
        dist.all_reduce(aux, group=mesh.get_group(a))
    return out, aux / mesh.size()
