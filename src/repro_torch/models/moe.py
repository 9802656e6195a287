"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed, top-k).

PyTorch counterpart of ``repro/models/moe.py``'s single-device route,
``moe_ffn``. Dispatch is sort-based, as in the reference: a stable argsort
of the (token, choice) pairs by expert id, a capacity-bucketed scatter into
(E, C, D), dense per-expert products, and the weighted rows summed back
into their tokens in a fixed order (``_combine``). Pairs past an expert's
capacity are dropped; which ones depends on the sort order, so the sort is
stable, as ``jnp.argsort`` is. With ``capacity_factor`` 0 the route is
dropless (DeepSeek-V2 drops tokens only in training). A served prompt on
the card (more than ``STATIC_DEPTH`` tokens, bf16 SwiGLU experts, no
autograd graph, no token block) runs the sorted pairs through G1
(``ops.grouped_experts``), which finds each expert's rows on the device:
nothing is read back (``_grouped``). Elsewhere, where the tokens are few
(a decode batch) or a CUDA graph is being captured, every bucket is as deep
as the tokens, so nothing is read back either (``_dropless_sizes``). Else
(training, the CPU) the experts' counts are read back to the host once a
layer, the batched products run in buckets of a depth chosen from them,
and the pairs of the few experts that have more run expert by expert
(``_dropless_expert_compute``). With ``norm_topk_prob`` false the pairs
are weighted by their raw router probabilities. Inside a profiler's trace
the route (scores, top-k, sort, any read of the counts) is the span
``model.route`` and the experts' products with the combine
``model.experts``.

Under a token block (the train step's, ``sharding.use_dp_block``) x is
this rank's block of the global batch's rows and, on a sequence block, of
its positions, and the route keeps the reference's global semantics: the
capacity of the global tokens, the drops of the global sort in row-major
(row, position) order (one all-gather of each row's E expert counts),
and the aux as this rank's share of the global one.

The bucketed expert products are plain batched einsums, which the
reference leaves to XLA outside any Pallas kernel. They touch every
expert's weights whatever the routing, so a decode step reads all E
experts.

Expert parallelism: ``moe_ffn_ep`` is one rank's part of the reference's
``shard_map`` route — its token shard routed, bucketed by target expert
shard with a static per-shard capacity, sent with ``all_to_all_single``
over the mesh's ``model`` group (rows as int8 with f32 row scales under
``a2a_dtype="int8"``), bucketed by local expert, computed and sent back.
``moe_ffn_ep_sharded`` is the ``shard_map`` around it: global tokens in
and out; ``moe_ffn_ep_block`` takes a sequence block's tokens as the shard
they are. All run on ``_ep_shards``, which carries a leading dim of shards;
a rank holds one, and on a ``ShapeMesh`` (the dry run, no process group)
one process holds every shard and the all-to-all is a transpose of the
shard and block dims, the same exchange without a network. On ranks the
route is differentiable with the bf16 exchange (``moe_ffn_ep_sharded``);
the int8 one refuses autograd (ROADMAP fault 14).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH

# A dropless route buckets every expert as deep as the tokens, reading
# nothing back, where there are at most this many: below it the batched
# products read each expert's weights once at any depth (a decode batch).
STATIC_DEPTH = 128
# An expert computed on its own costs six launches, taken here as the
# time of this many rows of the batched products (``_dropless_depth``).
LOOP_ROWS = 1024


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


def _top_k(x2d, router_w, m):
    """x2d: (..., T, D) -> the router's scores (..., T, E) and the top-k
    choices' weights, renormalised unless ``norm_topk_prob`` is false, and
    ids, each (..., T, k)."""
    logits = x2d.float() @ router_w.float()                    # (T, E)
    if m.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(scores, m.top_k, dim=-1)         # descending
    if m.norm_topk_prob:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return scores, top_w, top_i


def _dropless_sizes(counts, t: int):
    """A dropless route's pairs an expert, ``counts`` read back to the
    host, for ``_dropless_expert_compute``; None where the route instead
    buckets every expert as deep as the ``t`` tokens (an expert gets at
    most one pair a token) and reads nothing back: t <= ``STATIC_DEPTH``,
    the counts are shapes only, or a CUDA graph is being captured."""
    if t <= STATIC_DEPTH or counts.is_meta or (
            counts.is_cuda and torch.cuda.is_current_stream_capturing()):
        return None
    return counts.tolist()


def _grouped(x2d, p, cfg, block, t: int) -> bool:
    """Whether a route of ``t`` tokens runs its routed experts on G1
    (``ops.grouped_experts``), which reads no count back: dropless, more
    than ``STATIC_DEPTH`` tokens, no token block, on the card, no autograd
    graph recorded through it (the kernels have no backward), and bf16
    SwiGLU experts, which is what the kernels compute."""
    experts = (p["wi"], p["wg"], p["wo"])
    return (cfg.moe.capacity_factor <= 0 and block is None
            and t > STATIC_DEPTH and x2d.is_cuda
            and not L.records_grad(x2d, *experts)
            and all(w.dtype == torch.bfloat16 for w in experts)
            and L.act_fn(cfg.act) is torch.nn.functional.silu)


def _balance_aux(probs_mean, counts, m):
    """The Switch-style load-balance loss E·Σ frac·probs_mean, ``frac``
    the share of the top-k choices (``counts``, (..., E)) each expert
    got."""
    counts = counts.float()
    frac = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    return m.num_experts * torch.sum(frac * probs_mean, -1) * \
        m.aux_loss_coef


def _route(x2d, router_w, m):
    """x2d: (..., T, D) -> (top_w, top_i) each (..., T, k), and the
    Switch-style load-balance aux loss, one per leading index."""
    scores, top_w, top_i = _top_k(x2d, router_w, m)
    counts = _counts(top_i.flatten(-2), m.num_experts)
    return top_w, top_i, _balance_aux(scores.mean(dim=-2), counts, m)


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


def _dropless_depth(sizes) -> int:
    """The bucket depth d of a dropless route, from each expert's count
    ``sizes``: 0 or a count, whichever least costs E x d padded rows of the
    batched products plus, for each expert with more than d pairs, its
    pairs past d and ``LOOP_ROWS``. Skewed counts (a few hot experts) give
    a depth well below the largest, even routing the largest."""
    def cost(d):
        return len(sizes) * d + sum(n - d + LOOP_ROWS for n in sizes if n > d)
    return min([0, *sizes], key=cost)


def _dropless_expert_compute(xs, seg, pos_in_seg, sizes, wi, wg, wo, act):
    """xs: (N, D) pairs sorted by expert, ``seg``/``pos_in_seg`` as for
    ``_bucketed_expert_compute``, ``sizes`` each expert's count (host
    ints). The first d pairs of every expert in buckets of depth d
    (``_dropless_depth``), the rest of each expert's pairs over its own
    rows: no pair is dropped. Returns (N, D) in the same order."""
    depth = _dropless_depth(sizes)
    ys = (_bucketed_expert_compute(xs, seg, pos_in_seg, len(sizes), depth,
                                   wi, wg, wo, act) if depth
          else torch.zeros_like(xs))
    start = 0
    for e, n in enumerate(sizes):
        if n > depth:
            rows = slice(start + depth, start + n)
            x = xs[rows]
            ys[rows] = (L.act_fn(act)(x @ wg[e]) * (x @ wi[e])) @ wo[e]
        start += n
    return ys


def _place(counts, every, block, rows: int):
    """The number of pairs of each expert before each of this block's rows
    in global (row, position) order, less those of the block's own
    earlier rows: (rows, E). ``counts`` (rows, E) are this block's counts a
    row, ``every`` (n_blocks, rows, E) every block's."""
    e = counts.shape[-1]
    every = every.reshape(block.size, block.seq_size, rows, e) \
        .transpose(1, 2).reshape(block.size * rows, block.seq_size, e)
    total = every.sum(1)                                       # a global row
    before_row = torch.cumsum(total, 0) - total
    before_seq = torch.cumsum(every, 1) - every
    mine = torch.arange(rows, device=counts.device) + block.index * rows
    return before_row[mine] + before_seq[mine, block.seq_index] - \
        (torch.cumsum(counts, 0) - counts)


def _moe_tokens(x2d, p, cfg, block=None, rows: int = 1):
    """x2d (T, D), ``rows`` rows of tokens, routed as one group. Under a
    ``TokenBlock`` the group is the global tokens, of which x2d is this
    rank's block: the capacity comes from the global count, and a pair's
    place in its expert's bucket is its place in global (row, position)
    order (the pairs of its expert in the rows before its row and in its
    row before this block, from every block's counts a row, plus its place
    here), so every rank keeps exactly the pairs the one global sort keeps,
    and buckets and computes only its own."""
    m = cfg.moe
    t, d = x2d.shape
    k = m.top_k
    grouped = _grouped(x2d, p, cfg, block, t)
    with spans.span(spans.ROUTE):
        scores, top_w, top_i = _top_k(x2d, p["router"], m)
        flat_e = top_i.reshape(-1)                             # (T*k,)
        counts = _counts(flat_e, m.num_experts)
        t_all = t
        if block is None:              # ``_route``'s aux, from these counts
            aux = _balance_aux(scores.mean(dim=-2), counts, m)
        else:
            # frac from the global counts (they carry no gradient),
            # probs_mean this block's score sum over the global token
            # count: the shares and their gradients sum over the blocks
            # to the global aux's
            by_row = _counts(top_i.reshape(rows, -1), m.num_experts)
            every = block.gather(by_row)
            t_all = t * block.n_blocks
            aux = _balance_aux(scores.sum(0) / t_all, every.sum((0, 1)), m)
        sizes = None
        if m.capacity_factor > 0:
            capacity = max(int(np.ceil(t_all * k / m.num_experts
                                       * m.capacity_factor)), 4)
        elif block is not None:
            capacity = t_all           # no global place is past it
        elif not grouped:
            capacity, sizes = t, _dropless_sizes(counts, t)
        sort_idx = torch.argsort(flat_e, stable=True)
        tok_idx = sort_idx // k
        if not grouped:                # the buckets' places
            seg = flat_e[sort_idx]
            starts = torch.cumsum(counts, 0) - counts
            pos_in_seg = torch.arange(t * k, device=x2d.device) - starts[seg]
        if block is not None:
            # kept: the pair's global place is within the capacity;
            # bucketed at its place here (the kept pairs of an expert are
            # the first of its pairs here), in buckets as deep as this
            # rank's most kept pairs of one expert
            base = _place(by_row, every, block, rows)
            keep = pos_in_seg + base[tok_idx // (t // rows), seg] < capacity
            pos_in_seg = torch.where(keep, pos_in_seg, t * k)
            kept = torch.zeros_like(counts).index_add_(0, seg, keep.long())
            capacity = max(int(kept.max()), 1)
    with spans.span(spans.EXPERTS):
        xs = x2d[tok_idx]                                      # (T*k, D)
        if grouped:
            flat = ops.grouped_experts(xs, counts,
                                       top_w.reshape(-1)[sort_idx], sort_idx,
                                       p["wi"], p["wg"], p["wo"])
            return flat.unflatten(0, (-1, k)).sum(1), aux     # _combine's sum
        if sizes is not None:
            ys = _dropless_expert_compute(xs, seg, pos_in_seg, sizes,
                                          p["wi"], p["wg"], p["wo"], cfg.act)
        else:
            ys = _bucketed_expert_compute(xs, seg, pos_in_seg,
                                          m.num_experts, capacity, p["wi"],
                                          p["wg"], p["wo"], cfg.act)
        w_sorted = top_w.reshape(-1)[sort_idx].to(ys.dtype)    # (T*k,)
        out = _combine(ys * w_sorted[:, None], sort_idx, k)
    return out.to(x2d.dtype), aux


def _combine(rows, sort_idx, k: int):
    """The weighted pair rows (..., T*k, D), in sorted order, summed into
    their tokens (..., T, D): scattered back to the flat (token, choice)
    order through ``sort_idx`` (a permutation, so each index is written
    once) and summed over the k choices in a fixed order. The reference's
    ``.at[tok_idx].add``, with no atomics, so a run repeats bit for bit on
    the card (ROADMAP fault 13)."""
    flat = torch.zeros_like(rows).scatter(
        -2, sort_idx[..., None].expand(rows.shape), rows)
    return flat.unflatten(-2, (-1, k)).sum(-2)


def moe_ffn(x, p, cfg, *, group_size: int = 0):
    """x: (B, S, D) -> (out, aux_loss). Routed + shared experts.

    ``group_size`` > 0 routes the tokens in groups of that many, one after
    the other (the reference's ``lax.scan``), each with its own capacity;
    the aux loss is the groups' mean.

    Under a ``TokenBlock`` (``sharding.use_dp_block``) x is this rank's
    block of the global batch and the aux is its share of the global one.
    With no groups the tokens route as one global group (``_moe_tokens``).
    A group size that divides each run of this rank's tokens that is
    contiguous in the global order (all of them, or on a sequence block a
    row's) makes this rank's groups a block of the global ones, each
    routed alone, and the aux share this rank's mean over the blocks; any
    other group size would route other groups than the reference's, and
    raises."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    block = SH.current_dp_block()
    t_all = t * (block.n_blocks if block is not None else 1)
    if group_size <= 0 or group_size >= t_all:
        out, aux = _moe_tokens(x2d, p, cfg, block, rows=b)
    else:
        if t_all % group_size:
            raise ValueError(f"moe_ffn: {t_all} tokens do not divide into "
                             f"groups of {group_size}")
        run = s if block is not None and block.seq_size > 1 else t
        if run % group_size:
            raise ValueError(
                f"moe_ffn: this rank's runs of {run} of the batch's {t_all} "
                f"tokens do not divide into groups of {group_size}, so its "
                f"groups would not be the reference's")
        outs, auxs = zip(*(_moe_tokens(xi, p, cfg)
                           for xi in x2d.split(group_size)))
        out, aux = torch.cat(outs), torch.stack(auxs).mean()
        if block is not None:
            aux = aux / block.n_blocks
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


def _all_to_all(t, group):
    """The all-to-all over ``group`` of a (1, n_sh, ...) buffer: block j
    goes to rank j, block i of the result came from rank i (the
    reference's ``lax.all_to_all(split 0, concat 0)``)."""
    src = t[0].contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out[None]


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` under autograd. Swapping the blocks is its own
    inverse, so the backward is the same exchange of the output's
    gradient (the transpose of ``lax.all_to_all``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _exchange_group(group):
    """The all-to-all over ``group``, carrying its gradient."""
    return lambda t: _AllToAll.apply(t, group)


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
    if m.capacity_factor <= 0:
        raise ValueError("expert parallelism buckets by a capacity; the "
                         "dropless route (capacity_factor 0) runs on one "
                         "device (moe_ffn)")
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
    out = _combine(y_flat * w_sorted[..., None], sort_idx, k)
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
    ``all_to_all_single``, are computed there and come back.

    Under autograd the exchange carries its gradient (``_AllToAll``), so
    x's and the local experts' gradients are whole on return; the
    router's and the shared expert's are this rank's part, from its own
    tokens, for the caller to sum over the ranks, as ``shard_map``'s
    transpose does (``moe_ffn_ep_sharded``). The int8 exchange refuses
    autograd (ROADMAP fault 14): the reference rounds with ``jnp.round``,
    whose derivative is 0, so its gradient is wrong."""
    if cfg.moe.a2a_dtype == "int8" and L.records_grad(x, *_leaves(p)):
        raise NotImplementedError(
            "int8 expert parallelism under autograd (ROADMAP fault 14): the "
            "reference's rounding passes no gradient through the exchange; "
            "train with a2a_dtype='bf16'")
    n_sh = dist.get_world_size(group)
    shard_id = torch.full((1, 1), dist.get_rank(group), device=x.device)
    b, s, d = x.shape
    w = {n: (v[None] if n in ("wi", "wg", "wo") else v) for n, v in p.items()}
    out, aux = _ep_shards(x.reshape(1, b * s, d), w, cfg, n_sh=n_sh,
                          shard_id=shard_id, exchange=_exchange_group(group))
    return out.reshape(b, s, d), aux[0]


def _leaves(p):
    for v in p.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


class _Gather(torch.autograd.Function):
    """``_all_gather`` under autograd. The gradient of the joined tensor
    is the same on every rank (the model past the route is replicated),
    so the backward is this rank's block of it, with no collective."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        return SH._all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _Replicated(torch.autograd.Function):
    """A tensor replicated on every rank entering the route: forward this
    rank's block of it, cut along each ``(dim, group)`` of ``splits`` into
    equal blocks over the group's ranks (none: the whole). Each rank
    differentiates its own tokens and experts only, so the whole gradient
    is the sum of the ranks' parts: the backward sums this rank's over
    ``sums`` (the groups whose ranks hold the same block), then gathers
    the blocks along ``splits`` in reverse: the transpose of
    ``shard_map``'s replicated and sharded inputs."""

    @staticmethod
    def forward(ctx, t, splits, sums):
        ctx.splits, ctx.sums = splits, sums
        for dim, group in splits:
            n = t.shape[dim] // dist.get_world_size(group)
            t = t.narrow(dim, dist.get_rank(group) * n, n)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group in ctx.sums:
            dist.all_reduce(g, group=group)
        for dim, group in reversed(ctx.splits):
            g = SH._all_gather(g, group, dim)
        return g, None, None


class _MeshSum(torch.autograd.Function):
    """The sum of ``t`` over every rank of the mesh (``groups``). What
    follows it is replicated, so its gradient is already the same on
    every rank, and the backward passes it on as it is."""

    @staticmethod
    def forward(ctx, t, groups):
        t = t.clone()
        for group in groups:
            dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_ffn_ep_sharded(x, p, cfg, mesh):
    """The reference's ``shard_map`` around ``moe_ffn_ep``: tokens split B
    over the dp axes and S over ``model``, experts E over ``model``; the
    output is gathered back over the same axes and the aux loss averaged
    over every shard (the reference's ``pmean``).

    x (B, S, D) is the global view (the port's model is replicated on each
    rank); the train step's sequence blocks take ``moe_ffn_ep_block``.

    It is differentiable, with ``shard_map``'s transposes: the gradient
    of each replicated input (x, the router, the experts, the shared
    expert) is this rank's part summed over the axes it splits
    (``_Replicated``), the gather's is this rank's block (``_Gather``) and
    the aux sum's passes through (``_MeshSum``). So every rank ends a
    backward with the whole gradient.

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
    if b % n_dp:
        raise ValueError(f"moe_ffn_ep_sharded: a batch of {b} does not "
                         f"split over the dp size {n_dp}")
    dp_groups = [mesh.get_group(a) for a in dp       # major axis first
                 if SH.axis_size(mesh, a) > 1]
    model = [mesh.get_group("model")] if n_sh > 1 else []
    groups = dp_groups + model

    def enter(t, splits=(), sums=groups):
        return _Replicated.apply(t, tuple(splits), tuple(sums))
    # tokens: B over dp, S over model, each block on one rank only
    xl = enter(x, [(0, g) for g in dp_groups] + [(1, g) for g in model], ())
    # experts: E over model, each block on every rank of the dp axes
    experts = dict(splits=[(0, g) for g in model], sums=dp_groups)
    pl = {n: (enter(v, **experts) if n in ("wi", "wg", "wo") else
              {k: enter(w) for k, w in v.items()} if isinstance(v, dict)
              else enter(v)) for n, v in p.items()}
    out, aux = moe_ffn_ep(xl, pl, cfg, group=mesh.get_group("model"))
    for g in model:
        out = _Gather.apply(out, g, 1)
    for g in reversed(dp_groups):          # minor axis first
        out = _Gather.apply(out, g, 0)
    return out, _MeshSum.apply(aux, groups) / (n_dp * n_sh)


def moe_ffn_ep_block(x, p, cfg, block):
    """The expert-parallel route on the train step's sequence block
    (``sharding.seq_block``): x (B/dp, S/m, D) is this rank's shard of the
    reference's ``shard_map``, routed by ``moe_ffn_ep`` over ``model``
    against this rank's expert shard. The experts enter as this rank's
    slice, so their gradient here is its shard's, from every rank's tokens,
    and zero elsewhere; the router's and the shared expert's are this
    rank's part. The train step sums every leaf over the blocks once, which
    makes each the whole gradient. The aux is this shard's over the number
    of shards, its share of the reference's mean over them."""
    e_local = cfg.moe.num_experts // block.seq_size
    lo = block.seq_index * e_local
    pl = {n: (v[lo:lo + e_local] if n in ("wi", "wg", "wo") else v)
          for n, v in p.items()}
    out, aux = moe_ffn_ep(x, pl, cfg, group=block.seq_group)
    return out, aux / block.n_blocks
