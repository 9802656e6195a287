"""Model assembly: the stage-planned transformer.

PyTorch counterpart of ``repro/models/transformer.py`` for the dense
(GQA or MLA) ``attn``, sliding-window ``local``, ``rwkv6`` and ``rglru``
block kinds, each with a dense MLP or, past ``moe.first_dense_layers``, a
MoE FFN; Whisper's encoder, learned positions and cross-attention; the
Qwen2-VL patch prefix; and the losses. Parameters keep the reference's
stacked layout — ``params["stage<i>"]["sub<j>"]`` holds each weight with a
leading ``repeats`` axis, and DeepSeek-V3's ``mtp`` head, Whisper's ``enc``
subtree and the ``pos_embed`` tables sit where the reference puts them — so
converting the reference's weights is a tree-map (``repro_torch.convert``).
Where the reference runs each stage under ``lax.scan``, this runs a Python
loop over the stack (``unbind`` once a stage, whose backward is one stack)
and writes every cache in place. ``forward`` runs under
``torch.inference_mode()``; ``train_loss`` runs the same body
(``_forward``) outside it, where gradients flow through the kernels'
autograd Functions, and ``cfg.remat`` wraps each repeat's blocks (and each
encoder layer) in ``torch.utils.checkpoint``, as the reference wraps its
scan bodies in ``jax.checkpoint``. ``constrain`` sits where the
reference's does (a no-op on the port's plain tensors); under a mesh the
train step runs ``train_loss`` on this rank's token block of the batch
(``sharding.use_dp_block``), where the losses are this rank's shares of
the global ones. On a sequence block (``sharding.seq_block``) the
residual stream, norms, MLPs, the MoE and the loss run on this rank's
positions; attention gathers the sequence and runs this rank's heads,
RWKV6 and the RG-LRU exchange positions for heads or channels
(``attention.py``, ``recurrent.py``), and Whisper's encoder runs whole on
every ``model`` rank, as the reference's constraint leaves it. A MoE block
takes the expert-parallel route (``moe_ffn_ep_sharded``, or on a sequence
block ``moe_ffn_ep_block``; each trains with the bf16 exchange and refuses
the int8 one under autograd) under the reference's condition: ``moe_impl
== "ep"`` and a ``use_mesh`` mesh in the ``2d`` layout whose ``model`` axis
is > 1 and divides S; else ``moe_ffn`` with ``moe_group``.

Serving under a mesh (``launch/steps.py``) runs ``prefill`` on the same
token block and ``decode_step`` on this rank's dp rows, each mixer given
this rank's shard of its cache (``sharding.use_cache_block``;
``init_decode_caches`` allocates the shards under a ``DeviceMesh``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.sharding import (ShapeMesh, axis_size,
                                         cache_block, cache_shardings,
                                         constrain,
                                         current_cache_block,
                                         current_dp_block, current_layout,
                                         current_mesh, local_shape,
                                         seq_block, use_dp_block, use_mesh)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ===================================================================== #
# stage planning
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class Stage:
    cycle: tuple          # per-sublayer signatures: (kind, is_moe)
    repeats: int
    start_layer: int


def _layer_sig(cfg, i: int):
    kind = cfg.layer_kinds()[i]
    is_moe = (cfg.moe is not None and kind in ("attn", "local")
              and i >= cfg.moe.first_dense_layers)
    return (kind, is_moe)


def stage_plan(cfg) -> list:
    sigs = [_layer_sig(cfg, i) for i in range(cfg.num_layers)]
    p = len(cfg.block_pattern)
    stages, i = [], 0
    while i < len(sigs):
        if i + p <= len(sigs):
            cyc = tuple(sigs[i:i + p])
            reps = 1
            while i + (reps + 1) * p <= len(sigs) and \
                    tuple(sigs[i + reps * p:i + (reps + 1) * p]) == cyc:
                reps += 1
            stages.append(Stage(cyc, reps, i))
            i += reps * p
        else:
            stages.append(Stage((sigs[i],), 1, i))
            i += 1
    return stages


def _check_supported(cfg, sig):
    kind, _ = sig
    if kind not in ("attn", "local", "rwkv6", "rglru"):
        raise ValueError(kind)


def _torch_dtype(name_or_dtype):
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    return _DTYPES[str(name_or_dtype)]


# ===================================================================== #
# per-block init / apply
# ===================================================================== #
def _init_block(generator, cfg, sig, n_layers, *, dtype, device, lead,
                cross: bool = False):
    _check_supported(cfg, sig)
    kind, is_moe = sig
    kw = dict(device=device, lead=lead)
    p = {"norm1": L.init_norm(cfg.norm, cfg.d_model, **kw),
         "norm2": L.init_norm(cfg.norm, cfg.d_model, **kw)}
    if kind in ("attn", "local"):
        p["attn"] = A.init_attention(generator, cfg, n_layers, dtype=dtype,
                                     **kw)
    elif kind == "rwkv6":
        p["tmix"] = R.init_rwkv6(generator, cfg, n_layers, dtype=dtype, **kw)
    else:
        p["rec"] = R.init_rglru(generator, cfg, n_layers, dtype=dtype, **kw)
    if cross:
        p["norm_x"] = L.init_norm(cfg.norm, cfg.d_model, **kw)
        p["xattn"] = A.init_attention(generator, cfg, n_layers, dtype=dtype,
                                      **kw)
    if kind == "rwkv6":
        p["cmix"] = R.init_rwkv6_cmix(generator, cfg, n_layers, dtype=dtype,
                                      **kw)
    elif is_moe:
        p["moe"] = M.init_moe(generator, cfg, n_layers, dtype=dtype, **kw)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              n_layers, dtype=dtype, **kw)
    return p


def _init_block_cache(cfg, sig, batch, max_len, *, dtype, device, lead,
                      cross_len: int = 0):
    """A block's cache; ``cross_len`` > 0 adds the cross-attention K/V
    (``xk``, ``xv``) over that many encoder rows."""
    kind, _ = sig
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "attn":
        c = A.init_cache(cfg, batch, max_len, dtype=dtype, device=device,
                         lead=lead)
    elif kind == "local":
        w = min(cfg.local_window, max_len)
        shape = lead + (batch, w, cfg.num_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": torch.full(lead + (w,), -1, dtype=torch.int32,
                               device=device)}
    elif kind == "rwkv6":
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        c = {"state": torch.zeros(lead + (batch, h, n, n), **f32),
             "x_last_t": torch.zeros(lead + (batch, cfg.d_model), **f32),
             "x_last_c": torch.zeros(lead + (batch, cfg.d_model), **f32)}
    else:
        w = cfg.lru_width
        c = {"h": torch.zeros(lead + (batch, w), **f32),
             "conv": torch.zeros(lead + (batch, R.CONV_WIDTH - 1, w), **f32)}
    if cross_len:
        shape = lead + (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _local_ring_update(cache, k_new, v_new, positions, cb=None,
                       heads=None):
    """Write (B,S,kv,hd) tokens at ring slots pos % W, in place. Under a
    ``CacheBlock`` ``cb`` that splits the ring's W slots over ``model``
    this rank writes only the slots it holds; ``heads``: the sequence
    block whose ``model`` axis split the kv heads of ``k_new``/``v_new``,
    whose every head of this rank's slots is fetched first. ``pos`` is
    replicated: every rank writes all of it."""
    w = cache["pos"].shape[0]
    if k_new.shape[1] >= w:
        k_new, v_new = k_new[:, -w:], v_new[:, -w:]
        positions = positions[-w:]
    slots = positions % w
    own = cb.share(w) if cb is not None else None
    if own is None:
        if heads is not None:
            k_new, v_new = (heads.gather_plain(a, 2) for a in (k_new, v_new))
        cache["k"][:, slots] = k_new.to(cache["k"].dtype)
        cache["v"][:, slots] = v_new.to(cache["v"].dtype)
    else:
        owner = slots // (own.stop - own.start)
        order = torch.argsort(owner, stable=True)
        owner, slots_o = owner[order], slots[order]
        mine = slots_o[owner == cb.index] - own.start
        for key, val in (("k", k_new), ("v", v_new)):
            val = val[:, order]
            val = cb.to_owners(val, owner) if heads is not None else \
                val[:, owner == cb.index]
            cache[key][:, mine] = val.to(cache[key].dtype)
    cache["pos"][slots] = positions.to(cache["pos"].dtype)
    return cache


def _local_ring_attend(q, cache, t: int, window, cb=None):
    """Decode attention of the token at position ``t`` over a ring cache
    with stored absolute positions: the slots holding positions
    (t - window, t], through ``attention.decode_attention`` with the
    ring's ``pos`` (the kernel D1 on the card). Under a ``CacheBlock``
    that splits the slots, over this rank's slots
    (``attention.split_k_combine``)."""
    pos = cache["pos"]
    own = cb.share(pos.shape[0]) if cb is not None else None
    if own is not None:
        pos = pos[own]
    return A.decode_attention(q, cache["k"], cache["v"], t + 1,
                              window=window, pos=pos,
                              group=cb.group if own is not None else None)


def _local_attention_block(x, p, cfg, positions, cache, t):
    """Local (sliding-window) attention with a ring-buffer cache and
    plain RoPE (never ``cfg.rope_scaling``, which is the full layers'): a
    prompt on K3 with its causal window where
    ``attention.takes_window_kernel`` (the card, bf16, a head dim K3 has,
    no autograd), else on the plain attention functions, as the reference
    runs it (the CPU, training, and head_dim 256, ROADMAP queue 1, item
    18); a decode step through ``_local_ring_attend`` (D1). The attention,
    projections and cache writes aside, is the span ``model.window``.
    On a sequence block, this rank's heads over the whole sequence, as
    ``attention.gqa_forward``; under a serving ``CacheBlock`` the ring's
    slots are split over ``model`` where m divides W."""
    blk = seq_block()
    if blk is not None:
        x = blk.gather_seq(x)
    b, s, d = x.shape
    w = A.Heads.of(p, cfg, blk)
    q = torch.einsum("bsd,dhk->bshk", x, w.wq)
    k_kv, v_kv = (torch.einsum("bsd,dhk->bshk", x, w.wk),
                  torch.einsum("bsd,dhk->bshk", x, w.wv))
    k, v = w.kv(k_kv, v_kv)
    q = L.positional(q, positions, cfg.pos_kind, cfg.rope_theta)
    k = L.positional(k, positions, cfg.pos_kind, cfg.rope_theta)
    if cache is not None:
        cb = current_cache_block()
        pos_vec = positions[0] if positions.ndim == 2 else positions
        if w.kv_idx is not None:        # every kv head, as the cache holds
            k_kv = L.positional(k_kv, positions, cfg.pos_kind,
                                cfg.rope_theta)
        else:
            k_kv, v_kv = k, v
        _local_ring_update(cache, k_kv, v_kv, pos_vec, cb,
                           blk if w.split and w.kv_idx is None else None)
    with spans.span(spans.WINDOW):
        if cache is not None and s == 1:
            # decode: the token's position, t + 0 where t is given
            o = _local_ring_attend(q, cache, int(pos_vec[-1]) if t is None
                                   else t, cfg.local_window, cb)
        elif A.takes_window_kernel(q, k, v):
            o = A._flash_fwd(q, k, v, causal=True, window=cfg.local_window)
        else:
            blk = A._pick_block(s, s)
            if cache is None and s <= 2 * blk:
                o = A.full_attention(q, k, v, causal=True,
                                     window=cfg.local_window)
            else:
                o = A.chunked_attention(q, k, v, causal=True,
                                        window=cfg.local_window,
                                        q_block=blk, kv_block=blk)
    return w.to_block(torch.einsum("bshk,hkd->bsd", o, w.wo))


def _store(cache, key, value):
    """Write ``value`` into the cache's tensor (a view into the stacked
    caches), unless the kernel already wrote it there."""
    if value is not cache[key]:
        cache[key].copy_(value)


def apply_block(x, bp, cfg, sig, positions, *, enc_out=None, cache=None,
                t=None, moe_group: int = 0):
    """One block. ``cache`` (the block's views into the stacked caches) is
    updated in place. A block with ``xattn`` attends over ``enc_out`` (and
    writes its K/V into the cache's ``xk``/``xv``), or, given a cache and
    no ``enc_out``, over the cached ``xk``/``xv``. Returns (x, cache, aux),
    ``aux`` the MoE FFN's load-balance loss (0 for a dense FFN)."""
    _check_supported(cfg, sig)
    kind, is_moe = sig
    aux = torch.zeros((), device=x.device)
    with spans.span(spans.MIXER):
        h = L.norm(x, bp["norm1"], cfg.norm)
        if kind == "attn":
            attend = A.mla_forward if cfg.mla is not None else A.gqa_forward
            a, cache = attend(h, bp["attn"], cfg, positions, cache=cache, t=t)
        elif kind == "local":
            a = _local_attention_block(h, bp["attn"], cfg, positions, cache, t)
        elif kind == "rwkv6":
            st = (cache["state"], cache["x_last_t"]) if cache is not None \
                else (None, None)
            a, (state, x_last) = R.rwkv6_forward(h, bp["tmix"], cfg,
                                                 state=st[0], x_last=st[1])
            if cache is not None:
                _store(cache, "state", state)
                _store(cache, "x_last_t", x_last)
        else:
            st = ({"h": cache["h"], "conv": cache["conv"]}
                  if cache is not None else None)
            a, ns = R.rglru_forward(h, bp["rec"], cfg, state=st)
            if cache is not None:
                _store(cache, "h", ns["h"])
                _store(cache, "conv", ns["conv"])
        x = x + a
        x = constrain(x, "dp", "model", None)
        if "xattn" in bp:                                  # cross-attention
            hx = L.norm(x, bp["norm_x"], cfg.norm)
            xp = bp["xattn"]
            if cache is not None and enc_out is None:
                # decode: attend over the cross K/V in the cache, as it stands
                q = torch.einsum("bsd,dhk->bshk", hx, xp["wq"])
                o = A.decode_attention(q, cache["xk"], cache["xv"],
                                       cache["xk"].shape[1])
                o = torch.einsum("bshk,hkd->bsd", o, xp["wo"])
            else:
                o, _ = A.gqa_forward(hx, xp, cfg, positions, causal=False,
                                     kv_source=enc_out)
                if cache is not None:                      # store cross K/V
                    cache["xk"].copy_(torch.einsum("bsd,dhk->bshk", enc_out,
                                                   xp["wk"]))
                    cache["xv"].copy_(torch.einsum("bsd,dhk->bshk", enc_out,
                                                   xp["wv"]))
            x = x + o
    with spans.span(spans.FFN):
        h2 = L.norm(x, bp["norm2"], cfg.norm)
        if kind == "rwkv6":
            f, x_last_c = R.rwkv6_cmix(
                h2, bp["cmix"],
                x_last=cache["x_last_c"] if cache is not None else None)
            if cache is not None:
                _store(cache, "x_last_c", x_last_c)
        elif is_moe:
            mesh = current_mesh()
            n_model = axis_size(mesh, "model") if mesh is not None else 1
            blk = seq_block()
            s_all = h2.shape[1] * (blk.seq_size if blk is not None else 1)
            use_ep = (cfg.moe_impl == "ep" and current_layout() == "2d"
                      and n_model > 1 and s_all % n_model == 0)
            if use_ep and blk is not None:       # h2 is this rank's EP shard
                f, aux = M.moe_ffn_ep_block(h2, bp["moe"], cfg, blk)
            elif use_ep:
                f, aux = M.moe_ffn_ep_sharded(h2, bp["moe"], cfg, mesh)
            else:
                f, aux = M.moe_ffn(h2, bp["moe"], cfg, group_size=moe_group)
        else:
            f = L.mlp(h2, bp["mlp"], cfg.act)
        return constrain(x + f, "dp", "model", None), cache, aux


# ===================================================================== #
# model init
# ===================================================================== #
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def init_params(cfg, generator, device="cuda", dtype=None):
    """Random weights in the reference's layout, drawn from ``generator``
    on ``device``."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {"embed": L.embed_init(generator, (v, d), dtype=dtype,
                                          device=device)}
    if cfg.pos_kind == "learned":
        params["pos_embed"] = L.embed_init(
            generator, (max(32768, cfg.encoder_seq), d), dtype=dtype,
            device=device)
    cross = cfg.is_encoder_decoder
    for si, st in enumerate(stage_plan(cfg)):
        params[f"stage{si}"] = {
            f"sub{ci}": _init_block(generator, cfg, sig, cfg.num_layers,
                                    dtype=dtype, device=device,
                                    lead=(st.repeats,), cross=cross)
            for ci, sig in enumerate(st.cycle)}
    params["final_norm"] = L.init_norm(cfg.norm, d, device=device)
    params["lm_head"] = L.dense_init(generator, (d, v), dtype=dtype,
                                     device=device)
    if cross:       # Whisper's encoder
        params["enc"] = {
            "stage0": {"sub0": _init_block(
                generator, cfg, ("attn", False), cfg.encoder_layers,
                dtype=dtype, device=device, lead=(cfg.encoder_layers,))},
            "final_norm": L.init_norm(cfg.norm, d, device=device),
            "pos_embed": L.embed_init(generator, (cfg.encoder_seq, d),
                                      dtype=dtype, device=device)}
    if cfg.mtp:     # DeepSeek-V3's multi-token prediction head
        params["mtp"] = {
            "norm_h": L.init_norm(cfg.norm, d, device=device),
            "norm_e": L.init_norm(cfg.norm, d, device=device),
            "proj": L.dense_init(generator, (2 * d, d), dtype=dtype,
                                 device=device),
            "block": {"sub0": _init_block(generator, cfg, ("attn", False),
                                          cfg.num_layers, dtype=dtype,
                                          device=device, lead=(1,))}}
    return params


def _unstack(tree, n: int) -> list:
    """A stacked tree as ``n`` trees, one a leading index, by ``unbind``."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` and
    autograd records (the reference remats only outside decode). The
    recompute runs in the backward, on autograd's thread for the device,
    so it re-enters the mesh, layout and dp block of the forward."""
    if cfg.remat and torch.is_grad_enabled():
        mesh, layout, block = current_mesh(), current_layout(), \
            current_dp_block()

        def again(*a):
            with use_mesh(mesh, layout), use_dp_block(block):
                return fn(*a)
        return checkpoint(again, *args, use_reentrant=False)
    return fn(*args)


def count_params(params) -> int:
    leaves = []
    _tree_map(leaves.append, params)
    return int(sum(x.numel() for x in leaves))


# ===================================================================== #
# forward
# ===================================================================== #
def _run_stages(params, cfg, x, positions, *, enc_out=None, caches=None,
                t=None, moe_group: int = 0):
    """Every stage's blocks in order. Returns (x, the blocks' summed aux
    loss)."""
    aux = torch.zeros((), device=x.device)
    for si, st in enumerate(stage_plan(cfg)):
        with spans.span(spans.VIEWS):
            layers = _unstack(params[f"stage{si}"], st.repeats)
        cs = caches.get(f"stage{si}") if caches is not None else None
        for r in range(st.repeats):
            with spans.span(spans.VIEWS):
                cc = {sub: _tree_map(lambda a: a[r], c)
                      for sub, c in cs.items()} if cs is not None else None

            def body(x, _lp=layers[r], _cc=cc, _st=st):
                aux_r = torch.zeros((), device=x.device)
                for ci, sig in enumerate(_st.cycle):
                    sub = f"sub{ci}"
                    x, _, a = apply_block(
                        x, _lp[sub], cfg, sig, positions, enc_out=enc_out,
                        cache=_cc[sub] if _cc is not None else None, t=t,
                        moe_group=moe_group)
                    aux_r = aux_r + a
                return x, aux_r

            # a cache is written in place, so a body with one is never
            # recomputed
            x, a = _remat(cfg, body, x) if cc is None else body(x)
            aux = aux + a
    return x, aux


def _embed(params, cfg, tokens, positions, patches=None):
    x = params["embed"][tokens]
    if cfg.pos_kind == "learned":
        x = x + params["pos_embed"][positions].to(x.dtype)
    if patches is not None:       # the VLM stub: patches replace the prefix
        npatch = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, npatch:]], dim=1)
    return x


def encode(params, cfg, audio):
    """Whisper's encoder over precomputed frame embeddings (the conv stub):
    the learned positions, ``encoder_layers`` non-causal blocks (K3's full
    path), the final norm. It runs the whole sequence on every ``model``
    rank, as the reference constrains it to ``("dp", None, None)``."""
    with use_dp_block(None):
        return _encode(params, cfg, audio)


def _encode(params, cfg, audio):
    enc = params["enc"]
    x = audio.to(_torch_dtype(cfg.dtype)) + enc["pos_embed"][None]
    x = constrain(x, "dp", None, None)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    def body(x, bp):
        h = L.norm(x, bp["norm1"], cfg.norm)
        a, _ = A.gqa_forward(h, bp["attn"], cfg, pos, causal=False)
        x = x + a
        x = x + L.mlp(L.norm(x, bp["norm2"], cfg.norm), bp["mlp"], cfg.act)
        return constrain(x, "dp", None, None)

    for bp in _unstack(enc["stage0"]["sub0"], cfg.encoder_layers):
        x = _remat(cfg, body, x, bp)
    return L.norm(x, enc["final_norm"], cfg.norm)


def _forward(params, cfg, batch, *, caches=None, t=None, moe_group=0,
             return_hidden=False):
    """``forward``'s body, outside ``inference_mode`` (``train_loss``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    blk = seq_block()
    with spans.span(spans.EMBED):
        if "positions" in batch:
            positions = batch["positions"]
        else:                 # global: a sequence block starts at its offset
            start = (t or 0) + (blk.seq_index * s if blk is not None else 0)
            positions = start + torch.arange(s, device=tokens.device)
            positions = positions[None].expand(b, s)
        x = _embed(params, cfg, tokens, positions, batch.get("patches"))
        x = constrain(x, "dp", "model", None)
        if blk is not None:   # the mixers see the whole sequence's positions
            positions = blk.gather_plain(positions, dim=-1)
    enc_out = None
    if cfg.is_encoder_decoder and "audio" in batch:
        enc_out = encode(params, cfg, batch["audio"])
    x, aux = _run_stages(params, cfg, x, positions, enc_out=enc_out,
                         caches=caches, t=t, moe_group=moe_group)
    with spans.span(spans.HEAD):
        h_final = L.norm(x, params["final_norm"], cfg.norm)
        logits = constrain(h_final @ params["lm_head"], "dp", None, "model")
    if return_hidden:
        return logits, caches, aux, h_final
    return logits, caches, aux


@torch.inference_mode()
def forward(params, cfg, batch, *, caches=None, t=None, moe_group: int = 0,
            return_hidden=False):
    """batch: tokens (B,S) [+ patches (B,P,D) | audio (B,Se,D) |
    positions]. Returns (logits, caches, aux[, hidden]).

    ``caches`` are updated in place and returned; ``aux`` is the MoE
    blocks' summed load-balance loss (0 without MoE), as the reference's.
    ``moe_group`` > 0 routes a MoE block's tokens in groups of that many
    (``moe_ffn(group_size=)``)."""
    return _forward(params, cfg, batch, caches=caches, t=t,
                    moe_group=moe_group, return_hidden=return_hidden)


# ===================================================================== #
# losses
# ===================================================================== #
def softmax_xent(logits, labels, mask, impl: str = "gather"):
    """Mean negative log-likelihood over ``mask``; labels < 0 are clipped
    to 0 before the lookup (and masked out by the caller). Under a
    ``TokenBlock`` (``sharding.use_dp_block``) this rank's share of the global
    mean: its masked sum over the global mask count (one all-reduce of a
    scalar over each axis that splits the batch, which carries no
    gradient)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = labels.clamp(min=0).long()
    if impl == "onehot":          # select + reduce instead of a gather
        iota = torch.arange(lf.shape[-1], device=lf.device)
        ll = torch.where(iota == lab[..., None], lf, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * mask
    count = mask.sum()
    block = current_dp_block()
    if block is not None:
        block.sum_(count)
    return nll.sum() / torch.clamp(count, min=1.0)


def next_targets(tokens, labels) -> dict:
    """The multi-token prediction's inputs of a (B, S) batch: each
    position's next token and next label, the last position's padded (0
    and -1, masked out)."""
    pad = torch.nn.functional.pad
    return {"next_tokens": pad(tokens[:, 1:], (0, 1)),
            "next_labels": pad(labels[:, 1:], (0, 1), value=-1)}


def _mtp_loss(params, cfg, h_final, tokens, labels, mask, nxt=None):
    """DeepSeek-V3 multi-token prediction: predict t+2 from [h_t; emb_{t+1}],
    shifted by one and padded back to S (the padded tail masked out).
    ``nxt``: ``next_targets`` of the global batch, cut to this rank's
    sequence block (the train step's); the global last position's h is
    zeroed on the block that holds it."""
    mp = params["mtp"]
    blk = seq_block()
    b, s, _ = h_final.shape
    if blk is None:
        h = torch.nn.functional.pad(h_final[:, :-1], (0, 0, 0, 1))
        pos = torch.arange(s, device=h_final.device)
    else:
        at_end = blk.seq_index == blk.seq_size - 1
        last = torch.arange(s, device=h_final.device) == \
            (s - 1 if at_end else s)
        h = torch.where(last[:, None], 0.0, h_final)
        pos = torch.arange(s * blk.seq_size, device=h_final.device)
    if nxt is None:
        nxt = next_targets(tokens, labels)
        m2 = torch.nn.functional.pad(mask[:, 1:], (0, 1))
    else:
        m2 = (nxt["next_labels"] >= 0).float()
    h = L.norm(h, mp["norm_h"], cfg.norm)
    e = L.norm(params["embed"][nxt["next_tokens"]], mp["norm_e"], cfg.norm)
    x = torch.cat([h, e], dim=-1) @ mp["proj"]
    bp = _tree_map(lambda a: a[0], mp["block"]["sub0"])
    x, _, _ = apply_block(x, bp, cfg, ("attn", False),
                          pos[None].expand(b, -1))
    logits = x @ params["lm_head"]
    return softmax_xent(logits, nxt["next_labels"], m2, cfg.xent_impl)


def train_loss(params, cfg, batch, *, moe_group: int = 0):
    """batch: tokens (B,S), labels (B,S) (-1 = masked), + frontend stubs.
    Returns (loss, metrics) as the reference's. Called with autograd on,
    the loss carries the graph to every parameter leaf that requires a
    gradient (``repro_torch.launch.steps.make_train_step``). Under a
    ``TokenBlock`` the batch is this rank's block of the global one, and the
    loss and each metric are this rank's shares: summed over the blocks
    they are the reference's values over the global batch."""
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logits, _, aux, h = _forward(params, cfg, batch, moe_group=moe_group,
                                 return_hidden=True)
    loss = softmax_xent(logits, labels, mask, cfg.xent_impl)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp:
        nxt = ({k: batch[k] for k in ("next_tokens", "next_labels")}
               if "next_tokens" in batch else None)
        mtp = _mtp_loss(params, cfg, h, batch["tokens"], labels, mask, nxt)
        metrics["mtp"] = mtp
        loss = loss + 0.1 * mtp
    return loss + aux, metrics


# ===================================================================== #
# decode
# ===================================================================== #
@torch.inference_mode()
def init_decode_caches(cfg, batch: int, max_len: int, dtype=None,
                       device="cuda"):
    """Zeroed decode caches (a ring's ``pos`` -1) for ``batch`` rows of
    ``max_len`` positions. Under a ``use_mesh`` ``DeviceMesh`` only this
    rank's shard of each leaf, of the shape ``sharding.cache_shardings``
    gives it (rows over dp, S rows, heads or width over ``model``, each
    where the axis divides it); with no mesh or on a ``ShapeMesh`` (the
    dry run), the whole caches."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    mesh = current_mesh()
    if mesh is None or isinstance(mesh, ShapeMesh):
        return _whole_caches(cfg, batch, max_len, dtype, device)
    cache_block(mesh, max_len)            # the layouts it serves
    whole = _whole_caches(cfg, batch, max_len, dtype, "meta")

    def shard(leaf, sharding, name):
        return torch.full(local_shape(leaf.shape, sharding),
                          -1 if name == "pos" else 0, dtype=leaf.dtype,
                          device=device)
    return _zip_map(shard, whole, cache_shardings(whole, mesh))


def _zip_map(fn, tree, other, name=None):
    """``fn(leaf, other's leaf, leaf's key)`` over two trees of dicts of
    one structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k], k) for k, v in tree.items()}
    return fn(tree, other, name)


def _whole_caches(cfg, batch, max_len, dtype, device):
    cross_len = cfg.encoder_seq if cfg.is_encoder_decoder else 0
    caches = {}
    for si, st in enumerate(stage_plan(cfg)):
        for sig in st.cycle:
            _check_supported(cfg, sig)
        caches[f"stage{si}"] = {
            f"sub{ci}": _init_block_cache(cfg, sig, batch, max_len,
                                          dtype=dtype, device=device,
                                          lead=(st.repeats,),
                                          cross_len=cross_len)
            for ci, sig in enumerate(st.cycle)}
    return caches


def prefill(params, cfg, batch, caches):
    """Run the full prompt through the model, filling caches. t=0 start.
    Under the serving step's token block (``launch.steps.make_prefill_step``)
    ``batch`` is this rank's block and the logits its (B/d, S/m, V) block:
    its dp rows and sequence block over the whole vocabulary (not the
    reference's vocabulary split); ``caches`` are this rank's shards."""
    logits, caches, _ = forward(params, cfg, batch, caches=caches, t=0)
    return logits, caches


def decode_step(params, cfg, caches, token, t: int):
    """token: (B,) int; t: current length. -> (logits (B, V), caches).
    Under the serving step (``launch.steps.make_serve_step``) ``token``
    is this rank's dp rows, the residual stream whole over ``model``, and
    the logits (B/d, V) whole over the vocabulary on every ``model``
    rank."""
    logits, caches, _ = forward(params, cfg, {"tokens": token[:, None]},
                                caches=caches, t=t)
    return logits[:, 0], caches
