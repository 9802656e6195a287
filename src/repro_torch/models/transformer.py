"""Model assembly: the stage-planned transformer.

PyTorch counterpart of ``repro/models/transformer.py`` for the dense
(GQA or MLA) ``attn``, sliding-window ``local``, ``rwkv6`` and ``rglru``
block kinds, each with a dense MLP or, past ``moe.first_dense_layers``, a
MoE FFN. Parameters keep the reference's stacked layout —
``params["stage<i>"]["sub<j>"]`` holds each weight with a leading
``repeats`` axis, and DeepSeek-V3's ``mtp`` head sits where the reference
puts it — so converting the reference's weights is a tree-map
(``repro_torch.convert``). Where the reference runs each stage under
``lax.scan`` with remat, this runs a Python loop over the stack under
``torch.inference_mode()``, and writes every cache in place. Sharding
(``constrain``) and the expert-parallel MoE are ROADMAP queue 1, item 14;
cross-attention, learned positions and the MTP loss raise or wait for
item 10.
"""
from __future__ import annotations

import dataclasses

import torch

import numpy as np

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

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
    if cfg.is_encoder_decoder:
        raise NotImplementedError("cross-attention: ROADMAP queue 1, item 10")


def _torch_dtype(name_or_dtype):
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    return _DTYPES[str(name_or_dtype)]


# ===================================================================== #
# per-block init / apply
# ===================================================================== #
def _init_block(generator, cfg, sig, n_layers, *, dtype, device, lead):
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
    if kind == "rwkv6":
        p["cmix"] = R.init_rwkv6_cmix(generator, cfg, n_layers, dtype=dtype,
                                      **kw)
    elif is_moe:
        p["moe"] = M.init_moe(generator, cfg, n_layers, dtype=dtype, **kw)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              n_layers, dtype=dtype, **kw)
    return p


def _init_block_cache(cfg, sig, batch, max_len, *, dtype, device, lead):
    kind, _ = sig
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "attn":
        return A.init_cache(cfg, batch, max_len, dtype=dtype, device=device,
                            lead=lead)
    if kind == "local":
        w = min(cfg.local_window, max_len)
        shape = lead + (batch, w, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full(lead + (w,), -1, dtype=torch.int32,
                                  device=device)}
    if kind == "rwkv6":
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"state": torch.zeros(lead + (batch, h, n, n), **f32),
                "x_last_t": torch.zeros(lead + (batch, cfg.d_model), **f32),
                "x_last_c": torch.zeros(lead + (batch, cfg.d_model), **f32)}
    w = cfg.lru_width
    return {"h": torch.zeros(lead + (batch, w), **f32),
            "conv": torch.zeros(lead + (batch, R.CONV_WIDTH - 1, w), **f32)}


def _local_ring_update(cache, k_new, v_new, positions):
    """Write (B,S,kv,hd) tokens at ring slots pos % W, in place."""
    w = cache["k"].shape[1]
    if k_new.shape[1] >= w:
        k_new, v_new = k_new[:, -w:], v_new[:, -w:]
        positions = positions[-w:]
    slots = positions % w
    cache["k"][:, slots] = k_new.to(cache["k"].dtype)
    cache["v"][:, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][slots] = positions.to(cache["pos"].dtype)
    return cache


def _local_ring_attend(q, cache, t, window):
    """Decode attention over a ring cache with stored absolute positions."""
    b, _, h, hd = q.shape
    kvh = cache["k"].shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          cache["k"].float()) * scale
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= t) & (pos > t - window)
    logits = torch.where(valid, logits, A.NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, cache["v"].float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _local_attention_block(x, p, cfg, positions, cache, t):
    """Local (sliding-window) attention with a ring-buffer cache, on the
    plain attention functions, as the reference runs it (no kernel: K3
    takes neither a window nor head_dim 256, ROADMAP queue 1, item 18)."""
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = L.positional(q, positions, cfg.pos_kind, cfg.rope_theta)
    k = L.positional(k, positions, cfg.pos_kind, cfg.rope_theta)
    if cache is not None:
        pos_vec = positions[0] if positions.ndim == 2 else positions
        _local_ring_update(cache, k, v, pos_vec)
        if s == 1:
            o = _local_ring_attend(q, cache, pos_vec[-1], cfg.local_window)
        else:
            blk = A._pick_block(s, s)
            o = A.chunked_attention(q, k, v, causal=True,
                                    window=cfg.local_window, q_block=blk,
                                    kv_block=blk)
    else:
        blk = A._pick_block(s, s)
        if s <= 2 * blk:
            o = A.full_attention(q, k, v, causal=True, window=cfg.local_window)
        else:
            o = A.chunked_attention(q, k, v, causal=True,
                                    window=cfg.local_window,
                                    q_block=blk, kv_block=blk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _store(cache, key, value):
    """Write ``value`` into the cache's tensor (a view into the stacked
    caches), unless the kernel already wrote it there."""
    if value is not cache[key]:
        cache[key].copy_(value)


def apply_block(x, bp, cfg, sig, positions, *, cache=None, t=None):
    """One block. ``cache`` (the block's views into the stacked caches) is
    updated in place. Returns (x, cache, aux), ``aux`` the MoE FFN's
    load-balance loss (0 for a dense FFN)."""
    _check_supported(cfg, sig)
    kind, is_moe = sig
    aux = torch.zeros((), device=x.device)
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
    h2 = L.norm(x, bp["norm2"], cfg.norm)
    if kind == "rwkv6":
        f, x_last_c = R.rwkv6_cmix(
            h2, bp["cmix"],
            x_last=cache["x_last_c"] if cache is not None else None)
        if cache is not None:
            _store(cache, "x_last_c", x_last_c)
    elif is_moe:
        f, aux = M.moe_ffn(h2, bp["moe"], cfg)
    else:
        f = L.mlp(h2, bp["mlp"], cfg.act)
    return x + f, cache, aux


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
        raise NotImplementedError("learned positions (whisper): ROADMAP "
                                  "queue 1, item 10")
    for si, st in enumerate(stage_plan(cfg)):
        params[f"stage{si}"] = {
            f"sub{ci}": _init_block(generator, cfg, sig, cfg.num_layers,
                                    dtype=dtype, device=device,
                                    lead=(st.repeats,))
            for ci, sig in enumerate(st.cycle)}
    params["final_norm"] = L.init_norm(cfg.norm, d, device=device)
    params["lm_head"] = L.dense_init(generator, (d, v), dtype=dtype,
                                     device=device)
    if cfg.mtp:     # DeepSeek-V3's head; its loss (_mtp_loss) is item 10
        params["mtp"] = {
            "norm_h": L.init_norm(cfg.norm, d, device=device),
            "norm_e": L.init_norm(cfg.norm, d, device=device),
            "proj": L.dense_init(generator, (2 * d, d), dtype=dtype,
                                 device=device),
            "block": {"sub0": _init_block(generator, cfg, ("attn", False),
                                          cfg.num_layers, dtype=dtype,
                                          device=device, lead=(1,))}}
    return params


def count_params(params) -> int:
    leaves = []
    _tree_map(leaves.append, params)
    return int(sum(x.numel() for x in leaves))


# ===================================================================== #
# forward
# ===================================================================== #
def _run_stages(params, cfg, x, positions, *, caches=None, t=None):
    """Every stage's blocks in order. Returns (x, the blocks' summed aux
    loss)."""
    aux = torch.zeros((), device=x.device)
    for si, st in enumerate(stage_plan(cfg)):
        sp = params[f"stage{si}"]
        cs = caches.get(f"stage{si}") if caches is not None else None
        for r in range(st.repeats):
            for ci, sig in enumerate(st.cycle):
                sub = f"sub{ci}"
                bp = _tree_map(lambda a: a[r], sp[sub])
                cc = _tree_map(lambda a: a[r], cs[sub]) if cs is not None \
                    else None
                x, _, a = apply_block(x, bp, cfg, sig, positions, cache=cc,
                                      t=t)
                aux = aux + a
    return x, aux


@torch.inference_mode()
def forward(params, cfg, batch, *, caches=None, t=None):
    """batch: tokens (B,S) [+ positions]. Returns (logits, caches, aux).

    ``caches`` are updated in place and returned; ``aux`` is the MoE
    blocks' summed load-balance loss (0 without MoE), as the reference's."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = (t or 0) + torch.arange(s, device=tokens.device)
        positions = positions[None].expand(b, s)
    for key in ("patches", "audio"):
        if key in batch:
            raise NotImplementedError(f"{key} frontend: ROADMAP queue 1, "
                                      "item 10")
    x = params["embed"][tokens]
    x, aux = _run_stages(params, cfg, x, positions, caches=caches, t=t)
    h_final = L.norm(x, params["final_norm"], cfg.norm)
    logits = h_final @ params["lm_head"]
    return logits, caches, aux


# ===================================================================== #
# decode
# ===================================================================== #
@torch.inference_mode()
def init_decode_caches(cfg, batch: int, max_len: int, dtype=None,
                       device="cuda"):
    dtype = _torch_dtype(dtype or cfg.dtype)
    caches = {}
    for si, st in enumerate(stage_plan(cfg)):
        for sig in st.cycle:
            _check_supported(cfg, sig)
        caches[f"stage{si}"] = {
            f"sub{ci}": _init_block_cache(cfg, sig, batch, max_len,
                                          dtype=dtype, device=device,
                                          lead=(st.repeats,))
            for ci, sig in enumerate(st.cycle)}
    return caches


def prefill(params, cfg, batch, caches):
    """Run the full prompt through the model, filling caches. t=0 start."""
    logits, caches, _ = forward(params, cfg, batch, caches=caches, t=0)
    return logits, caches


def decode_step(params, cfg, caches, token, t: int):
    """token: (B,) int; t: current length. -> (logits (B, V), caches)."""
    logits, caches, _ = forward(params, cfg, {"tokens": token[:, None]},
                                caches=caches, t=t)
    return logits[:, 0], caches
