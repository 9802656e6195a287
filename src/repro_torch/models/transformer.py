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
reference's does (a no-op on the port's plain tensors), and a MoE block
takes the expert-parallel route (``moe_ffn_ep_sharded``) under the
reference's condition: ``moe_impl == "ep"`` and a ``use_mesh`` mesh in the
``2d`` layout whose ``model`` axis is > 1 and divides S; else ``moe_ffn``
with ``moe_group``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.sharding import (axis_size, constrain,
                                         current_layout, current_mesh)

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
    if "xattn" in bp:                                      # cross-attention
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
            if cache is not None:                          # store cross K/V
                cache["xk"].copy_(torch.einsum("bsd,dhk->bshk", enc_out,
                                               xp["wk"]))
                cache["xv"].copy_(torch.einsum("bsd,dhk->bshk", enc_out,
                                               xp["wv"]))
        x = x + o
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
        use_ep = (cfg.moe_impl == "ep" and current_layout() == "2d"
                  and n_model > 1 and h2.shape[1] % n_model == 0)
        if use_ep:
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
    autograd records (the reference remats only outside decode)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
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
        layers = _unstack(params[f"stage{si}"], st.repeats)
        cs = caches.get(f"stage{si}") if caches is not None else None
        for r in range(st.repeats):
            cc = {sub: _tree_map(lambda a: a[r], c) for sub, c in cs.items()} \
                if cs is not None else None

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
    path), the final norm."""
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
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = (t or 0) + torch.arange(s, device=tokens.device)
        positions = positions[None].expand(b, s)
    enc_out = None
    if cfg.is_encoder_decoder and "audio" in batch:
        enc_out = encode(params, cfg, batch["audio"])
    x = _embed(params, cfg, tokens, positions, batch.get("patches"))
    x = constrain(x, "dp", "model", None)
    x, aux = _run_stages(params, cfg, x, positions, enc_out=enc_out,
                         caches=caches, t=t, moe_group=moe_group)
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
    to 0 before the lookup (and masked out by the caller)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = labels.clamp(min=0).long()
    if impl == "onehot":          # select + reduce instead of a gather
        iota = torch.arange(lf.shape[-1], device=lf.device)
        ll = torch.where(iota == lab[..., None], lf, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _mtp_loss(params, cfg, h_final, tokens, labels, mask):
    """DeepSeek-V3 multi-token prediction: predict t+2 from [h_t; emb_{t+1}],
    shifted by one and padded back to S (the padded tail masked out)."""
    mp = params["mtp"]
    pad = torch.nn.functional.pad
    h = L.norm(pad(h_final[:, :-1], (0, 0, 0, 1)), mp["norm_h"], cfg.norm)
    shifted = pad(tokens[:, 1:], (0, 1))
    e = L.norm(params["embed"][shifted], mp["norm_e"], cfg.norm)
    x = torch.cat([h, e], dim=-1) @ mp["proj"]
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    bp = _tree_map(lambda a: a[0], mp["block"]["sub0"])
    x, _, _ = apply_block(x, bp, cfg, ("attn", False), pos)
    logits = x @ params["lm_head"]
    lab2 = pad(labels[:, 1:], (0, 1), value=-1)
    m2 = pad(mask[:, 1:], (0, 1))
    return softmax_xent(logits, lab2, m2, cfg.xent_impl)


def train_loss(params, cfg, batch, *, moe_group: int = 0):
    """batch: tokens (B,S), labels (B,S) (-1 = masked), + frontend stubs.
    Returns (loss, metrics) as the reference's. Called with autograd on,
    the loss carries the graph to every parameter leaf that requires a
    gradient (``repro_torch.launch.steps.make_train_step``)."""
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logits, _, aux, h = _forward(params, cfg, batch, moe_group=moe_group,
                                 return_hidden=True)
    loss = softmax_xent(logits, labels, mask, cfg.xent_impl)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp:
        mtp = _mtp_loss(params, cfg, h, batch["tokens"], labels, mask)
        metrics["mtp"] = mtp
        loss = loss + 0.1 * mtp
    return loss + aux, metrics


# ===================================================================== #
# decode
# ===================================================================== #
@torch.inference_mode()
def init_decode_caches(cfg, batch: int, max_len: int, dtype=None,
                       device="cuda"):
    dtype = _torch_dtype(dtype or cfg.dtype)
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
    """Run the full prompt through the model, filling caches. t=0 start."""
    logits, caches, _ = forward(params, cfg, batch, caches=caches, t=0)
    return logits, caches


def decode_step(params, cfg, caches, token, t: int):
    """token: (B,) int; t: current length. -> (logits (B, V), caches)."""
    logits, caches, _ = forward(params, cfg, {"tokens": token[:, None]},
                                caches=caches, t=t)
    return logits[:, 0], caches
