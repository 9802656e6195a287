"""Model assembly: the stage-planned dense transformer.

PyTorch counterpart of ``repro/models/transformer.py`` for the dense
``("attn", False)`` block. Parameters keep the reference's stacked layout —
``params["stage<i>"]["sub<j>"]`` holds each weight with a leading
``repeats`` axis — so converting the reference's weights is a tree-map
(``repro_torch.convert``). Where the reference runs each stage under
``lax.scan`` with remat, this runs a Python loop over the stack under
``torch.inference_mode()``. Sharding (``constrain``) is ROADMAP queue 1,
item 14; the other block kinds raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L

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
    kind, is_moe = sig
    if kind == "local":
        raise NotImplementedError("local attention: ROADMAP queue 1, item 10")
    if kind in ("rwkv6", "rglru"):
        raise NotImplementedError(f"{kind}: ROADMAP queue 1, item 8")
    if kind != "attn":
        raise ValueError(kind)
    if is_moe:
        raise NotImplementedError("MoE: ROADMAP queue 1, item 9")
    if cfg.mla is not None:
        raise NotImplementedError("MLA: ROADMAP queue 1, item 7")
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
    kw = dict(device=device, lead=lead)
    return {"norm1": L.init_norm(cfg.norm, cfg.d_model, **kw),
            "norm2": L.init_norm(cfg.norm, cfg.d_model, **kw),
            "attn": A.init_attention(generator, cfg, n_layers, dtype=dtype,
                                     **kw),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              n_layers, dtype=dtype, **kw)}


def apply_block(x, bp, cfg, sig, positions, *, cache=None, t=None):
    """One dense block. Returns (x, cache)."""
    _check_supported(cfg, sig)
    h = L.norm(x, bp["norm1"], cfg.norm)
    a, cache = A.gqa_forward(h, bp["attn"], cfg, positions, cache=cache, t=t)
    x = x + a
    h2 = L.norm(x, bp["norm2"], cfg.norm)
    return x + L.mlp(h2, bp["mlp"], cfg.act), cache


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
    if cfg.mtp:
        raise NotImplementedError("MTP head: ROADMAP queue 1, item 10")
    return params


def count_params(params) -> int:
    leaves = []
    _tree_map(leaves.append, params)
    return int(sum(x.numel() for x in leaves))


# ===================================================================== #
# forward
# ===================================================================== #
def _run_stages(params, cfg, x, positions, *, caches=None, t=None):
    for si, st in enumerate(stage_plan(cfg)):
        sp = params[f"stage{si}"]
        cs = caches.get(f"stage{si}") if caches is not None else None
        for r in range(st.repeats):
            for ci, sig in enumerate(st.cycle):
                sub = f"sub{ci}"
                bp = _tree_map(lambda a: a[r], sp[sub])
                cc = _tree_map(lambda a: a[r], cs[sub]) if cs is not None \
                    else None
                x, _ = apply_block(x, bp, cfg, sig, positions, cache=cc, t=t)
    return x


@torch.inference_mode()
def forward(params, cfg, batch, *, caches=None, t=None):
    """batch: tokens (B,S) [+ positions]. Returns (logits, caches, aux).

    ``caches`` are updated in place and returned; ``aux`` is the reference's
    MoE loss, zero for dense blocks."""
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
    x = _run_stages(params, cfg, x, positions, caches=caches, t=t)
    h_final = L.norm(x, params["final_norm"], cfg.norm)
    logits = h_final @ params["lm_head"]
    return logits, caches, torch.zeros((), device=logits.device)


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
            f"sub{ci}": A.init_cache(cfg, batch, max_len, dtype=dtype,
                                     device=device, lead=(st.repeats,))
            for ci in range(len(st.cycle))}
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
