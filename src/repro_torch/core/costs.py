"""Analytic implementation-cost model: FLOPs / HBM bytes / MODEL_FLOPS per
(config x shape). Mirrors what the implementation executes (causal-block
waste, MLA decode mode, MoE capacity padding, remat recompute). Used by the
roofline analysis and by the Kernelet serving profiles.

Constants: TPU v5e — 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI;
NVIDIA H100 SXM — 989 TFLOP/s dense bf16, 3.35 TB/s HBM3 (data sheet, at its
700 W power limit), the peaks of ``profiles.h100_profile_from_costs``.
"""
from __future__ import annotations

PEAK_FLOPS = 197e12
HBM_BW = 819e9
LINK_BW = 50e9

H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12


def _ffn_mult(act: str) -> int:
    return 3 if act in ("swiglu", "geglu") else 2


def layer_flops_fwd(cfg, b, s, kind: str, is_moe: bool, kv_len=None) -> float:
    """Forward FLOPs of one layer on (b, s) tokens (implementation counts:
    full-block attention, capacity-padded MoE, padded-v MLA; causal_skip
    scans only ~(g+1)/(2g) of the KV blocks at g=4 groups)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = b * s
    fl = 0.0
    skip = 0.625 if (cfg.causal_skip and kv_len is None and s > 2048) else 1.0
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            m = cfg.mla
            qk_d = m.qk_nope_dim + m.qk_rope_dim
            if m.q_lora_rank:
                fl += 2 * t * d * m.q_lora_rank + \
                    2 * t * m.q_lora_rank * h * qk_d
            else:                                         # direct wq
                fl += 2 * t * d * h * qk_d
            fl += 2 * t * d * (m.kv_lora_rank + m.qk_rope_dim)
            att_len = kv_len if kv_len else s
            if kind == "local":
                att_len = min(att_len, cfg.local_window)
            decode = kv_len is not None and s == 1
            if decode and cfg.mla_decode == "absorbed":
                # latent-space attention: no K/V expansion over the cache
                fl += 2 * t * h * m.qk_nope_dim * m.kv_lora_rank  # q absorb
                fl += 2 * b * s * att_len * h * \
                    (2 * m.kv_lora_rank + m.qk_rope_dim)          # scores+PV
                fl += 2 * t * h * m.kv_lora_rank * m.v_head_dim   # out absorb
            else:
                kv_t = b * att_len
                fl += 2 * kv_t * m.kv_lora_rank * h * \
                    (m.qk_nope_dim + m.v_head_dim)                # expansion
                fl += 2 * b * s * att_len * h * qk_d * 2  # scores+padded-v PV
            fl += 2 * t * h * m.v_head_dim * d
        else:
            fl += 2 * t * d * hd * (h + 2 * kv)
            att_len = kv_len if kv_len else s
            if kind == "local":
                att_len = min(att_len, cfg.local_window)
            fl += 2 * b * s * att_len * h * hd * 2 * \
                (skip if kind != "local" else 1.0)
            fl += 2 * t * h * hd * d
    elif kind == "rwkv6":
        n = cfg.rwkv_head_dim
        fl += 5 * 2 * t * d * d                       # r,k,v,g,o projections
        fl += 2 * t * d * (2 * 32 * 5 + 2 * 64)       # token-shift/decay loras
        chunk = 32
        fl += 2 * t * chunk * d * 2                   # intra-chunk attention
        fl += 2 * t * d * n * 2                       # inter-chunk state ops
    elif kind == "rglru":
        w = cfg.lru_width
        fl += 2 * t * d * w * 2                       # in + gate
        fl += 2 * t * w * w * 2                       # recurrence/input gates
        fl += t * w * 12                              # conv + scan elementwise
        fl += 2 * t * w * d                           # out
    # ffn
    if kind == "rwkv6":
        fl += 2 * 2 * t * d * cfg.d_ff                # cmix (2 matmuls)
    elif is_moe:
        m = cfg.moe
        fl += 2 * t * d * m.num_experts               # router
        # capacity-padded pairs; a dropless route (capacity_factor 0)
        # computes every pair
        routed_t = t * m.top_k * (m.capacity_factor or 1.0)
        fl += 2 * routed_t * d * m.d_ff_expert * _ffn_mult(cfg.act)
        fl += 2 * t * d * m.d_ff_expert * m.num_shared_experts * _ffn_mult(cfg.act)
    else:
        fl += 2 * t * d * cfg.d_ff * _ffn_mult(cfg.act)
    return fl


def model_flops_fwd(cfg, b, s, kv_len=None) -> float:
    from repro_torch.models.transformer import stage_plan
    fl = 0.0
    for st in stage_plan(cfg):
        for sig in st.cycle:
            fl += st.repeats * layer_flops_fwd(cfg, b, s, sig[0], sig[1],
                                               kv_len)
    # embedding lookup negligible; lm head:
    fl += 2 * b * s * cfg.d_model * cfg.vocab_size
    if cfg.is_encoder_decoder:
        se = cfg.encoder_seq
        for _ in range(cfg.encoder_layers):
            fl += layer_flops_fwd(cfg, b, se, "attn", False)
        # cross attention in each decoder layer
        h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        fl += cfg.num_layers * (2 * b * se * d * hd * cfg.num_kv_heads * 2
                                + 2 * b * s * d * h * hd
                                + 2 * b * s * se * h * hd * 2
                                + 2 * b * s * h * hd * d)
    if cfg.mtp:
        fl += 2 * b * s * (2 * cfg.d_model) * cfg.d_model
        fl += layer_flops_fwd(cfg, b, s, "attn", False)
        fl += 2 * b * s * cfg.d_model * cfg.vocab_size
    return fl


def cell_cost(cfg, shape) -> dict:
    """Implementation FLOPs / HBM bytes / MODEL_FLOPS for one cell."""
    b, s = shape.global_batch, shape.seq_len
    p_total = cfg.param_count()
    p_active = cfg.param_count(active_only=True)
    if shape.phase == "train":
        fwd = model_flops_fwd(cfg, b, s)
        flops = 4.0 * fwd if cfg.remat else 3.0 * fwd   # bwd 2x + remat 1x
        model_fl = 6.0 * p_active * b * s
        # bytes: params (fwd+bwd reads, grad write, adam m/v r+w, param w)
        mdt = 2 if p_total > 5e10 else 4
        bytes_params = p_total * (2 + 2 + 2 + 2 + 4 * (mdt // 2) + 2)
        # activations: residual stream saved per layer (remat) + recompute
        # traffic ~ 6 tensors of (b, s, d)-scale per layer, 2B each, r+w
        act = b * s * cfg.d_model * 2.0
        bytes_act = act * cfg.num_layers * (2 + 6 * 2)
        bytes_logits = b * s * cfg.vocab_size * (2 + 4) * 2
        hbm = bytes_params + bytes_act + bytes_logits
    elif shape.phase == "prefill":
        fwd = model_flops_fwd(cfg, b, s)
        flops = fwd
        model_fl = 2.0 * p_active * b * s
        act = b * s * cfg.d_model * 2.0
        hbm = p_total * 2 + act * cfg.num_layers * 6 + \
            b * s * cfg.vocab_size * 2
    else:  # decode: one token with kv_len cache
        fwd = model_flops_fwd(cfg, b, 1, kv_len=s)
        flops = fwd
        model_fl = 2.0 * p_active * b
        # params once + cache read
        cache_bytes = _cache_bytes(cfg, b, s)
        hbm = p_total * 2 + cache_bytes + b * cfg.vocab_size * 2
    return {"flops": flops, "hbm_bytes": hbm, "model_flops": model_fl}


def _cache_bytes(cfg, b, s) -> float:
    from repro_torch.models.transformer import stage_plan
    total = 0.0
    for st in stage_plan(cfg):
        for sig in st.cycle:
            kind = sig[0]
            if kind == "attn":
                if cfg.mla is not None:
                    per = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
                    total += st.repeats * b * s * per * 2
                else:
                    total += st.repeats * b * s * cfg.num_kv_heads * \
                        cfg.head_dim * 2 * 2
            elif kind == "local":
                w = min(cfg.local_window, s)
                total += st.repeats * b * w * cfg.num_kv_heads * \
                    cfg.head_dim * 2 * 2
            elif kind == "rwkv6":
                n = cfg.rwkv_head_dim
                total += st.repeats * b * (cfg.d_model // n) * n * n * 4
            elif kind == "rglru":
                total += st.repeats * b * cfg.lru_width * 4
    return total


