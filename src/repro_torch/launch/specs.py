"""Meta-tensor stand-ins for every model input and state — the dry run's
no-allocation inputs — plus their shardings on a given mesh.

PyTorch counterpart of ``repro/launch/specs.py``: the reference's
``ShapeDtypeStruct``s are tensors on the ``meta`` device, built by the
port's own ``init_params`` / ``adamw.init`` / ``init_decode_caches`` with
``device="meta"``, so they have the real trees' keys, shapes and dtypes.
"""
from __future__ import annotations

import torch

from repro_torch.data.synthetic import VLM_PATCHES
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg, shape):
    """Training/prefill batch stand-ins."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((b, s), torch.int32)}
    if shape.phase == "train":
        out["labels"] = _sds((b, s), torch.int32)
    if cfg.frontend == "vision_stub":
        out["patches"] = _sds((b, min(VLM_PATCHES, s // 2), cfg.d_model),
                              torch.float32)
    if cfg.frontend == "audio_stub":
        out["audio"] = _sds((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def params_specs(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(0), device=META)


def opt_specs(cfg, params_sd, opt_cfg):
    return adamw.init(opt_cfg, params_sd)


def cache_specs(cfg, shape):
    return T.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                device=META)


def decode_input_specs(cfg, shape):
    return {"token": _sds((shape.global_batch,), torch.int32),
            "t": _sds((), torch.int32)}


def input_specs(cfg, shape, mesh, opt_cfg=None):
    """Everything the step function needs: (args, in_shardings) trees.

    train: (params, opt_state, batch); prefill: (params, caches, batch);
    decode: (params, caches, token, t).
    """
    params_sd = params_specs(cfg)
    p_sh = SH.param_shardings(params_sd, mesh,
                              fsdp=cfg.param_fsdp or shape.phase == "train")
    if shape.phase == "train":
        opt_cfg = opt_cfg or default_opt_config(cfg)
        opt_sd = opt_specs(cfg, params_sd, opt_cfg)
        o_sh = opt_shardings(opt_sd, params_sd, p_sh, mesh)
        batch_sd = batch_specs(cfg, shape)
        b_sh = SH.batch_shardings(batch_sd, mesh)
        return (params_sd, opt_sd, batch_sd), (p_sh, o_sh, b_sh)
    cache_sd = cache_specs(cfg, shape)
    c_sh = SH.cache_shardings(cache_sd, mesh)
    if shape.phase == "prefill":
        # full-prompt forward filling the caches
        batch_sd = batch_specs(cfg, shape)
        b_sh = SH.batch_shardings(batch_sd, mesh)
        return (params_sd, cache_sd, batch_sd), (p_sh, c_sh, b_sh)
    dec = decode_input_specs(cfg, shape)
    repl = SH.NamedSharding(mesh, SH.spec())
    tok_sh = SH.batch_shardings({"token": dec["token"]}, mesh)["token"]
    return ((params_sd, cache_sd, dec["token"], dec["t"]),
            (p_sh, c_sh, tok_sh, repl))


def opt_shardings(opt_sd, params_sd, p_sh, mesh):
    """Moments mirror the param shardings; scalars replicated."""
    repl = SH.NamedSharding(mesh, SH.spec())
    out = {"step": repl, "mu": p_sh, "nu": p_sh}
    if "err" in opt_sd:
        out["err"] = p_sh
    return out


def default_opt_config(cfg):
    big = cfg.param_count() > 5e10
    return adamw.OptConfig(moment_dtype="bfloat16" if big else "float32")


def moe_group_size(cfg, shape, mesh) -> int:
    """Bound the MoE dispatch transient: tokens are processed in groups so
    the (E, C, D) buffer stays O(group x top_k x cf) per device."""
    if cfg.moe is None:
        return 0
    dp = SH.axis_size(mesh, SH.dp_axes(mesh))
    tokens_per_shard = shape.global_batch * shape.seq_len // max(dp, 1)
    return int(min(tokens_per_shard, 8192))
