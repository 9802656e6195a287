"""Common layer primitives: norms, activations, rotary embeddings, inits.

PyTorch counterpart of ``repro/models/layers.py``, with the same numerics:
norms compute in f32 and scale by ``1 + scale``, ``gelu`` is the tanh
approximation, and RoPE rotates split halves. Inits draw from an explicit
``torch.Generator``; they cannot reproduce ``jax.random``'s draws, so the
tests load the reference's weights through ``repro_torch.convert``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def _trunc_normal_(t, generator):
    """Standard normal truncated to [-2, 2], drawn in place by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t


def dense_init(generator, shape, scale: float = 1.0, *, dtype=torch.bfloat16,
               device="cpu", lead: tuple = ()):
    """Truncated-normal fan-in init of a ``lead + shape`` tensor: one
    ``shape`` weight per leading index (a stack of layers), each drawn in
    f32 and cast, so no f32 copy of the whole stack is ever held."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / np.sqrt(fan_in)
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    tmp = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    for idx in np.ndindex(*lead):
        out[idx].copy_(_trunc_normal_(tmp, generator).mul_(std))
    return out


def embed_init(generator, shape, *, dtype=torch.bfloat16, device="cpu"):
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return w.normal_(generator=generator).mul_(0.02).to(dtype)


# --------------------------------------------------------------------- #
# norms (computed in f32, cast back)
# --------------------------------------------------------------------- #
def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params.get("bias"))


def init_norm(kind: str, d: int, *, device="cpu", lead: tuple = ()):
    p = {"scale": torch.zeros(tuple(lead) + (d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), device=device)
    return p


# --------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------- #
def act_fn(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                         # RWKV channel-mix
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# --------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), device=x.device)
    ang = positions[..., :, None, None].float() * freqs      # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positional(x, q_pos, pos_kind: str, theta: float):
    if pos_kind == "rope":
        return apply_rope(x, q_pos, theta)
    if pos_kind == "mrope":
        raise NotImplementedError(
            "mrope (qwen2-vl): ROADMAP queue 1, item 6")
    return x                                                   # learned/none


# --------------------------------------------------------------------- #
# MLP / FFN
# --------------------------------------------------------------------- #
def init_mlp(generator, d: int, f: int, act: str, n_layers: int, *,
             dtype=torch.bfloat16, device="cpu", lead: tuple = ()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"wi": dense_init(generator, (d, f), **kw),
         "wo": dense_init(generator, (f, d), 1.0 / np.sqrt(2 * n_layers), **kw)}
    if is_gated(act):
        p["wg"] = dense_init(generator, (d, f), **kw)
    return p


def mlp(x, p, act: str):
    h = x @ p["wi"]
    if is_gated(act):
        h = act_fn(act)(x @ p["wg"]) * h
    else:
        h = act_fn(act)(h)
    return h @ p["wo"]
