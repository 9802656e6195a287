"""Common layer primitives: norms, activations, rotary embeddings, inits.

PyTorch counterpart of ``repro/models/layers.py``, with the same numerics:
norms compute in f32 and scale by ``1 + scale``, ``gelu`` is the tanh
approximation, and RoPE and Qwen2-VL's M-RoPE rotate split halves. Inits
draw from an explicit ``torch.Generator``; they cannot reproduce
``jax.random``'s draws, so the tests load the reference's weights through
``repro_torch.convert``.
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
               device="cpu", lead: tuple = (), fan_in: int = 0):
    """Truncated-normal fan-in init of a ``lead + shape`` tensor: one
    ``shape`` weight per leading index (a stack of layers), each drawn in
    f32 and cast, so no f32 copy of the whole stack is ever held. ``fan_in``
    0 means ``shape[0]``; a caller that moves a weight's first dim into
    ``lead`` passes that dim to keep the reference's scale."""
    if not fan_in:
        fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / np.sqrt(fan_in)
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    if out.is_meta:                  # shapes only: there is nothing to draw
        return out
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


def _rotate(x, ang):
    """Rotate x's split halves by the angles ``ang`` (..., S, 1, d/2)."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), device=x.device)
    ang = positions[..., :, None, None].float() * freqs      # (..., S, 1, d/2)
    return _rotate(x, ang)


def mrope_sections(head_dim: int) -> tuple:
    """3-way split of the d/2 frequency bands (temporal, height, width)."""
    h2 = head_dim // 2
    a = h2 // 4
    b = (h2 - a) // 2
    return (a, b, h2 - a - b)


def apply_mrope(x, positions3, theta: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL). positions3: (..., 3, S) t/h/w position
    ids, each driving its own contiguous band of frequencies; where
    t == h == w this is RoPE."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), device=x.device)
    p = positions3.float()
    parts, start = [], 0
    for axis, n in enumerate(mrope_sections(d)):
        parts.append(p[..., axis, :, None] * freqs[start:start + n])
        start += n
    return _rotate(x, torch.cat(parts, dim=-1)[..., :, None, :])


def positional(x, q_pos, pos_kind: str, theta: float):
    if pos_kind == "rope":
        return apply_rope(x, q_pos, theta)
    if pos_kind == "mrope":        # 1-D ids: the same id on all three axes
        p3 = q_pos[..., None, :].expand(*q_pos.shape[:-1], 3,
                                        q_pos.shape[-1])
        return apply_mrope(x, p3, theta)
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


# --------------------------------------------------------------------- #
# autograd around the kernels
# --------------------------------------------------------------------- #
def records_grad(*tensors) -> bool:
    """Whether autograd is recording a graph through any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs, grad_outputs):
    """A kernel's backward: autograd through ``plain``, the form the
    reference differentiates, recomputed from the saved ``inputs``.
    ``needs`` (``ctx.needs_input_grad``) says which inputs want a gradient;
    the others get None."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs,
                                                                  needs)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if o.requires_grad and g is not None]
        want = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if x.requires_grad else None for x in xs)
