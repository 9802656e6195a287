"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the CPU path of ``ops`` and the
values every CUDA kernel is held against on the card. ``rwkv6`` and
``rg_lru`` arrive with their kernels (ROADMAP queue 2).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def matmul(a, b):
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def sliced_matmul(a, b, slice_offsets_sizes=None):
    """Slicing never changes the result: the plain version is the matmul."""
    return matmul(a, b)


def streaming_scale(x, scale):
    """The memory-bound co-scheduled op: y = x * scale."""
    return (x * scale).to(x.dtype)


def coschedule(a, b, x, scale):
    """The fused interleave equals running the two ops separately."""
    return matmul(a, b), streaming_scale(x, scale)


def flash_attention(q, k, v, *, causal=True):
    """q, k, v: (B, H, S, D) -> (B, H, S, D)."""
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / np.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)
