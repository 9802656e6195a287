"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the CPU path of ``ops`` and the
values every CUDA kernel is held against on the card. ``rwkv6`` and
``rg_lru`` are the sequential recurrences, the oracles of K4 and K5; the
CPU path of ``ops.rwkv6_scan`` and ``ops.rg_lru`` is the model's own
chunked and scanned form in ``repro_torch.models.recurrent``.
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


def rwkv6(r, k, v, w_log, u, state=None):
    """Sequential WKV6 recurrence. r/k/v/w_log: (B, S, H, N); u: (H, N);
    state: (B, H, N, N) f32. Returns (out f32, final_state)."""
    bsz, s, h, n = r.shape
    if state is None:
        state = torch.zeros(bsz, h, n, n, device=r.device)
    state = state.float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w_log))
    uf = u.float()[None, ..., None]
    outs = []
    for t in range(s):
        kv = torch.einsum("bhn,bhm->bhnm", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], state + uf * kv))
        state = torch.exp(wf[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def rg_lru(x, a_log, h0=None):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t. x, a_log: (B, S, W) f32;
    h0: (B, W). Returns h: (B, S, W) f32."""
    b, s, w = x.shape
    h = torch.zeros(b, w, device=x.device) if h0 is None else h0.float()
    xf, af = x.float(), a_log.float()
    hs = []
    for t in range(s):
        a = torch.exp(af[:, t])
        h = a * h + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * xf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
