"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the CPU path of ``ops`` and the
values every CUDA kernel is held against on the card. ``rwkv6`` and
``rg_lru`` are the sequential recurrences, the oracles of K4 and K5;
``rwkv6_chunked`` and ``rglru_scan``, the chunked and scanned forms the
reference model computes, are the CPU path of ``ops.rwkv6_scan`` and
``ops.rg_lru`` and what ``models/recurrent.py``'s ``WKV6`` and ``RGLRU``
differentiate. Like every module under ``kernels/``, this one imports
nothing of the model layer above it.
``decode_attention`` has no Pallas counterpart: it is the reference's plain
``decode_attention`` (``repro/models/attention.py:183``) as partial
softmaxes, split as the kernel D1 splits it.
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


def flash_attention(q, k, v, *, causal=True, window: int = 0):
    """q, k, v: (B, H, S, D) -> (B, H, S, D); ``window`` > 0 keeps the
    keys k with q - k < window."""
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / np.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        if window > 0:
            mask = mask.triu(-(window - 1))
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def decode_rows(lo: int, hi: int, offset: int, s: int, ring: bool):
    """The rows [r0, r1) of an S-row cache that decode attention reads:
    those whose position ``offset + r`` lies in [lo, hi), or every slot of
    a ring (``ring``: each row's position is stored, not implied)."""
    if ring:
        return 0, s
    r0 = min(max(lo - offset, 0), s)
    return r0, min(max(hi - offset, r0), s)


def decode_split(rows: int, n_splits: int) -> int:
    """Rows a split reads: split i takes [r0 + i c, r0 + (i + 1) c) of the
    rows read, cut at r1; the last splits may be short or empty."""
    return -(-rows // n_splits)


def decode_attention(q, k, v, *, lo: int, hi: int, offset: int = 0,
                     pos=None, n_splits: int = 1):
    """One query token's attention partials over a KV cache. q (B, H, D);
    k, v (B, S, kv, D) f32 or bf16; a row's key position is ``offset + r``,
    or ``pos[r]`` ((S,) int, -1 an empty slot), and the row is valid when
    that lies in [max(lo, 0), hi). Returns f32 (m, l, o) of shapes (B, H),
    (B, H), (B, H, D): the max logit (q . k / sqrt(D)), the sum of
    exp(logit - m) and the unnormalised sum of exp(logit - m) v over the
    valid rows; no valid row gives (NEG_INF, 0, 0). Each of ``n_splits``
    splits of the rows read (``decode_rows``, ``decode_split``) is computed
    alone and the splits are merged in f32, in order, as the kernel does."""
    b, s, kvh, d = k.shape
    h = q.shape[1]
    lo = max(lo, 0)
    qg = q.float().reshape(b, kvh, h // kvh, d)
    scale = 1.0 / np.sqrt(d)
    kpos = (pos.long() if pos is not None else
            offset + torch.arange(s, device=k.device))
    valid = (kpos >= lo) & (kpos < hi)
    r0, r1 = decode_rows(lo, hi, offset, s, pos is not None)
    chunk = decode_split(r1 - r0, n_splits)
    parts = []
    for i in range(n_splits):
        a = min(r0 + i * chunk, r1)
        e = min(a + chunk, r1)
        if e == a:
            parts.append((torch.full(qg.shape[:-1], NEG_INF, device=k.device),
                          torch.zeros(qg.shape[:-1], device=k.device),
                          torch.zeros(qg.shape, device=k.device)))
            continue
        ok = valid[a:e]
        logits = torch.einsum("bkgd,bskd->bkgs", qg,
                              k[:, a:e].float()) * scale
        logits = torch.where(ok, logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.where(ok, torch.exp(logits - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgs,bskd->bkgd", p, v[:, a:e].float())))
    m = parts[0][0]
    for pm, _, _ in parts[1:]:
        m = torch.maximum(m, pm)
    l_sum = torch.zeros_like(m)
    o = torch.zeros_like(qg)
    for pm, pl, po in parts:
        w = torch.exp(pm - m)
        l_sum = l_sum + pl * w
        o = o + po * w[..., None]
    return m.reshape(b, h), l_sum.reshape(b, h), o.reshape(b, h, d)


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


def rwkv6_chunked(r, k, v, w_log, u, state, chunk: int = 32):
    """Chunkwise-parallel WKV6, the plain version of K4. r/k/v: (B,S,H,N)
    (any float), w_log (B,S,H,N) f32 (<=0), u (H,N), state (B,H,N,N) f32.
    Returns (out (B,S,H,N) f32, new_state).

    The intra-chunk decay exp(la_prev_i - la_j) is masked to j < i with
    ``where``, as the TPU kernel masks it (``rwkv6_scan.py:46``). The
    reference model multiplies by the mask instead, and above the diagonal
    the exponent is >= 0: where it overflows f32, inf * 0 gives NaN there
    (ROADMAP queue 3, item 4). Wherever the reference is finite the two
    agree exactly. This is also the form ``WKV6``'s backward differentiates,
    so the exponent is masked before ``exp`` too."""
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError((s, chunk))
    if r.is_meta:
        return _rwkv6_chunks_at_once(r, k, v, w_log, u, state, chunk)
    ii = torch.arange(chunk, device=r.device)
    lower = (ii[:, None] > ii[None, :])[None, :, :, None]      # (1,C,C,1)
    outs = []
    # chunks by ``split``, whose backward is one concatenation (a slice's
    # would write a zero tensor of the whole sequence for each chunk)
    for rr, kk, vv, ww in zip(*(a.split(chunk, dim=1)
                                for a in (r, k, v, w_log))):
        rr, kk, vv, ww = rr.float(), kk.float(), vv.float(), ww.float()
        la = torch.cumsum(ww, dim=1)                           # (B,C,H,N) <=0
        la_prev = la - ww                                      # exclusive
        la_end = la[:, -1:]                                    # (B,1,H,N)
        # inter-chunk: out_i += (r_i * exp(la_prev_i)) @ S
        r_dec = rr * torch.exp(la_prev)
        out = torch.einsum("bchn,bhnm->bchm", r_dec, state)
        # intra-chunk: att[i,j] = sum_n r_i k_j exp(la_prev_i - la_j), j<i;
        # the exponent is zeroed above the diagonal before exp, so neither
        # the values nor their gradient meet inf there
        dmat = torch.exp(torch.where(lower[..., None],
                                     la_prev[:, :, None] - la[:, None, :, :],
                                     0.0))
        att = torch.einsum("bihn,bjhn,bijhn->bijh", rr, kk, dmat)
        att = torch.where(lower, att, 0.0)
        out = out + torch.einsum("bijh,bjhn->bihn", att, vv)
        # bonus diagonal term: r_i (u * k_i) v_i
        diag = torch.einsum("bchn,bchn->bch", rr, kk * u[None, None])
        outs.append(out + diag[..., None] * vv)
        # state update: S' = diag(exp(la_end)) S + sum_j exp(la_end - la_j) k_j v_j^T
        k_dec = kk * torch.exp(la_end - la)
        state = torch.exp(la_end[:, 0])[..., None] * state + \
            torch.einsum("bchn,bchm->bhnm", k_dec, vv)
    return torch.cat(outs, dim=1), state


def _rwkv6_chunks_at_once(r, k, v, w_log, u, state, chunk):
    """``rwkv6_chunked`` on meta tensors (the dry run): no values, so no
    recurrence to follow. The same products run over every chunk at once,
    each chunk's incoming state standing in by the previous chunk's k.v
    term, so ``FlopCounterMode`` counts the loop's matmuls (and their
    backward) and the outputs have the loop's shapes and depend on every
    input, without a Python step a chunk."""
    b, s, h, n = r.shape
    ii = torch.arange(chunk, device=r.device)
    lower = (ii[:, None] > ii[None, :])[None, None, :, :, None]
    rr, kk, vv, ww = (a.float().reshape(b, s // chunk, chunk, h, n)
                      for a in (r, k, v, w_log))
    la = torch.cumsum(ww, dim=2)
    la_prev = la - ww
    la_end = la[:, :, -1:]
    k_dec = kk * torch.exp(la_end - la)
    kv = torch.einsum("bcthn,bcthm->bchnm", k_dec, vv)
    r_dec = rr * torch.exp(la_prev)
    out = torch.cat([torch.einsum("bcthn,bhnm->bcthm", r_dec[:, :1],
                                  state.float()),
                     torch.einsum("bcthn,bchnm->bcthm", r_dec[:, 1:],
                                  kv[:, :-1])], dim=1)
    dmat = torch.exp(torch.where(lower[..., None],
                                 la_prev[:, :, :, None] - la[:, :, None],
                                 0.0))
    att = torch.einsum("bcihn,bcjhn,bcijhn->bcijh", rr, kk, dmat)
    att = torch.where(lower, att, 0.0)
    out = out + torch.einsum("bcijh,bcjhn->bcihn", att, vv)
    diag = torch.einsum("bcthn,bcthn->bcth", rr, kk * u[None, None, None])
    out = out + diag[..., None] * vv
    last_in = kv[:, -2] if kv.shape[1] > 1 else state.float()
    final = torch.exp(la_end[:, -1, 0])[..., None] * last_in + kv[:, -1]
    return out.reshape(b, s, h, n), final


def rglru_scan(x, a_log, h0):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t, the plain version of K5.

    x (B,S,W) f32, a_log (B,S,W) f32 (log a_t <= 0), h0 (B,W) f32. The
    reference runs ``lax.associative_scan``; torch has none, so this is a
    loop over time (equal up to f32 rounding order). The steps come from
    ``unbind``, whose backward is one stack (indexing a step would write a
    zero tensor of the whole sequence for each step). Returns (h, h_last).
    """
    if x.is_meta:       # the dry run: no values to recur over, the
        # loop's shapes and inputs from elementwise ops, as the loop's are
        hh = torch.exp(a_log) * h0[:, None] + torch.sqrt(torch.clamp(
            1.0 - torch.exp(2.0 * a_log), min=1e-12)) * x
        return hh, hh[:, -1]
    a = torch.exp(a_log).unbind(1)
    b_term = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * a_log),
                                     min=1e-12)) * x).unbind(1)
    h = b_term[0] + a[0] * h0                # initial state folded in
    hs = [h]
    for t in range(1, x.shape[1]):
        h = a[t] * h + b_term[t]
        hs.append(h)
    hh = torch.stack(hs, dim=1)
    return hh, hh[:, -1]
