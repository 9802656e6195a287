"""Recurrent sequence mixers: RWKV6 ("Finch") and RG-LRU (Griffin).

PyTorch counterpart of ``repro/models/recurrent.py``, with the same casts.
A multi-token call (prefill, forward) goes through the port's kernels:
RWKV6's time mix through ``ops.rwkv6_scan`` (K4) and the RG-LRU recurrence
through ``ops.rg_lru`` (K5), each starting from the caller's state — on
the card the hand-written kernel, on the CPU the plain chunked and scanned
forms ``rwkv6_chunked`` and ``rglru_scan`` of ``kernels/ref.py``, which are
what the reference model computes. A one-token decode step is plain
PyTorch, as in the reference.

States are updated in place where a kernel can write them:
``ops.rwkv6_scan`` overwrites the (B, H, N, N) state it is given with the
final one, so a prefill writes straight into its cache.

While autograd records (training), K4 and K5 run inside ``WKV6`` and
``RGLRU``: the forward is the kernel, the backward autograd through
``rwkv6_chunked`` and ``rglru_scan`` recomputed from the inputs, the forms
the reference trains through; ``WKV6`` returns the final state as a new
tensor instead of writing the caller's.

On the train step's sequence block (``sharding.seq_block``) the token
shift and the causal conv read the positions before the block from the
previous ranks (``TokenBlock.halo``), the projections, gates and norms
run on this rank's positions, and an all-to-all over ``model`` hands the
scan this rank's heads (WKV6) or channels (RG-LRU) over the whole
sequence, and hands the result back: the norm after WKV6 is a layernorm
over all of D, so it runs on the sequence block. Where ``model`` does not
divide the heads or channels, every rank scans all of them.

Serving under a ``CacheBlock`` (``sharding.use_cache_block``) holds this
rank's heads of the WKV state and its block of the width of ``x_last_*``,
``h`` and ``conv``: the scans run those heads or channels from this
rank's state, the shift and the conv read the whole carries gathered
over ``model``, and the carries written back are this rank's block of
the global last rows.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rglru_scan, rwkv6_chunked
from repro_torch.models import layers as L
from repro_torch.models.sharding import current_cache_block, seq_block

RWKV_LORA = 32
DECAY_LORA = 64


def _const(arr, *, device, lead):
    """A numpy f32 constant repeated over the stack's leading axes."""
    t = torch.as_tensor(np.asarray(arr, np.float32), device=device)
    return t.expand(tuple(lead) + tuple(t.shape)).contiguous()


# ===================================================================== #
# RWKV6 time mix
# ===================================================================== #
def init_rwkv6(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
               device="cpu", lead: tuple = ()):
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    nh = d // n
    f32 = dict(dtype=torch.float32, device=device, lead=lead)
    kw = dict(dtype=dtype, device=device, lead=lead)
    lead = tuple(lead)
    return {
        # token-shift mixing coefficients (base + low-rank data-dependent)
        "mu": torch.zeros(lead + (5, d), device=device),      # w,k,v,r,g
        "mu_x": torch.zeros(lead + (d,), device=device),
        "lora_a": L.dense_init(generator, (5, d, RWKV_LORA), **f32),
        "lora_b": L.dense_init(generator, (5, RWKV_LORA, d), **f32),
        # decay: base + lora
        "w_base": _const(
            np.tile(-6.0 + 5.0 * (np.arange(n) / max(n - 1, 1)) ** 0.9, nh),
            device=device, lead=lead),                         # (d,)
        "w_lora_a": L.dense_init(generator, (d, DECAY_LORA), **f32),
        "w_lora_b": L.dense_init(generator, (DECAY_LORA, d), **f32),
        "wr": L.dense_init(generator, (d, d), **kw),
        "wk": L.dense_init(generator, (d, d), **kw),
        "wv": L.dense_init(generator, (d, d), **kw),
        "wg": L.dense_init(generator, (d, d), **kw),
        "wo": L.dense_init(generator, (d, d), 1.0 / np.sqrt(2 * n_layers),
                           **kw),
        "u": torch.zeros(lead + (nh, n), device=device),        # bonus
        "ln_out": {"scale": torch.zeros(lead + (d,), device=device),
                   "bias": torch.zeros(lead + (d,), device=device)},
    }


def _rwkv6_projections(x, x_prev, p):
    """Token-shift + data-dependent interpolation -> r,k,v,g,w_log."""
    dx = x_prev - x                                            # (B,S,D)
    xx = x + dx * p["mu_x"].to(x.dtype)
    # 5 low-rank mixes at once: (B,S,5,D)
    hid = torch.tanh(torch.einsum("bsd,cdr->bscr", xx,
                                  p["lora_a"].to(x.dtype)))
    mix = torch.einsum("bscr,crd->bscd", hid, p["lora_b"].to(x.dtype))
    mix = mix + p["mu"].to(x.dtype)                            # (B,S,5,D)
    xw, xk, xv, xr, xg = [x + dx * mix[:, :, i] for i in range(5)]
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    w_raw = (p["w_base"].float()
             + torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"])
    w_log = -torch.exp(w_raw)                                  # log decay <= 0
    return r, k, v, g, w_log


def rwkv6_step(r, k, v, w_log, u, state):
    """Single-token recurrence. r/k/v/w_log: (B,H,N); state (B,H,N,N)."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    out = torch.einsum("bhn,bhnm->bhm", rf, state + u[None, ..., None] * kv)
    state = torch.exp(w_log)[..., None] * state + kv
    return out, state


class WKV6(torch.autograd.Function):
    """K4 under autograd: the forward is ``ops.rwkv6_scan`` on a copy of
    the initial state, returned as the final state (the kernel overwrites
    the state it is given); the backward is autograd through
    ``rwkv6_chunked`` recomputed from r, k, v, w_log, u and the initial
    state, the form the reference trains through."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, state, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, w_log, u, state)
        final = state.clone()
        out = ops.rwkv6_scan(r, k, v, w_log, u, chunk=chunk, state=final)
        return out, final

    @staticmethod
    def backward(ctx, g_out, g_state):
        return L.plain_vjp(
            lambda *xs: rwkv6_chunked(*xs, chunk=ctx.chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:6],
            (g_out, g_state)) + (None,)


def _shifted(x, x_last):
    """The previous token of each position: x_last (or zeros) first, on a
    sequence block the previous block's last (x_last before the first
    block)."""
    blk = seq_block()
    if blk is not None:
        return torch.cat([blk.halo(x, 1, None if x_last is None else
                                   x_last[:, None]), x[:, :-1]], dim=1)
    if x_last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _whole(t, cb, n: int):
    """A cache leaf of global width ``n`` (its last dim) whole: gathered
    over ``model`` where the ``CacheBlock`` ``cb`` splits it."""
    if cb is None or cb.share(n) is None:
        return t
    return cb.gather(t, -1)


def _own(t, cb, n: int):
    """The part of ``t`` (width ``n`` in its last dim) that this rank's
    cache shard holds: its block where ``cb`` splits the width."""
    ws = cb.share(n) if cb is not None else None
    return t if ws is None else t[..., ws]


def _last(x, blk):
    """The global sequence's last position of ``x`` (B, S, ...): on a
    sequence block the last block's."""
    return x[:, -1] if blk is None else blk.from_last(x[:, -1])


def _to_scan(blk, ts, n: int):
    """(B, S/m, n, ...) tensors of a sequence block ``blk`` -> the whole
    sequence of this rank's part of the n heads or channels (dim 2), or of
    all of them where ``model`` does not divide n; and the way back."""
    if blk.share(n) is not None:
        return [blk.seq_to_heads(t) for t in ts], blk.heads_to_seq
    s = blk.share(ts[0].shape[1] * blk.seq_size)
    return [blk.gather_seq(t) for t in ts], lambda t: t[:, s]


def rwkv6_forward(x, p, cfg, *, state=None, x_last=None, chunk: int = 32):
    """Full time-mix block. x (B,S,D).

    state/x_last: decode carries ((B,H,N,N) f32, (B,D)). Returns
    (out, (state, x_last)). A multi-token call overwrites ``state`` with the
    final state (``ops.rwkv6_scan``), or, while autograd records, returns
    it as a new tensor of the graph (``WKV6``); a one-token step returns a
    new one.

    Under a serving ``CacheBlock`` (state given) the caches hold this
    rank's block of the heads of ``state`` and of the width of ``x_last``
    where ``model`` divides them: the scan (K4, or the one-token step)
    runs this rank's heads from its state, on a sequence block by the
    all-to-all, else sliced from the whole sequence; the heads come back
    for the layernorm over D, and the returned ``x_last`` is this rank's
    block of the global last position's row."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    blk = seq_block()
    cb = current_cache_block() if state is not None else None
    if cb is not None:
        x_last = _whole(x_last, cb, d)
    r, k, v, g, w_log = _rwkv6_projections(x, _shifted(x, x_last), p)
    rh, kh, vh, wh = (a.reshape(b, s, h, n) for a in (r, k, v, w_log))
    u, back = p["u"], None
    if blk is not None:       # this rank's heads over the whole sequence
        (rh, kh, vh, wh), back = _to_scan(blk, (rh, kh, vh, wh), h)
        hs = blk.share(h)
        u = u if hs is None else u[hs]
        s = rh.shape[1]
    elif cb is not None and cb.share(h) is not None:   # the state's heads
        hs = cb.share(h)
        rh, kh, vh, wh = (a[:, :, hs] for a in (rh, kh, vh, wh))
        u = u[hs]
        back = lambda o: cb.gather(o, 2)               # noqa: E731
    if state is None:
        state = torch.zeros(b, u.shape[0], n, n, device=x.device)
    if s == 1:
        o, state = rwkv6_step(rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0], u,
                              state)
        o = o[:, None]
    else:
        c = max(chunk if s % chunk == 0 else int(np.gcd(s, chunk)), 1)
        if L.records_grad(rh, kh, vh, wh, u, state):
            o, state = WKV6.apply(rh, kh, vh, wh, u, state, c)
        else:
            o = ops.rwkv6_scan(rh, kh, vh, wh, u, chunk=c, state=state)
    if back is not None:
        o = back(o)
    o2 = o.reshape(g.shape)
    o2 = L.layernorm(o2.to(x.dtype), p["ln_out"]["scale"],
                     p["ln_out"]["bias"])                      # group-norm approx
    out = (o2 * g) @ p["wo"]
    last = x[:, -1] if cb is None else _own(_last(x, blk), cb, d)
    return out, (state, last.float())


def init_rwkv6_cmix(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
                    device="cpu", lead: tuple = ()):
    """RWKV channel-mix (squared-relu FFN with token shift)."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "mu_k": torch.zeros(tuple(lead) + (d,), device=device),
        "wk": L.dense_init(generator, (d, f), **kw),
        "wv": L.dense_init(generator, (f, d), 1.0 / np.sqrt(2 * n_layers),
                           **kw),
    }


def rwkv6_cmix(x, p, *, x_last=None):
    """The channel mix; under a serving ``CacheBlock`` (x_last given)
    ``x_last`` and the returned last row are this rank's block of D, as
    ``rwkv6_forward``'s."""
    cb = current_cache_block() if x_last is not None else None
    d = x.shape[-1]
    if cb is not None:
        x_last = _whole(x_last, cb, d)
    x_prev = _shifted(x, x_last)
    xk = x + (x_prev - x) * p["mu_k"].to(x.dtype)
    h = torch.square(F.relu(xk @ p["wk"]))
    last = x[:, -1] if cb is None else _own(_last(x, seq_block()), cb, d)
    return h @ p["wv"], last.float()


# ===================================================================== #
# RG-LRU (Griffin / RecurrentGemma)
# ===================================================================== #
CONV_WIDTH = 4
LRU_C = 8.0


def init_rglru(generator, cfg, n_layers: int, *, dtype=torch.bfloat16,
               device="cpu", lead: tuple = ()):
    d, w = cfg.d_model, cfg.lru_width
    kw = dict(dtype=dtype, device=device, lead=lead)
    conv = torch.empty(tuple(lead) + (CONV_WIDTH, w), device=device)
    return {
        "w_in": L.dense_init(generator, (d, w), **kw),
        "w_gate": L.dense_init(generator, (d, w), **kw),
        "conv": conv.normal_(generator=generator).mul_(0.1),
        "w_a": L.dense_init(generator, (w, w), **kw),          # recurrence gate
        "w_x": L.dense_init(generator, (w, w), **kw),          # input gate
        # Λ s.t. a = exp(-c·softplus(Λ)) spans [0.9, 0.999] at r=1
        "lam": _const(
            np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w)) / LRU_C)),
            device=device, lead=lead),
        "w_out": L.dense_init(generator, (w, d), 1.0 / np.sqrt(2 * n_layers),
                              **kw),
    }


def _causal_conv1d(x, kernel, conv_state=None):
    """Depthwise causal conv. x (B,S,W), kernel (CW,W).

    conv_state: (B, CW-1, W) previous inputs for decode. Returns (y, new_state).
    The taps are summed in x's dtype, in order, as the reference sums them.
    """
    b, s, w = x.shape
    cw = kernel.shape[0]
    if conv_state is None:
        pad = torch.zeros(b, cw - 1, w, dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                            # (B,S+CW-1,W)
    kern = kernel.to(x.dtype)
    y = xp[:, 0:s] * kern[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * kern[i]
    return y, xp[:, -(cw - 1):].float()


class RGLRU(torch.autograd.Function):
    """K5 under autograd: the forward is ``ops.rg_lru`` from ``h0``, the
    backward autograd through ``rglru_scan`` recomputed from x, a_log and
    h0, the recurrence the reference trains through."""

    @staticmethod
    def forward(ctx, x, a_log, h0):
        ctx.save_for_backward(x, a_log, h0)
        return ops.rg_lru(x, a_log, chunk=x.shape[1], bw=x.shape[2], h0=h0)

    @staticmethod
    def backward(ctx, g):
        return L.plain_vjp(lambda x, a_log, h0: rglru_scan(
            x.float(), a_log.float(), h0.float())[0], ctx.saved_tensors,
            ctx.needs_input_grad, (g,))


def rglru_forward(x, p, cfg, *, state=None):
    """Griffin recurrent block. x (B,S,D).

    state: dict(h (B,W) f32, conv (B,CW-1,W) f32) or None.
    Returns (out, new_state): on a sequence block, h at its last position.

    Under a serving ``CacheBlock`` (state given) the caches hold this
    rank's block of the width W of ``h`` and ``conv`` where ``model``
    divides it: the recurrence (K5, or the one-token step) runs this
    rank's channels from its ``h``, on a sequence block by the all-to-all,
    else sliced from the whole sequence, and the channels come back for
    the output projection; the returned ``h`` is taken before they come
    back, and ``conv`` is this rank's block of the global prompt's last
    CW - 1 rows of the conv's input."""
    b, s, d = x.shape
    w = cfg.lru_width
    blk = seq_block()
    cb = current_cache_block() if state is not None else None
    carry = state is not None
    if state is None:
        state = {"h": torch.zeros(b, w, device=x.device),
                 "conv": torch.zeros(b, CONV_WIDTH - 1, w, device=x.device)}
    conv = _whole(state["conv"], cb, w)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")         # (B,S,W)
    u = x @ p["w_in"]
    u, conv_state = _causal_conv1d(
        u, p["conv"], conv if blk is None else
        blk.halo(u, CONV_WIDTH - 1, conv if carry else None))
    uf = u.float()
    r = torch.sigmoid(u @ p["w_a"]).float()                    # recurrence gate
    i = torch.sigmoid(u @ p["w_x"]).float()                    # input gate
    a_log = -LRU_C * F.softplus(p["lam"]) * r                  # (B,S,W) <= 0
    xin = i * uf
    h0, back = state["h"], None
    if blk is not None:       # this rank's channels over the whole sequence
        (xin, a_log), back = _to_scan(blk, (xin, a_log), w)
        if not carry:
            h0 = torch.zeros(b, xin.shape[2], device=x.device)
    elif cb is not None and cb.share(w) is not None:   # the cache's channels
        xin, a_log = _own(xin, cb, w), _own(a_log, cb, w)
        back = lambda y: cb.gather(y, -1)              # noqa: E731
    if xin.shape[1] == 1:
        a = torch.exp(a_log[:, 0])
        h = a * h0 + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) \
            * xin[:, 0]
        y = h[:, None]
    else:
        # one block over the whole call: the reference model scans any S,
        # and the chunk/bw tiling checks belong to the TPU kernel's grid
        if L.records_grad(xin, a_log, h0):
            y = RGLRU.apply(xin, a_log, h0)
        else:
            y = ops.rg_lru(xin, a_log, chunk=xin.shape[1], bw=xin.shape[2],
                           h0=h0)
    h_last = y[:, -1]
    if back is not None:
        y = back(y)
    if blk is not None and not carry:
        h_last = y[:, -1]
    if cb is not None:
        conv_state = _own(conv_state if blk is None else
                          blk.from_last(conv_state), cb, w)
    out = (y.to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}
