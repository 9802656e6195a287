"""K4 on Hopper: chunked WKV6, the RWKV6 time mix, with its state carried.

Replaces ``rwkv6_scan`` of ``repro/kernels/rwkv6_scan.py`` (the
``pl.pallas_call`` at :72). The CUDA kernels are in ``csrc/rwkv6_scan.cu``,
two passes a call: pass 1, one CTA per (b, h, block of value columns), walks
the chunks in order and writes the state entering each chunk to a scratch
tensor; pass 2, one CTA per (b, h, chunk), forms each chunk's output from that
state with no sequential dependence. The chunk's products run on the tensor
cores with split-precision (bf16 high + low) operands, and no exponent above 0
is ever formed. Unlike the TPU kernel it starts from a given state and writes
the final one, so every multi-token call of the model runs on it. The plain
version is ``repro_torch.kernels.ref.rwkv6_chunked``, the oracle
``repro_torch.kernels.ref.rwkv6``; ``repro_torch.kernels.ops.rwkv6_scan``
picks between kernel and plain version by device. ``two_pass`` repeats the
kernels' arithmetic in plain PyTorch for the CPU tests.

The kernels take r/k/v in one dtype (f32 or bf16) beside f32 w_log, u and
state, at N = 32 or 64. The wrapper takes what the reference's kernel takes
(it widens every input in its body): w_log, u and a state in bf16 are
widened to f32 (they are a small share of the bytes), r/k/v of mixed dtypes
(or of another float type) all to f32, and an N below 64 that is neither is padded up to the next
instance with channels that leave the real ones untouched: zero r, k, v and
u, and a log decay of 0, which the kernels' own ragged-chunk padding uses
as neutral. An N above 64 raises.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit) at
(4, 2048, 32, 64) with bf16 r/k/v: 239.1 MB of inputs and output at
3.35 TB/s, 0.0714 ms a call; its 6.34 GFLOP would take 0.0947 ms all in f32 on
the CUDA cores, but the products run on the tensor cores (see PERF.md).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)        # template instances in csrc/rwkv6_scan.cu
CHUNK = 32                  # csrc/rwkv6_scan.cu C: the kernels' own chunk
SUB = 16                    # csrc/rwkv6_scan.cu SUB: the scores' sub-chunk
LOG2E = 1.4426950408889634

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv6_scan_fwd": ([_P] * 9 + [_I] * 5 + [_P], ctypes.c_int)}


def check_shapes(r, k, v, w_log, u, chunk: int) -> None:
    """The reference's preconditions (``rwkv6_scan.py:65-66``). On the
    card N must also be at most 64 (``padded_n``); the CPU route takes any
    N."""
    if r.ndim != 4 or not r.shape == k.shape == v.shape == w_log.shape:
        raise ValueError(f"rwkv6_scan: r, k, v, w_log must share one "
                         f"(B, S, H, N) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w_log.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"rwkv6_scan: u must be (H, N) = "
                         f"{tuple(r.shape[2:])}, got {tuple(u.shape)}")
    s = r.shape[1]
    if s % min(chunk, s):
        raise ValueError(f"rwkv6_scan: S={s} does not divide into chunks "
                         f"of {chunk}")


def padded_n(n: int) -> int:
    """The kernel instance that takes head dim ``n``: the smallest of
    ``HEAD_DIMS`` not below it."""
    for inst in HEAD_DIMS:
        if n <= inst:
            return inst
    raise ValueError(f"rwkv6_scan: head dim {n} is above {HEAD_DIMS[-1]}; "
                     f"the card takes N <= {HEAD_DIMS[-1]} (instances "
                     f"{HEAD_DIMS}, a smaller N padded up to the next)")


def widen_and_pad(r, k, v, w_log, u, state=None):
    """What the wrapper hands the kernels: r/k/v in one dtype (all f32 if
    they differ or are neither f32 nor bf16), w_log, u and the state (if
    any) in f32, every N padded to
    ``padded_n(N)`` with zero r, k, v, u and state and a log decay of 0.
    Returns (r, k, v, w_log, u, state); an f32 state at an instance's N is
    returned as it is, so that the kernels overwrite it in place."""
    n = r.shape[-1]
    np_ = padded_n(n)
    if (not r.dtype == k.dtype == v.dtype
            or r.dtype not in (torch.float32, torch.bfloat16)):
        r, k, v = r.float(), k.float(), v.float()
    w_log, u = w_log.float(), u.float()
    state = None if state is None else state.float().contiguous()
    if np_ != n:
        pad = (0, np_ - n)
        r, k, v, w_log, u = (torch.nn.functional.pad(t, pad)
                             for t in (r, k, v, w_log, u))
        if state is not None:
            state = torch.nn.functional.pad(state, pad + pad)
    return r, k, v, w_log, u, state


def _require(r, k, v, w_log, u, state) -> None:
    """What ``widen_and_pad`` hands over, on one card: r/k/v in one dtype,
    w_log/u/state in f32. The kernels copy rows 16 bytes at a time, so
    every tensor starts 16-byte aligned."""
    _build.require_cuda("rwkv6_scan", r, k, v)
    _build.require_cuda("rwkv6_scan", w_log, u, state)
    if w_log.device != r.device:
        raise ValueError(f"rwkv6_scan: w_log, u and state must be on "
                         f"{r.device}, got {w_log.device}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w_log, u, state)):
        raise ValueError("rwkv6_scan: tensors must start 16-byte aligned")


def rwkv6_scan(r, k, v, w_log, u, state=None):
    """(B, S, H, N) -> out (B, S, H, N) f32 on the card. ``state``
    ((B, H, N, N), f32 or bf16) is the initial state and is overwritten
    with the final one; None starts from zero and keeps no state. One call
    launches both passes and counts once in ``LAUNCHES``."""
    b, s, h, n = r.shape
    if state is not None and tuple(state.shape) != (b, h, n, n):
        raise ValueError(f"rwkv6_scan: state must be {(b, h, n, n)}, got "
                         f"{tuple(state.shape)}")
    r, k, v, w_log, u, state_f = widen_and_pad(r, k, v, w_log, u, state)
    np_ = r.shape[-1]
    state_out = state_f if state_f is not None else torch.empty(
        b, h, np_, np_, device=r.device)
    _require(r, k, v, w_log, u, state_out)
    out = torch.empty(b, s, h, np_, device=r.device)
    scratch = torch.empty(b, h, math.ceil(s / CHUNK), np_, np_,
                          device=r.device)
    lib = _build.load("rwkv6_scan", _SIGNATURES)
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state_f.data_ptr() if state_f is not None else None,
            out.data_ptr(), state_out.data_ptr(), scratch.data_ptr(), b, s,
            h, np_, _build.DTYPE_CODES[r.dtype], _build.stream_ptr(r))
    _build.check("rwkv6_scan", err)
    if state is not None and state_out is not state:
        state.copy_(state_out[..., :n, :n])
    return out[..., :n].contiguous() if np_ != n else out


def two_pass(r, k, v, w_log, u, state=None, *, on_exponent=None):
    """The kernels' arithmetic in plain f32 PyTorch, for the CPU tests:
    chunks of ``CHUNK`` (a ragged last one padded with zeros), logs in
    log2 units, the states entering every chunk first (pass 1), then every
    chunk's output from its state (pass 2), with the intra-chunk scores
    factored across sub-chunks of ``SUB``. ``on_exponent``, if given, is
    called with every tensor of exponents before ``exp2`` takes it.
    Returns (out (B, S, H, N), final state (B, H, N, N))."""
    b, s, h, n = r.shape
    nc = math.ceil(s / CHUNK)

    def chunks(x):                       # (B, S, H, N) -> (B, H, nc, C, N)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, nc * CHUNK - s))
        return x.reshape(b, nc, CHUNK, h, n).permute(0, 3, 1, 2, 4)

    def exp2(x):
        if on_exponent is not None:
            on_exponent(x)
        return torch.exp2(x)

    rr, kk, vv, ww = map(chunks, (r, k, v, w_log))
    la = torch.cumsum(ww * LOG2E, dim=3)                  # inclusive
    lp = torch.nn.functional.pad(la[..., :-1, :], (0, 0, 1, 0))  # la_{i-1}
    la_end = la[..., -1, :]
    # pass 1: S_{c+1} = exp(la_end) S_c + kd^T v
    kd = kk * exp2(la_end[..., None, :] - la)
    dec = exp2(la_end)
    s_c = (torch.zeros(b, h, n, n) if state is None else state.float())
    entering = []
    for c in range(nc):
        entering.append(s_c)
        s_c = dec[:, :, c, :, None] * s_c + \
            kd[:, :, c].transpose(-1, -2) @ vv[:, :, c]
    s_prev = torch.stack(entering, dim=2)                 # (B, H, nc, N, N)
    # pass 2: rd @ S + att @ v + diag v
    out = (rr * exp2(lp)) @ s_prev
    lb = la[..., SUB - 1:SUB, :]
    att = torch.zeros(b, h, nc, CHUNK, CHUNK)
    q = rr[..., SUB:, :] * exp2(lp[..., SUB:, :] - lb)
    kp = kk[..., :SUB, :] * exp2(lb - la[..., :SUB, :])
    att[..., SUB:, :SUB] = q @ kp.transpose(-1, -2)
    ii, jj = torch.tril_indices(SUB, SUB, -1)             # j < i only
    for s0 in range(0, CHUNK, SUB):
        i, j = ii + s0, jj + s0
        d = exp2(lp[..., i, :] - la[..., j, :])
        att[..., i, j] = (rr[..., i, :] * kk[..., j, :] * d).sum(-1)
    out = out + att @ vv
    diag = (rr * u.float()[None, :, None, None, :] * kk).sum(-1)
    out = out + diag[..., None] * vv
    out = out.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h, n)[:, :s]
    return out, s_c
