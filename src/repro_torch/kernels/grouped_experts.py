"""G1 on Hopper: a dropless MoE route's routed experts as two grouped
products over the (token, choice) pairs sorted by expert, each expert's
rows found on the device.

No Pallas kernel of the reference computes this: it replaces the port's
bucketed expert products of a dropless route (``models/moe.py``
``_dropless_expert_compute``), which the reference leaves to XLA's batched
einsums over capacity buckets (``repro/models/moe.py`` ``moe_ffn``). Those
needed the experts' counts on the host to size the buckets, one read back a
MoE layer, and ran the few hot experts' rest one product at a time. The
CUDA kernels are ``csrc/grouped_experts.cu``: the gate and up products in
one pass, ``silu(g) * u`` rounded once to bf16 (``h``), then ``h @ wo[e]``
with each row weighted and written to its pair's flat (token, choice) slot.
A CTA finds its expert and row block from the counts in device memory, so
the grid depends only on the number of pairs, nothing is read back, and a
call is two launches (``LAUNCHES["grouped_experts"]`` counts both).
``plain`` below is the same function in plain PyTorch, expert by expert,
with the same f32 epilogue and one rounding;
``repro_torch.kernels.ops.grouped_experts`` picks between the two by
device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit), the
operations: at DeepSeek-V2-Lite's prompt (4096 tokens, top-6 of 64 experts,
D 2048, F 1408) one layer's products are 425.2 GFLOP, 0.430 ms at 989
TFLOP/s, against 0.330 ms for the experts' 1.107 GB at 3.35 TB/s (see
PERF.md for the kernels' time).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

BLOCK_ROWS = 128          # pair rows a tile: csrc/grouped_experts.cu BM
MAX_ROW_TILES = 65535     # the grid's second dim: ceil(N / BLOCK_ROWS) + E

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grouped_gate_up_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                               _I),
    "grouped_down_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                            _I)}


def check_shapes(xs, counts, weights, sort_idx, wi, wg, wo) -> None:
    """xs (N, D) pairs sorted by expert; counts (E,) and sort_idx (N,)
    integer, weights (N,) float; wi and wg (E, D, F), wo (E, F, D), of xs's
    float dtype; D and F multiples of 8 (16-byte rows). What the kernels
    take, held on every device, so a CPU run refuses what the card would.
    That the counts sum to N and sort_idx is a permutation is the caller's
    to keep: neither is read on the host."""
    if xs.ndim != 2 or counts.ndim != 1 or weights.ndim != 1 or \
            sort_idx.ndim != 1 or any(w.ndim != 3 for w in (wi, wg, wo)):
        shapes = [tuple(t.shape) for t in (xs, counts, weights, sort_idx,
                                           wi, wg, wo)]
        raise ValueError(
            f"grouped_experts: xs (N, D), counts (E,), weights (N,), "
            f"sort_idx (N,), wi/wg (E, D, F), wo (E, F, D); got {shapes}")
    n, d = xs.shape
    e, _, f = wi.shape
    if (tuple(wi.shape) != (e, d, f) or tuple(wg.shape) != (e, d, f)
            or tuple(wo.shape) != (e, f, d) or counts.shape[0] != e
            or weights.shape[0] != n or sort_idx.shape[0] != n):
        raise ValueError(
            f"grouped_experts: shapes disagree: xs {tuple(xs.shape)}, counts "
            f"{tuple(counts.shape)}, weights {tuple(weights.shape)}, "
            f"sort_idx {tuple(sort_idx.shape)}, wi {tuple(wi.shape)}, wg "
            f"{tuple(wg.shape)}, wo {tuple(wo.shape)}")
    if n == 0 or d % 8 or f % 8:
        raise ValueError(f"grouped_experts: N = {n}, D = {d}, F = {f}; the "
                         f"kernels take N > 0 and D, F multiples of 8")
    if -(-n // BLOCK_ROWS) + e > MAX_ROW_TILES:
        raise ValueError(f"grouped_experts: {n} pairs over {e} experts need "
                         f"more than {MAX_ROW_TILES} row tiles")
    if not xs.dtype.is_floating_point or any(w.dtype != xs.dtype
                                             for w in (wi, wg, wo)):
        raise ValueError(f"grouped_experts: xs {xs.dtype}, wi {wi.dtype}, wg "
                         f"{wg.dtype}, wo {wo.dtype}: one float dtype")
    if counts.dtype.is_floating_point or sort_idx.dtype.is_floating_point \
            or not weights.dtype.is_floating_point:
        raise ValueError(f"grouped_experts: counts {counts.dtype} and "
                         f"sort_idx {sort_idx.dtype} integer, weights "
                         f"{weights.dtype} float")


def plain(xs, counts, weights, sort_idx, wi, wg, wo):
    """(N, D) in xs's dtype: row ``sort_idx[i]`` is ``weights[i] *
    (silu(xs[i] @ wg[e]) * (xs[i] @ wi[e])) @ wo[e]`` for pair i of expert
    e (expert e's pairs are the ``counts[e]`` rows after the counts before
    it). Expert by expert, every product in f32, ``h`` rounded once to
    xs's dtype before the down product and the weighted row once after it,
    as the kernels do. Reads the counts on the host."""
    out = xs.new_empty(xs.shape)
    start = 0
    for e, c in enumerate(counts.tolist()):
        if c:
            rows = slice(start, start + c)
            x = xs[rows].float()
            h = (F.silu(x @ wg[e].float()) * (x @ wi[e].float())).to(xs.dtype)
            y = (h.float() @ wo[e].float()) * weights[rows, None].float()
            out[sort_idx[rows]] = y.to(xs.dtype)
        start += c
    return out


def grouped_experts(xs, counts, weights, sort_idx, wi, wg, wo):
    """``plain``'s function on the card: two launches, nothing read back.
    xs, wi, wg, wo bf16, counts and sort_idx int64, weights float32, all
    contiguous on one CUDA device."""
    dev = xs.device
    for name, t, dtype in (("xs", xs, torch.bfloat16),
                           ("wi", wi, torch.bfloat16),
                           ("wg", wg, torch.bfloat16),
                           ("wo", wo, torch.bfloat16),
                           ("counts", counts, torch.int64),
                           ("weights", weights, torch.float32),
                           ("sort_idx", sort_idx, torch.int64)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"grouped_experts: {name} on {t.device}, not "
                             f"the CUDA device {dev}")
        if t.dtype != dtype:
            raise ValueError(f"grouped_experts: {name} is {t.dtype}; the "
                             f"kernels take {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"grouped_experts: {name} must be contiguous "
                             f"and start on 16 bytes")
    n, d = xs.shape
    e, _, f = wi.shape
    h = torch.empty(n, f, dtype=xs.dtype, device=dev)
    out = torch.empty(n, d, dtype=xs.dtype, device=dev)
    lib = _build.load("grouped_experts", _SIGNATURES)
    stream = _build.stream_ptr(xs)
    with torch.cuda.device(dev):
        err = lib.grouped_gate_up_launch(
            xs.data_ptr(), wg.data_ptr(), wi.data_ptr(), counts.data_ptr(),
            h.data_ptr(), n, d, f, e, stream)
        _build.check("grouped_experts", err)
        err = lib.grouped_down_launch(
            h.data_ptr(), wo.data_ptr(), counts.data_ptr(),
            weights.data_ptr(), sort_idx.data_ptr(), out.data_ptr(), n, f,
            d, e, stream)
    _build.check("grouped_experts", err)
    return out
