"""D2 on Hopper: MLA's absorbed single-token attention over the latent
cache, split along the cache's rows, reading the bf16 latents in place.

No Pallas kernel of the reference computes this: it replaces the
reference's absorbed decode (the branch of ``mla_forward`` at
``repro/models/attention.py:332``), two einsums over the latents, which the
port ran eagerly on an f32 copy of every layer's latent cache each decode
step, on the CUDA cores. The CUDA kernel is ``csrc/mla_decode.cu``: one
warpgroup per (split, tile of 16 query heads, b) streams the split's rows
of ``ckv`` and ``krope`` by TMA through a ring in shared memory, once for
all the tile's heads, and runs both products on the tensor cores
(``wgmma``, transposed: the rows or latent columns as the tile's 64 rows,
the heads as its 16 columns) with an f32 online softmax; a second launch
merges the splits. It returns the partials (m, l, o) that
``split_k_combine`` takes; the model divides o by l or combines ranks
(``models/attention.py``). ``plain`` below is the same function in plain
PyTorch, the f32 arithmetic the port ran before the kernel;
``repro_torch.kernels.ops.mla_decode_attention`` picks between the two by
device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit), the bytes: at
DeepSeek-V2-Lite's decode, 48 x 8193 rows of 512 + 64 bf16 latents, a
layer reads 453.0 MB, ~0.135 ms at 3.35 TB/s (see PERF.md for the
kernel's time).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, decode_rows
MAX_R = 512               # csrc/mla_decode.cu MAX_R
MAX_DR = 64               # csrc/mla_decode.cu MAX_DR
HEAD_TILE = 16            # query heads a CTA: csrc/mla_decode.cu HT
TILE_ROWS = 64            # cache rows a tile: csrc/mla_decode.cu BN
MAX_SPLITS = 1024         # csrc/mla_decode.cu MAX_SPLITS
SPLIT_COST_TILES = 2      # a split's fixed cost, in tiles' time: its first
                          # load, its epilogue, its partials in the merge

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mla_decode_launch": (
        [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
        ctypes.c_int),
    "mla_decode_ctas_per_sm": ([_I, _I, ctypes.POINTER(_I)], ctypes.c_int)}


def check_shapes(q_lat, q_rope, ckv, krope) -> None:
    """q_lat (B, H, R) and q_rope (B, H, DR) of one float dtype; ckv
    (B, S, R) and krope (B, S, DR) of one float dtype, each of unit stride
    along its last dim with rows on 16 bytes; R a multiple of 8 up to
    ``MAX_R``, DR one up to ``MAX_DR``. What the kernel takes, held on every
    device, so a CPU run refuses what the card would."""
    if any(t.ndim != 3 for t in (q_lat, q_rope, ckv, krope)):
        raise ValueError(
            f"mla_decode: q_lat, q_rope, ckv and krope must be 3-d, got "
            f"{[tuple(t.shape) for t in (q_lat, q_rope, ckv, krope)]}")
    b, s, r = ckv.shape
    h, dr = q_lat.shape[1], krope.shape[2]
    if (tuple(krope.shape[:2]) != (b, s) or tuple(q_lat.shape) != (b, h, r)
            or tuple(q_rope.shape) != (b, h, dr)):
        raise ValueError(
            f"mla_decode: q_lat (B, H, R), q_rope (B, H, DR), ckv (B, S, R) "
            f"and krope (B, S, DR) must agree, got {tuple(q_lat.shape)}, "
            f"{tuple(q_rope.shape)}, {tuple(ckv.shape)}, "
            f"{tuple(krope.shape)}")
    if r % 8 or not 8 <= r <= MAX_R:
        raise ValueError(f"mla_decode: latent width R = {r}; the kernel "
                         f"takes a multiple of 8 up to {MAX_R}")
    if dr % 8 or not 8 <= dr <= MAX_DR:
        raise ValueError(f"mla_decode: rope width DR = {dr}; the kernel "
                         f"takes a multiple of 8 up to {MAX_DR}")
    for pair in ((q_lat, q_rope), (ckv, krope)):
        if not pair[0].dtype.is_floating_point or pair[1].dtype != pair[0].dtype:
            raise ValueError(f"mla_decode: dtypes {pair[0].dtype}, "
                             f"{pair[1].dtype}; each pair must share one "
                             f"float dtype")
    for name, t in (("ckv", ckv), ("krope", krope)):
        sb, ss, sd = t.stride()
        if sd != 1 or any(x * t.element_size() % 16 for x in (sb, ss)):
            raise ValueError(
                f"mla_decode: {name} {tuple(t.shape)} with strides "
                f"{t.stride()}: the kernel reads the cache in place, from "
                f"16-byte aligned rows of unit stride")


def plain(q_lat, q_rope, ckv, krope, *, lo: int, hi: int, offset: int = 0,
          scale: float):
    """(m, l, o) f32 of shapes (B, H), (B, H), (B, H, R): over the rows
    whose position ``offset + r`` lies in [lo, hi), the max logit
    ((q_lat . ckv + q_rope . krope) * ``scale``), the sum of exp(logit - m)
    and the unnormalised sum of exp(logit - m) ckv; no valid row gives
    (NEG_INF, 0, 0). In f32 over f32 copies of the latents, as the port
    computed the absorbed decode before the kernel."""
    s = ckv.shape[1]
    pos = offset + torch.arange(s, device=ckv.device)
    valid = (pos >= max(lo, 0)) & (pos < hi)
    ckv_f = ckv.float()
    logits = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv_f)
              + torch.einsum("bhk,btk->bht", q_rope.float(),
                             krope.float())) * scale
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bht,btr->bhr", p, ckv_f)


@functools.lru_cache(maxsize=None)
def split_count(pairs: int, tiles: int, slots: int) -> int:
    """Splits of each of ``pairs`` (b, head tile)s' ``tiles`` row tiles:
    of 1 to one a tile, the count whose grid ends soonest, counted as the
    waves of CTAs the card holds at once (``slots``) times the tiles a
    split reads and ``SPLIT_COST_TILES``; a tie goes to fewer splits."""
    best, best_cost = 1, None
    for n in range(1, min(max(tiles, 1), MAX_SPLITS) + 1):
        cost = -(-pairs * n // slots) * (-(-tiles // n) + SPLIT_COST_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
    return best


@functools.lru_cache(maxsize=None)
def _slots(index: int, r: int, dr: int) -> int:
    """CTAs the card ``index`` holds at once at latent widths (r, dr)."""
    lib = _build.load("mla_decode", _SIGNATURES)
    per_sm = _I(0)
    with torch.cuda.device(index):
        err = lib.mla_decode_ctas_per_sm(r, dr, ctypes.byref(per_sm))
    _build.raise_on("mla_decode", err, "occupancy query")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * max(per_sm.value, 1)


def mla_decode_attention(q_lat, q_rope, ckv, krope, *, lo: int, hi: int,
                         offset: int = 0, scale: float, n_splits: int = None):
    """(m, l, o) f32 on the card, as ``plain``; every tensor bf16 on one
    CUDA device, the latents read where they lie. ``n_splits`` None:
    ``split_count`` of this call."""
    dev = q_lat.device
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
                    ("krope", krope)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"mla_decode: {name} on {t.device}, not the "
                             f"CUDA device {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"mla_decode: {name} is {t.dtype}; the kernel "
                             f"takes bfloat16")
    b, s, r = ckv.shape
    h, dr = q_lat.shape[1], krope.shape[2]
    r0, r1 = decode_rows(int(lo), int(hi), int(offset), s, False)
    tiles = -(-(r1 - r0) // TILE_ROWS)
    ns = n_splits or split_count(b * -(-h // HEAD_TILE), tiles,
                                 _slots(dev.index or 0, r, dr))
    if not 1 <= ns <= MAX_SPLITS:
        raise ValueError(f"mla_decode: {ns} splits; the kernel takes 1 to "
                         f"{MAX_SPLITS}")
    chunk = -(-tiles // ns) * TILE_ROWS      # whole tiles a split
    ql, qr = q_lat.contiguous(), q_rope.contiguous()
    for name, t in (("q_lat", ql), ("q_rope", qr), ("ckv", ckv),
                    ("krope", krope)):
        if t.data_ptr() % 16:
            raise ValueError(f"mla_decode: {name} starts "
                             f"{t.data_ptr() % 16} bytes past 16")
    m = torch.empty(b, h, device=dev)
    l_sum = torch.empty(b, h, device=dev)
    o = torch.empty(b, h, r, device=dev)
    if ns == 1:
        parts = (m, l_sum, o)
    else:
        parts = (torch.empty(b, h, ns, device=dev),
                 torch.empty(b, h, ns, device=dev),
                 torch.empty(b, h, ns, r, device=dev))
    lib = _build.load("mla_decode", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.mla_decode_launch(
            ql.data_ptr(), qr.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
            ckv.stride(0), ckv.stride(1), krope.stride(0), krope.stride(1),
            *(t.data_ptr() for t in parts), m.data_ptr(), l_sum.data_ptr(),
            o.data_ptr(), b, h, s, r, dr, r0, r1, chunk, ns, float(scale),
            _build.stream_ptr(q_lat))
    _build.check("mla_decode", err)
    return m, l_sum, o
