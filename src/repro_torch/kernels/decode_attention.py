"""D1 on Hopper: one query token's attention over a KV cache, split along
the cache's rows, reading the cache in place.

No Pallas kernel of the reference computes this: it replaces the eager
transliteration of the reference's plain ``decode_attention``
(``repro/models/attention.py:183``) and of its ring's
``_local_ring_attend`` (``repro/models/transformer.py:132``), which wrote an
f32 copy of every cache a layer a step. The CUDA kernel is
``csrc/decode_attention.cu``: one CTA per (split, kv head, b) reading the
bf16 or f32 rows once through the cache's strides, f32 online softmax per
query head, and a second launch that merges the splits in order. It returns
the partials (m, l, o); the model divides o by l or combines ranks
(``models/attention.py`` ``split_k_combine``). The plain version is
``repro_torch.kernels.ref.decode_attention``;
``repro_torch.kernels.ops.decode_attention`` picks between the two by
device.

Bound on an H100 SXM (data-sheet peaks at its 700 W limit), the bytes: at
phi3-mini's decode, 8 x 2049 valid rows of 32 kv heads x 96 in bf16, a
layer reads 201.4 MB of K and V, ~0.060 ms at 3.35 TB/s (see PERF.md for
the kernel's time).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256        # csrc/decode_attention.cu MAX_D
MAX_GROUP = 16            # query heads a kv head: the largest instance
SPLIT_WAVES = 2           # CTAs an SM the split count aims for
MIN_SPLIT_ROWS = 32       # rows a split reads at least, where it can
MAX_SPLITS = 1024         # csrc/decode_attention.cu MAX_SPLITS

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention_launch": (
    [_P, _P, _P, _L, _L, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    ctypes.c_int)}


def check_shapes(q, k, v, pos=None) -> None:
    """q (B, H, D); k and v (B, S, kv, D) alike; kv divides H with at most
    ``MAX_GROUP`` query heads a kv head; D a multiple of 8 up to
    ``MAX_HEAD_DIM``; ``pos`` (S,). What the kernel takes, held on every
    device, so a CPU run refuses what the card would."""
    if k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"decode_attention: k and v must share one (B, S, "
                         f"kv, D) shape, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, kvh, d = k.shape
    if q.ndim != 3 or q.shape[0] != b or q.shape[2] != d:
        raise ValueError(f"decode_attention: q must be (B, H, D) = ({b}, H, "
                         f"{d}), got {tuple(q.shape)}")
    h = q.shape[1]
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} query heads over {kvh} kv "
                         f"heads; kv must divide H, with at most "
                         f"{MAX_GROUP} query heads a kv head")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {d}; the kernel takes "
                         f"a multiple of 8 up to {MAX_HEAD_DIM}")
    if pos is not None and tuple(pos.shape) != (s,):
        raise ValueError(f"decode_attention: pos must be ({s},), got "
                         f"{tuple(pos.shape)}")


def split_count(pairs: int, rows: int, sms: int,
                waves: int = SPLIT_WAVES) -> int:
    """Splits of the rows read per (b, kv head): enough that the grid puts
    ``waves`` CTAs on each of ``sms`` SMs, no more than leave each split
    ``MIN_SPLIT_ROWS`` rows, and at least one."""
    want = -(-waves * sms // pairs)
    return max(1, min(want, rows // MIN_SPLIT_ROWS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _strides(name: str, t) -> tuple:
    """(b, row, head) element strides of a cache the kernel reads in place:
    unit stride along D and 16-byte aligned rows, else it raises (a copy
    of the cache is what the kernel exists to avoid)."""
    sb, ss, sh, sd = t.stride()
    elt = t.element_size()
    if sd != 1 or t.data_ptr() % 16 or any(x * elt % 16 for x in (sb, ss, sh)):
        raise ValueError(
            f"decode_attention: {name} {tuple(t.shape)} with strides "
            f"{t.stride()} at {t.data_ptr() % 16} bytes past 16: the kernel "
            f"reads the cache in place, from 16-byte aligned rows of unit "
            f"stride")
    return sb, ss, sh


def decode_attention(q, k, v, *, lo: int, hi: int, offset: int = 0,
                     pos=None, n_splits: int = None):
    """(m, l, o) f32 on the card, as ``ref.decode_attention``; q (B, H, D)
    of any float dtype, k and v CUDA tensors of one dtype (f32 or bf16),
    read where they lie. ``n_splits`` None: ``split_count`` of this call."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, not "
                             f"the CUDA device {dev}")
    if k.dtype not in _build.DTYPE_CODES or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: k and v must both be float32 "
                         f"or bfloat16, got {k.dtype}, {v.dtype}")
    ks, vs = _strides("k", k), _strides("v", v)
    b, s, kvh, d = k.shape
    h = q.shape[1]
    lo = max(int(lo), 0)
    hi = int(hi)
    r0, r1 = ref.decode_rows(lo, hi, offset, s, pos is not None)
    ns = n_splits or split_count(b * kvh, r1 - r0,
                                 _sm_count(dev.index or 0))
    if not 1 <= ns <= MAX_SPLITS:
        raise ValueError(f"decode_attention: {ns} splits; the kernel takes "
                         f"1 to {MAX_SPLITS}")
    chunk = ref.decode_split(r1 - r0, ns)
    qf = q.float().contiguous()
    m = torch.empty(b, h, device=dev)
    l_sum = torch.empty(b, h, device=dev)
    o = torch.empty(b, h, d, device=dev)
    if ns == 1:
        parts = (m, l_sum, o)
    else:
        parts = (torch.empty(b, h, ns, device=dev),
                 torch.empty(b, h, ns, device=dev),
                 torch.empty(b, h, ns, d, device=dev))
    if pos is not None:
        pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    lib = _build.load("decode_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), *ks, *vs,
            pos.data_ptr() if pos is not None else None,
            *(t.data_ptr() for t in parts), m.data_ptr(), l_sum.data_ptr(),
            o.data_ptr(), b, kvh, h, d, r0, r1, chunk, ns, lo, hi,
            float(np.float32(1.0 / np.sqrt(d))),
            _build.DTYPE_CODES[k.dtype], _build.stream_ptr(q))
    _build.check("decode_attention", err)
    return m, l_sum, o
