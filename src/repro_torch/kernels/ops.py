"""Public entry points for the port's kernels, with the keyword arguments of
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``. Nothing else
selects the path: there is no counterpart of ``REPRO_PALLAS_INTERPRET``.
``LAUNCHES`` counts the kernels' launches by name.
"""
from __future__ import annotations

from repro_torch.kernels import _build, ref
from repro_torch.kernels import coschedule as _cs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import sliced_matmul as _sm

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def sliced_matmul(a, b, *, slice_size: int = 4, bm: int = 128,
                  bn: int = 128, bk: int = 128):
    _sm.check_shapes(a, b, bm, bn, bk)
    if _on_cpu(a):
        return ref.sliced_matmul(a, b)
    return _sm.sliced_matmul(a, b, slice_size=slice_size, bm=bm, bn=bn,
                             bk=bk)


def coschedule(a, b, x, *, scale: float = 2.0, run_a: int = 1,
               run_b: int = 1, bm: int = 128, bn: int = 128, bx: int = 256):
    _cs.check_shapes(a, b, x, bm, bn, bx)
    if _on_cpu(a):
        return ref.coschedule(a, b, x, scale)
    return _cs.coschedule(a, b, x, scale=scale, run_a=run_a, run_b=run_b,
                          bm=bm, bn=bn, bx=bx)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128):
    _fa.check_shapes(q, k, v, bq, bk)
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)
