"""What both references share: float32 with TF32 off, the norms, and the
precision a matrix product runs in (float32, or the control's fp8)."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32, not TF32, for the block's duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t, dim: int):
    """``t`` rounded through float8_e4m3fn with one scale a slice along
    ``dim`` (its absolute maximum mapped to the format's largest)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How the reference multiplies. ``control=False``: float32 weights
    and activations. ``control=True``: the control, one step below the
    configuration's bfloat16: every product's weight rounded through fp8
    (e4m3, a scale an output column) and its input through fp8 (a scale a
    row), the product then taken in float32, as an fp8 GEMM would."""

    def __init__(self, control: bool = False):
        self.control = control

    def weight(self, w):
        """A (K, N) weight as the products read it."""
        w = w.float()
        return _fp8(w, 0) if self.control else w

    def mm(self, x, w):
        """x (..., K) @ w (K, N), w prepared by ``weight``."""
        x = x.float()
        return (_fp8(x, -1) if self.control else x) @ w


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + scale) + bias


def rel_err(got, want) -> float:
    """||got - want|| / ||want||."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def worst_row_rel_err(got, want):
    """The same ratio at the worst last-axis row: (ratio, the row's index
    over the leading axes)."""
    g, w = got.float(), want.float()
    ratios = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    flat = int(ratios.argmax())
    index = tuple(int(i) for i in torch.unravel_index(
        torch.tensor(flat), ratios.shape))
    return float(ratios.reshape(-1)[flat]), index
