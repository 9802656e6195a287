"""The port's kernels (K1 sliced_matmul, K2 coschedule, K3 flash_attention)
against the reference's ``repro.kernels.ops`` (Pallas in interpret mode),
over the grids and tolerances of tests/test_kernels.py; K4 and K5 are held
to the reference in tests/test_torch_recurrent.py. On the CPU the
port's ops run their plain versions; tests/test_torch_cuda.py holds the
Hopper kernels to those plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import coschedule as jax_cs
from repro.kernels import ops as jax_ops
from repro_torch.kernels import coschedule as CS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grouped_experts as GE
from repro_torch.kernels import ops
from repro_torch.kernels import rg_lru as LRU
from repro_torch.kernels import rwkv6_scan as WKV
from repro_torch.kernels import sliced_matmul as SM

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    # tests/test_kernels.py:17-19
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def pair(rng, shape, name):
    """The same values for both packages: drawn in f32 with numpy, then cast
    to the dtype by each framework (both round to nearest even)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,ss", [(256, 128, 256, 1), (128, 256, 384, 3),
                                      (384, 128, 128, 4)])
def test_sliced_matmul_matches_reference(m, k, n, ss, dtype):
    rng = np.random.default_rng(7)
    ja, ta = pair(rng, (m, k), dtype)
    jb, tb = pair(rng, (k, n), dtype)
    np.testing.assert_allclose(
        as_f32(ops.sliced_matmul(ta, tb, slice_size=ss)),
        as_f32(jax_ops.sliced_matmul(ja, jb, slice_size=ss)), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("run_a,run_b", [(1, 1), (2, 1), (1, 3)])
def test_coschedule_matches_reference(run_a, run_b, dtype):
    rng = np.random.default_rng(8)
    ja, ta = pair(rng, (256, 128), dtype)
    jb, tb = pair(rng, (128, 256), dtype)
    jx, tx = pair(rng, (1024, 256), dtype)
    mm, st = ops.coschedule(ta, tb, tx, run_a=run_a, run_b=run_b)
    jmm, jst = jax_ops.coschedule(ja, jb, jx, run_a=run_a, run_b=run_b)
    np.testing.assert_allclose(as_f32(mm), as_f32(jmm), **tol(dtype))
    np.testing.assert_allclose(as_f32(st), as_f32(jst), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d,causal", [(1, 2, 256, 64, True),
                                            (2, 1, 128, 128, True),
                                            (1, 2, 256, 64, False)])
def test_flash_attention_matches_reference(b, h, s, d, causal, dtype):
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = (pair(rng, (b, h, s, d), dtype)
                                    for _ in range(3))
    np.testing.assert_allclose(
        as_f32(ops.flash_attention(tq, tk, tv, causal=causal, bq=128,
                                   bk=128)),
        as_f32(jax_ops.flash_attention(jq, jk, jv, causal=causal, bq=128,
                                       bk=128)), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 160, 48, 192])
def test_flash_attention_stablelm_head_dims_match_reference(d, causal,
                                                            dtype):
    """StableLM's head dims (3B: 80, 12B: 160) and MLA's q.k dims
    (DeepSeek: 128 + 64 = 192; reduced: 32 + 16 = 48), which K3 takes on
    the card: the plain version against the reference's Pallas kernel in
    interpret mode, as tests/test_kernels.py:52-58 runs it, with its
    tolerances (f32 2e-4, bf16 2e-2)."""
    rng = np.random.default_rng(10)
    (jq, tq), (jk, tk), (jv, tv) = (pair(rng, (1, 2, 256, d), dtype)
                                    for _ in range(3))
    assert d in FA.HEAD_DIMS
    np.testing.assert_allclose(
        as_f32(ops.flash_attention(tq, tk, tv, causal=causal, bq=128,
                                   bk=128)),
        as_f32(jax_ops.flash_attention(jq, jk, jv, causal=causal, bq=128,
                                       bk=128)), **tol(dtype))


@pytest.mark.parametrize("n_a,n_b,run_a,run_b", [(4, 4, 1, 1), (6, 2, 2, 1),
                                                 (3, 7, 1, 3), (0, 5, 2, 2),
                                                 (4096, 256, 8, 8)])
def test_make_schedule_equals_reference(n_a, n_b, run_a, run_b):
    for got, want in zip(CS.make_schedule(n_a, n_b, run_a, run_b),
                         jax_cs.make_schedule(n_a, n_b, run_a, run_b)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_shape_checks_match_the_reference():
    a, b = torch.zeros(100, 128), torch.zeros(128, 128)
    with pytest.raises(ValueError):
        ops.sliced_matmul(a, b)
    with pytest.raises(ValueError):
        ops.coschedule(torch.zeros(128, 64), torch.zeros(64, 128),
                       torch.zeros(100, 64))
    q = torch.zeros(1, 1, 192, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)             # 192 % 128 != 0
    ops.flash_attention(q, q, q, bq=64, bk=64)


@pytest.mark.parametrize("call", [
    lambda t: SM.sliced_matmul(t, t),
    lambda t: CS.coschedule(t, t, t.repeat(2, 1)),
    lambda t: FA.flash_attention(t[None, None, :, :64], t[None, None, :, :64],
                                 t[None, None, :, :64]),
    lambda t: WKV.rwkv6_scan(*[t.view(1, 128, 2, 64)] * 4, t[0].view(2, 64)),
    lambda t: LRU.rg_lru(t[None], t[None]),
    lambda t: GE.grouped_experts(t, t[0, :2].long(), t[:, 0],
                                 t[:, 0].long(), *[t.view(2, 128, 64)] * 2,
                                 t.view(2, 64, 128)),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never falls back."""
    t = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        call(t)


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    q = torch.zeros(1, 1, 64, 32)
    ops.flash_attention(q, q, q)
    ops.sliced_matmul(torch.zeros(128, 128), torch.zeros(128, 128))
    x = torch.zeros(1, 32, 2, 32)
    ops.rwkv6_scan(x, x, x, x, torch.zeros(2, 32))
    ops.rg_lru(torch.zeros(1, 16, 64), torch.zeros(1, 16, 64))
    ops.decode_attention(torch.zeros(1, 2, 32), torch.zeros(1, 8, 1, 32),
                         torch.zeros(1, 8, 1, 32), hi=5)
    ops.mla_decode_attention(torch.zeros(1, 2, 32), torch.zeros(1, 2, 16),
                             torch.zeros(1, 8, 32), torch.zeros(1, 8, 16),
                             hi=5, scale=0.1)
    w = torch.zeros(2, 8, 16)
    ops.grouped_experts(torch.zeros(3, 8), torch.tensor([1, 2]),
                        torch.zeros(3), torch.arange(3), w, w,
                        w.transpose(1, 2).contiguous())
    assert ops.LAUNCHES == {"sliced_matmul": 0, "coschedule": 0,
                            "flash_attention": 0, "rwkv6_scan": 0,
                            "rg_lru": 0, "decode_attention": 0,
                            "mla_decode": 0, "grouped_experts": 0}
