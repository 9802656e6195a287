"""The port's Hopper kernels and its CUDA serving path on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports neither JAX nor the reference package, so it also runs on
a machine with the card and no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sliced_matmul as SM
from repro_torch.launch import serve as TS

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),     # tests/test_kernels.py
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    a, b, x = randn(384, 256), randn(256, 256), randn(512, 256)
    torch.testing.assert_close(ops.sliced_matmul(a, b, slice_size=3),
                               ref.matmul(a, b), **TOL[dtype])
    mm, st = ops.coschedule(a, b, x, run_a=2, run_b=1)
    torch.testing.assert_close(mm, ref.matmul(a, b), **TOL[dtype])
    torch.testing.assert_close(st, ref.streaming_scale(x, 2.0), **TOL[dtype])
    for d in FA.HEAD_DIMS:
        q, k, v = randn(2, 3, 200, d), randn(2, 3, 200, d), randn(2, 3, 200, d)
        for causal in (True, False):
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, causal=causal, bq=200, bk=200),
                ref.flash_attention(q, k, v, causal=causal), **TOL[dtype])


def test_sliced_matmul_is_bitwise_equal_across_slice_sizes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(1024, 512, generator=gen, device=cuda).bfloat16()
    b = torch.randn(512, 768, generator=gen, device=cuda).bfloat16()
    whole = torch.empty(1024, 768, dtype=a.dtype, device=cuda)
    SM.matmul_slice(a, b, whole, offset=0, slice_size=8 * 6)
    for ss in (1, 3, 4):
        assert torch.equal(ops.sliced_matmul(a, b, slice_size=ss), whole)


def test_server_drains_through_the_kernels(cuda):
    srv = TS.SharedPodServer()
    ops.reset_launches()
    srv.submit(TS.Job("a-prefill", "phi3-mini-3.8b", "prefill", 6, 1, 32))
    srv.submit(TS.Job("b-decode", "starcoder2-15b", "decode", 6, 1, 32))
    res = srv.drain()
    assert all(j.num_slices == 0 for j in srv.jobs.values())
    assert res["predicted_gain"] > 0.05
    prefill_runs = 1 + sum(n1 if k1 == "a-prefill" else
                           (n2 if k2 == "a-prefill" else 0)
                           for k1, k2, n1, n2, _ in res["rounds"])
    layers = reduced(get_config("phi3-mini-3.8b")).num_layers
    assert ops.LAUNCHES["flash_attention"] == layers * prefill_runs
