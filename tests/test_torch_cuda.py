"""The port's Hopper kernels and its CUDA serving path on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports neither JAX nor the reference package, so it also runs on
a machine with the card and no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import coschedule as CS
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grouped_experts as GE
from repro_torch.kernels import mla_decode as MLA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as LRU
from repro_torch.kernels import sliced_matmul as SM
from repro_torch.launch import serve as TS
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

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
    """192 tiles: slice size 132 leaves a ragged last launch of 60."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(2048, 512, generator=gen, device=cuda).bfloat16()
    b = torch.randn(512, 1536, generator=gen, device=cuda).bfloat16()
    whole = torch.empty(2048, 1536, dtype=a.dtype, device=cuda)
    SM.matmul_slice(a, b, whole, offset=0, slice_size=16 * 12)
    for ss in (1, 3, 4, 132):
        assert torch.equal(ops.sliced_matmul(a, b, slice_size=ss), whole)


@pytest.mark.parametrize("slice_size", [4, 132])
def test_sliced_matmul_bf16_matches_plain(cuda, slice_size):
    """The tensor-core path at 2560 x 1536 (K 1024): 240 tiles, which 132
    does not divide."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(2560, 1024, generator=gen, device=cuda).bfloat16()
    b = torch.randn(1024, 1536, generator=gen, device=cuda).bfloat16()
    torch.testing.assert_close(ops.sliced_matmul(a, b, slice_size=slice_size),
                               ref.matmul(a, b), **TOL[torch.bfloat16])


def test_sliced_matmul_bf16_takes_whole_stages_of_k(cuda):
    """bf16 stages K 64 at a time: K = 96 is refused, not cut."""
    a = torch.zeros(128, 96, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(96, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stages K"):
        ops.sliced_matmul(a, b, bk=32)


@pytest.mark.parametrize("s", [1, 100, 200, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_attention_bf16_matches_plain(cuda, d, causal, s):
    """The tensor-core path for every head dim, causal and full; S = 1, 100
    and 200 leave ragged q and key tiles."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape = (1, 2, s, d) if s == 2048 else (2, 3, s, d)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=causal, bq=s, bk=s),
        ref.flash_attention(q, k, v, causal=causal), **TOL[torch.bfloat16])


def test_stablelm_head_dims_run_their_own_instances(cuda):
    """The profiler names the D = 80 and D = 160 instances of both paths,
    and MLA's D = 48 and 192."""
    from torch.profiler import ProfilerActivity, profile
    dims = (80, 160, 48, 192)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for d in dims:
            q = torch.randn(1, 2, 256, d, device=cuda)
            ops.flash_attention(q, q, q)
            ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    for d in dims:
        assert f"flash_fwd_wgmma_kernel<{d}>" in names, names
        assert f"flash_fwd_kernel<float, {d}>" in names, names


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "deepseek-v2-lite"])
def test_reduced_deepseek_forward_matches_the_cpu(cuda, arch):
    """Reduced DeepSeek (MLA at q.k dim 48, MoE with capacity drops, or
    V2-Lite's direct query, YaRN and dropless routing) in f32
    on the card against the same weights' forward on the CPU (every op's
    plain version there): K3 once a layer, logits and aux within 1e-3
    (f32 on both; sums in another order)."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    want, _, want_aux = T.forward(params, cfg, {"tokens": tokens})
    on_card = T._tree_map(lambda a: a.to(cuda), params)
    ops.reset_launches()
    got, _, aux = T.forward(on_card, cfg, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    assert abs(float(aux) - float(want_aux)) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_whisper_encoder_width(cuda, causal):
    """Whisper's encoder shape, (2, 12, 1500, 64) bf16, both masks: 1500 =
    11 x 128 + 92 query rows and 28 keys in the last 64-key tile, whose
    rows past S TMA fills with zeros; a zero key scores 0, not -inf, so the
    full path's edge mask must hold. Blocks of 125, as ``_flash`` picks."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, 12, 1500, 64, generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=causal, bq=125, bk=125),
        ref.flash_attention(q, k, v, causal=causal), **TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small"])
def test_reduced_multimodal_prefill_and_decode_match_the_cpu(cuda, arch):
    """Reduced Qwen2-VL (M-RoPE, 32 patch rows) and Whisper (encoder over
    16 frames, cross-attention) in f32 on the card against the same
    weights' forward on the CPU (1e-3: f32 on both, sums in another order):
    K3 once a decoder layer and once an encoder layer, in the forward and
    in the prefill into the caches, and never in the decode steps, whose
    logits match the CPU's teacher-forced forward; D1 once a decoder layer
    a decode step (twice for Whisper's: its self and cross caches)."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    raw = make_batch(cfg, 2, 64)
    batch = {k: torch.from_numpy(v) for k, v in raw.items() if k != "labels"}
    want, _, _ = T.forward(params, cfg, batch)
    on_card = T._tree_map(lambda a: a.to(cuda), params)
    card = {k: v.to(cuda) for k, v in batch.items()}
    n_k3 = cfg.num_layers + cfg.encoder_layers
    ops.reset_launches()
    got, _, _ = T.forward(on_card, cfg, card)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n_k3
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    caches = T.init_decode_caches(cfg, 2, 64, dtype=torch.float32,
                                  device=cuda)
    ops.reset_launches()
    lp, caches = T.prefill(on_card, cfg,
                           dict(card, tokens=card["tokens"][:, :32]), caches)
    for pos in range(32, 36):
        lg, caches = T.decode_step(on_card, cfg, caches,
                                   card["tokens"][:, pos], pos)
        torch.testing.assert_close(lg.cpu(), want[:, pos], atol=1e-3,
                                   rtol=1e-3)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n_k3
    assert ops.LAUNCHES["decode_attention"] == 4 * cfg.num_layers * (
        2 if cfg.is_encoder_decoder else 1)
    torch.testing.assert_close(lp.cpu(), want[:, :32], atol=1e-3, rtol=1e-3)


def test_stablelm_3b_prefill_at_full_width(cuda):
    """One prefill step of full-width stablelm-3b (32 layers of D = 80),
    bf16, seeded random weights, at (1, 512): K3 runs once a layer and the
    logits are finite."""
    cfg = get_config("stablelm-3b")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device=cuda)
    ops.reset_launches()
    logits, _, _ = T.forward(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    assert tuple(logits.shape) == (1, 512, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_port_daemon_names_the_h100(cuda):
    """The port's daemon resolves its own chip by name."""
    from repro_torch.core.profiles import H100
    from repro_torch.runtime.daemon import resolve_gpu
    assert resolve_gpu("H100") is H100


def test_bf16_runs_on_the_tensor_cores(cuda):
    """A bf16 call of K1, K2 and K3 runs the wgmma kernels and not the FMA
    ones, which only f32 reaches."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(256, 256, device=cuda).bfloat16()
    x = torch.randn(512, 256, device=cuda).bfloat16()
    q = torch.randn(1, 2, 256, 96, device=cuda).bfloat16()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.sliced_matmul(a, a)
        ops.coschedule(a, a, x)
        ops.flash_attention(q, q, q)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert "sliced_matmul_wgmma_kernel" in names, names
    assert "coschedule_wgmma_kernel" in names, names
    assert "flash_fwd_wgmma_kernel" in names, names
    assert "sliced_matmul_kernel" not in names, names
    assert "coschedule_kernel" not in names, names
    assert "flash_fwd_kernel" not in names, names
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.sliced_matmul(a.float(), a.float())
        ops.coschedule(a.float(), a.float(), x.float())
        ops.flash_attention(q.float(), q.float(), q.float())
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert "sliced_matmul_kernel" in names and "flash_fwd_kernel" in names
    assert "coschedule_kernel" in names, names
    assert "wgmma" not in names, names


def test_coschedule_bf16_takes_whole_stages_of_k(cuda):
    """bf16 K2 stages K 64 at a time on the wgmma tile: K = 96 is refused,
    not cut."""
    a = torch.zeros(128, 96, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(96, 128, device=cuda, dtype=torch.bfloat16)
    x = torch.zeros(256, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stages K"):
        ops.coschedule(a, b, x)


def test_coschedule_holds_two_ctas_an_sm(cuda):
    """Two bf16 K2 CTAs fit on one SM, so a stream CTA can sit beside a
    matmul CTA."""
    assert CS.occupancy() >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coschedule_trace_records_every_step(cuda, dtype):
    """One traced launch of either kernel: every step writes its SM, a start
    no later than its end, and its op; the results equal an untraced
    launch's."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn(384, 128, generator=gen, device=cuda).to(dtype)
    b = torch.randn(128, 256, generator=gen, device=cuda).to(dtype)
    x = torch.randn(1024, 256, generator=gen, device=cuda).to(dtype)
    schedule = CS.make_schedule(6, 4, 2, 1)
    sched = CS.schedule_tensor(schedule, cuda)
    trace = torch.zeros(len(schedule[0]), 4, dtype=torch.int64, device=cuda)
    got = CS.launch(a, b, x, sched, scale=2.0, bx=256, trace=trace)
    want = CS.launch(a, b, x, sched, scale=2.0, bx=256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rec = trace.cpu()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bool(((rec[:, 0] >= 0) & (rec[:, 0] < sms)).all())
    assert bool((rec[:, 1] <= rec[:, 2]).all()) and bool((rec[:, 1] > 0).all())
    assert rec[:, 3].tolist() == schedule[0].tolist()


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
    decode_runs = 1 + sum(n1 if k1 == "b-decode" else
                          (n2 if k2 == "b-decode" else 0)
                          for k1, k2, n1, n2, _ in res["rounds"])
    # graphs whose replays count
    assert srv.captures == {"a-prefill": None, "b-decode": None}
    assert ops.LAUNCHES["decode_attention"] == decode_runs * reduced(
        get_config("starcoder2-15b")).num_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,n,chunk", [(2, 64, 2, 32, 16),
                                           (1, 128, 4, 64, 32),
                                           (2, 80, 2, 64, 16)])
def test_rwkv6_scan_matches_plain(cuda, b, s, h, n, chunk, dtype):
    """K4 from zero and from a given state, against the sequential oracle
    and the plain chunked version, with tests/test_kernels.py:75-76's
    tolerances (f32 1e-3, bf16 5e-2). S = 80 leaves a ragged last chunk of
    the kernel's own 32."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    r, k, v = (randn(b, s, h, n).to(dtype) for _ in range(3))
    w_log = -torch.exp(randn(b, s, h, n) - 1.0)
    u = randn(h, n) * 0.1
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=1e-3, rtol=1e-3)
    want, _ = ref.rwkv6(r, k, v, w_log, u)
    torch.testing.assert_close(ops.rwkv6_scan(r, k, v, w_log, u, chunk=chunk),
                               want, **tol)
    s0 = randn(b, h, n, n)
    want, want_s = ref.rwkv6(r, k, v, w_log, u, s0)
    plain, plain_s = R.rwkv6_chunked(r, k, v, w_log, u, s0, chunk=chunk)
    state = s0.clone()
    got = ops.rwkv6_scan(r, k, v, w_log, u, chunk=chunk, state=state)
    for a, b_ in ((got, want), (state, want_s), (got, plain),
                  (state, plain_s)):
        torch.testing.assert_close(a, b_, **tol)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("s", [37, 64])
def test_rwkv6_scan_extreme_decay_matches_oracle(cuda, n, s):
    """A log decay of -4 a step (tests/test_torch_recurrent.py's seed-24
    case), from zero and from a given state, against the sequential oracle
    (f32, 1e-3): above the diagonal the exponent would reach 4 * 31, so the
    kernels form none there. S = 37 leaves a ragged last chunk."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    r, k, v = (torch.randn(1, s, 2, n, generator=gen, device=cuda)
               for _ in range(3))
    w_log = torch.full_like(r, -4.0)
    u = torch.randn(2, n, generator=gen, device=cuda) * 0.1
    s0 = torch.randn(1, 2, n, n, generator=gen, device=cuda)
    tol = dict(atol=1e-3, rtol=1e-3)
    got = ops.rwkv6_scan(r, k, v, w_log, u, chunk=s)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.rwkv6(r, k, v, w_log, u)[0], **tol)
    state = s0.clone()
    got = ops.rwkv6_scan(r, k, v, w_log, u, chunk=s, state=state)
    want, want_s = ref.rwkv6(r, k, v, w_log, u, s0)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(state, want_s, **tol)


def test_rwkv6_scan_checks_each_dtype(cuda):
    """K4 takes what the reference's kernel takes: bf16 or f32 w_log and u,
    r/k/v of one dtype or of two, each against the sequential oracle on the
    same values (f32 1e-3, bf16 5e-2); an N above 64 raises, naming the Ns
    the card covers."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    r, k, v = (randn(1, 64, 2, 32) for _ in range(3))
    w_log = -torch.exp(randn(1, 64, 2, 32) - 1.0)
    u = randn(2, 32) * 0.1
    b16 = torch.bfloat16
    for args, tol in (((r.to(b16), k.to(b16), v.to(b16), w_log, u), 5e-2),
                      ((r, k, v, w_log.to(b16), u.to(b16)), 1e-3),
                      ((r.to(b16), k, v.to(b16), w_log.to(b16), u), 5e-2)):
        want, _ = ref.rwkv6(*args)
        torch.testing.assert_close(ops.rwkv6_scan(*args), want, atol=tol,
                                   rtol=tol)
    x = torch.zeros(1, 32, 2, 80, device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        ops.rwkv6_scan(x, x, x, x, torch.zeros(2, 80, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 48])
def test_rwkv6_scan_pads_a_smaller_n(cuda, n, dtype):
    """N = 16 and 48 run on the 32 and 64 instances, padded with channels
    that leave the real ones untouched: out and a given state (bf16 here,
    overwritten in place) against the sequential oracle, from bf16 w_log
    and u. S = 80 leaves a ragged last chunk."""
    gen = torch.Generator(device=cuda).manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    r, k, v = (randn(2, 80, 3, n).to(dtype) for _ in range(3))
    w_log = (-torch.exp(randn(2, 80, 3, n) - 1.0)).bfloat16()
    u = (randn(3, n) * 0.1).bfloat16()
    s0 = randn(2, 3, n, n).bfloat16()
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=1e-3, rtol=1e-3)
    want, want_s = ref.rwkv6(r, k, v, w_log, u, s0)
    state = s0.clone()
    got = ops.rwkv6_scan(r, k, v, w_log, u, chunk=16, state=state)
    assert got.shape == (2, 80, 3, n) and got.is_contiguous()
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(state.float(), want_s, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("b,s,w", [(2, 256, 512), (1, 128, 1024),
                                   (3, 37, 100), (2, 300, 42),
                                   (1, 4100, 64)])
def test_rg_lru_matches_plain(cuda, b, s, w):
    """K5 from zero and from h0 against the oracle and the plain scan,
    1e-4 (tests/test_kernels.py:88-89). (3, 37, 100) and (2, 300, 42) are
    ragged in the kernel's 32-channel blocks and lie inside one window of
    2048 steps, most of its CTAs past S; W * 4 % 16 != 0 in both, so the
    threads load the tiles where TMA cannot; (1, 4100, 64) walks three
    windows, the last ragged."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(b, s, w, generator=gen, device=cuda)
    a_log = -torch.exp(torch.randn(b, s, w, generator=gen, device=cuda))
    h0 = torch.randn(b, w, generator=gen, device=cuda)
    tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ops.rg_lru(x, a_log, chunk=s, bw=w),
                               ref.rg_lru(x, a_log), **tol)
    got = ops.rg_lru(x, a_log, chunk=s, bw=w, h0=h0)
    torch.testing.assert_close(got, ref.rg_lru(x, a_log, h0), **tol)
    torch.testing.assert_close(got, R.rglru_scan(x, a_log, h0)[0], **tol)


@pytest.mark.parametrize("b,s,w", [(2, 300, 42), (1, 4100, 64)])
def test_rg_lru_takes_bf16(cuda, b, s, w):
    """bf16 x and a_log, widened in the kernel, give f32 h within 1e-4 of
    the oracle on the same values in f32, from zero and from h0; W = 42
    takes the threads' loads (W * 2 % 16 != 0), W = 64 the TMA path."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(b, s, w, generator=gen, device=cuda).bfloat16()
    a_log = (-torch.exp(torch.randn(b, s, w, generator=gen, device=cuda))
             ).bfloat16()
    h0 = torch.randn(b, w, generator=gen, device=cuda)
    tol = dict(atol=1e-4, rtol=1e-4)
    for init in (None, h0):
        got = ops.rg_lru(x, a_log, chunk=s, bw=w, h0=init)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref.rg_lru(x.float(), a_log.float(),
                                                   init), **tol)


def test_rg_lru_chains_through_h0(cuda):
    """Two calls chained through h0, split at the kernel's window, equal
    one call over both bit for bit: the window carry is the last row of h
    as written."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 4100, 96, generator=gen, device=cuda)
    a_log = -torch.exp(torch.randn(2, 4100, 96, generator=gen, device=cuda))
    h0 = torch.randn(2, 96, generator=gen, device=cuda)
    cut = LRU.RANKS * LRU.STEPS
    whole = ops.rg_lru(x, a_log, chunk=4100, bw=96, h0=h0)
    first = ops.rg_lru(x[:, :cut].contiguous(), a_log[:, :cut].contiguous(),
                       chunk=cut, bw=96, h0=h0)
    second = ops.rg_lru(x[:, cut:].contiguous(), a_log[:, cut:].contiguous(),
                        chunk=4100 - cut, bw=96, h0=first[:, -1].contiguous())
    assert torch.equal(torch.cat([first, second], 1), whole)


def test_recurrentgemma_prefill_runs_the_cluster_kernel(cuda):
    """A RecurrentGemma prefill runs K5's cluster kernel, not the
    per-segment ``rg_lru_kernel`` it replaced."""
    from torch.profiler import ProfilerActivity, profile
    cfg = reduced(get_config("recurrentgemma-9b"))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), device=cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        T.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert "rg_lru_cluster_kernel" in names, names
    assert "rg_lru_kernel" not in names, names


def test_rg_lru_fills_the_card_with_clusters(cuda):
    """The runtime places at least one cluster of the f32 and the bf16
    kernel, and two or more CTAs an SM."""
    for dtype in (torch.float32, torch.bfloat16):
        clusters, per_sm = LRU.occupancy(dtype)
        assert clusters >= 1 and per_sm >= 2, (dtype, clusters, per_sm)


def test_recurrent_server_drains_through_k4_and_k5(cuda):
    srv = TS.SharedPodServer()
    ops.reset_launches()
    jobs = [TS.Job("c-prefill", "rwkv6-1.6b", "prefill", 4, 1, 32),
            TS.Job("e-prefill", "recurrentgemma-9b", "prefill", 4, 1, 32),
            TS.Job("f-decode", "recurrentgemma-9b", "decode", 6, 2, 32)]
    for job in jobs:
        srv.submit(job)
    res = srv.drain()
    assert all(j.num_slices == 0 for j in srv.jobs.values())
    runs = {job.name: 1 + sum(n1 * (k1 == job.name) + n2 * (k2 == job.name)
                              for k1, k2, n1, n2, _ in res["rounds"])
            for job in jobs}
    kinds = {arch: reduced(get_config(arch)).layer_kinds()
             for arch in ("rwkv6-1.6b", "recurrentgemma-9b")}
    assert ops.LAUNCHES["rwkv6_scan"] == \
        kinds["rwkv6-1.6b"].count("rwkv6") * runs["c-prefill"]
    assert ops.LAUNCHES["rg_lru"] == \
        kinds["recurrentgemma-9b"].count("rglru") * runs["e-prefill"]
    # graphs whose replays count
    assert srv.captures == {"c-prefill": None, "e-prefill": None,
                            "f-decode": None}
    assert ops.LAUNCHES["decode_attention"] == \
        kinds["recurrentgemma-9b"].count("local") * runs["f-decode"]


def _k3_case(gen, cuda, dtype):
    q = torch.randn(2, 200, 4, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 200, 2, 64, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    from repro_torch.models import attention as A
    return ("flash_attention", (q, k, v),
            lambda q, k, v: (A.FlashAttention.apply(q, k, v, True),),
            lambda q, k, v: (A._flash_fwd(q, k, v, causal=True),),
            lambda q, k, v: (A.plain_attention(q, k, v, causal=True),))


def _k4_case(gen, cuda, dtype):
    r, k, v = (torch.randn(1, 96, 2, 64, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    w = -torch.exp(torch.randn(1, 96, 2, 64, generator=gen, device=cuda) - 1)
    u = torch.randn(2, 64, generator=gen, device=cuda) * 0.1
    s0 = torch.randn(1, 2, 64, 64, generator=gen, device=cuda) * 0.1

    def kernel(r, k, v, w, u, s0):
        final = s0.clone()
        return ops.rwkv6_scan(r, k, v, w, u, state=final), final
    return ("rwkv6_scan", (r, k, v, w, u, s0),
            lambda *xs: R.WKV6.apply(*xs, 32), kernel,
            lambda *xs: R.rwkv6_chunked(*xs, chunk=32))


def _k5_case(gen, cuda, dtype):
    x = torch.randn(2, 300, 64, generator=gen, device=cuda).to(dtype)
    a = -torch.exp(torch.randn(2, 300, 64, generator=gen, device=cuda) - 3)
    h0 = torch.randn(2, 64, generator=gen, device=cuda)
    return ("rg_lru", (x, a.to(dtype), h0),
            lambda *xs: (R.RGLRU.apply(*xs),),
            lambda x, a, h0: (ops.rg_lru(x, a, chunk=300, bw=64, h0=h0),),
            lambda x, a, h0: (R.rglru_scan(x.float(), a.float(), h0)[0],))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [_k3_case, _k4_case, _k5_case])
def test_autograd_functions_on_the_card(cuda, case, dtype):
    """K3's, K4's and K5's autograd Functions: the forward is the kernel's
    output bit for bit in one launch, the backward launches none of the
    port's kernels, and each input's gradient equals autograd through the
    plain form on the same inputs (f32 1e-4, bf16 2e-2 of max(1, the
    gradient's largest entry))."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    name, args, fn, kernel, plain = case(gen, cuda, dtype)
    leaves = [t.detach().requires_grad_() for t in args]
    cot = [torch.randn(o.shape, generator=gen, device=cuda).to(o.dtype)
           for o in kernel(*args)]
    ops.reset_launches()
    outs = fn(*leaves)
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
    grads = torch.autograd.grad(outs, leaves, cot)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
    with torch.no_grad():
        for o, w in zip(outs, kernel(*args)):
            assert torch.equal(o.detach(), w)
    ref_leaves = [t.detach().requires_grad_() for t in args]
    want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, cot)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * max(1.0, float(w.float().abs().max())), err


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """A reduced stablelm-3b train step in f32 on the card against the
    same step on the CPU: the loss and every leaf's gradient within 1e-3
    relative (of the leaf's largest entry), K3 once a layer, and the
    step's loss and grad norm within 1e-3."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = reduced(get_config("stablelm-3b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    raw = make_batch(cfg, 2, 64)
    results = {}
    for dev in ("cpu", cuda):
        p = T._tree_map(lambda a: a.to(dev).requires_grad_(), params)
        leaves = []
        T._tree_map(leaves.append, p)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        ops.reset_launches()
        loss, _ = T.train_loss(p, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        if dev == cuda:
            torch.cuda.synchronize()
            assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
        p = T._tree_map(lambda a: a.detach().clone(), p)
        opt = adamw.OptConfig()
        _, _, m = make_train_step(cfg, opt)(p, adamw.init(opt, p), batch)
        results[str(dev)] = (float(loss), [g.cpu() for g in grads],
                             float(m["loss"]), float(m["grad_norm"]))
    want, got = results["cpu"], results[str(cuda)]
    assert abs(got[0] - want[0]) <= 1e-3 * abs(want[0])
    for g, w in zip(got[1], want[1]):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())
    for i in (2, 3):
        assert abs(got[i] - want[i]) <= 1e-3 * abs(want[i])


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A (params, opt_state) checkpoint saved from the card restores onto
    the CPU, and the CPU's back onto the card, every leaf equal and in the
    template's dtype and device (bf16 params, int32 step)."""
    from repro_torch.checkpoint import store
    from repro_torch.optim import adamw
    cfg = reduced(get_config("phi3-mini-3.8b"))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    opt = adamw.OptConfig()
    state = (params, adamw.init(opt, params))
    store.save(str(tmp_path / "card"), 2, state)
    on_cpu = T._tree_map(lambda a: torch.zeros_like(a, device="cpu"),
                         {"p": state[0], "s": state[1]})
    (p_cpu, s_cpu), step = store.restore(str(tmp_path / "card"),
                                         (on_cpu["p"], on_cpu["s"]))
    assert step == 2 and s_cpu["step"].dtype == torch.int32
    assert p_cpu["embed"].device.type == "cpu"
    assert p_cpu["embed"].dtype == torch.bfloat16
    assert torch.equal(p_cpu["embed"], params["embed"].cpu())
    store.save(str(tmp_path / "cpu"), 3, (p_cpu, s_cpu))
    (p_back, _), _ = store.restore(str(tmp_path / "cpu"), state)
    flat_a, flat_b = [], []
    T._tree_map(flat_a.append, params)
    T._tree_map(flat_b.append, p_back)
    for a, b in zip(flat_a, flat_b):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_ep_at_world_size_one_on_nccl_equals_moe_ffn(cuda):
    """EP over a one-rank NCCL group (``make_host_mesh(1)``) on reduced
    deepseek-v2 in f32, at a capacity factor that drops no pair: it is
    ``moe_ffn``. The group is destroyed after."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    cfg = reduced(get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda, dtype=torch.float32)
    p = params["stage1"]["sub0"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in p.items()}
    x = torch.randn(2, 32, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    own = not dist.is_initialized()
    mesh = make_host_mesh(1)
    try:
        assert dist.get_backend() == "nccl" and mesh.shape == (1, 1)
        with torch.inference_mode():
            want, want_aux = M.moe_ffn(x, p, cfg)
            for route in ("ep", "ep_sharded"):
                if route == "ep":
                    out, aux = M.moe_ffn_ep(x, p, cfg,
                                            group=mesh.get_group("model"))
                else:
                    out, aux = M.moe_ffn_ep_sharded(x, p, cfg, mesh)
                torch.testing.assert_close(out, want, **TOL[torch.float32])
                torch.testing.assert_close(aux, want_aux,
                                           **TOL[torch.float32])
    finally:
        if own:
            dist.destroy_process_group()


def test_moe_combine_repeats_bit_for_bit(cuda):
    """ROADMAP fault 13: the combine sums each token's k rows in a fixed
    order, with no atomics, so ``moe_ffn`` on bf16 (ungrouped and in
    groups) and reduced deepseek-v2's forward repeat bit for bit."""
    from repro_torch.models import moe as M
    cfg = reduced(get_config("deepseek-v2-236b"))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    p = params["stage1"]["sub0"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in p.items()}
    x = torch.randn(4, 256, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    tokens = torch.from_numpy(make_batch(cfg, 2, 64)["tokens"]).to(cuda)
    with torch.inference_mode():
        for group in (0, 256):
            a = M.moe_ffn(x, p, cfg, group_size=group)[0]
            assert torch.equal(a, M.moe_ffn(x, p, cfg, group_size=group)[0])
        a = T.forward(params, cfg, {"tokens": tokens})[0]
        assert torch.equal(a, T.forward(params, cfg, {"tokens": tokens})[0])


def test_ep_backward_at_world_size_one_on_nccl_equals_moe_ffn(cuda):
    """EP under autograd over a one-rank NCCL group, reduced deepseek-v2
    in f32 with no pair dropped: x's and every weight's gradient is
    autograd's through ``moe_ffn`` (1e-5 of each leaf's largest value),
    and the int8 exchange under autograd raises (ROADMAP fault 14)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    cfg = reduced(get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda, dtype=torch.float32)
    p = params["stage1"]["sub0"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in p.items()}
    x = torch.randn(2, 32, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    own = not dist.is_initialized()
    mesh = make_host_mesh(1)
    try:
        group = mesh.get_group("model")
        grads = []
        for fn in (lambda xx, pp: M.moe_ffn(xx, pp, cfg),
                   lambda xx, pp: M.moe_ffn_ep(xx, pp, cfg, group=group)):
            xx = x.clone().requires_grad_()
            pp = T._tree_map(lambda w: w.clone().requires_grad_(), p)
            out, aux = fn(xx, pp)
            leaves = [xx] + list(M._leaves(pp))
            grads.append(torch.autograd.grad(out.square().sum() + 3 * aux,
                                             leaves))
        for got, want in zip(grads[1], grads[0]):
            torch.testing.assert_close(
                got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
        int8 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, a2a_dtype="int8"))
        with pytest.raises(NotImplementedError, match="fault 14"):
            M.moe_ffn_ep(x.requires_grad_(), p, int8, group=group)
    finally:
        if own:
            dist.destroy_process_group()


def test_deepseek_gradients_repeat_bit_for_bit(cuda):
    """Ranks that train together stay in step only if each computes the
    same gradients, since no step reduces them: reduced deepseek-v2's
    ``train_loss`` gradients in bf16 (MLA, K3, the MoE's gathers of each
    token k times) repeat bit for bit on the card, and so do x's and the
    weights' through ``moe_ffn_ep`` over a one-rank NCCL group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    cfg = reduced(get_config("deepseek-v2-236b"))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, 2, 64).items()}

    def grads(loss_fn, tree, *extra):
        live = T._tree_map(lambda w: w.detach().requires_grad_(), tree)
        leaves = [e.detach().requires_grad_() for e in extra]
        T._tree_map(leaves.append, live)
        return torch.autograd.grad(loss_fn(live, *leaves[:len(extra)]),
                                   leaves, allow_unused=True,
                                   materialize_grads=True)

    def model_loss(p):
        return T.train_loss(p, cfg, batch)[0]
    first, again = grads(model_loss, params), grads(model_loss, params)
    assert len(first) == len(again) > 20
    for a, b in zip(first, again):
        assert torch.equal(a, b)

    p = params["stage1"]["sub0"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in p.items()}
    x = torch.randn(2, 64, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    own = not dist.is_initialized()
    mesh = make_host_mesh(1)
    try:
        group = mesh.get_group("model")

        def ep_loss(pp, xx):
            out, aux = M.moe_ffn_ep(xx, pp, cfg, group=group)
            return out.float().square().sum() + 3 * aux
        first, again = grads(ep_loss, p, x), grads(ep_loss, p, x)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-236b"])
def test_train_step_on_a_one_rank_mesh_equals_no_mesh(cuda, arch):
    """``make_train_step`` under the (1, 1) mesh of a one-rank NCCL group
    (``make_host_mesh(1)``) against the step with no mesh, three steps of
    the reduced arch in bf16 from the same init: at world size 1 the dp
    block is the whole batch and nothing is exchanged, so the losses,
    params and moments are equal bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw
    cfg = reduced(get_config(arch))
    opt = adamw.OptConfig(warmup_steps=1)
    batches = [{k: torch.from_numpy(v).to(cuda)
                for k, v in make_batch(cfg, 4, 64, step=i).items()}
               for i in range(3)]
    own = not dist.is_initialized()
    mesh = make_host_mesh(1)
    try:
        assert dist.get_backend() == "nccl" and mesh.shape == (1, 1)
        runs = []
        for on in (None, mesh):
            params = T.init_params(cfg, torch.Generator(
                device=cuda).manual_seed(0), device=cuda)
            state = adamw.init(opt, params)
            step = make_train_step(cfg, opt)
            losses = []
            with SH.use_mesh(on):
                for batch in batches:
                    params, state, m = step(params, state, batch)
                    losses.append(m["loss"])
            leaves = []
            T._tree_map(leaves.append, {"p": params, "mu": state["mu"],
                                        "nu": state["nu"]})
            runs.append((torch.stack(losses), leaves))
    finally:
        if own:
            dist.destroy_process_group()
    (want_loss, want), (got_loss, got) = runs
    assert torch.equal(got_loss, want_loss)
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _decode_cases(s):
    """(lo, hi, offset, ring pos after positions hi - s .. hi - 1, n_splits)
    over an s-row cache: the whole prefix, a window, ragged splits, 8
    splits of 5 rows, a row block with no valid row, and a wrapped ring
    whose window leaves slots out."""
    return ((None, 200, 0, False, None), (150, 200, 0, False, None),
            (None, s, 0, False, 7), (0, 5, 0, False, 8),
            (None, 200, 250, False, None), (s + 100 - 250 + 1, s + 100, 0,
                                            True, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 48, 64, 80, 96, 128, 160, 192, 256])
@pytest.mark.parametrize("g", [1, 4, 7, 12, 16])
def test_decode_attention_matches_plain(cuda, dtype, d, g):
    """D1 against ``ref.decode_attention`` at the same split count, at each
    head dim and query-head group the models give it: o / l and m within
    5e-4 absolute for an f32 cache (ROADMAP item 19), bf16's tolerance for
    a bf16 one, l within 5e-4 relative; no valid row gives exactly
    (NEG_INF, 0, 0)."""
    gen = torch.Generator(device=cuda).manual_seed(d + g)
    b, kv, s = 3, 2, 300
    q = torch.randn(b, kv * g, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tol = (dict(atol=5e-4, rtol=0.0) if dtype == torch.float32
           else TOL[torch.bfloat16])
    for lo, hi, offset, ring, splits in _decode_cases(s):
        pos = None
        if ring:
            p = torch.arange(hi - s, hi, device=cuda, dtype=torch.int32)
            pos = torch.empty(s, device=cuda, dtype=torch.int32)
            pos[p % s] = p
        r0, r1 = ref.decode_rows(max(lo or 0, 0), hi, offset, s, ring)
        ns = splits or DA.split_count(b * kv, r1 - r0, sms)
        kw = dict(lo=lo or 0, hi=hi, offset=offset, pos=pos, n_splits=ns)
        ops.reset_launches()
        got = ops.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == 1
        want = ref.decode_attention(q, k, v, **kw)
        if r1 == r0:
            for x, w in zip(got, want):
                assert torch.equal(x, w)
            assert bool((got[0] == ref.NEG_INF).all()) and not got[1].any()
            continue
        torch.testing.assert_close(got[2] / got[1][..., None],
                                   want[2] / want[1][..., None], **tol)
        torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=0.0)
        torch.testing.assert_close(got[1], want[1], atol=0.0, rtol=5e-4)


def test_decode_attention_reads_views_in_place(cuda):
    """A cache view of 4 of 8 kv heads (non-unit row and batch strides)
    is read where it lies, no copy of it allocated; a view whose rows
    start 8 bytes off 16 is refused, never copied."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randn(4, 512, 8, 96, generator=gen, device=cuda).bfloat16()
    bigv = torch.randn(4, 512, 8, 96, generator=gen, device=cuda).bfloat16()
    k, v = big[:, :, 2:6], bigv[:, :, 2:6]
    assert not k.is_contiguous()
    q = torch.randn(4, 8, 96, generator=gen, device=cuda).bfloat16()
    ops.decode_attention(q, k, v, hi=300)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ops.decode_attention(q, k, v, hi=300)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < k.numel() * 2
    want = ref.decode_attention(q, k.contiguous(), v.contiguous(), lo=0,
                                hi=300)
    torch.testing.assert_close(got[2] / got[1][..., None],
                               want[2] / want[1][..., None],
                               **TOL[torch.bfloat16])
    odd = torch.zeros(4, 512, 8, 104, device=cuda).bfloat16()[..., 4:100]
    with pytest.raises(ValueError, match="in place"):
        ops.decode_attention(q, odd[:, :, :4], odd[:, :, :4], hi=300)


def test_decode_step_allocates_no_f32_cache_copy(cuda):
    """A one-layer decode step of full-width phi3-mini over an 8 x 4096
    bf16 cache at t = 2049: D1 once, no other kernel of the port, and the
    step's peak memory above what it held before less than one bf16 cache
    tensor of the layer (the eager einsums allocated an f32 copy of k and
    of v, four such tensors)."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), num_layers=1)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    caches = T.init_decode_caches(cfg, 8, 4096, device=cuda)
    tok = torch.zeros(8, dtype=torch.long, device=cuda)
    T.decode_step(params, cfg, caches, tok, 2048)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logits, _ = T.decode_step(params, cfg, caches, tok, 2049)
    torch.cuda.synchronize()
    layer = 8 * 4096 * cfg.num_kv_heads * cfg.head_dim * 2
    assert torch.cuda.max_memory_allocated() - base < layer
    assert ops.LAUNCHES["decode_attention"] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(logits.float()).all())


# D2's cases: ((B, H, S, R, DR), hi, offset): dsv2lite-mixed's decode (8193
# of a 16,384-row latent cache), the reduced widths (DR 8: the krope box
# mostly zeros), 128 heads (DeepSeek-V2-236B, V3: 8 head tiles), a row
# block at an offset, and a block holding no valid row
MLA_CASES = {"dsv2lite": ((48, 16, 16384, 512, 64), 8193, 0),
             "reduced": ((2, 4, 64, 32, 16), 40, 0),
             "reduced_dr8": ((2, 4, 64, 32, 8), 40, 0),
             "h128": ((2, 128, 1024, 512, 64), 700, 0),
             "offset": ((4, 16, 2048, 512, 64), 3000, 1536),
             "empty": ((2, 16, 256, 512, 64), 100, 256)}


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_decode_matches_plain(cuda, case):
    """D2 against ``mla_decode.plain`` (f32 over the same bf16 latents),
    the latents ~ N(0, 1.5^2) below hi and N(0, 64^2) after it, so a read
    past hi shows: o / l within bf16's tolerance, m within 5e-4, l within
    5e-4 relative, one launch; no valid row gives exactly (NEG_INF, 0,
    0)."""
    (b, h, s, r, dr), hi, offset = MLA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    r0, r1 = ref.decode_rows(0, hi, offset, s, False)

    def latents(width):
        x = torch.randn(b, s, width, generator=gen, device=cuda) * 1.5
        x[:, r1:] *= 64.0 / 1.5
        return x.bfloat16()

    q_lat = torch.randn(b, h, r, generator=gen, device=cuda).bfloat16()
    q_rope = torch.randn(b, h, dr, generator=gen, device=cuda).bfloat16()
    ckv, krope = latents(r), latents(dr)
    kw = dict(hi=hi, offset=offset, scale=0.11)
    ops.reset_launches()
    got = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mla_decode"] == 1
    want = MLA.plain(q_lat, q_rope, ckv, krope, lo=0, **kw)
    if r1 == r0:
        assert bool((got[0] == ref.NEG_INF).all())
        assert not got[1].any() and not got[2].any()
        return
    torch.testing.assert_close(got[2] / got[1][..., None],
                               want[2] / want[1][..., None],
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=0.0)
    torch.testing.assert_close(got[1], want[1], atol=0.0, rtol=5e-4)


def test_mla_decode_step_allocates_no_f32_latent_copy(cuda):
    """A one-layer decode step of full-width DeepSeek-V2-Lite over 8 x
    4096 bf16 latent caches at t = 2049: D2 once, D1 never, no f32 product
    on the CUDA cores (the eager einsums' ``*gemm_f32f32*``), and the
    step's peak memory above what it held before less than the layer's ckv
    cache (the einsums allocated an f32 copy of it, twice its size)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=1)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    caches = T.init_decode_caches(cfg, 8, 4096, device=cuda)
    tok = torch.zeros(8, dtype=torch.long, device=cuda)
    T.decode_step(params, cfg, caches, tok, 2048)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logits, _ = T.decode_step(params, cfg, caches, tok, 2049)
    torch.cuda.synchronize()
    layer = 8 * 4096 * cfg.mla.kv_lora_rank * 2
    assert torch.cuda.max_memory_allocated() - base < layer
    assert ops.LAUNCHES["mla_decode"] == 1
    assert ops.LAUNCHES["decode_attention"] == 0
    assert bool(torch.isfinite(logits.float()).all())
    for _ in range(5):      # the profiler has come back empty on the card
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            T.decode_step(params, cfg, caches, tok, 2049)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if any("mla_decode_kernel" in n for n in names):
            break
    assert any("mla_decode_kernel" in n for n in names), names
    assert not any("gemm_f32f32" in n for n in names), names


def _g1_case(cuda, skewed: bool, seed: int = 0):
    """G1's inputs at dsv2lite-mixed's prompt: 4096 tokens, top-6 of 64
    experts, D 2048, F 1408, bf16 experts of unit-variance products. Even:
    384 pairs an expert. Skewed: one expert 3506 pairs (of 4096 tokens, as
    the seeded router sends), three experts none, the rest uneven."""
    t, k, e, d, f = 4096, 6, 64, 2048, 1408
    n = t * k
    g = torch.Generator().manual_seed(seed)
    if skewed:
        share = torch.rand(e, generator=g) ** 4
        share[[5, 7, 20, 41]] = 0
        counts = (share / share.sum() * (n - 3506)).floor().long()
        counts[5] = 3506
        counts[0] += n - int(counts.sum())
    else:
        counts = torch.full((e,), n // e)
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda) * scale
                ).bfloat16()

    return dict(xs=randn(n, d), counts=counts.to(cuda),
                weights=torch.rand(n, generator=gen, device=cuda),
                sort_idx=torch.randperm(n, generator=gen, device=cuda),
                wi=randn(e, d, f, scale=d ** -0.5),
                wg=randn(e, d, f, scale=d ** -0.5),
                wo=randn(e, f, d, scale=f ** -0.5))


@pytest.mark.parametrize("skewed", [False, True], ids=["even", "skewed"])
def test_grouped_experts_matches_plain(cuda, skewed):
    """G1 against ``grouped_experts.plain`` (f32 products of the same bf16
    inputs, h and each row rounded once) at the cell's shape: within
    bf16's tolerance, since the f32 sums run in another order and may move
    a rounding by one ulp; two launches; a second call the same bits."""
    case = _g1_case(cuda, skewed)
    ops.reset_launches()
    got = ops.grouped_experts(**case)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["grouped_experts"] == 2
    want = GE.plain(**case)
    torch.testing.assert_close(got, want, **TOL[torch.bfloat16])
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert float(rel) < 2e-3, float(rel)
    assert torch.equal(got, ops.grouped_experts(**case))


def _dsv2lite(cuda, layers: int):
    """Full-width DeepSeek-V2-Lite cut to ``layers`` layers (the first
    dense), bf16 on the card."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"),
                              num_layers=layers)
    return cfg, T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                              device=cuda)


def test_a_served_prompts_moe_layer_reads_nothing_back(cuda, monkeypatch):
    """One full-width DeepSeek-V2-Lite MoE layer over a 4096-token prompt
    under inference mode runs with ``set_sync_debug_mode("error")`` (no
    read of the counts, no synchronising op), launches G1 twice, and
    agrees with the route that reads the counts back (bf16 both)."""
    from repro_torch.models import moe as M
    cfg, params = _dsv2lite(cuda, 2)
    p = T._tree_map(lambda a: a[0], params["stage1"]["sub0"]["moe"])
    x = torch.randn(1, 4096, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).bfloat16()
    with torch.inference_mode():
        M.moe_ffn(x, p, cfg)                  # builds G1
        torch.cuda.synchronize()
        ops.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = M.moe_ffn(x, p, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["grouped_experts"] == 2
        monkeypatch.setattr(M, "_grouped", lambda *args: False)
        want, _ = M.moe_ffn(x, p, cfg)
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert float(rel) < 1e-2, float(rel)


def test_g1_launches_twice_a_moe_layer_of_a_prompt_and_never_in_decode(cuda):
    """A prompt of 256 tokens through three full-width layers (one dense,
    two MoE): G1 twice a MoE layer; a decode step of 8 sequences keeps the
    static buckets: no G1."""
    cfg, params = _dsv2lite(cuda, 3)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda,
                           generator=gen)
    caches = T.init_decode_caches(cfg, 8, 64, device=cuda)
    with torch.inference_mode():
        ops.reset_launches()
        logits, _, _ = T.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        assert ops.LAUNCHES["grouped_experts"] == 2 * (
            cfg.num_layers - cfg.moe.first_dense_layers)
        ops.reset_launches()
        T.decode_step(params, cfg, caches, tokens[0, :8], 0)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["grouped_experts"] == 0
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("s,window", [(16384, 1024), (1000, 100), (1000, 64),
                                      (200, 1), (100, 300)],
                         ids=["mellum2", "ragged-s-and-w", "ragged-s",
                              "self-only", "past-the-prompt"])
def test_k3_window_matches_the_plain_window(cuda, s, window):
    """K3 with a causal window at Mellum2's window layer (1, 32, 16384,
    128), W 1024, with its 4 kv heads repeated as ``_flash_fwd`` calls
    it, against the plain windowed attention in float32
    (``chunked_attention``, the route it replaces), and at the edges: S
    not a whole number of 128-row tiles, W not a whole number of 64-key
    tiles, W 1, W past the prompt."""
    from repro_torch.models import attention as A
    gen = torch.Generator(device=cuda).manual_seed(s + window)
    h, kv = (32, 4) if s == 16384 else (4, 2)
    q = torch.randn(1, s, h, 128, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(1, s, kv, 128, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    got = A._flash_fwd(q, k, v, causal=True, window=window)
    blk = A._pick_block(s, s)
    want = A.chunked_attention(q.float(), k.float(), v.float(), causal=True,
                               window=window, q_block=blk, kv_block=blk)
    torch.testing.assert_close(got.float(), want, **TOL[torch.bfloat16])


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_k3_window_takes_every_head_dim(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(2, 3, 200, d, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, bq=200, bk=200, window=70),
        ref.flash_attention(q, k, v, window=70), **TOL[torch.bfloat16])


def test_k3_window_refuses_f32(cuda):
    """The f32 kernel takes no window: no model runs one in f32."""
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16 only"):
        ops.flash_attention(q, q, q, bq=64, bk=64, window=16)


@pytest.mark.parametrize("s", [100, 2048])
def test_a_window_past_the_prompt_is_the_causal_kernel(cuda, s):
    """W >= S masks nothing the causal mask keeps: the windowed kernel
    gives the causal kernel's bits, and runs under its own symbol."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(1, 4, s, 128, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    causal = ops.flash_attention(q, k, v, causal=True, bq=s, bk=s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        windowed = ops.flash_attention(q, k, v, bq=s, bk=s, window=s)
        torch.cuda.synchronize()
    assert torch.equal(windowed, causal)
    names = [e.key for e in prof.key_averages()]
    assert any("flash_fwd_window_kernel<128>" in n for n in names), names
    assert not any("flash_fwd_wgmma_kernel" in n for n in names), names


def test_mellum2_window_layers_run_k3s_window(cuda, monkeypatch):
    """Reduced Mellum2 (8 layers, two periods) in bf16 at a window of 64
    over a 256-token prompt: K3 once a layer, the 6 window layers under
    ``flash_fwd_window_kernel`` and the 2 full ones under
    ``flash_fwd_wgmma_kernel``, and each windowed call within bf16's
    tolerance of the plain windowed attention in float32 on the same q, k
    and v. (The logits are not compared with the plain route's: a
    rounding apart moves the renormalised top-k routing, which amplifies
    it.)"""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(reduced(get_config("mellum2-12b-a2.5b")),
                              local_window=64)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    calls, real = [], A._flash_fwd

    def spy(q, k, v, *, causal, window=0):
        out = real(q, k, v, causal=causal, window=window)
        if window:
            calls.append((q, k, v, window, out))
        return out
    monkeypatch.setattr(A, "_flash_fwd", spy)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        T.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    counts = {e.key: e.count for e in prof.key_averages()}
    d = cfg.head_dim
    window = sum(n for key, n in counts.items()
                 if f"flash_fwd_window_kernel<{d}>" in key)
    full = sum(n for key, n in counts.items()
               if f"flash_fwd_wgmma_kernel<{d}>" in key)
    assert (window, full) == (6, 2), counts
    assert len(calls) == 6
    for q, k, v, w, out in calls:
        want = A.chunked_attention(q.float(), k.float(), v.float(),
                                   causal=True, window=w, q_block=128,
                                   kv_block=128)
        torch.testing.assert_close(out.float(), want, **TOL[torch.bfloat16])
