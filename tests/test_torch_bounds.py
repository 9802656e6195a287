"""The yardsticks ``chip_smoke.py`` holds the kernels' times against: the
card's least time for the work (``bound``), the least time of a matmul cut
into slices (``sliced_bound_ms``), K4's work and bound (``wkv6_work``,
``wkv6_bound_ms``, ``wkv6_pass_bytes``), K5's bytes (``lru_bytes``), and
what ``trace_report`` reads from K2's trace. Pure arithmetic from the H100's
data-sheet peaks, so it runs on the CPU; ``chip_smoke`` imports torch only
inside ``main``."""
import importlib.util
import math
import pathlib
import subprocess
import sys

import pytest

_PATH = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N = 8192
MM_FLOPS, MM_BYTES = 2.0 * N ** 3, 3 * N * N * 2      # K1 at 8192^3 bf16
TILES, TILE_FLOPS = (N // 128) ** 2, 2.0 * 128 * 128 * N


def test_importing_chip_smoke_leaves_torch_out():
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location("
            f"'cs', {str(_PATH)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'torch' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("flops,nbytes,want_ms,by", [
    (MM_FLOPS, MM_BYTES, 1.1117, "operations"),
    # K3 (1, 32, 2048, 96) bf16 causal: 4 D S(S+1)/2 B H over q, k, v, out
    (4.0 * 96 * (2048 * 2049 // 2) * 32, 4 * 32 * 2048 * 96 * 2, 0.0261,
     "operations"),
    # K5 (1, 2048, 4096) f32: bound by its 100.7 MB
    (9.0 * 2048 * 4096, 3 * 4 * 2048 * 4096 + 4 * 4096, 0.0301, "bytes"),
])
def test_bound(smoke, flops, nbytes, want_ms, by):
    dtype = "float32" if by == "bytes" else "bfloat16"
    ms, got_by = smoke.bound(flops, nbytes, dtype)
    assert got_by == by
    assert ms == pytest.approx(want_ms, abs=5e-5)


@pytest.mark.parametrize("in_bytes,reads,want", [
    (4, 1, 100_679_680),    # f32, x and a_log read once: the bound's bytes
    (2, 1, 67_125_248),     # bf16 x and a_log
    (4, 2, 167_788_544),    # f32 read twice, as the kernel it replaced did
])
def test_lru_bytes(smoke, in_bytes, reads, want):
    """K5's bytes at (1, 2048, 4096) from a given h0."""
    assert smoke.lru_bytes(1, 2048, 4096, in_bytes, reads) == want


@pytest.mark.parametrize("slice_size,want_ms", [
    (4, 36.69),        # 1024 launches x 1 wave x 35.83 us
    (132, 1.1465),     # 32 launches x 1 wave x 35.83 us
    (4096, 1.1117),    # one launch: the whole card's bound
])
def test_sliced_bound(smoke, slice_size, want_ms):
    got = smoke.sliced_bound_ms(TILES, slice_size, TILE_FLOPS, MM_BYTES)
    assert got == pytest.approx(want_ms, abs=5e-3 if want_ms > 10 else 5e-5)


def test_sliced_bound_counts_launches_and_waves(smoke):
    one_tile = 1e3 * TILE_FLOPS / (smoke.PEAK_FLOPS["bfloat16"] / smoke.SMS)
    assert one_tile == pytest.approx(0.03583, abs=1e-5)
    # 264 tiles a launch run as two waves of 132
    got = smoke.sliced_bound_ms(TILES, 264, TILE_FLOPS, MM_BYTES)
    assert got == pytest.approx(math.ceil(TILES / 264) * 2 * one_tile)
    # no slice size beats the whole card
    whole = smoke.bound(MM_FLOPS, MM_BYTES, "bfloat16")[0]
    for s in (1, 3, 4, 100, 132, 1000, 4095):
        assert smoke.sliced_bound_ms(TILES, s, TILE_FLOPS, MM_BYTES) >= whole


def test_rwkv6_work_at_the_main_shape(smoke):
    """K4 at (4, 2048, 32, 64) with bf16 r/k/v: 6.34 GFLOP and 239.1 MB;
    0.0947 ms were all of it f32 on the CUDA cores, 0.0714 ms by the bytes,
    which bound it once the products run on the tensor cores."""
    products, other, nbytes = smoke.wkv6_work(4, 2048, 32, 64, 2)
    assert products + other == pytest.approx(6.342e9, rel=1e-3)
    assert nbytes == pytest.approx(239.08e6, rel=1e-4)
    ms, by = smoke.bound(products + other, nbytes, "float32")
    assert by == "operations" and ms == pytest.approx(0.0947, abs=5e-5)
    ms, by = smoke.wkv6_bound_ms(products, other, nbytes)
    assert by == "bytes" and ms == pytest.approx(0.0714, abs=5e-5)


def test_rwkv6_two_passes_move_the_scratch_twice(smoke):
    """The passes' traffic: 641.7 MB, a 0.1916 ms floor, of which the
    (B, H, 64, N, N) f32 scratch, written once and read once, is 268.4 MB;
    a ragged S rounds up to whole chunks."""
    moved, scratch = smoke.wkv6_pass_bytes(4, 2048, 32, 64, 2)
    assert scratch == 2 * 4 * 4 * 32 * 64 * 64 * 64
    assert moved == pytest.approx(641.74e6, rel=1e-4)
    assert 1e3 * moved / smoke.HBM_BYTES_PER_S == pytest.approx(0.1916,
                                                                 abs=5e-5)
    assert smoke.wkv6_pass_bytes(1, 33, 1, 32, 2)[1] == 2 * 4 * 2 * 32 * 32


def test_trace_report_reads_the_trace(smoke):
    """Rows (SM, start, end, op), starting at 1000 ns: the stream CTA on SM
    0 spends 60 of its 100 ns beside two overlapping matmul CTAs (merged,
    not counted twice); the one on SM 1 meets none. The stream phase ends at
    100 ns; matmul CTAs starting before it take 40 ns on average, after it
    75 ns; at 1/4 of the 200 ns launch one matmul and two stream CTAs are
    resident, two stream CTAs at most, and 0.8 matmul CTAs on average
    while stream CTAs ran."""
    trace = [(0, 1000, 1100, 1), (0, 1040, 1080, 0), (0, 1060, 1100, 0),
             (0, 1150, 1200, 0), (1, 1000, 1100, 1), (1, 1100, 1200, 0)]
    got = smoke.trace_report(trace)
    assert got["share"] == pytest.approx(60 / 200)
    assert got["met"] == 0.5 and got["stream_sms"] == 2
    assert got["stream_end_us"] == pytest.approx(0.1)
    assert got["mm_us_during"] == pytest.approx(0.04)
    assert got["mm_us_after"] == pytest.approx(0.075)
    assert got["resident"] == [(1, 2), (1, 0), (2, 0)]
    assert got["stream_us"] == pytest.approx(0.1) and got["peak_stream"] == 2
    assert got["mm_resident_during"] == pytest.approx((40 + 40) / 100)
    alone = smoke.trace_report([(3, 5, 15, 0)])
    assert alone["share"] == 0.0 and alone["mm_us_after"] == pytest.approx(0.01)


@pytest.mark.parametrize("d,want_ms", [(80, 0.0217), (160, 0.0434)])
def test_bound_of_stablelm_head_dims(smoke, d, want_ms):
    """K3 at (1, 32, 2048, D) bf16 causal for StableLM's head dims: 21.5
    and 42.9 GFLOP, held by the tensor cores."""
    flops = 4.0 * d * (2048 * 2049 // 2) * 32
    assert flops / 1e9 == pytest.approx(21.5 * d / 80, rel=2e-3)
    ms, by = smoke.bound(flops, 4 * 32 * 2048 * d * 2, "bfloat16")
    assert by == "operations" and ms == pytest.approx(want_ms, abs=5e-5)


# nvcc -Xptxas -v's lines for two of K3's instances, the second one's spill
# counts made nonzero to show that each entry keeps its own
PTXAS = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash\
_attention_cu_2c13897922flash_fwd_wgmma_kernelILi160EEEv14CUtensorMap_stS1_S1_\
P13__nv_bfloat16ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_a
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash\
_attention_cu_2c13897916flash_fwd_kernelIfLi80EEEvPKT_S3_S3_PS1_ifi' for \
'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 100 registers, used 1 barriers
"""


def test_ptxas_entries_name_each_instance(smoke):
    """The mangled name is cut to the kernel and its template arguments
    (the hash before the name's length does not leak in), and each
    instance keeps its own register and spill lines."""
    assert smoke.ptxas_entries(PTXAS) == [
        ("flash_fwd_wgmma_kernelILi160E", "Used 167 registers, used 1 "
         "barriers", "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
         "spill loads"),
        ("flash_fwd_kernelIfLi80E", "Used 100 registers, used 1 barriers",
         "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")]


@pytest.mark.parametrize("xs,want", [([3.0, 1.0, 2.0], (2.0, 1.0, 3.0)),
                                     ([4, 1, 3, 2], (2.5, 1, 4))])
def test_median_range(smoke, xs, want):
    assert smoke.median_range(xs) == want
