"""The yardsticks ``chip_smoke.py`` holds the kernels' times against: the
card's least time for the work (``bound``) and the least time of a matmul
cut into slices (``sliced_bound_ms``). Pure arithmetic from the H100's
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
