// K1: one slice of a sliced matmul (Kernelet's slicing with index
// rectification, paper Fig. 3).
//
// Replaces the TPU kernel `matmul_slice` (src/repro/kernels/sliced_matmul.py:44,
// body `_mm_kernel` :28). A launch covers `slice_size` consecutive (128 x 128)
// output tiles: CTA b rectifies its id to the global tile g = offset + b and
// decomposes g into (g / n_j, g % n_j) -- the paper's rBlockID -- then loops
// over K with f32 accumulation and writes its tile straight into the (M, N)
// output. The TPU version's packed (slice, bm, bn) tiles and the unpack step
// after the launches are gone. One CTA per tile, never persistent and never
// split along K: a slice's CTA count is its occupancy, the knob the paper
// turns.
//
// Two paths, chosen by dtype alone:
// - bf16: the tensor-core tile of wgmma_tile.cuh (wgmma.m64n128k16 from a
//   4-stage TMA ring, a producer warp and two consumer warpgroups). The two
//   tensor maps are encoded once per sliced_matmul call
//   (sliced_matmul_tma_maps) and passed by value to every slice's launch.
// - f32: common.cuh's FMA tile on the CUDA cores (no model runs K1 in f32).
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at 8192^3 bf16, 1.1 TFLOP against 0.4 GB of traffic, so the
// tensor cores (989 TFLOP/s) bound one launch at ~1.1 ms. A slice of s < 132
// tiles holds s SMs, and one SM's share of the peak needs ~36 us for a
// (128 x 128 x 8192) tile: at the default slice_size=4, 1024 launches take
// at least ~37 ms. That idle machine is the slicing overhead the paper
// measures.
//
// A tile's result depends only on its own CTA's code, never on which launch
// ran it, so every slice size gives output bitwise equal to one launch.
#include "wgmma_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::TILE_THREADS, 2)
sliced_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int n, int k, int n_j, int offset) {
  __shared__ repro::TileSmem sm;
  const int g = offset + static_cast<int>(blockIdx.x);  // rectified block id
  repro::matmul_tile<float>(A, B, C, n, k, g / n_j, g % n_j, sm);
}

__global__ void __launch_bounds__(repro::sm90::TILE_THREADS_WG, 1)
sliced_matmul_wgmma_kernel(__grid_constant__ const CUtensorMap map_a,
                           __grid_constant__ const CUtensorMap map_b,
                           __nv_bfloat16* __restrict__ C, int n, int k, int n_j, int offset) {
  extern __shared__ uint8_t smem[];
  const int g = offset + static_cast<int>(blockIdx.x);  // rectified block id
  repro::sm90::wgmma_matmul_tile(&map_a, &map_b, C, n, k, g / n_j, g % n_j, smem);
}

constexpr size_t MAP_BYTES = sizeof(CUtensorMap);
static_assert(2 * MAP_BYTES == 256, "kernels/sliced_matmul.py MAP_BYTES");

}  // namespace

// f32: a (m, k), b (k, n), c (m, n), row-major and contiguous; m, n
// multiples of 128, k of 16.
extern "C" int sliced_matmul_launch(const void* a, const void* b, void* c, int n, int k,
                                    int offset, int slice_size, void* stream) {
  sliced_matmul_kernel<<<slice_size, repro::TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), n, k,
      n / repro::TILE_N, offset);
  return static_cast<int>(cudaGetLastError());
}

// bf16: writes the tensor maps of a (m, k) and b (k, n) into `maps` (256
// bytes, no alignment asked). m, n multiples of 128, k of 64.
extern "C" int sliced_matmul_tma_maps(const void* a, const void* b, int m, int n, int k,
                                      void* maps) {
  CUtensorMap map_a, map_b;
  const int err = repro::sm90::encode_tile_maps(&map_a, &map_b, a, b, m, n, k);
  if (err != 0) return err;
  std::memcpy(maps, &map_a, MAP_BYTES);
  std::memcpy(static_cast<char*>(maps) + MAP_BYTES, &map_b, MAP_BYTES);
  return 0;
}

// bf16: one slice, tiles offset .. offset + slice_size - 1 of c (m, n).
extern "C" int sliced_matmul_launch_bf16(const void* maps, void* c, int n, int k, int offset,
                                         int slice_size, void* stream) {
  CUtensorMap map_a, map_b;
  std::memcpy(&map_a, maps, MAP_BYTES);
  std::memcpy(&map_b, static_cast<const char*>(maps) + MAP_BYTES, MAP_BYTES);
  const size_t smem = repro::sm90::TILE_SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      sliced_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sliced_matmul_wgmma_kernel<<<slice_size, repro::sm90::TILE_THREADS_WG, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), n, k, n / repro::sm90::TILE_BN, offset);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(sliced_matmul)
