// K1: one slice of a sliced matmul (Kernelet's slicing with index
// rectification, paper Fig. 3).
//
// Replaces the TPU kernel `matmul_slice` (src/repro/kernels/sliced_matmul.py:44,
// body `_mm_kernel` :28). A launch covers `slice_size` consecutive (128 x 128)
// output tiles: CTA b rectifies its id to the global tile g = offset + b and
// decomposes g into (g / n_j, g % n_j) -- the paper's rBlockID -- then loops
// over K with f32 accumulation and writes its tile straight into the (M, N)
// output. The TPU version's packed (slice, bm, bn) tiles and the unpack step
// after the launches are gone.
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at 8192^3 bf16, 1.1 TFLOP against 0.4 GB of
// traffic, so the tensor cores (989 TFLOP/s) would bound it at ~1.1 ms. This
// first version runs f32 FMA on the CUDA cores, so it is far from that bound;
// wgmma/TMA come later. At the default slice_size=4 a launch holds 4 CTAs for
// 132 SMs: that idle machine is the slicing overhead the paper measures.
//
// A tile's result depends only on its own CTA's code, never on which launch
// ran it, so every slice size gives output bitwise equal to one launch.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::TILE_THREADS, 2)
sliced_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                     int n, int k, int n_j, int offset) {
  __shared__ repro::TileSmem sm;
  const int g = offset + static_cast<int>(blockIdx.x);  // rectified block id
  repro::matmul_tile<T>(A, B, C, n, k, g / n_j, g % n_j, sm);
}

}  // namespace

// a (m, k), b (k, n), c (m, n), row-major and contiguous; m, n multiples of 128.
extern "C" int sliced_matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                                    int offset, int slice_size, int dtype, void* stream) {
  (void)m;
  const int n_j = n / repro::TILE_N;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(slice_size);
  if (dtype == repro::DTYPE_F32) {
    sliced_matmul_kernel<float><<<grid, repro::TILE_THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), n, k,
        n_j, offset);
  } else if (dtype == repro::DTYPE_BF16) {
    sliced_matmul_kernel<__nv_bfloat16><<<grid, repro::TILE_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), n, k, n_j, offset);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(sliced_matmul)
