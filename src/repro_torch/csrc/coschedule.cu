// K2: fused co-scheduled execution of a compute-bound matmul and a
// memory-bound stream in one launch -- Kernelet's concurrent kernel
// execution at the balanced slice ratio.
//
// Replaces the TPU kernel `coschedule` (src/repro/kernels/coschedule.py:73,
// body `_kernel` :58). The grid has one CTA per schedule step, all with the
// same blockDim. CTA t reads op[t], ai[t] and bi[t] from device memory and
// either computes matmul tile ai[t] over all of K, or scales row block bi[t]
// of x. CTAs are dispatched roughly in id order, so runs of run_a matmul
// CTAs and run_b stream CTAs from the scheduler's s1:s2 plan sit on the SMs
// together: on the H100 co-residency is real, where the TPU could only
// overlap the stream's DMA with the matmul's compute. Only the active op's
// block is written; the TPU kernel's rewrite of the idle op's block is gone.
//
// What bounds it on an H100 SXM (data-sheet peaks, 989 TFLOP/s bf16 and
// 3.35 TB/s, which assume its 700 W power limit): at 8192^3 bf16 plus a
// 65536 x 8192 bf16 stream, the matmul's 1.1 TFLOP bounds it at ~1.1 ms
// while the stream's 2.15 GB would take ~0.64 ms alone, so a perfect
// overlap hides the stream entirely (serial bound ~1.75 ms). The matmul CTAs here run f32 FMA, so they are
// far from their bound; the stream CTAs use 16-byte loads and stores.
#include "common.cuh"

namespace {

// y[i] = x[i] * scale over one contiguous block, cast back to T.
template <typename T>
__device__ __forceinline__ void scale_block(const T* __restrict__ x, T* __restrict__ y,
                                            size_t count, float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0) &&
      (count % VEC == 0);
  if (aligned) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    const size_t nv = count / VEC;
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 u = xv[i];
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = repro::from_f32<T>(repro::to_f32(e[j]) * scale);
      yv[i] = u;
    }
  } else {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x)
      y[i] = repro::from_f32<T>(repro::to_f32(x[i]) * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::TILE_THREADS, 2)
coschedule_kernel(const int* __restrict__ op, const int* __restrict__ ai,
                  const int* __restrict__ bi, const T* __restrict__ A, const T* __restrict__ B,
                  const T* __restrict__ X, T* __restrict__ MM, T* __restrict__ ST, int n, int k,
                  int n_j, int bx, int q, float scale) {
  __shared__ repro::TileSmem sm;
  const int t = blockIdx.x;
  if (op[t] == 0) {  // uniform over the block, so the tile's barriers are safe
    const int g = ai[t];
    repro::matmul_tile<T>(A, B, MM, n, k, g / n_j, g % n_j, sm);
  } else {
    const size_t base = static_cast<size_t>(bi[t]) * bx * q;
    scale_block<T>(X + base, ST + base, static_cast<size_t>(bx) * q, scale);
  }
}

}  // namespace

// op/ai/bi: int32 device arrays of length `steps`; a (m, k), b (k, n), x (p, q),
// mm (m, n), st (p, q), row-major and contiguous; m, n multiples of 128, p of bx.
extern "C" int coschedule_launch(const void* op, const void* ai, const void* bi, const void* a,
                                 const void* b, const void* x, void* mm, void* st, int n, int k,
                                 int q, int bx, float scale, int steps, int dtype, void* stream) {
  const int n_j = n / repro::TILE_N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(op);
  const int* i_a = static_cast<const int*>(ai);
  const int* i_b = static_cast<const int*>(bi);
  if (steps <= 0) return 0;
  if (dtype == repro::DTYPE_F32) {
    coschedule_kernel<float><<<steps, repro::TILE_THREADS, 0, s>>>(
        o, i_a, i_b, static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(x), static_cast<float*>(mm), static_cast<float*>(st), n, k, n_j,
        bx, q, scale);
  } else if (dtype == repro::DTYPE_BF16) {
    coschedule_kernel<__nv_bfloat16><<<steps, repro::TILE_THREADS, 0, s>>>(
        o, i_a, i_b, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(mm),
        static_cast<__nv_bfloat16*>(st), n, k, n_j, bx, q, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(coschedule)
