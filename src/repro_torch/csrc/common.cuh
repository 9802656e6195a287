// Shared helpers for the port's Hopper kernels: dtype conversion, the
// error-string export every library carries, and the one-CTA matmul tile
// that sliced_matmul.cu and coschedule.cu both run.
//
// Built with plain nvcc (no PyTorch headers) into one shared library per
// .cu file, loaded through ctypes by repro_torch/kernels/_build.py.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// ---------------------------------------------------------------------------
// One (128 x 128) output tile of C = A @ B, accumulated in f32 over all of K.
//
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns the 8 x 8 outputs
// at rows ty + 16 i and columns tx + 16 j, so a warp reads two A values and
// sixteen consecutive B values of shared memory per k: no bank conflicts.
// K is staged through shared memory TILE_K values at a time (the TPU kernel
// kept whole K strips in VMEM; a (128 x 8192) bf16 strip is 2 MB, far above
// the 227 KB a block can use here). Inputs are converted to f32 on the way
// into shared memory; plain FMA on the CUDA cores, no tensor cores yet.
// ---------------------------------------------------------------------------
constexpr int TILE_M = 128;
constexpr int TILE_N = 128;
constexpr int TILE_K = 16;
constexpr int TILE_THREADS = 256;
constexpr int TILE_PAD = 4;  // A is stored transposed; the pad spreads its stores over banks

struct TileSmem {
  float a[TILE_K][TILE_M + TILE_PAD];
  float b[TILE_K][TILE_N];
};

template <typename T>
__device__ __forceinline__ void matmul_tile(const T* __restrict__ A, const T* __restrict__ B,
                                            T* __restrict__ C, int n, int k, int ti, int tj,
                                            TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* a_blk = A + static_cast<size_t>(ti) * TILE_M * k;
  const T* b_blk = B + static_cast<size_t>(tj) * TILE_N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TILE_K) {
#pragma unroll
    for (int e = 0; e < (TILE_M * TILE_K) / TILE_THREADS; ++e) {
      const int idx = tid + e * TILE_THREADS;
      const int r = idx / TILE_K;
      const int c = idx % TILE_K;
      sm.a[c][r] = to_f32(a_blk[static_cast<size_t>(r) * k + k0 + c]);
    }
#pragma unroll
    for (int e = 0; e < (TILE_K * TILE_N) / TILE_THREADS; ++e) {
      const int idx = tid + e * TILE_THREADS;
      const int r = idx / TILE_N;
      const int c = idx % TILE_N;
      sm.b[r][c] = to_f32(b_blk[static_cast<size_t>(k0 + r) * n + c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE_K; ++kk) {
      float av[8];
      float bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* c_blk = C + static_cast<size_t>(ti) * TILE_M * n + static_cast<size_t>(tj) * TILE_N;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c_blk[static_cast<size_t>(ty + 16 * i) * n + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

}  // namespace repro

// Every library exports <prefix>_strerror so the wrapper can name a failed launch.
#define REPRO_EXPORT_STRERROR(prefix)                        \
  extern "C" const char* prefix##_strerror(int err) {        \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
