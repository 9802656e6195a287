// K2: fused co-scheduled execution of a compute-bound matmul and a
// memory-bound stream in one launch -- Kernelet's concurrent kernel
// execution at the balanced slice ratio.
//
// Replaces the TPU kernel `coschedule` (src/repro/kernels/coschedule.py:73,
// body `_kernel` :58). The grid has one CTA per schedule step. CTA t reads
// op[t], ai[t] and bi[t] from device memory and either computes matmul tile
// ai[t] over all of K, or scales row block bi[t] of x. CTAs are dispatched
// roughly in id order, so runs of run_a matmul CTAs and run_b stream CTAs
// from the scheduler's s1:s2 plan sit on the SMs together: on the H100
// co-residency is real, where the TPU could only overlap the stream's DMA
// with the matmul's compute. Only the active op's block is written; the TPU
// kernel's rewrite of the idle op's block is gone.
//
// Two kernels, chosen by dtype alone:
// - bf16 (coschedule_wgmma_kernel): matmul steps run wgmma_tile.cuh's
//   tensor-core tile with a 3-stage ring (99,376 bytes of shared memory), so
//   two CTAs fit on an SM and a stream CTA can sit beside a matmul CTA; a
//   launch gives every CTA the same size, so the heavier op sets occupancy.
//   The two TMA maps are encoded once per launch and passed by value.
// - f32 (coschedule_kernel): common.cuh's FMA tile (no model runs K2 in f32).
// Stream steps keep STREAM_UNROLL 16-byte loads in flight a thread.
//
// A nullable `trace` of 4 u64 a step records, from thread 0 of each CTA,
// (%smid, %globaltimer at entry, %globaltimer after its last barrier, op),
// from which the share of stream time spent beside a matmul CTA on the same
// SM is read. Passing null costs one predicate.
//
// What bounds it on an H100 SXM (data-sheet peaks, 989 TFLOP/s bf16 and
// 3.35 TB/s, which assume its 700 W power limit): at 8192^3 bf16 plus a
// 65536 x 8192 bf16 stream, the matmul's 1.1 TFLOP bounds it at ~1.11 ms
// while the stream's 2.15 GB would take ~0.64 ms alone, so a perfect overlap
// hides the stream entirely (serial bound ~1.75 ms). The matmul alone runs at
// K1's tile rate (~2 ms, one stage fewer); the stream needs only bandwidth,
// so the question the launch answers is whether the stream's bytes move
// while the tensor cores are busy.
#include "wgmma_tile.cuh"

namespace {

constexpr int WG_STAGES = 3;
constexpr size_t WG_SMEM = repro::sm90::tile_smem_bytes(WG_STAGES);
constexpr int STREAM_UNROLL = 8;

static_assert(2 * (WG_SMEM + 1024) <= 233472, "two bf16 CTAs must fit on an SM");

// y[i] = x[i] * scale over one contiguous block, cast back to T; each thread
// keeps STREAM_UNROLL 16-byte loads in flight, streamed past the caches.
template <typename T>
__device__ __forceinline__ void scale_block(const T* __restrict__ x, T* __restrict__ y,
                                            size_t count, float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0) &&
      (count % VEC == 0);
  if (!aligned) {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x)
      y[i] = repro::from_f32<T>(repro::to_f32(x[i]) * scale);
    return;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const size_t nv = count / VEC;
  const size_t step = static_cast<size_t>(blockDim.x) * STREAM_UNROLL;
  auto scale_vec = [scale](uint4& u) {
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = repro::from_f32<T>(repro::to_f32(e[j]) * scale);
  };
  size_t i = threadIdx.x;
  for (; i + (STREAM_UNROLL - 1) * static_cast<size_t>(blockDim.x) < nv; i += step) {
    uint4 u[STREAM_UNROLL];
#pragma unroll
    for (int e = 0; e < STREAM_UNROLL; ++e) u[e] = __ldcs(xv + i + e * blockDim.x);
#pragma unroll
    for (int e = 0; e < STREAM_UNROLL; ++e) {
      scale_vec(u[e]);
      __stcs(yv + i + e * blockDim.x, u[e]);
    }
  }
  for (; i < nv; i += blockDim.x) {
    uint4 u = __ldcs(xv + i);
    scale_vec(u);
    __stcs(yv + i, u);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every thread of the CTA calls it once its step is done.
__device__ __forceinline__ void record_step(unsigned long long* trace, unsigned long long start,
                                            int op) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* rec = trace + 4 * static_cast<size_t>(blockIdx.x);
    rec[0] = sm;
    rec[1] = start;
    rec[2] = global_ns();
    rec[3] = static_cast<unsigned long long>(op);
  }
}

__global__ void __launch_bounds__(repro::TILE_THREADS, 2)
coschedule_kernel(const int* __restrict__ op, const int* __restrict__ ai,
                  const int* __restrict__ bi, const float* __restrict__ A,
                  const float* __restrict__ B, const float* __restrict__ X, float* __restrict__ MM,
                  float* __restrict__ ST, int n, int k, int n_j, int bx, int q, float scale,
                  unsigned long long* trace) {
  __shared__ repro::TileSmem sm;
  const int t = blockIdx.x;
  const unsigned long long start = trace ? global_ns() : 0;
  const int o = op[t];
  if (o == 0) {  // uniform over the block, so the tile's barriers are safe
    const int g = ai[t];
    repro::matmul_tile<float>(A, B, MM, n, k, g / n_j, g % n_j, sm);
  } else {
    const size_t base = static_cast<size_t>(bi[t]) * bx * q;
    scale_block<float>(X + base, ST + base, static_cast<size_t>(bx) * q, scale);
  }
  if (trace) record_step(trace, start, o);
}

__global__ void __launch_bounds__(repro::sm90::TILE_THREADS_WG, 2)
coschedule_wgmma_kernel(__grid_constant__ const CUtensorMap map_a,
                        __grid_constant__ const CUtensorMap map_b, const int* __restrict__ op,
                        const int* __restrict__ ai, const int* __restrict__ bi,
                        const __nv_bfloat16* __restrict__ X, __nv_bfloat16* __restrict__ MM,
                        __nv_bfloat16* __restrict__ ST, int n, int k, int n_j, int bx, int q,
                        float scale, unsigned long long* trace) {
  extern __shared__ uint8_t smem[];
  const int t = blockIdx.x;
  const unsigned long long start = trace ? global_ns() : 0;
  const int o = op[t];
  if (o == 0) {  // uniform over the block: the tile's producer warp returns to here
    const int g = ai[t];
    repro::sm90::wgmma_matmul_tile<WG_STAGES>(&map_a, &map_b, MM, n, k, g / n_j, g % n_j, smem);
  } else {
    const size_t base = static_cast<size_t>(bi[t]) * bx * q;
    scale_block<__nv_bfloat16>(X + base, ST + base, static_cast<size_t>(bx) * q, scale);
  }
  if (trace) record_step(trace, start, o);
}

int set_wgmma_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      coschedule_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(WG_SMEM)));
}

}  // namespace

// op/ai/bi: int32 device arrays of length `steps`; a (m, k), b (k, n), x (p, q),
// mm (m, n), st (p, q), row-major and contiguous; m, n multiples of 128, k of
// 64 (bf16) or 16 (f32), p of bx. trace: null, or 4 * steps u64.
extern "C" int coschedule_launch(const void* op, const void* ai, const void* bi, const void* a,
                                 const void* b, const void* x, void* mm, void* st, int m, int n,
                                 int k, int q, int bx, float scale, int steps, int dtype,
                                 void* trace, void* stream) {
  const int n_j = n / repro::TILE_N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(op);
  const int* i_a = static_cast<const int*>(ai);
  const int* i_b = static_cast<const int*>(bi);
  auto* tr = static_cast<unsigned long long*>(trace);
  if (steps <= 0) return 0;
  if (dtype == repro::DTYPE_F32) {
    coschedule_kernel<<<steps, repro::TILE_THREADS, 0, s>>>(
        o, i_a, i_b, static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(x), static_cast<float*>(mm), static_cast<float*>(st), n, k, n_j,
        bx, q, scale, tr);
  } else if (dtype == repro::DTYPE_BF16) {
    CUtensorMap map_a, map_b;
    int err = repro::sm90::encode_tile_maps(&map_a, &map_b, a, b, m, n, k);
    if (err != 0) return err;
    err = set_wgmma_smem();
    if (err != 0) return err;
    coschedule_wgmma_kernel<<<steps, repro::sm90::TILE_THREADS_WG, WG_SMEM, s>>>(
        map_a, map_b, o, i_a, i_b, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(mm), static_cast<__nv_bfloat16*>(st), n, k, n_j, bx, q, scale,
        tr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the bf16 kernel an SM holds at once (cudaOccupancyMaxActive-
// BlocksPerMultiprocessor at its block and shared-memory size), or minus a
// CUDA error.
extern "C" int coschedule_occupancy() {
  int err = set_wgmma_smem();
  if (err != 0) return -err;
  int blocks = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, coschedule_wgmma_kernel, repro::sm90::TILE_THREADS_WG, WG_SMEM));
  return err != 0 ? -err : blocks;
}

REPRO_EXPORT_STRERROR(coschedule)
