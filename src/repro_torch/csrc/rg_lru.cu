// K5: the RG-LRU linear recurrence of Griffin / RecurrentGemma,
//   h_t = a_t h_{t-1} + sqrt(max(1 - exp(2 a_log_t), 1e-12)) x_t,  a_t = exp(a_log_t),
// over x, a_log: (B, S, W) f32, from an optional initial state h0: (B, W).
//
// Replaces the TPU kernel `rg_lru` (src/repro/kernels/rg_lru.py:41, body
// `_lru_kernel` :17). The TPU grid (B, W/bw, S/chunk) ran its chunks in order
// and carried h in VMEM scratch, with an associative scan inside a chunk. Here
// one thread owns one channel w of one time segment, sequential in time, and
// a warp's 32 threads own 32 neighbouring channels, so every load and store of
// a warp is one coalesced 128-byte row piece. A CTA holds 32 channels and
// SEG = 16 warps, one per segment of ceil(S / 16) steps, in three phases:
//   1. each segment runs the recurrence from h = 0 and keeps its end value B
//      and the product A of its a's;
//   2. one warp chains the segments: carry_{k+1} = A_k carry_k + B_k, from h0;
//   3. each segment runs the recurrence again from its carry and writes h.
// Phase 3 is the sequential recurrence itself, so only the carries differ
// from a plain time loop, by f32 rounding order. It forms 1 - exp(2 a_log) as
// the TPU kernel does (`rg_lru.py:27`); the oracle forms 1 - a*a.
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (1, 2048, 4096) it must read x and a_log and write h,
// ~101 MB (0.030 ms at 3.35 TB/s); its arithmetic is ~15 operations per
// element, far below the memory line. A single sequential pass per channel
// would give only B W / 32 = 128 warps to the whole card; the segments give
// 2048 warps (128 CTAs on 132 SMs) at the price of reading x and a_log twice.
#include "common.cuh"

namespace {

constexpr int LANES = 32;    // channels per CTA
constexpr int SEG = 16;      // time segments per CTA, one warp each

__device__ __forceinline__ float lru_b(float al, float x) {
  return sqrtf(fmaxf(1.f - expf(2.f * al), 1e-12f)) * x;
}

__global__ void __launch_bounds__(LANES * SEG)
rg_lru_kernel(const float* __restrict__ X, const float* __restrict__ A, const float* h0,
              float* __restrict__ O, int S, int W) {
  __shared__ float seg_a[SEG][LANES];
  __shared__ float seg_b[SEG][LANES];
  __shared__ float carry[SEG][LANES];
  const int lane = threadIdx.x % LANES;
  const int seg = threadIdx.x / LANES;
  const int w = blockIdx.x * LANES + lane;
  const int b = blockIdx.y;
  const bool live = w < W;
  const int len = (S + SEG - 1) / SEG;
  const int t0 = min(seg * len, S);
  const int t1 = min(t0 + len, S);
  const size_t col = static_cast<size_t>(b) * S * W + w;

  float prod = 1.f;
  float h = 0.f;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const size_t g = col + static_cast<size_t>(t) * W;
      const float al = A[g];
      const float a = expf(al);
      h = fmaf(a, h, lru_b(al, X[g]));
      prod *= a;
    }
  }
  seg_a[seg][lane] = prod;
  seg_b[seg][lane] = h;
  __syncthreads();

  if (seg == 0) {
    float c = (live && h0) ? h0[static_cast<size_t>(b) * W + w] : 0.f;
    for (int k = 0; k < SEG; ++k) {
      carry[k][lane] = c;
      c = fmaf(seg_a[k][lane], c, seg_b[k][lane]);
    }
  }
  __syncthreads();

  if (live) {
    h = carry[seg][lane];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const size_t g = col + static_cast<size_t>(t) * W;
      const float al = A[g];
      h = fmaf(expf(al), h, lru_b(al, X[g]));
      O[g] = h;
    }
  }
}

}  // namespace

// x, a_log, out: (b, s, w) f32; h0 (nullable): (b, w) f32; all contiguous.
extern "C" int rg_lru_fwd(const void* x, const void* a_log, const void* h0, void* out, int b,
                          int s, int w, void* stream) {
  const dim3 grid((w + LANES - 1) / LANES, b);
  rg_lru_kernel<<<grid, LANES * SEG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a_log),
      static_cast<const float*>(h0), static_cast<float*>(out), s, w);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(rg_lru)
