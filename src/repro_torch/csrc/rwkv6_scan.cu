// K4: chunked WKV6 (RWKV6 "Finch" time mix) with an (N x N) f32 state carried
// across chunks.
//
// Replaces the TPU kernel `rwkv6_scan` (src/repro/kernels/rwkv6_scan.py:58,
// body `_wkv_kernel` :19). The TPU grid (B, H, n_chunks) ran its chunk axis in
// order on one core and carried the state in VMEM scratch. Blocks here run in
// no order, so one CTA owns one (b, h) and loops over the chunks itself; the
// state stays in shared memory for the whole sequence. Per chunk of C = 32
// tokens it computes, as `_wkv_kernel` does (:34-55):
//   la      = cumsum(w) over the chunk, la_prev = la - w     (both <= 0)
//   out_i   = (r_i * exp(la_prev_i)) @ S                     inter-chunk
//           + sum_{j<i} [sum_n r_in k_jn exp(la_prev_in - la_jn)] v_j
//           + (sum_n r_in u_n k_in) v_i                      u-bonus diagonal
//   S'      = exp(la_end) * S + sum_j (k_j * exp(la_end - la_j))^T v_j
// Every exponent is <= 0: the intra-chunk decay is formed only for j < i
// (above the diagonal it would be >= 0 and can overflow f32).
//
// Beyond the TPU kernel it takes an optional initial state and always writes
// the final one (in place when the two pointers are equal: a CTA reads its
// own (b, h) slice before it writes it), so a prefill with a cache runs here
// too. Its chunk is its own: C = 32 with a ragged last chunk padded with
// r = k = v = 0 and w = 0, which leaves out and the state unchanged, so any S
// is taken. The chunk length changes only f32 rounding order.
//
// Layout: r, k, v (f32 or bf16), w (f32) and out (f32) are (B, S, H, N)
// row-major, as the model produces them, so a CTA reads rows of N values at a
// stride of H * N; u is (H, N) f32; state (B, H, N, N) f32. N is a template
// parameter (64 for RWKV6-1.6B, 32 for the reduced test configurations).
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (4, 2048, 32, 64) with bf16 r/k/v, ~235 MB of inputs and
// output (0.070 ms at 3.35 TB/s) against ~7.5 GFLOP of f32 arithmetic on the
// CUDA cores (0.11 ms at 67 TFLOP/s), so the f32 operations bound it. The
// design keeps the state and every intermediate of a chunk in shared memory,
// so device memory sees each input once and each output once. This first
// version is plain FMA with one CTA per (b, h) (128 CTAs on 132 SMs at the
// main shape) and no prefetch of the next chunk; splitting the state's value
// columns over more CTAs, and mma for the three chunk products, come later.
#include "common.cuh"

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;

template <int N>
struct Smem {
  static constexpr int ROW = N + 1;  // row stride of the (C x N) arrays: rows on distinct banks
  float r[C * ROW];
  float k[C * ROW];
  float v[C * ROW];
  float la[C * ROW];   // w, then its inclusive cumsum
  float lp[C * ROW];   // exclusive cumsum (la_prev)
  float rd[C * ROW];   // r * exp(la_prev)
  float kd[C * ROW];   // k * exp(la_end - la)
  float s[N * N];      // the state, S[n][m]
  float att[C * (C + 1)];
  float diag[C];
  float u[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ R, const T* __restrict__ K, const T* __restrict__ V,
            const float* __restrict__ W, const float* __restrict__ U,
            const float* state_in, float* __restrict__ O, float* state_out, int S, int H) {
  static_assert(THREADS % N == 0 && N <= THREADS, "N must divide the block");
  constexpr int ROW = Smem<N>::ROW;
  constexpr int RSTEP = THREADS / N;   // rows (or state rows) a pass of the block covers
  constexpr int OUT_Q = C / RSTEP;     // out rows per thread
  constexpr int ST_Q = N / RSTEP;      // state rows per thread
  extern __shared__ float smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * N;     // between tokens
  const size_t base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * N;
  float* st_out = state_out + static_cast<size_t>(bh) * N * N;

  for (int idx = tid; idx < N * N; idx += THREADS)
    sm.s[idx] = state_in ? state_in[static_cast<size_t>(bh) * N * N + idx] : 0.f;
  for (int n = tid; n < N; n += THREADS) sm.u[n] = U[static_cast<size_t>(h) * N + n];

  const int m = tid % N;               // value column this thread owns in out and S
  const int r0 = tid / N;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the last chunk's state update no longer reads kd / v
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int i = idx / N;
      const int n = idx % N;
      const int t = c0 + i;
      const bool in = t < S;
      const size_t g = base + static_cast<size_t>(t) * row_stride + n;
      sm.r[i * ROW + n] = in ? repro::to_f32(R[g]) : 0.f;
      sm.k[i * ROW + n] = in ? repro::to_f32(K[g]) : 0.f;
      sm.v[i * ROW + n] = in ? repro::to_f32(V[g]) : 0.f;
      sm.la[i * ROW + n] = in ? W[g] : 0.f;
    }
    __syncthreads();

    // cumulative log decay, one thread per channel n
    if (tid < N) {
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const float w = sm.la[i * ROW + tid];
        sm.lp[i * ROW + tid] = acc;
        acc += w;
        sm.la[i * ROW + tid] = acc;
      }
    }
    __syncthreads();

    // decayed r and k, the u-bonus diagonal, the intra-chunk scores
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int i = idx / N;
      const int n = idx % N;
      const int o = i * ROW + n;
      sm.rd[o] = sm.r[o] * expf(sm.lp[o]);
      sm.kd[o] = sm.k[o] * expf(sm.la[(C - 1) * ROW + n] - sm.la[o]);
    }
    if (tid < C) {
      float acc = 0.f;
      for (int n = 0; n < N; ++n)
        acc = fmaf(sm.r[tid * ROW + n] * sm.u[n], sm.k[tid * ROW + n], acc);
      sm.diag[tid] = acc;
    }
    {
      // thread -> row i = tid / 8 and columns j = tid % 8 + 8 q, only j < i
      const int i = tid / 8;
      const int jg = tid % 8;
      float acc[C / 8];
#pragma unroll
      for (int q = 0; q < C / 8; ++q) acc[q] = 0.f;
      if (i > jg) {
        for (int n = 0; n < N; ++n) {
          const float ri = sm.r[i * ROW + n];
          const float lpi = sm.lp[i * ROW + n];
#pragma unroll
          for (int q = 0; q < C / 8; ++q) {
            const int j = jg + 8 * q;
            if (j < i)
              acc[q] = fmaf(ri * sm.k[j * ROW + n], expf(lpi - sm.la[j * ROW + n]), acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < C / 8; ++q) sm.att[i * (C + 1) + jg + 8 * q] = acc[q];
    }
    __syncthreads();

    // out rows r0 + RSTEP q, column m
    {
      float acc[OUT_Q];
#pragma unroll
      for (int q = 0; q < OUT_Q; ++q) acc[q] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s = sm.s[n * N + m];
#pragma unroll
        for (int q = 0; q < OUT_Q; ++q) acc[q] = fmaf(sm.rd[(r0 + RSTEP * q) * ROW + n], s, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < OUT_Q; ++q) {
        const int i = r0 + RSTEP * q;
        float a = acc[q];
        for (int j = 0; j < i; ++j) a = fmaf(sm.att[i * (C + 1) + j], sm.v[j * ROW + m], a);
        a = fmaf(sm.diag[i], sm.v[i * ROW + m], a);
        const int t = c0 + i;
        if (t < S) O[base + static_cast<size_t>(t) * row_stride + m] = a;
      }
    }
    __syncthreads();  // every read of the old state is done

    // state rows r0 + RSTEP q, column m
#pragma unroll
    for (int q = 0; q < ST_Q; ++q) {
      const int n = r0 + RSTEP * q;
      float a = expf(sm.la[(C - 1) * ROW + n]) * sm.s[n * N + m];
      for (int j = 0; j < C; ++j) a = fmaf(sm.kd[j * ROW + n], sm.v[j * ROW + m], a);
      sm.s[n * N + m] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * N; idx += THREADS) st_out[idx] = sm.s[idx];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* out, float* state_out, int b, int s, int h,
           cudaStream_t stream) {
  const size_t smem = sizeof(Smem<N>);  // 79 KB at N = 64: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T, N><<<b * h, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      state_in, out, state_out, s, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* r, const void* k, const void* v, const float* w, const float* u,
               const float* state_in, float* out, float* state_out, int b, int s, int h, int n,
               cudaStream_t stream) {
  switch (n) {
    case 32: return launch<T, 32>(r, k, v, w, u, state_in, out, state_out, b, s, h, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, state_in, out, state_out, b, s, h, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (b, s, h, n) in `dtype`; w, out: (b, s, h, n) f32; u: (h, n) f32;
// state_in (nullable) and state_out: (b, h, n, n) f32; all contiguous.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state_in, void* out, void* state_out,
                              int b, int s, int h, int n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  auto* of = static_cast<float*>(out);
  auto* so = static_cast<float*>(state_out);
  if (dtype == repro::DTYPE_F32)
    return dispatch_n<float>(r, k, v, wf, uf, si, of, so, b, s, h, n, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_n<__nv_bfloat16>(r, k, v, wf, uf, si, of, so, b, s, h, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_STRERROR(rwkv6_scan)
