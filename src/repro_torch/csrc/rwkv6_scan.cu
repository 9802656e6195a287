// K4: chunked WKV6 (RWKV6 "Finch" time mix) with an (N x N) f32 state carried
// across chunks, in two passes over the sequence.
//
// Replaces the TPU kernel `rwkv6_scan` (src/repro/kernels/rwkv6_scan.py:58,
// body `_wkv_kernel` :19). The TPU grid (B, H, n_chunks) ran its chunk axis in
// order on one core and carried the state in VMEM scratch. Here the chunks
// are split the way the public chunked RWKV6 kernels split them (chunk states
// first, then outputs), so only a short recurrence stays sequential. Per chunk
// of C = 32 tokens, with la = cumsum(w) over the chunk and la_prev = la - w
// (both <= 0), as `_wkv_kernel` computes it (:34-55):
//   out_i = (r_i * exp(la_prev_i)) @ S                     inter-chunk
//         + sum_{j<i} [sum_n r_in k_jn exp(la_prev_in - la_jn)] v_j
//         + (sum_n r_in u_n k_in) v_i                      u-bonus diagonal
//   S'    = exp(la_end) * S + sum_j (k_j * exp(la_end - la_j))^T v_j
//
// Pass 1 (wkv6_states_kernel): one CTA of four warps per (b, h, block of
// MB = 32 value columns). Columns of the state are independent (S'[:, m]
// needs only v[:, m]), so N / MB CTAs share a head, each forming the chunk's
// decays itself (fewer blocks would leave SMs idle, more would repeat that
// work more often). The CTA walks the chunks in order, the next two chunks'
// k, w and v arriving by cp.async into a ring of RING = 3 stages while the
// current one computes; its columns of S stay in mma accumulators. It writes
// the state entering each chunk to `scratch` (B, H, n_chunks, N, N) f32,
// which the wrapper allocates, and the final state to `state_out`.
//
// Pass 2 (wkv6_out_kernel): one CTA of eight warps per (b, h, chunk), no
// sequential dependence, four CTAs an SM. The chunk's r, k, v, w land by
// cp.async; its entering state lands in a second group while the decays and
// scores are formed. The intra-chunk scores are built by sub-chunks of
// SUB = 16: for i in the later sub-chunk and j in the earlier one, with la_b
// the log decay at their boundary,
// exp(la_prev_i - la_j) = exp(la_prev_i - la_b) exp(la_b - la_j), both
// factors <= 1, so that block is the product of two decayed (SUB x N)
// operands; only the two diagonal (SUB x SUB) blocks are formed element by
// element, for j < i only. No exponent formed anywhere is above 0 (above the
// diagonal it would be, and can overflow f32).
//
// The chunk's products (r_dec @ S, the off-diagonal scores, kd^T v, att @ v)
// run on the tensor cores as mma.sync m16n8k16 with split-precision operands:
// each f32 operand is a bf16 high part plus a bf16 low part and three
// products are summed (a_lo b_hi + a_hi b_lo + a_hi b_hi), a relative error
// of ~1e-5; an operand exact in bf16 (bf16 v) skips its low product. Plain
// TF32 (unit roundoff 4.9e-4) would sit too close to the 1e-3 tolerance.
// Exponentials are ex2.approx on logs pre-scaled by log2(e) (relative error
// ~2^-22).
//
// It takes an optional initial state and always writes the final one (in
// place when the two pointers are equal: a pass-1 CTA reads its own columns
// before it writes them, and pass 2 reads only the scratch). Its chunk is its
// own: C = 32 with a ragged last chunk padded with r = k = v = 0 and w = 0,
// which leaves out and the state unchanged, so any S is taken.
//
// Layout: r, k, v (f32 or bf16), w (f32) and out (f32) are (B, S, H, N)
// row-major, as the model produces them, so a CTA reads rows of N values at a
// stride of H * N; u is (H, N) f32; state (B, H, N, N) f32. N is a template
// parameter (64 for RWKV6-1.6B, 32 for the reduced test configurations).
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (4, 2048, 32, 64) with bf16 r/k/v the work is 6.34 GFLOP
// (4CN^2 + 3.5C^2N + 10CN a chunk) and 239.1 MB of inputs and output. With
// the products on the tensor cores the bytes bound it: 0.0714 ms at
// 3.35 TB/s, against 0.0947 ms were all of it f32 on the CUDA cores. The two
// passes move ~640 MB, a floor of ~0.19 ms, of which the scratch written by
// pass 1 and read by pass 2 is 268 MB (42%).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int C = 32;          // chunk length
constexpr int SUB = 16;        // sub-chunk of the intra-chunk scores
constexpr int THREADS1 = 128;  // pass 1: four warps
constexpr int THREADS2 = 256;  // pass 2: eight warps
constexpr int Q = THREADS2 / C;                 // pass-2 threads a query row
constexpr int WPM = THREADS2 / 32 / (C / 16);   // pass-2 warps a 16-row tile
constexpr int MB = 32;         // value columns of the state a pass-1 CTA carries
constexpr int RING = 3;        // pass-1 stages: chunk c computes while c + 1 and c + 2 load
constexpr float LOG2E = 1.4426950408889634f;

static_assert(THREADS2 % C == 0 && SUB % Q == 0 && 32 % Q == 0, "pass 2: Q threads a row");
static_assert(WPM >= 1 && THREADS2 / 32 >= 2, "pass 2: whole warps a 16-row tile");

// ---------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Rows t0 .. t0 + C - 1 of a tensor whose rows lie `row_stride` elements
// apart, COLS elements of each from `src`, into shared rows of LD elements;
// rows at or past S are zero-filled. The shape is compile-time, so a
// thread's pieces cost no division.
template <int COLS, int LD, int THREADS, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src, size_t row_stride, int t0, int S) {
  constexpr int PER = 16 / static_cast<int>(sizeof(E));
  constexpr int PIECES = COLS / PER;
  constexpr int TOTAL = C * PIECES;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * THREADS;
    if (TOTAL % THREADS != 0 && idx >= TOTAL) break;
    const int i = idx / PIECES;
    const int p = idx % PIECES;
    const bool in = t0 + i < S;
    cp_async16(dst + i * LD + p * PER, src + static_cast<size_t>(in ? t0 + i : t0) * row_stride + p * PER,
               in);
  }
}

// four consecutive elements of shared memory as f32 (16- or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &v.x, sizeof lo);
  memcpy(&hi, &v.y, sizeof hi);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// split-precision operands of mma.m16n8k16: x = hi + lo, each a bf16
template <int R>
struct Split {
  uint32_t hi[R];
  uint32_t lo[R];
};

// (x0, x1) as bf16 high parts and the bf16 rounding of what they leave, x0
// in the low half of each register.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  memcpy(&hi, &h, sizeof hi);
  memcpy(&lo, &l, sizeof lo);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three bf16 products, the small ones first. B_EXACT: b is exact
// in bf16, its low part zero, so its product is skipped.
template <bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma_bf16(d, a.lo, b.hi);
  if (!B_EXACT) mma_bf16(d, a.hi, b.lo);
  mma_bf16(d, a.hi, b.hi);
}

// Fragments of mma.m16n8k16 (lane = 4 g + t). A (16 x 16): registers 0-3
// hold (row g, cols 2t, 2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
// B (16 x 8): (k 2t, 2t+1; col g), (k 2t + 8, 2t + 9; col g). Accumulator
// (16 x 8): (row g, cols 2t, 2t+1), (row g + 8, cols 2t, 2t+1).
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A at (r0, c0) of a row-major f32 array
__device__ __forceinline__ Split<4> frag_a(const float* x, int ld, int r0, int c0) {
  const float* p = x + (r0 + lane_g()) * ld + c0 + 2 * lane_t();
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  Split<4> f;
  split2(v0.x, v0.y, f.hi[0], f.lo[0]);
  split2(v1.x, v1.y, f.hi[1], f.lo[1]);
  split2(v2.x, v2.y, f.hi[2], f.lo[2]);
  split2(v3.x, v3.y, f.hi[3], f.lo[3]);
  return f;
}

// A at (r0, c0) of the transpose of a row-major f32 array: A[row][col] = x[col][row]
__device__ __forceinline__ Split<4> frag_a_t(const float* x, int ld, int r0, int c0) {
  const float* p = x + (c0 + 2 * lane_t()) * ld + r0 + lane_g();
  Split<4> f;
  split2(p[0], p[ld], f.hi[0], f.lo[0]);
  split2(p[8], p[ld + 8], f.hi[1], f.lo[1]);
  split2(p[8 * ld], p[9 * ld], f.hi[2], f.lo[2]);
  split2(p[8 * ld + 8], p[9 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// B at (k0, n0) of a row-major [k][n] array
__device__ __forceinline__ Split<2> frag_b_kn(const float* x, int ld, int k0, int n0) {
  const float* p = x + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  Split<2> f;
  split2(p[0], p[ld], f.hi[0], f.lo[0]);
  split2(p[8 * ld], p[9 * ld], f.hi[1], f.lo[1]);
  return f;
}

// the same of a bf16 array, exact: its low parts are zero and left unset
__device__ __forceinline__ Split<2> frag_b_kn(const __nv_bfloat16* x, int ld, int k0, int n0) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(x) + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  Split<2> f;
  f.hi[0] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
  f.hi[1] = static_cast<uint32_t>(p[8 * ld]) | (static_cast<uint32_t>(p[9 * ld]) << 16);
  return f;
}

// B at (k0, n0) of a row-major [n][k] f32 array: B[k][n] = x[n][k]
__device__ __forceinline__ Split<2> frag_b_nk(const float* x, int ld, int k0, int n0) {
  const float* p = x + (n0 + lane_g()) * ld + k0 + 2 * lane_t();
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
  Split<2> f;
  split2(v0.x, v0.y, f.hi[0], f.lo[0]);
  split2(v1.x, v1.y, f.hi[1], f.lo[1]);
  return f;
}

// Row strides, in elements: 16 bytes of pad put consecutive rows of raw
// inputs on distinct banks; f32 rows of N + 4 (4 mod 32 words) keep B
// fragments and row broadcasts conflict-free, rows of N + 8 (8 mod 32) the
// float2 A fragments.
template <typename T, int N>
struct Ld {
  static constexpr int RAW = N + 16 / static_cast<int>(sizeof(T));
  static constexpr int V1 = MB + 16 / static_cast<int>(sizeof(T));
  static constexpr int F = N + 4;
  static constexpr int A = N + 8;
  static constexpr int ATT = C + 8;
};

// ---------------------------------------------------------------------------
// pass 1: the state entering each chunk
// ---------------------------------------------------------------------------
template <typename T, int N>
struct StatesSmem {
  struct Stage {
    alignas(16) T k[C * Ld<T, N>::RAW];
    alignas(16) float w[C * Ld<T, N>::F];
    alignas(16) T v[C * Ld<T, N>::V1];
  };
  Stage st[RING];
  alignas(16) float kd[C * Ld<T, N>::F];  // k_j exp(la_end - la_j), [j][n]
  float dec[N];                           // exp(la_end): each state row's decay over the chunk
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS1)
wkv6_states_kernel(const T* __restrict__ K, const T* __restrict__ V, const float* __restrict__ W,
                   const float* state_in, float* state_out, float* __restrict__ scratch, int S,
                   int H) {
  using L = Ld<T, N>;
  constexpr int NT = MB / 8;  // n-tiles of the CTA's columns
  constexpr bool V_EXACT = sizeof(T) == 2;
  static_assert(N % MB == 0 && N % 16 == 0 && N <= THREADS1, "head dim");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  StatesSmem<T, N>& sm = *reinterpret_cast<StatesSmem<T, N>*>(smem_raw);

  const int col0 = blockIdx.x * MB;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x / 32;
  const int g = lane_g();
  const int t = lane_t();
  const int nc = (S + C - 1) / C;
  const size_t row_stride = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * N;
  const size_t st_off = static_cast<size_t>(bh) * N * N;
  const bool owns = warp < N / 16;  // warp w carries state rows 16 w .. 16 w + 15
  const int row = 16 * warp + g;    // and + 8

  // the CTA's columns of S in accumulator layout
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + 8 * nt + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = (owns && state_in) ? state_in[st_off + (row + 8 * (e >> 1)) * N + col + (e & 1)] : 0.f;
  }

  // one cp.async group a chunk, empty past the last, so that group c is chunk c
  auto load_chunk = [&](int c) {
    if (c < nc) {
      auto& stg = sm.st[c % RING];
      load_rows<N, L::RAW, THREADS1>(stg.k, K + base, row_stride, c * C, S);
      load_rows<N, L::F, THREADS1>(stg.w, W + base, row_stride, c * C, S);
      load_rows<MB, L::V1, THREADS1>(stg.v, V + base + col0, row_stride, c * C, S);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < RING - 1; ++c) load_chunk(c);

  for (int c = 0; c < nc; ++c) {
    const auto& stg = sm.st[c % RING];
    cp_async_wait<RING - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's reads of kd and of its stage are done
    load_chunk(c + RING - 1);  // into chunk c - 1's stage

    if (threadIdx.x < N) {  // one thread a channel: the log2 decay, summed in order
      const int n = threadIdx.x;
      // every load before the first store into kd, which the compiler
      // cannot tell apart from the stage it reads (its index is not known
      // at compile time)
      float la[C];
      float kv[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        la[i] = stg.w[i * L::F + n];
        kv[i] = repro::to_f32(stg.k[i * L::RAW + n]);
      }
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        a += la[i] * LOG2E;
        la[i] = a;
      }
#pragma unroll
      for (int i = 0; i < C; ++i) sm.kd[i * L::F + n] = kv[i] * ex2(a - la[i]);
      sm.dec[n] = ex2(a);
    }
    __syncthreads();

    if (owns) {
      float* out = scratch + (static_cast<size_t>(bh) * nc + c) * N * N;
      const float d0 = sm.dec[row];
      const float d1 = sm.dec[row + 8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(out + row * N + col) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (row + 8) * N + col) = make_float2(acc[nt][2], acc[nt][3]);
        acc[nt][0] *= d0;
        acc[nt][1] *= d0;
        acc[nt][2] *= d1;
        acc[nt][3] *= d1;
      }
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        const Split<4> a = frag_a_t(sm.kd, L::F, 16 * warp, 16 * ks);  // (kd^T)[n][j]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_split<V_EXACT>(acc[nt], a, frag_b_kn(stg.v, L::V1, 16 * ks, 8 * nt));
      }
    }
  }

  if (owns) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(state_out + st_off + row * N + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(state_out + st_off + (row + 8) * N + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: each chunk's output from the state entering it
// ---------------------------------------------------------------------------
template <typename T, int N>
struct OutSmem {
  alignas(16) T r[C * Ld<T, N>::RAW];
  alignas(16) T k[C * Ld<T, N>::RAW];
  alignas(16) T v[C * Ld<T, N>::RAW];
  alignas(16) float la[C * Ld<T, N>::F];   // w_log, then its inclusive cumsum in log2 units
  alignas(16) float s[N * Ld<T, N>::F];    // the state entering the chunk
  // rows < SUB: k_j exp(la_b - la_j); rows >= SUB: r_i exp(la_prev_i - la_b);
  // once the scores are formed, r_i exp(la_prev_i) (62 KB a CTA less 9 KB: four fit an SM)
  alignas(16) float qk[C * Ld<T, N>::A];
  alignas(16) float att[C * Ld<T, N>::ATT];
  float diag[C];
  float u[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS2)
wkv6_out_kernel(const T* __restrict__ R, const T* __restrict__ K, const T* __restrict__ V,
                const float* __restrict__ W, const float* __restrict__ U,
                const float* __restrict__ scratch, float* __restrict__ O, int S, int H) {
  using L = Ld<T, N>;
  constexpr bool V_EXACT = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  OutSmem<T, N>& sm = *reinterpret_cast<OutSmem<T, N>*>(smem_raw);

  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = c * C;
  const int warp = threadIdx.x / 32;
  const int g = lane_g();
  const int t = lane_t();
  const size_t row_stride = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * N;

  // group 0: the chunk's inputs; group 1: the state entering it, which lands
  // while the decays and scores are formed
  load_rows<N, L::RAW, THREADS2>(sm.r, R + base, row_stride, t0, S);
  load_rows<N, L::RAW, THREADS2>(sm.k, K + base, row_stride, t0, S);
  load_rows<N, L::RAW, THREADS2>(sm.v, V + base, row_stride, t0, S);
  load_rows<N, L::F, THREADS2>(sm.la, W + base, row_stride, t0, S);
  cp_async_commit();
  const float* st = scratch + (static_cast<size_t>(bh) * nc + c) * N * N;
  for (int idx = threadIdx.x; idx < N * N / 4; idx += THREADS2) {
    const int n = idx / (N / 4);
    const int p = idx % (N / 4);
    cp_async16(sm.s + n * L::F + 4 * p, st + n * N + 4 * p, true);
  }
  cp_async_commit();
  for (int n = threadIdx.x; n < N; n += THREADS2) sm.u[n] = U[static_cast<size_t>(h) * N + n];
  cp_async_wait<1>();
  __syncthreads();

  // 1. the cumulative log2 decay, one thread a channel, summed in order
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      a += sm.la[i * L::F + n] * LOG2E;
      sm.la[i * L::F + n] = a;
    }
  }
  __syncthreads();

  // 2. the scores' decayed operands; la_prev_i = la_{i-1}, la_b = la_{SUB-1}
#pragma unroll
  for (int it = 0; it < C * N / THREADS2; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * THREADS2;
    const int i = idx / N;
    const int n = idx % N;
    const float lb = sm.la[(SUB - 1) * L::F + n];
    sm.qk[i * L::A + n] = i < SUB ? repro::to_f32(sm.k[i * L::RAW + n]) * ex2(lb - sm.la[i * L::F + n])
                                  : repro::to_f32(sm.r[i * L::RAW + n]) * ex2(sm.la[(i - 1) * L::F + n] - lb);
  }
  __syncthreads();

  // 3. the scores att[i][j], j < i, and the u-bonus diagonal
  if (warp < 2) {  // rows SUB.., columns 8 warp .. 8 warp + 7 of the off-diagonal block
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      mma_split<false>(d, frag_a(sm.qk, L::A, SUB, 16 * ks), frag_b_nk(sm.qk, L::A, 16 * ks, 8 * warp));
    float* a0 = sm.att + (SUB + g) * L::ATT + 8 * warp + 2 * t;
    a0[0] = d[0];
    a0[1] = d[1];
    a0[8 * L::ATT] = d[2];
    a0[8 * L::ATT + 1] = d[3];
  }
  {
    // row i, columns jb + q + Q e of its diagonal block (and every Q-th one past it)
    const int i = threadIdx.x / Q;
    const int q = threadIdx.x % Q;
    const int jb = (i / SUB) * SUB;
    float acc[SUB / Q];
#pragma unroll
    for (int e = 0; e < SUB / Q; ++e) acc[e] = 0.f;
    if (i > jb + q) {
      // four channels a step, as 16-byte (8-byte for bf16) loads: a warp's
      // rows are few and broadcast, so narrow loads would waste wavefronts
      for (int n = 0; n < N; n += 4) {
        const float4 lpi = *reinterpret_cast<const float4*>(sm.la + (i - 1) * L::F + n);
        float ri[4];
        load4(sm.r + i * L::RAW + n, ri);
#pragma unroll
        for (int e = 0; e < SUB / Q; ++e) {
          const int j = jb + q + Q * e;
          if (j < i) {
            const float4 laj = *reinterpret_cast<const float4*>(sm.la + j * L::F + n);
            float kj[4];
            load4(sm.k + j * L::RAW + n, kj);
            acc[e] = fmaf(ri[0] * kj[0], ex2(lpi.x - laj.x), acc[e]);
            acc[e] = fmaf(ri[1] * kj[1], ex2(lpi.y - laj.y), acc[e]);
            acc[e] = fmaf(ri[2] * kj[2], ex2(lpi.z - laj.z), acc[e]);
            acc[e] = fmaf(ri[3] * kj[3], ex2(lpi.w - laj.w), acc[e]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < SUB / Q; ++e) {
      const int j = jb + q + Q * e;
      sm.att[i * L::ATT + j] = j < i ? acc[e] : 0.f;
    }
    for (int j = jb + SUB + q; j < C; j += Q) sm.att[i * L::ATT + j] = 0.f;
    float dg = 0.f;
    for (int n = q; n < N; n += Q)
      dg = fmaf(repro::to_f32(sm.r[i * L::RAW + n]) * sm.u[n], repro::to_f32(sm.k[i * L::RAW + n]), dg);
#pragma unroll
    for (int o = 1; o < Q; o <<= 1) dg += __shfl_xor_sync(0xffffffffu, dg, o);
    if (q == 0) sm.diag[i] = dg;
  }
  __syncthreads();

  // 4. rd = r_i exp(la_prev_i), the inter-chunk operand, over qk
#pragma unroll
  for (int it = 0; it < C * N / THREADS2; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * THREADS2;
    const int i = idx / N;
    const int n = idx % N;
    const float lp = i ? sm.la[(i - 1) * L::F + n] : 0.f;
    sm.qk[i * L::A + n] = repro::to_f32(sm.r[i * L::RAW + n]) * ex2(lp);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. out = rd @ S + att @ v + diag v; warp: rows 16 mt .., columns n0 .. n0 + N / WPM - 1
  constexpr int NT = N / WPM / 8;
  static_assert(NT >= 1 && N % (8 * WPM) == 0, "pass 2: whole n-tiles a warp");
  const int mt = warp / WPM;
  const int n0 = (warp % WPM) * (N / WPM);
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    const Split<4> a = frag_a(sm.qk, L::A, 16 * mt, 16 * ks);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_split<false>(acc[nt], a, frag_b_kn(sm.s, L::F, 16 * ks, n0 + 8 * nt));
  }
  for (int ks = 0; ks <= mt; ++ks) {  // att is zero right of the diagonal block
    const Split<4> a = frag_a(sm.att, L::ATT, 16 * mt, 16 * ks);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_split<V_EXACT>(acc[nt], a, frag_b_kn(sm.v, L::RAW, 16 * ks, n0 + 8 * nt));
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * mt + g + 8 * half;
    if (t0 + i >= S) continue;
    const float dg = sm.diag[i];
    float* o = O + base + static_cast<size_t>(t0 + i) * row_stride;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(o + col) =
          make_float2(fmaf(dg, repro::to_f32(sm.v[i * L::RAW + col]), acc[nt][2 * half]),
                      fmaf(dg, repro::to_f32(sm.v[i * L::RAW + col + 1]), acc[nt][2 * half + 1]));
    }
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* out, float* state_out, float* scratch, int b, int s, int h,
           cudaStream_t stream) {
  if (s <= 0 || b * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (s + C - 1) / C;
  const size_t sm1 = sizeof(StatesSmem<T, N>);
  const size_t sm2 = sizeof(OutSmem<T, N>);  // 53 KB at N = 64 bf16: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(wkv6_states_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sm1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv6_out_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  wkv6_states_kernel<T, N><<<dim3(N / MB, b * h), THREADS1, sm1, stream>>>(kt, vt, w, state_in, state_out,
                                                                         scratch, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_out_kernel<T, N><<<dim3(nc, b * h), THREADS2, sm2, stream>>>(rt, kt, vt, w, u, scratch, out, s, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* r, const void* k, const void* v, const float* w, const float* u,
               const float* state_in, float* out, float* state_out, float* scratch, int b, int s, int h,
               int n, cudaStream_t stream) {
  switch (n) {
    case 32: return launch<T, 32>(r, k, v, w, u, state_in, out, state_out, scratch, b, s, h, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, state_in, out, state_out, scratch, b, s, h, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (b, s, h, n) in `dtype`; w, out: (b, s, h, n) f32; u: (h, n) f32;
// state_in (nullable) and state_out: (b, h, n, n) f32; scratch: (b, h,
// ceil(s / 32), n, n) f32; all contiguous and 16-byte aligned. Launches pass 1
// then pass 2 on `stream`.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state_in, void* out, void* state_out,
                              void* scratch, int b, int s, int h, int n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* si = static_cast<const float*>(state_in);
  auto* of = static_cast<float*>(out);
  auto* so = static_cast<float*>(state_out);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == repro::DTYPE_F32)
    return dispatch_n<float>(r, k, v, wf, uf, si, of, so, sc, b, s, h, n, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_n<__nv_bfloat16>(r, k, v, wf, uf, si, of, so, sc, b, s, h, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_STRERROR(rwkv6_scan)
