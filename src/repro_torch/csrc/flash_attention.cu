// K3: causal (or full) flash attention over (B, H, S, D) with online softmax.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py:56,
// body `_flash_kernel` :18). The TPU grid walked KV tiles in order on one
// core and carried m/l/acc in VMEM scratch; here a CTA loops over KV tiles
// itself -- only up to the diagonal when causal -- with m, l and the output
// accumulator in f32 registers. Same numerics as the reference: scale
// 1/sqrt(D) after the dot, mask -1e30 on global positions, out = acc /
// max(l, 1e-30). One launch per call; any S, the ragged edge masked; D in
// {32, 64, 80, 96, 128, 160} as a template parameter (96 is Phi-3's head_dim,
// 80 StableLM-3B's, 160 StableLM-12B's).
//
// Two paths, chosen by dtype alone:
// - bf16, flash_fwd_wgmma_kernel: one CTA per (b*h, 128-row q tile), causal
//   tiles heaviest first. Warp 8 is the producer: its lane 0 loads the Q
//   tile once and keeps a 2-stage ring of (64-key K, V) tiles filled by TMA
//   (3-D maps over (D, S, B*H), so rows past S read as zero), with a full and
//   an empty mbarrier per stage. Warps 0-7 are two consumer warpgroups of 64
//   q rows each: S = Q K^T by wgmma.m64n64k16 from shared memory (both
//   K-major), the online softmax in registers (a row's 16 scores per thread,
//   reduced across the row's four lanes), then O += P V by wgmma.m64nDk16
//   with P converted to bf16 in registers as the A operand and V read
//   MN-major (transpose bit). Every tile is stored in TMA's 64-byte swizzle
//   in 32-column boxes: D / 32 of them where 32 divides D (160 = 5 x 32).
//   D = 80 is not a whole number of boxes. Of the two ways to take it -- a
//   16-column tail box in the 32-byte swizzle with descriptors of its own,
//   or the 96-column tile of D = 96 with columns 80-95 left to TMA's zero
//   fill -- the kernel takes the second, because the first would need a
//   second swizzle mode, its own descriptors and a P V split in two, where
//   the second changes no descriptor: the tensor maps keep an inner
//   dimension of 80 (rows of 160 bytes, a multiple of 16), so the third box
//   of every row reads 16 real columns and 16 zeros. It is exact: Q K^T
//   runs only the D / 16 = 5 steps of real columns (the zeros would add
//   nothing), and P V runs m64n80k16, whose B operand is the first 80
//   columns of the 96-wide V tile (on the card it gave the errors that
//   m64n96k16 over the whole tile gives). It costs the 16 zero columns'
//   shared memory and TMA traffic, none of device memory's bytes. D = 160's Q tile (40 KB) and two stages
//   of K and V (20 KB each a stage) take 120 KB; its O accumulator is 80 f32
//   a thread beside the 32 scores.
// - f32, flash_fwd_kernel: f32 FMA on the CUDA cores, 64-row q tiles, four
//   threads a row (no model runs attention in f32).
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (1, 32, 2048, 96) bf16 causal, 25.8 GFLOP of
// the 4 D S(S+1)/2 B H the causal mask leaves against 50 MB of q, k, v and
// out, so the tensor cores (989 TFLOP/s) would bound it at ~26 us. The bf16
// kernel does not overlap one warpgroup's softmax with its own products; the
// other warpgroup's products fill that gap only in part.
#include "wgmma_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: thread t owns q row t / 4 of a 64-row tile; the four threads of a row
// split its 64 keys (key lane + 4 i) for the scores and its D columns (float4
// chunk lane + 4 c) for the output, and reduce row max and row sum with two
// warp shuffles. Q, K and V tiles sit in shared memory with row strides of
// D + 4 floats, which puts the eight rows a warp reads at once on distinct
// banks.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;  // 4 threads per q row

template <int D>
struct Smem {
  static constexpr int ROW = D + 4;     // q/k/v row stride, = 4 (mod 32) floats
  static constexpr int PROW = BKV + 4;  // probability row stride
  static constexpr size_t bytes = sizeof(float) * (static_cast<size_t>(BQ) * ROW +
                                                   2 * static_cast<size_t>(BKV) * ROW +
                                                   static_cast<size_t>(BQ) * PROW);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                 T* __restrict__ O, int S, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int ROW = Smem<D>::ROW;
  constexpr int PROW = Smem<D>::PROW;
  constexpr int NC = D / 16;       // float4 output chunks per thread
  constexpr int NS = BKV / 4;      // scores per thread per KV tile
  extern __shared__ float smem[];
  float* qs = smem;                // [BQ][ROW]
  float* ks = qs + BQ * ROW;       // [BKV][ROW]
  float* vs = ks + BKV * ROW;      // [BKV][ROW]
  float* ps = vs + BKV * ROW;      // [BQ][PROW]

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int lane = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + r;
  const size_t head = static_cast<size_t>(blockIdx.y) * S * D;
  const T* q = Q + head;
  const T* k = K + head;
  const T* v = V + head;
  T* o = O + head;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int rr = idx / D;
    const int dd = idx % D;
    qs[rr * ROW + dd] = (q0 + rr < S) ? repro::to_f32(q[static_cast<size_t>(q0 + rr) * D + dd]) : 0.f;
  }

  float m_run = NEG_INF;
  float l_run = 0.f;
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  int n_tiles = (S + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);  // skip tiles above the diagonal

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // q tile written (t == 0); last tile's k/v no longer read
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int j = idx / D;
      const int dd = idx % D;
      const bool in = k0 + j < S;
      const size_t g = static_cast<size_t>(k0 + j) * D + dd;
      ks[j * ROW + dd] = in ? repro::to_f32(k[g]) : 0.f;
      vs[j * ROW + dd] = in ? repro::to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(qs + r * ROW);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 qv = qrow[c];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 kv = reinterpret_cast<const float4*>(ks + (lane + 4 * i) * ROW)[c];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + lane + 4 * i;
      const bool keep = kpos < S && (!causal || qpos >= kpos);
      s[i] = keep ? s[i] * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);

    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + lane + 4 * i;
      const float p = kpos < S ? expf(s[i] - m_new) : 0.f;  // padding keys do not exist
      lsum += p;
      ps[r * PROW + lane + 4 * i] = p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();  // the row's four threads share one warp

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] *= alpha;
      acc[c][1] *= alpha;
      acc[c][2] *= alpha;
      acc[c][3] *= alpha;
    }
    const int kmax = min(BKV, S - k0);
    for (int j = 0; j < kmax; ++j) {
      const float p = ps[r * PROW + j];
      const float4* vrow = reinterpret_cast<const float4*>(vs + j * ROW);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vrow[lane + 4 * c];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
  }

  if (qpos < S) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* orow = o + static_cast<size_t>(qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 4 * (lane + 4 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[d0 + e] = repro::from_f32<T>(acc[c][e] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_BQ = 128;   // q rows a CTA: 64 per consumer warpgroup
constexpr int WG_BKV = 64;   // keys a KV tile
constexpr int KV_STAGES = 2;
constexpr int BOX = 32;      // columns a TMA box: 64 bytes, the swizzle's width
constexpr int WG_THREADS = repro::sm90::TILE_THREADS_WG;

template <int D>
struct WgSmem {
  static constexpr int DP = (D + BOX - 1) / BOX * BOX;  // D padded to whole boxes
  static constexpr int NB = DP / BOX;
  static constexpr uint32_t Q_BYTES = WG_BQ * DP * 2;    // NB boxes of 128 rows x 64 B
  static constexpr uint32_t KV_BYTES = WG_BKV * DP * 2;  // NB boxes of 64 rows x 64 B
  static constexpr uint32_t BARS = Q_BYTES + KV_STAGES * 2 * KV_BYTES;
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * KV_STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v, __nv_bfloat16* __restrict__ O,
                       int S, float scale, int causal) {
  using namespace repro::sm90;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  using L = WgSmem<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(align_smem(smem_raw));
  const uint32_t q_bar = base + L::BARS;
  const uint32_t full = q_bar + 8;                 // full[s] at full + 8 s
  const uint32_t empty = full + 8 * KV_STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // causal q tiles heaviest first, so that the last wave is the shortest
  const int qt = causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int q0 = qt * WG_BQ;
  int n_kv = (S + WG_BKV - 1) / WG_BKV;
  if (causal) n_kv = min(n_kv, (q0 + WG_BQ - 1) / WG_BKV + 1);  // skip tiles above the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) tma_load_3d(base + c * WG_BQ * 64, &map_q, q_bar, BOX * c, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % KV_STAGES;
        if (t >= KV_STAGES) mbar_wait(empty + 8 * s, ((t / KV_STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t ks = base + L::Q_BYTES + s * 2 * L::KV_BYTES;
        mbar_expect_tx(bar, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(ks + c * WG_BKV * 64, &map_k, bar, BOX * c, t * WG_BKV, bh);
          tma_load_3d(ks + L::KV_BYTES + c * WG_BKV * 64, &map_v, bar, BOX * c, t * WG_BKV, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q0 + 64 wg ...; this thread holds rows
  // row0 and row0 + 8 of them, and in each 8-column block j the columns
  // 8 j + 2 (lane % 4) and + 1 (the wgmma accumulator layout)
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  float o[D / 2];  // P V is m64nDk16: columns past D are never formed
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
  const uint32_t q_s = base + wg * 64 * 64;              // 64 bytes per row in each box
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_kv; ++t) {
    const int s = t % KV_STAGES;
    const int k0 = t * WG_BKV;
    const uint32_t k_s = base + L::Q_BYTES + s * 2 * L::KV_BYTES;
    const uint32_t v_s = k_s + L::KV_BYTES;
    mbar_wait(full + 8 * s, (t / KV_STAGES) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 of D a step: box kk / 2, 32 bytes in for odd kk
                                           // (padding columns past D are never read)
      const uint32_t off = (kk % 2) * 32;
      wgmma_ss_n64(sc, make_desc(q_s + (kk / 2) * WG_BQ * 64 + off, 16, 512, SWIZZLE_64B),
                   make_desc(k_s + (kk / 2) * WG_BKV * 64 + off, 16, 512, SWIZZLE_64B), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const bool edge = k0 + WG_BKV > S || (causal && k0 + WG_BKV - 1 > row0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale;
        float x1 = sc[4 * j + 2 + e] * scale;
        if (edge) {
          const int kpos = k0 + 8 * j + cq + e;
          if (kpos >= S || (causal && kpos > row0)) x0 = NEG_INF;
          if (kpos >= S || (causal && kpos > row1)) x1 = NEG_INF;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - mn0);
    const float alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // A masked or padding score is -1e30 and the row max is a real score
    // (key 0 is never masked), so its probability underflows to 0.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = __expf(sc[4 * j + e] - mn0);
        const float p1 = __expf(sc[4 * j + 2 + e] - mn1);
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P as wgmma's A fragment: keys 16 kk .. 16 kk + 15 are the score
    // blocks j = 2 kk, 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys a step: 16 rows of 64 bytes
      wgmma_rs_tb<D>(o, pa[kk], make_desc(v_s + 1024 * kk, WG_BKV * 64, 512, SWIZZLE_64B), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o_head = O + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o_head + static_cast<size_t>(row0) * D + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o_head + static_cast<size_t>(row1) * D + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;  // 94 KB at D = 96: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_fwd_kernel<float, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
                int causal, cudaStream_t stream) {
  // (D, S, B*H) in boxes of (32, rows, 1), 64-byte swizzle; at D = 80 the
  // third box of a row runs past D and TMA fills columns 80-95 with zeros
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box_q[3] = {BOX, WG_BQ, 1};
  const cuuint32_t box_kv[3] = {BOX, WG_BKV, 1};
  CUtensorMap map_q, map_k, map_v;
  int e = repro::sm90::encode_bf16_map(&map_q, q, 3, dims, strides, box_q, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = repro::sm90::encode_bf16_map(&map_k, k, 3, dims, strides, box_kv, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = repro::sm90::encode_bf16_map(&map_v, v, 3, dims, strides, box_kv, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != 0) return e;
  const size_t smem = WgSmem<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + WG_BQ - 1) / WG_BQ, bh);
  flash_fwd_wgmma_kernel<D><<<grid, WG_THREADS, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
           int causal, int dtype, cudaStream_t stream) {
  if (dtype == repro::DTYPE_F32) return launch_f32<D>(q, k, v, o, bh, s, scale, causal, stream);
  if (dtype == repro::DTYPE_BF16) return launch_bf16<D>(q, k, v, o, bh, s, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (bh, s, d) row-major and contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                   int s, int d, float scale, int causal, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, bh, s, scale, causal, dtype, st);
    case 64: return launch<64>(q, k, v, o, bh, s, scale, causal, dtype, st);
    case 80: return launch<80>(q, k, v, o, bh, s, scale, causal, dtype, st);
    case 96: return launch<96>(q, k, v, o, bh, s, scale, causal, dtype, st);
    case 128: return launch<128>(q, k, v, o, bh, s, scale, causal, dtype, st);
    case 160: return launch<160>(q, k, v, o, bh, s, scale, causal, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT_STRERROR(flash_attention)
