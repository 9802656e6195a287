// K3: causal (or full) flash attention over (B, H, S, D) with online softmax.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py:56,
// body `_flash_kernel` :18). One CTA per (b*h, 64-row q tile). The TPU grid
// walked KV tiles in order on one core and carried m/l/acc in VMEM scratch;
// here the CTA loops over KV tiles itself -- only up to the diagonal when
// causal -- with m, l and the output accumulator in f32 registers. Same
// numerics as the reference: scale 1/sqrt(D) after the dot, mask -1e30 on
// global positions, out = acc / max(l, 1e-30).
//
// Layout: thread t owns q row t / 4 of the tile; the four threads of a row
// split its 64 keys (key lane + 4 i) for the scores and its D columns (float4
// chunk lane + 4 c) for the output, and reduce row max and row sum with two
// warp shuffles. Q, K and V tiles are converted to f32 in shared memory with
// row strides of D + 4 floats, which puts the eight rows a warp reads at once
// on distinct banks. D is a template parameter: 96 (Phi-3's head_dim, not a
// power of two), 64 and 128, and 32 for the reduced test configurations.
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (1, 32, 2048, 96) bf16 causal, 25.8 GFLOP of
// the 4 D S(S+1)/2 B H the causal mask leaves against 50 MB of q, k, v and
// out, so the tensor cores (989 TFLOP/s) would bound it at ~26 us. This first
// version runs f32 FMA on the CUDA cores; mma/wgmma come later.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;  // 4 threads per q row
constexpr float NEG_INF = -1e30f;

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;  // 94 KB at D = 96: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
               float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, scale, causal, stream);
    case 96: return launch<T, 96>(q, k, v, o, bh, s, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: (bh, s, d) row-major and contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                   int s, int d, float scale, int causal, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_d<float>(q, k, v, o, bh, s, d, scale, causal, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, s, d, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_STRERROR(flash_attention)
