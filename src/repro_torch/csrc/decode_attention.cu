// D1: one query token's attention over a KV cache, split along the cache's
// rows (split-K, "flash decoding"), read in place in its own dtype.
//
// No Pallas kernel of the reference computes this: its decode attention is
// plain XLA (`decode_attention`, src/repro/models/attention.py:183; the ring
// cache's `_local_ring_attend`, src/repro/models/transformer.py:132), where
// XLA may fuse `k_cache.astype(float32)` into the product's read of the
// cache. Eager PyTorch cannot: a transliteration writes an f32 copy of each
// whole cache, every layer of every decode step. This kernel reads each bf16
// (or f32) K and V row once, through the cache's strides, and keeps every
// sum in f32.
//
// The function: for each (b, h), over the rows r of a (B, S, kv, D) cache
// whose key position p (offset + r, or pos[r] for a ring, -1 an empty slot)
// lies in [lo, hi), with logit = (q . k_r) * scale:
//   m = max logit, l = sum exp(logit - m), o = sum exp(logit - m) v_r,
// all f32. The caller divides o by l, or combines ranks' partials first
// (models/attention.py split_k_combine). No valid row: m = NEG_INF, l = 0,
// o = 0. The wrapper (kernels/decode_attention.py) turns [lo, hi) into the
// row range [r_begin, r_end) to read when there is no pos; with pos every
// slot is read and masked (a ring holds at most its window).
//
// Layout. One CTA of WARPS warps per (split, kv head, b); the g = H / kv
// query heads of that kv head (g <= G <= 16) are staged in shared memory once.
// A row is read by L lanes (L the power of two >= D / 8, at least 4), eight
// elements a lane (16 bytes of bf16), so a warp reads 32 / L rows at once and
// a CTA GROUPS row groups. The split's rows are dealt to the row groups
// round-robin, U rows a group a trip, each trip's rows loaded while the trip
// before is computed. Each lane keeps, per query head, an online softmax over
// its group's rows: the running max and sum and its 8 elements of o; the L
// lanes of a row sum each logit by shuffles.
// At the end the row groups merge, inside a warp by shuffles and across the
// warps through shared memory in a fixed order, and the CTA writes its
// split's (m, l, o). With more than one split a second launch merges the
// splits of each (b, h) in order. No atomics: a call gives the same bits on
// every run.
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W): the bytes. At
// phi3-mini's decode (8 x 2049 valid rows x 32 kv heads x 96, bf16) a layer
// reads 201.4 MB of K and V, 0.060 ms at 3.35 TB/s. A row does 4 g D FLOPs
// on 4 D bytes (bf16): g <= 16 FLOPs a byte, far below the ~295 where the
// tensor cores would bound it, so the products run as FMAs on the CUDA cores.
// The split count (kernels/decode_attention.py split_count) puts at least two
// CTAs on every SM where the cache has the rows for it.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_D = 256;
constexpr int MAX_SPLITS = 1024;  // the combine's weights in shared memory
constexpr float NEG_INF = -1e30f;  // the port's mask constant (kernels/ref.py)

// a call's pointers, strides and shapes
struct Args {
  const float* q;  // (B, H, D) f32, contiguous
  const void* k;   // (B, S, kv, D), unit stride along D, 16-byte aligned rows
  const void* v;
  long long k_sb, k_ss, k_sh;  // element strides of b, row, kv head
  long long v_sb, v_ss, v_sh;
  const int* pos;  // (S,) key position of each row, or nullptr
  float* part_m;   // (B, H, n_splits)
  float* part_l;   // (B, H, n_splits)
  float* part_o;   // (B, H, n_splits, D)
  int n_heads, d, g, r_begin, r_end, chunk, lo, hi;
  float scale;
};

// eight consecutive elements, as loaded: one 16-byte vector of bf16, two of f32
template <typename T>
struct Raw {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw(Raw<T>& r, const T* p) {
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < int(sizeof(T) / 2); ++i) r.w[i] = __ldg(src + i);
}

template <typename T>
__device__ __forceinline__ void zero_raw(Raw<T>& r) {
#pragma unroll
  for (int i = 0; i < int(sizeof(T) / 2); ++i) r.w[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void bf16x2(unsigned int x, float& a, float& b) {
  a = __uint_as_float(x << 16);  // the low half is the earlier element
  b = __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void to_f32(const Raw<__nv_bfloat16>& r, float f[8]) {
  bf16x2(r.w[0].x, f[0], f[1]);
  bf16x2(r.w[0].y, f[2], f[3]);
  bf16x2(r.w[0].z, f[4], f[5]);
  bf16x2(r.w[0].w, f[6], f[7]);
}

__device__ __forceinline__ void to_f32(const Raw<float>& r, float f[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(r.w[i].x);
    f[4 * i + 1] = __uint_as_float(r.w[i].y);
    f[4 * i + 2] = __uint_as_float(r.w[i].z);
    f[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}

// The rows r0 + u GROUPS + group (u < U) of this lane's group: its 8
// elements of each K and V row, and whether the row is valid (inside
// [r0, r_hi) and, on a ring, holding a position in [lo, hi)); an invalid
// row, or a lane past D, loads nothing and reads zeros.
template <typename T, int U, int GROUPS>
__device__ __forceinline__ void fetch(const Args& a, const T* kb, const T* vb, int r0, int r_hi,
                                      int group, bool active, Raw<T> (&kr)[U], Raw<T> (&vr)[U],
                                      bool (&ok)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * GROUPS + group;
    ok[u] = r < r_hi;
    if (ok[u] && a.pos != nullptr) {
      const int p = __ldg(a.pos + r);
      ok[u] = p >= a.lo && p < a.hi;
    }
    if (ok[u] && active) {
      load_raw(kr[u], kb + r * a.k_ss);
      load_raw(vr[u], vb + r * a.v_ss);
    } else {
      zero_raw(kr[u]);
      zero_raw(vr[u]);
    }
  }
}

template <typename T, int L, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Args a) {
  constexpr int R = 32 / L;          // rows a warp reads at once
  constexpr int GROUPS = WARPS * R;  // row groups of the CTA
  constexpr int U = G >= 8 ? 1 : (G >= 4 ? 2 : 4);  // rows a group has in flight
  __shared__ __align__(16) float smem[G * MAX_D];    // q, then the merged o
  __shared__ float warp_m[WARPS][G];
  __shared__ float warp_l[WARPS][G];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % L;                 // this lane's 8-element chunk of a row
  const int group = warp * R + lane / L;   // this lane's row group
  const int d = a.d, g = a.g;
  const bool active = li * 8 < d;
  const int head0 = kvh * g;

  // q, zero past g heads and D columns: the row loop then runs every one of
  // the G heads and 8 lanes' columns without a branch (the compiler can
  // interleave the heads), and what lies past them sums to 0
  const float* qb = a.q + (static_cast<size_t>(b) * a.n_heads + head0) * d;
  for (int i = tid; i < G * MAX_D; i += THREADS) {
    const int j = i / MAX_D, c = i % MAX_D;
    smem[i] = j < g && c < d ? qb[j * d + c] : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  const int r_lo = min(a.r_begin + split * a.chunk, a.r_end);
  const int r_hi = min(r_lo + a.chunk, a.r_end);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh + li * 8;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh + li * 8;

  // a trip's U rows per group, loaded one trip ahead of their use
  Raw<T> kr[U], vr[U];
  bool ok[U];
  fetch<T, U, GROUPS>(a, kb, vb, r_lo, r_hi, group, active, kr, vr, ok);
  for (int r0 = r_lo; r0 < r_hi; r0 += GROUPS * U) {  // the same trips for every thread
    Raw<T> kn[U], vn[U];
    bool okn[U];
    fetch<T, U, GROUPS>(a, kb, vb, r0 + GROUPS * U, r_hi, group, active, kn, vn, okn);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8], vf[8];
      to_f32(kr[u], kf);
      to_f32(vr[u], vf);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4 q0 = *reinterpret_cast<const float4*>(&smem[j * MAX_D + li * 8]);
        const float4 q1 = *reinterpret_cast<const float4*>(&smem[j * MAX_D + li * 8 + 4]);
        float s = q0.x * kf[0];
        s = fmaf(q0.y, kf[1], s);
        s = fmaf(q0.z, kf[2], s);
        s = fmaf(q0.w, kf[3], s);
        s = fmaf(q1.x, kf[4], s);
        s = fmaf(q1.y, kf[5], s);
        s = fmaf(q1.z, kf[6], s);
        s = fmaf(q1.w, kf[7], s);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        // an invalid row leaves the state as it is: alpha 1, p 0 (its v is 0)
        s *= a.scale;
        const float mn = ok[u] ? fmaxf(m[j], s) : m[j];
        const float alpha = __expf(m[j] - mn);
        const float p = ok[u] ? __expf(s - mn) : 0.f;
        l[j] = fmaf(l[j], alpha, p);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(acc[j][e], alpha, p * vf[e]);
        m[j] = mn;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
      ok[u] = okn[u];
    }
  }

  // merge the warp's row groups: lanes L, 2L, ... apart hold the same chunk
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
        const float lsum = __shfl_xor_sync(0xffffffffu, l[j], off);
        const float mn = fmaxf(m[j], mo);
        const float a1 = __expf(m[j] - mn), a2 = __expf(mo - mn);
        l[j] = l[j] * a1 + lsum * a2;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float oo = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
          acc[j][e] = acc[j][e] * a1 + oo * a2;
        }
        m[j] = mn;
      }
    }
  }

  // merge the warps, in order, into shared memory (q is no longer read)
  const bool lead = lane < L;  // row group 0 of the warp holds the warp's merge
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < g) {
        warp_m[warp][j] = m[j];
        warp_l[warp][j] = l[j];
      }
    }
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && lead && active) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < g) {
          float top = warp_m[0][j];
#pragma unroll
          for (int x = 1; x < WARPS; ++x) top = fmaxf(top, warp_m[x][j]);
          const float wgt = __expf(m[j] - top);
          float* dst = &smem[j * MAX_D + li * 8];
#pragma unroll
          for (int e = 0; e < 8; ++e) dst[e] = (w == 0 ? 0.f : dst[e]) + acc[j][e] * wgt;
        }
      }
    }
    __syncthreads();
  }

  const size_t row0 = static_cast<size_t>(b) * a.n_heads + head0;  // (b, h) of query head 0
  for (int i = tid; i < g * d; i += THREADS) {
    const int j = i / d, c = i % d;
    a.part_o[((row0 + j) * n_splits + split) * d + c] = smem[j * MAX_D + c];
  }
  if (tid < g) {
    float top = warp_m[0][tid];
#pragma unroll
    for (int x = 1; x < WARPS; ++x) top = fmaxf(top, warp_m[x][tid]);
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) sum += warp_l[x][tid] * __expf(warp_m[x][tid] - top);
    a.part_m[(row0 + tid) * n_splits + split] = top;
    a.part_l[(row0 + tid) * n_splits + split] = sum;
  }
}

// The splits of one (b, h) merged in order: a block a (b, h), a thread a
// column of o. Each split's weight exp(m_s - max) is formed once, in shared
// memory, so a column's loop over the splits only loads and adds.
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_o, float* __restrict__ m,
                      float* __restrict__ l, float* __restrict__ o, int d, int n_splits) {
  __shared__ float wgt[MAX_SPLITS];
  __shared__ float top_s;
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_splits;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) wgt[s] = pm[s];
  __syncthreads();
  if (threadIdx.x == 0) {
    float top = NEG_INF;
    for (int s = 0; s < n_splits; ++s) top = fmaxf(top, wgt[s]);
    top_s = top;
  }
  __syncthreads();
  const float top = top_s;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) wgt[s] = __expf(wgt[s] - top);
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) sum += part_o[(bh * n_splits + s) * d + c] * wgt[s];
    o[bh * d + c] = sum;
  }
  if (threadIdx.x == 0) {
    const float* pl = part_l + bh * n_splits;
    float sum = 0.f;
    for (int s = 0; s < n_splits; ++s) sum += pl[s] * wgt[s];
    m[bh] = top;
    l[bh] = sum;
  }
}

template <typename T, int L>
void launch_g(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.g <= 1)
    decode_attention_kernel<T, L, 1><<<grid, THREADS, 0, st>>>(a);
  else if (a.g <= 4)
    decode_attention_kernel<T, L, 4><<<grid, THREADS, 0, st>>>(a);
  else if (a.g <= 8)
    decode_attention_kernel<T, L, 8><<<grid, THREADS, 0, st>>>(a);
  else
    decode_attention_kernel<T, L, 16><<<grid, THREADS, 0, st>>>(a);
}

template <typename T>
void launch_l(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.d <= 32)
    launch_g<T, 4>(a, grid, st);
  else if (a.d <= 64)
    launch_g<T, 8>(a, grid, st);
  else if (a.d <= 128)
    launch_g<T, 16>(a, grid, st);
  else
    launch_g<T, 32>(a, grid, st);
}

}  // namespace

// q (B, H, D) f32 contiguous; k, v (B, S, kv, D) of `dtype`, element strides
// (b, row, kv head), unit stride along D, 16-byte aligned rows; pos (S,) int32
// or null. Writes m, l (B, H) and o (B, H, D) f32; with n_splits > 1 through
// part_m, part_l (B, H, n_splits) and part_o (B, H, n_splits, D), which the
// caller allocates (with n_splits == 1 they may be m, l and o themselves).
// D a multiple of 8 up to 256, 1 <= g = H / kv <= 16.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, const void* pos, void* part_m, void* part_l,
    void* part_o, void* m, void* l, void* o, int batch, int n_kv, int n_heads, int d,
    int r_begin, int r_end, int chunk, int n_splits, int lo, int hi, float scale, int dtype,
    void* stream) {
  if (batch <= 0 || batch > 65535 || n_kv <= 0 || n_kv > 65535 || n_heads % n_kv != 0 ||
      n_heads / n_kv > 16 || d <= 0 || d % 8 != 0 || d > MAX_D || n_splits <= 0 ||
      n_splits > MAX_SPLITS ||
      r_begin > r_end || chunk < 0 || static_cast<long long>(chunk) * n_splits < r_end - r_begin)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), k, v, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         static_cast<const int*>(pos), static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_o), n_heads, d, n_heads / n_kv, r_begin, r_end, chunk, lo, hi,
         scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_splits, n_kv, batch);
  if (dtype == repro::DTYPE_F32)
    launch_l<float>(a, grid, st);
  else if (dtype == repro::DTYPE_BF16)
    launch_l<__nv_bfloat16>(a, grid, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  decode_combine_kernel<<<batch * n_heads, THREADS, 0, st>>>(
      a.part_m, a.part_l, a.part_o, static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(o), d, n_splits);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(decode_attention)
