// D2: MLA's absorbed single-token attention over the latent cache, split
// along the cache's rows, with the query heads sharing each latent row on the
// tensor cores.
//
// No Pallas kernel of the reference computes this: it replaces the
// reference's absorbed decode (the branch of `mla_forward` at
// src/repro/models/attention.py:332), two einsums over the latents that XLA
// may fuse with their f32 cast. Eager PyTorch cannot: a transliteration writes
// an f32 copy of every layer's latent cache each decode step and runs both
// products in f32 on the CUDA cores. This kernel reads each bf16 row of `ckv`
// and `krope` once, in place through their strides, for all the heads of a
// tile, and keeps every sum in f32.
//
// The function: for each (b, h), over the rows r of the (B, S, R) latents
// `ckv` and (B, S, DR) `krope` in [r_begin, r_end) (the wrapper turns the key
// positions [lo, hi) into rows), with
//   logit_r = (q_lat[b, h] . ckv[b, r] + q_rope[b, h] . krope[b, r]) * scale,
//   m = max logit, l = sum exp(logit - m), o = sum exp(logit - m) ckv[b, r],
// all f32 (o is the latent output, (B, H, R)). The caller divides o by l, or
// combines ranks' partials first (models/attention.py split_k_combine). No
// row: m = NEG_INF, l = 0, o = 0.
//
// Layout. One CTA, one warpgroup, per (split, tile of HT = 16 heads, b). The
// split's rows come in tiles of BN = 64 by TMA into a ring of STAGES tiles in
// shared memory: ckv in boxes of 64 rows x 64 columns and krope in one such
// box, each 128-byte swizzled, columns past R or DR and rows past the call's
// last row read as zeros. The products run transposed on wgmma, the tile's
// rows or latent columns as the 64 rows of m64n16k16 and the heads as its 16
// columns, so no head is padded:
//   scores: S^T (64 rows x 16 heads) = [ckv | krope] tile (K-major, straight
//     from the ring) x [q_lat | q_rope]^T (the CTA's queries, written once
//     into shared memory in the same swizzle);
//   softmax: f32 online max and sum per head, the max over the tile's rows
//     met across the four warps in shared memory; P is rounded to bf16 only
//     as it is written for the next product, as K3 does;
//   output: O^T (R x 16) += ckv tile^T (MN-major, the same boxes read down
//     their columns) x P^T, one m64 block a box, held in registers (64 a
//     thread at R = 512).
// Each tile's load is issued as soon as its stage is free; the output product
// of one tile runs while the next tile's wait and scores are issued. With more
// than one split a second launch merges the splits of each (b, h) in order.
// No atomics: a call gives the same bits on every run.
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W): the bytes. At
// DeepSeek-V2-Lite's decode (48 sequences x 8193 rows x (512 + 64) bf16) a
// layer reads 453.0 MB of latents, 0.1352 ms at 3.35 TB/s. A row does
// 2 H (R + DR + R) FLOPs on 2 (R + DR) bytes: at H = 16, ~30 FLOPs a byte,
// above what the CUDA cores' f32 rate keeps up with at the memory's rate, far
// below the ~295 where the tensor cores would bound it. So the products run
// on the tensor cores, asynchronously beside the loads, and the split count
// (kernels/mla_decode.py split_count) fills the card's resident CTAs in
// whole waves.
#include "wgmma_tile.cuh"

namespace {

using namespace repro::sm90;

constexpr int THREADS = 128;   // one warpgroup
constexpr int HT = 16;         // query heads a CTA: the N of every wgmma
constexpr int BN = 64;         // cache rows a tile: the M of the scores' wgmma
constexpr int STAGES = 2;      // tiles in the shared-memory ring
constexpr int BOX = 64;        // columns a TMA box (128 bytes of bf16)
constexpr int MAX_R = 512;
constexpr int MAX_DR = 64;
constexpr int MAX_BOXES = MAX_R / BOX;  // ckv boxes a tile: the m64 blocks of O^T
constexpr uint32_t TILE_BOX_BYTES = BN * BOX * 2;  // a box of the ring
constexpr uint32_t Q_BOX_BYTES = HT * BOX * 2;     // a box of q, and P^T
constexpr int MAX_SPLITS = 1024;  // the combine's weights in shared memory
constexpr float NEG_INF = -1e30f;  // the port's mask constant (kernels/ref.py)

// a call's shapes and pointers; the latents come through the tensor maps
struct Args {
  const __nv_bfloat16* q_lat;   // (B, H, R), contiguous
  const __nv_bfloat16* q_rope;  // (B, H, DR), contiguous
  float* part_m;  // (B, H, n_splits)
  float* part_l;  // (B, H, n_splits)
  float* part_o;  // (B, H, n_splits, R)
  int n_heads, r, dr, r_begin, r_end, chunk;
  float scale;
};

// ckv boxes a row of width r takes
__host__ __device__ constexpr int boxes(int r) { return (r + BOX - 1) / BOX; }

__host__ __device__ constexpr uint32_t stage_bytes(int r) { return (boxes(r) + 1) * TILE_BOX_BYTES; }

// the ring, q's boxes, P^T, the per-head exchange [HT][4] and the mbarriers,
// from a 1024-byte aligned base
__host__ __device__ constexpr size_t smem_bytes(int r) {
  return STAGES * stage_bytes(r) + (boxes(r) + 1) * Q_BOX_BYTES + Q_BOX_BYTES +
         HT * 4 * sizeof(float) + STAGES * 8 + 1024;
}

// byte offset of bf16 element (row, col) of a K-major operand stored as
// 128-byte rows in the 128-byte swizzle (16-byte chunks XOR the row mod 8)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return static_cast<uint32_t>(row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 16, f32) += A (64 x 16) B (16 x 16), both from shared memory by
// descriptor, bf16; B K-major; A K-major (TA 0) or MN-major (TA 1)
template <int TA>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// K-major operand rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return make_desc(addr, 16, 1024, SWIZZLE_128B); }

// Rows row .. row + 63 of batch row b into stage s: the ckv boxes and the
// krope box, counted on the stage's mbarrier. One thread.
__device__ __forceinline__ void issue_tile(const CUtensorMap* ckv, const CUtensorMap* krope,
                                           uint32_t ring, uint32_t bars, int s, int nbox,
                                           int row, int b) {
  const uint32_t bar = bars + 8 * s;
  const uint32_t dst = ring + s * stage_bytes(nbox * BOX);
  mbar_expect_tx(bar, (nbox + 1) * TILE_BOX_BYTES);
  for (int bx = 0; bx < nbox; ++bx) tma_load_3d(dst + bx * TILE_BOX_BYTES, ckv, bar, bx * BOX, row, b);
  tma_load_3d(dst + nbox * TILE_BOX_BYTES, krope, bar, 0, row, b);
}

__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(__grid_constant__ const CUtensorMap map_ckv,
                  __grid_constant__ const CUtensorMap map_krope, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int split = blockIdx.x, h0 = blockIdx.y * HT, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = a.r, dr = a.dr, nbox = boxes(r);
  const uint32_t ring = smem_u32(smem);
  const uint32_t sb = stage_bytes(r);
  uint8_t* q_s = smem + STAGES * sb;                      // q's boxes [HT][BOX] each
  uint8_t* p_s = q_s + (nbox + 1) * Q_BOX_BYTES;          // P^T [HT heads][BN rows]
  float* red = reinterpret_cast<float*>(p_s + Q_BOX_BYTES);  // [HT][4 warps]
  const uint32_t bars = smem_u32(red + HT * 4);
  const uint32_t q_a = smem_u32(q_s), p_a = smem_u32(p_s);

  const int r_lo = min(a.r_begin + split * a.chunk, a.r_end);
  const int r_hi = min(r_lo + a.chunk, a.r_end);
  const int n_tiles = (r_hi - r_lo + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    for (int s = 0; s < STAGES && s < n_tiles; ++s)
      issue_tile(&map_ckv, &map_krope, ring, bars, s, nbox, r_lo + s * BN, b);
  }
  // the CTA's queries, zero past H heads and R or DR columns, into q's boxes
  // in the operand's swizzle: 16 bytes a thread a step
  for (int i = tid; i < HT * (nbox + 1) * (BOX / 8); i += THREADS) {
    const int head = i / ((nbox + 1) * (BOX / 8));
    const int c = i % ((nbox + 1) * (BOX / 8));  // 8-column chunk of [ckv boxes | krope box]
    const int bx = c / (BOX / 8), col = (c % (BOX / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const size_t bh = static_cast<size_t>(b) * a.n_heads + h0 + head;
    if (h0 + head < a.n_heads) {
      if (bx < nbox && bx * BOX + col < r)
        v = *reinterpret_cast<const uint4*>(a.q_lat + bh * r + bx * BOX + col);
      else if (bx == nbox && col < dr)
        v = *reinterpret_cast<const uint4*>(a.q_rope + bh * dr + col);
    }
    *reinterpret_cast<uint4*>(q_s + bx * Q_BOX_BYTES + swz(head, col)) = v;
  }
  fence_proxy_async();
  __syncthreads();

  // accumulator layout (m64n16): this thread's rows r0 = 16 warp + lane / 4
  // and r0 + 8, heads c0 = 2 (lane % 4), c0 + 1, c0 + 8, c0 + 9; register
  // 4 j + e holds head c0 + 8 j + (e & 1) at row r0 + 8 (e >> 1)
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float o[MAX_BOXES][8];
#pragma unroll
  for (int mt = 0; mt < MAX_BOXES; ++mt)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[mt][e] = 0.f;
  float m[4], l[4];  // per head q of this thread: c0 + 8 (q >> 1) + (q & 1)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m[q] = NEG_INF;
    l[q] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t st = ring + s * sb;
    mbar_wait(bars + 8 * s, (it / STAGES) & 1);

    // S^T = [ckv | krope] q^T over the k-steps that hold columns
    float sc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int bx = 0; bx <= MAX_BOXES; ++bx) {
      const bool rope = bx == MAX_BOXES;
      if (rope || bx < nbox) {
        const uint32_t at = st + (rope ? nbox : bx) * TILE_BOX_BYTES;
        const uint32_t bt = q_a + (rope ? nbox : bx) * Q_BOX_BYTES;
        const int width = rope ? dr : r - bx * BOX;
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk)
          if (kk * 16 < width) wgmma_n16<0>(sc, kmajor(at + 32 * kk), kmajor(bt + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // these scores, and the tile before's output product
    fence_regs(sc);
#pragma unroll
    for (int mt = 0; mt < MAX_BOXES; ++mt) fence_regs(o[mt]);

    // the tile's max per head: this thread's two rows, the warp's 16, then
    // the four warps' in shared memory
    const int row0 = r_lo + it * BN;
    const bool ok0 = row0 + r0 < r_hi, ok1 = row0 + r0 + 8 < r_hi;
    float tmax[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = ((e >> 1) & 1 ? ok1 : ok0) ? sc[e] * a.scale : NEG_INF;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float x = fmaxf(sc[(q >> 1) * 4 + (q & 1)], sc[(q >> 1) * 4 + 2 + (q & 1)]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
      tmax[q] = x;
    }
    if (lane < 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(c0 + 8 * (q >> 1) + (q & 1)) * 4 + warp] = tmax[q];
    }
    __syncthreads();  // and every warp's products of the tile before are done
    if (tid == 0 && it >= 1 && it + 1 < n_tiles)  // its stage is free
      issue_tile(&map_ckv, &map_krope, ring, bars, (it + 1) % STAGES, nbox, row0 + BN, b);
    float al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(&red[(c0 + 8 * (q >> 1) + (q & 1)) * 4]);
      const float mn = fmaxf(m[q], fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w)));
      al[q] = __expf(m[q] - mn);
      m[q] = mn;
    }

    // P in f32 for the sums, in bf16 into P^T [head][row] for the output
    // product; the output rescaled
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = 2 * (e >> 2) + (e & 1);
      const bool ok = (e >> 1) & 1 ? ok1 : ok0;
      const float pe = ok ? __expf(sc[e] - m[q]) : 0.f;
      l[q] = e & 2 ? l[q] + pe : fmaf(l[q], al[q], pe);
      const int head = c0 + 8 * (e >> 2) + (e & 1), row = r0 + 8 * ((e >> 1) & 1);
      *reinterpret_cast<__nv_bfloat16*>(p_s + swz(head, row)) = __float2bfloat16(pe);
    }
#pragma unroll
    for (int mt = 0; mt < MAX_BOXES; ++mt)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[mt][e] *= al[2 * (e >> 2) + (e & 1)];
    fence_proxy_async();
    __syncthreads();  // P^T is whole; the exchange is read

    // O^T += ckv tile^T P^T: each box an m64 block, read MN-major
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MAX_BOXES; ++mt) {
      if (mt < nbox) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_n16<1>(o[mt], make_desc(st + mt * TILE_BOX_BYTES + kk * 2048, TILE_BOX_BYTES, 1024,
                                        SWIZZLE_128B),
                       kmajor(p_a + 32 * kk));
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MAX_BOXES; ++mt) fence_regs(o[mt]);

  // l over the warp's rows, then the four warps'
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    l[q] += __shfl_xor_sync(0xffffffffu, l[q], 4);
    l[q] += __shfl_xor_sync(0xffffffffu, l[q], 8);
    l[q] += __shfl_xor_sync(0xffffffffu, l[q], 16);
  }
  __syncthreads();
  if (lane < 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[(c0 + 8 * (q >> 1) + (q & 1)) * 4 + warp] = l[q];
  }
  __syncthreads();
  const size_t bh = static_cast<size_t>(b) * a.n_heads + h0;
#pragma unroll
  for (int mt = 0; mt < MAX_BOXES; ++mt) {
    if (mt < nbox) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int head = c0 + 8 * (e >> 2) + (e & 1);
        const int col = mt * BOX + r0 + 8 * ((e >> 1) & 1);
        if (h0 + head < a.n_heads && col < r)
          a.part_o[((bh + head) * n_splits + split) * r + col] = o[mt][e];
      }
    }
  }
  if (warp == 0 && lane < 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int head = c0 + 8 * (q >> 1) + (q & 1);
      if (h0 + head < a.n_heads) {
        const float4 w = *reinterpret_cast<const float4*>(&red[head * 4]);
        a.part_m[(bh + head) * n_splits + split] = m[q];
        a.part_l[(bh + head) * n_splits + split] = (w.x + w.y) + (w.z + w.w);
      }
    }
  }
}

// The splits of one (b, h) merged in order: a block a (b, h), a thread four
// columns of o. Each split's weight exp(m_s - max) is formed once, in shared
// memory, so a column's loop over the splits only loads and adds.
__global__ void __launch_bounds__(THREADS)
mla_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_o, float* __restrict__ m,
                   float* __restrict__ l, float* __restrict__ o, int r, int n_splits) {
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
  for (int c = 4 * threadIdx.x; c < r; c += 4 * blockDim.x) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(&part_o[(bh * n_splits + s) * r + c]);
      const float w = wgt[s];
      sum.x += x.x * w;
      sum.y += x.y * w;
      sum.z += x.z * w;
      sum.w += x.w * w;
    }
    *reinterpret_cast<float4*>(&o[bh * r + c]) = sum;
  }
  if (threadIdx.x == 0) {
    const float* pl = part_l + bh * n_splits;
    float sum = 0.f;
    for (int s = 0; s < n_splits; ++s) sum += pl[s] * wgt[s];
    m[bh] = top;
    l[bh] = sum;
  }
}

bool shapes_ok(int r, int dr) {
  return r % 8 == 0 && r >= 8 && r <= MAX_R && dr % 8 == 0 && dr >= 8 && dr <= MAX_DR;
}

// the largest ring the kernel may use, allowed once per device before its
// first launch (never inside a CUDA graph's capture, which the first launch
// precedes)
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(MAX_R)));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// A (B, S, width) bf16 latent cache as a 3-d map (width, rows, b) of boxes
// of 64 rows x 64 columns, 128-byte swizzled; rows past `rows` and columns
// past `width` read as zeros.
int encode_latents(CUtensorMap* map, const void* ptr, int width, int rows, int batch,
                   long long sb, long long ss) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {BOX, BN, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// CTAs of the kernel one SM holds at once for latents of width (r, dr), into
// *out; on the current device.
extern "C" int mla_decode_ctas_per_sm(int r, int dr, int* out) {
  if (!shapes_ok(r, dr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, mla_decode_kernel, THREADS, smem_bytes(r)));
}

// q_lat (B, H, R), q_rope (B, H, DR) bf16 contiguous with 16-byte aligned
// rows; ckv (B, S, R), krope (B, S, DR) bf16 with element strides (b, row),
// unit stride along the last dim and 16-byte aligned rows. Reads rows
// [r_begin, r_end), split i taking [r_begin + i chunk, + chunk). Writes m, l
// (B, H) and o (B, H, R) f32; with n_splits > 1 through part_m, part_l (B, H,
// n_splits) and part_o (B, H, n_splits, R), which the caller allocates (with
// n_splits == 1 they may be m, l and o themselves). R and DR multiples of 8
// up to 512 and 64.
extern "C" int mla_decode_launch(const void* q_lat, const void* q_rope, const void* ckv,
                                 const void* krope, long long c_sb, long long c_ss,
                                 long long k_sb, long long k_ss, void* part_m, void* part_l,
                                 void* part_o, void* m, void* l, void* o, int batch, int n_heads,
                                 int s_rows, int r, int dr, int r_begin, int r_end, int chunk,
                                 int n_splits, float scale, void* stream) {
  const int head_tiles = (n_heads + HT - 1) / HT;
  if (batch <= 0 || batch > 65535 || n_heads <= 0 || head_tiles > 65535 || !shapes_ok(r, dr) ||
      n_splits <= 0 || n_splits > MAX_SPLITS || r_begin > r_end || r_end > s_rows || chunk < 0 ||
      static_cast<long long>(chunk) * n_splits < r_end - r_begin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_ckv, map_krope;
  const int rows = r_end > 0 ? r_end : 1;  // the map's row extent: reads past r_end are zeros
  int e = encode_latents(&map_ckv, ckv, r, rows, batch, c_sb, c_ss);
  if (e == 0) e = encode_latents(&map_krope, krope, dr, rows, batch, k_sb, k_ss);
  if (e != 0) return e;
  const Args a{static_cast<const __nv_bfloat16*>(q_lat), static_cast<const __nv_bfloat16*>(q_rope),
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_o), n_heads, r, dr, r_begin, r_end, chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_decode_kernel<<<dim3(n_splits, head_tiles, batch), THREADS, smem_bytes(r), st>>>(
      map_ckv, map_krope, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  mla_combine_kernel<<<batch * n_heads, THREADS, 0, st>>>(
      a.part_m, a.part_l, a.part_o, static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(o), r, n_splits);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(mla_decode)
