// G1: the routed experts of a dropless MoE route as two grouped products over
// the (token, choice) pairs sorted by expert, each expert's rows found on the
// device.
//
// No Pallas kernel of the reference computes this: the reference leaves the
// experts to XLA's batched einsums over capacity buckets
// (src/repro/models/moe.py moe_ffn), and so did the port. A dropless route
// has no capacity, so the port read each expert's count back to the host to
// size its buckets and ran the hot experts' rest one product at a time; the
// read stopped the host once a MoE layer. Here the grid depends only on the
// number of pairs: each CTA finds its expert and row block from the experts'
// counts in device memory, so nothing is read back and a layer is two
// launches.
//
// The function, for the N pairs sorted by expert (expert e's pairs are rows
// start_e .. start_e + counts[e] - 1 of xs, start_e the sum of the counts
// before e):
//   gate/up: h[i] = bf16(silu(xs[i] @ wg[e]) * (xs[i] @ wi[e])), (N, F), the
//     gate and up products both f32 and rounded once;
//   down: out[dest[i]] = bf16(weights[i] * (h[i] @ wo[e])), (N, D), with
//     dest a permutation of 0 .. N-1 (the caller's sort_idx: the pair's flat
//     (token, choice) slot), so every row of out is written exactly once,
//     with no atomics, and a call gives the same bits on every run. The
//     caller sums each token's k rows in a fixed order (models/moe.py).
//
// Layout: wgmma_tile.cuh's primitives. 288 threads: two consumer warpgroups,
// each 64 of the tile's BM = 128 pair rows, issuing wgmma.m64n128k16 from a
// ring of STAGES stages; warp 8's lane 0 keeps the ring filled by TMA. A: BM
// rows of xs or h from the expert's row block on (rows past N read as zeros,
// rows of the next expert are computed and never stored). B: 64 K rows of
// the expert's weights in 64-column boxes of a 3-d map over (E, K, N), two
// boxes an accumulator of 128 columns: down takes 256 columns of wo[e] into
// two accumulators; gate/up takes 128 columns of wg[e] into one and the same
// 128 of wi[e] into the other, and the epilogue pairs them in registers. A
// consumer warpgroup whose 64 rows all lie past the expert's last pair
// issues nothing (the empty barriers count only the warps that read). Four
// stages of 48 KB and 128 accumulators a thread hold one CTA an SM.
//
// Tile scheduling: the grid is (column tiles, ceil(N / BM) + E). Row tile y
// is expert e's row block y - (row blocks of the experts before e), e the
// expert whose blocks hold y; a warp finds it with a scan of the counts, 32
// experts a step. Tiles past the last block exit at once; an empty expert
// has no block. Column tiles run fastest, so the CTAs of one row block run
// together and the row blocks of one expert share its weights in L2.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit): the
// operations. At DeepSeek-V2-Lite's prompt (4096 tokens, top-6 of 64 experts,
// D 2048, F 1408) a layer's products are 2 x 24,576 x 3 x 2048 x 1408 =
// 425.2 GFLOP, 0.430 ms at 989 TFLOP/s; every expert's three matrices are
// 1.107 GB, 0.330 ms at 3.35 TB/s, so the tensor cores, not the weights'
// bytes, bound it: the products run on wgmma from a TMA ring, and the wasted
// rows of an expert's last row block are cut to 64 at most by the idle
// warpgroup.
#include "wgmma_tile.cuh"

namespace {

using namespace repro::sm90;

constexpr int BM = 128;       // pair rows a tile
constexpr int BK = 64;        // K a stage: one 128-byte swizzle row of A
constexpr int BOX = 64;       // columns a B box
constexpr int CONSUMERS = 8;  // warps: two warpgroups
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr uint32_t A_BYTES = BM * BK * 2;
constexpr uint32_t B_BOX_BYTES = BK * BOX * 2;
constexpr unsigned FULL = 0xffffffffu;

// Each kernel's tile: NACC accumulators of 128 columns a consumer
// warpgroup (B boxes a stage: 2 NACC) and a ring of STAGES stages; one
// accumulator keeps two CTAs on an SM, two keep one. At the cell's shape
// two accumulators and four stages took 0.752 ms a call against 0.828 for
// one and three (two CTAs an SM) and 0.823 for two and three (PERF.md).
constexpr int GU_NACC = 2, GU_STAGES = 4;  // gate/up
constexpr int DN_NACC = 2, DN_STAGES = 4;  // down

__host__ __device__ constexpr uint32_t stage_bytes(int nacc) { return A_BYTES + 2 * nacc * B_BOX_BYTES; }
__host__ __device__ constexpr size_t smem_bytes(int nacc, int stages) {
  return stages * stage_bytes(nacc) + 16 * stages + 1024;
}
__host__ __device__ constexpr int min_blocks(int nacc) { return nacc == 1 ? 2 : 1; }
constexpr int GU_BLOCKS = min_blocks(GU_NACC), DN_BLOCKS = min_blocks(DN_NACC);

static_assert(smem_bytes(GU_NACC, GU_STAGES) <= 232448 && smem_bytes(DN_NACC, DN_STAGES) <= 232448,
              "a CTA's shared memory");
static_assert(GU_BLOCKS * (smem_bytes(GU_NACC, GU_STAGES) + 1024) <= 233472 &&
                  DN_BLOCKS * (smem_bytes(DN_NACC, DN_STAGES) + 1024) <= 233472,
              "the CTAs an SM holds");

// A tile's expert, its first row, and the end of the expert's rows; expert
// -1 past the last row block.
struct Tile {
  int expert, row0, row_end;
};

// Row tile `tile` of the grid. Expert e has ceil(counts[e] / BM) row blocks,
// experts in order. One warp, every lane with the same `tile`; every lane
// returns the answer.
__device__ __forceinline__ Tile find_tile(const long long* __restrict__ counts, int n_experts,
                                          int tile) {
  const int lane = threadIdx.x & 31;
  int tiles_before = 0, rows_before = 0;
  for (int e0 = 0; e0 < n_experts; e0 += 32) {
    const int c = e0 + lane < n_experts ? static_cast<int>(counts[e0 + lane]) : 0;
    const int nb = (c + BM - 1) / BM;
    int nb_incl = nb, c_incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, nb_incl, off);
      const int y = __shfl_up_sync(FULL, c_incl, off);
      if (lane >= off) {
        nb_incl += x;
        c_incl += y;
      }
    }
    const int first = tiles_before + nb_incl - nb;
    const unsigned hit = __ballot_sync(FULL, tile >= first && tile < first + nb);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int start = __shfl_sync(FULL, rows_before + c_incl - c, src);
      const int f = __shfl_sync(FULL, first, src);
      const int n = __shfl_sync(FULL, c, src);
      return Tile{e0 + src, start + (tile - f) * BM, start + n};
    }
    tiles_before += __shfl_sync(FULL, nb_incl, 31);
    rows_before += __shfl_sync(FULL, c_incl, 31);
  }
  return Tile{-1, 0, 0};
}

// The products of one tile: this consumer warpgroup's 64 rows by NACC x 128
// columns, over all of K. A stage holds 2 NACC boxes of 64 columns: the
// first NACC from map_b0 at columns col0, col0 + 64, ..., the others from
// map_b1 at col1, ...; accumulator a reads boxes 2a and 2a + 1. Every thread
// of the CTA calls it; returns false on a thread that holds no rows of the
// tile (the producer warp, an idle warpgroup), which then has nothing more
// to do.
template <int NACC, int STAGES>
__device__ __forceinline__ bool tile_products(const CUtensorMap* map_a, const CUtensorMap* map_b0,
                                              int col0, const CUtensorMap* map_b1, int col1,
                                              const Tile& t, int k, uint8_t* smem_raw,
                                              float (&acc)[NACC][64]) {
  constexpr uint32_t STAGE = stage_bytes(NACC);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(align_smem(smem_raw));
  const uint32_t full = base + STAGES * STAGE;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const int busy_groups = t.row0 + 64 < t.row_end ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * busy_groups);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int kblocks = (k + BK - 1) / BK;

  if (warp == CONSUMERS) {  // producer
    if (lane == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(empty + 8 * s, ((kb / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t sa = base + s * STAGE;
        mbar_expect_tx(bar, STAGE);
        tma_load_2d(sa, map_a, bar, kb * BK, t.row0);
#pragma unroll
        for (int b = 0; b < 2 * NACC; ++b)
          tma_load_3d(sa + A_BYTES + b * B_BOX_BYTES, b < NACC ? map_b0 : map_b1, bar,
                      (b < NACC ? col0 : col1) + (b % NACC) * BOX, kb * BK, t.expert);
      }
    }
    return false;
  }
  const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63 of the tile
  if (wg >= busy_groups) return false;
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[a][i] = 0.f;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(full + 8 * s, (kb / STAGES) & 1);
    const uint32_t sa = base + s * STAGE + wg * 64 * 128;  // 128 bytes an A row
    const uint32_t sb = base + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int a = 0; a < NACC; ++a)
        wgmma_ss_n128_tb(acc[a], make_desc(sa + 32 * kk, 16, 1024, SWIZZLE_128B),
                         make_desc(sb + 2 * a * B_BOX_BYTES + 2048 * kk, B_BOX_BYTES, 1024,
                                   SWIZZLE_128B),
                         1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NACC; ++a) fence_regs(acc[a]);
  return true;
}

// accumulator layout (wgmma_tile.cuh): warp w of the warpgroup holds rows
// 16 w + lane / 4 and + 8; register 4 j + e is column 8 j + 2 (lane % 4) +
// (e & 1), row + 8 for e >= 2
__device__ __forceinline__ int acc_row(const Tile& t) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return t.row0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// h columns a CTA: 64 NACC. One accumulator holds 64 gate columns beside
// the same 64 up columns; two hold 128 gate columns and 128 up columns.
__global__ void __launch_bounds__(THREADS, GU_BLOCKS)
grouped_gate_up_kernel(__grid_constant__ const CUtensorMap map_x,
                       __grid_constant__ const CUtensorMap map_wg,
                       __grid_constant__ const CUtensorMap map_wi,
                       const long long* __restrict__ counts, __nv_bfloat16* __restrict__ h,
                       int d, int f, int n_experts) {
  extern __shared__ uint8_t smem[];
  const Tile t = find_tile(counts, n_experts, blockIdx.y);
  if (t.expert < 0) return;
  const int col0 = blockIdx.x * BOX * GU_NACC;  // of F
  float acc[GU_NACC][64];
  if (!tile_products<GU_NACC, GU_STAGES>(&map_x, &map_wg, col0, &map_wi, col0, t, d, smem, acc))
    return;
  const int row = acc_row(t);
  const int col = col0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= t.row_end) continue;
    __nv_bfloat16* out = h + static_cast<size_t>(r) * f + col;
#pragma unroll
    for (int j = 0; j < 8 * GU_NACC; ++j) {  // h columns 8 j ..
      if (col + 8 * j >= f) continue;
      const int g = 4 * j + 2 * half;  // the gate's register; the up's:
      const int u = GU_NACC == 1 ? g + 32 : g;  // + 32 of the one, or of the second
      const float* up = acc[GU_NACC - 1];
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(silu(acc[0][g]) * up[u], silu(acc[0][g + 1]) * up[u + 1]);
    }
  }
}

// out columns a CTA: 128 DN_NACC.
__global__ void __launch_bounds__(THREADS, DN_BLOCKS)
grouped_down_kernel(__grid_constant__ const CUtensorMap map_h,
                    __grid_constant__ const CUtensorMap map_wo,
                    const long long* __restrict__ counts, const float* __restrict__ weights,
                    const long long* __restrict__ dest, __nv_bfloat16* __restrict__ out, int f,
                    int d, int n_experts) {
  extern __shared__ uint8_t smem[];
  const Tile t = find_tile(counts, n_experts, blockIdx.y);
  if (t.expert < 0) return;
  const int col0 = blockIdx.x * 2 * BOX * DN_NACC;  // of D
  float acc[DN_NACC][64];
  if (!tile_products<DN_NACC, DN_STAGES>(&map_h, &map_wo, col0, &map_wo, col0 + BOX * DN_NACC, t,
                                         f, smem, acc))
    return;
  const int row = acc_row(t);
  const int col = col0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= t.row_end) continue;
    const float w = weights[r];
    __nv_bfloat16* o = out + static_cast<size_t>(dest[r]) * d + col;
#pragma unroll
    for (int a = 0; a < DN_NACC; ++a)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (col + 128 * a + 8 * j >= d) continue;
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(o + 128 * a + 8 * j) =
            __floats2bfloat162_rn(acc[a][e] * w, acc[a][e + 1] * w);
      }
  }
}

// the ring's shared memory, allowed once per device before the first launch
// (never inside a CUDA graph's capture, which the first launch precedes)
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(grouped_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(GU_NACC, GU_STAGES)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(DN_NACC, DN_STAGES)));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// (rows, k) row-major bf16 pairs as a 2-d map of (BM x BK) boxes; rows past
// `rows` and columns past k read as zeros
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {BK, BM};
  return encode_bf16_map(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// (E, k, n) row-major bf16 experts as a 3-d map of (BK x 64) boxes, one
// expert a box; rows past k and columns past n read as zeros
int encode_experts(CUtensorMap* map, const void* ptr, int n_experts, int k, int n) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                 static_cast<cuuint64_t>(k) * n * 2};
  const cuuint32_t box[3] = {BOX, BK, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

bool shapes_ok(int n, int d, int f, int n_experts) {
  const long long row_tiles = (static_cast<long long>(n) + BM - 1) / BM + n_experts;
  return n > 0 && n_experts > 0 && row_tiles <= 65535 && d > 0 && f > 0 && d % 8 == 0 &&
         f % 8 == 0;
}

}  // namespace

// xs (n, d), wg and wi (E, d, f), h (n, f): bf16, contiguous, 16-byte
// aligned; counts (E,) int64 on the device, summing to n. d and f multiples
// of 8. h[i] = silu(xs[i] @ wg[e]) * (xs[i] @ wi[e]) for pair i of expert e.
extern "C" int grouped_gate_up_launch(const void* xs, const void* wg, const void* wi,
                                      const void* counts, void* h, int n, int d, int f,
                                      int n_experts, void* stream) {
  if (!shapes_ok(n, d, f, n_experts)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_x, map_wg, map_wi;
  int e = encode_rows(&map_x, xs, n, d);
  if (e == 0) e = encode_experts(&map_wg, wg, n_experts, d, f);
  if (e == 0) e = encode_experts(&map_wi, wi, n_experts, d, f);
  if (e != 0) return e;
  const dim3 grid((f + BOX * GU_NACC - 1) / (BOX * GU_NACC), (n + BM - 1) / BM + n_experts);
  grouped_gate_up_kernel<<<grid, THREADS, smem_bytes(GU_NACC, GU_STAGES),
                           static_cast<cudaStream_t>(stream)>>>(
      map_x, map_wg, map_wi, static_cast<const long long*>(counts),
      static_cast<__nv_bfloat16*>(h), d, f, n_experts);
  return static_cast<int>(cudaGetLastError());
}

// h (n, f), wo (E, f, d), out (n, d): bf16, contiguous, 16-byte aligned;
// counts (E,) int64 summing to n, weights (n,) f32, dest (n,) int64 a
// permutation of 0 .. n-1. out[dest[i]] = weights[i] * (h[i] @ wo[e]).
extern "C" int grouped_down_launch(const void* h, const void* wo, const void* counts,
                                   const void* weights, const void* dest, void* out, int n, int f,
                                   int d, int n_experts, void* stream) {
  if (!shapes_ok(n, d, f, n_experts)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_h, map_wo;
  int e = encode_rows(&map_h, h, n, f);
  if (e == 0) e = encode_experts(&map_wo, wo, n_experts, f, d);
  if (e != 0) return e;
  const dim3 grid((d + 2 * BOX * DN_NACC - 1) / (2 * BOX * DN_NACC),
                  (n + BM - 1) / BM + n_experts);
  grouped_down_kernel<<<grid, THREADS, smem_bytes(DN_NACC, DN_STAGES),
                        static_cast<cudaStream_t>(stream)>>>(
      map_h, map_wo, static_cast<const long long*>(counts), static_cast<const float*>(weights),
      static_cast<const long long*>(dest), static_cast<__nv_bfloat16*>(out), f, d, n_experts);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_STRERROR(grouped_experts)
