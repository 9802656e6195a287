// K5: the RG-LRU linear recurrence of Griffin / RecurrentGemma,
//   h_t = a_t h_{t-1} + sqrt(max(1 - exp(2 a_log_t), 1e-12)) x_t,  a_t = exp(a_log_t),
// over x, a_log: (B, S, W) f32 or bf16 (both the same), from an optional
// initial state h0: (B, W) f32, into h: (B, S, W) f32, whose last row is the
// final state.
//
// Replaces the TPU kernel `rg_lru` (src/repro/kernels/rg_lru.py:41, body
// `_lru_kernel` :17). The TPU grid (B, W/bw, S/chunk) ran its chunks in order
// and carried h in VMEM scratch, with an associative scan inside a chunk. Here
// the time axis is cut across the CTAs of a thread-block cluster, in one pass
// that reads x and a_log from device memory once and writes h once.
//
// A cluster of RANKS = 8 CTAs (the portable maximum) owns CW = 32 channels of
// one batch row and walks S in windows of RANKS * STEPS = 2048 steps; rank r
// owns steps [r STEPS, (r + 1) STEPS) of each window, and its warp k the
// sub-segment of SUB = 32 steps at k SUB, lane = channel. In each window a CTA
//   1. brings its (STEPS x CW) tiles of x and a_log into shared memory, one
//      TMA request each on one mbarrier, so every resident CTA's loads are in
//      flight together (where W or a pointer is not 16-byte aligned, as TMA
//      needs, its threads load the tiles instead);
//   2. each warp forms its sub-segment's product A of the a's and its end
//      value B from h = 0, reading rows of shared memory without bank
//      conflicts; in f32 it writes a and sqrt(1 - exp(2 a_log)) x back over
//      the tiles, so step 4 does not form them again;
//   3. folds its warps' (A, B) into its own and stores it into the shared
//      memory of every later rank of the cluster (distributed shared memory:
//      remote stores, which no thread waits on), then passes a cluster
//      barrier; each warp chains its carry from the window's, through the
//      earlier ranks' (A, B) and its own earlier warps', all read locally. The
//      window's carry is h0 (or 0) in the first window, else the previous
//      window's last row of h, which rank RANKS - 1 pushes to every rank;
//   4. each warp runs its sub-segment again from its carry and stores h, lanes
//      on neighbouring channels (128-byte rows).
// The cluster is co-scheduled by the hardware, so no CTA waits on one that is
// not resident; nothing global is shared, so calls on two streams cannot
// interfere. What a rank pushes is double-buffered by window parity, so one
// cluster barrier a window, and one before exit, suffice.
//
// Steps beyond S and channels beyond W read as zero (TMA fills them), the
// identity step a = 1, b = 0: no mask is needed in the scan, and the state
// after a ragged last tile is its last real row bit for bit. A warp whose rows
// lie wholly beyond S skips the scan and contributes (1, 0), and a CTA whose
// tile does loads nothing. Step 4 is the sequential recurrence, so h differs
// from a plain time loop only in the carries' rounding order and in exp and
// sqrt, which run on the special-function unit (ex2.approx and sqrt.approx,
// relative errors ~2^-22). The window carry is the row as written, so a call
// over S1 + S2 steps equals two calls chained through h0 bit for bit when S1
// is a multiple of the window. It forms 1 - exp(2 a_log) as the TPU kernel
// does (`rg_lru.py:27`); the oracle forms 1 - a*a.
//
// What bounds it on an H100 SXM (data-sheet peaks, which assume its 700 W
// power limit): at (1, 2048, 4096) f32 it must read x, a_log and h0 and write
// h, 100.7 MB (0.0301 ms at 3.35 TB/s), and this kernel moves exactly that;
// its arithmetic is ~15 operations an element. The kernel it replaces ran
// each segment twice from device memory, reading x and a_log twice (167.8 MB).
// At that shape the grid is 128 clusters (1024 CTAs of 256 threads, ~68 KB of
// shared memory each in f32, three an SM).
#include <cooperative_groups.h>

#include "wgmma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::sm90::align_smem;
using repro::sm90::mbar_expect_tx;
using repro::sm90::mbar_fence_init;
using repro::sm90::mbar_init;
using repro::sm90::mbar_wait;
using repro::sm90::smem_u32;
using repro::sm90::tma_load_3d;

constexpr int RANKS = 8;                // CTAs a cluster, along time
constexpr int CW = 32;                  // channels a cluster, one a lane
constexpr int WARPS = 8;                // sub-segments a CTA
constexpr int STEPS = 256;              // steps a CTA owns in a window
constexpr int SUB = STEPS / WARPS;      // steps a sub-segment
constexpr int WINDOW = RANKS * STEPS;
constexpr int THREADS = 32 * WARPS;

template <typename E>
struct Smem {
  E x[STEPS][CW];             // x; in f32, sqrt(1 - exp(2 a_log)) x after step 2
  E al[STEPS][CW];            // a_log; in f32, a after step 2
  float seg_a[WARPS][CW];     // each sub-segment's product of a
  float seg_b[WARPS][CW];     // and its end value from h = 0
  float from_a[2][RANKS][CW]; // each earlier rank's (A, B), pushed by it, by window parity
  float from_b[2][RANKS][CW];
  float last[2][CW];          // the window's last row of h, pushed by rank RANKS - 1
  uint64_t bar;               // the tiles' TMA barrier
};

// bytes of dynamic shared memory: the struct and the 1024 align_smem may skip
template <typename E>
constexpr size_t smem_bytes() { return sizeof(Smem<E>) + 1024; }

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, sqrt(max(1 - exp(2 a_log), 1e-12)) x) of one step; __expf is ex2.approx
__device__ __forceinline__ float2 lru_step(float al, float x) {
  return make_float2(__expf(al), sqrt_approx(fmaxf(1.f - __expf(2.f * al), 1e-12f)) * x);
}

// TMA: whether the tiles arrive by tensor map or by the threads' own loads.
template <typename E, bool TMA>
__global__ void __launch_bounds__(THREADS)
rg_lru_cluster_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_a, const E* __restrict__ X,
                      const E* __restrict__ AL, const float* __restrict__ h0,
                      float* __restrict__ O, int S, int W) {
  constexpr bool IN_PLACE = sizeof(E) == sizeof(float);
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_smem(smem_raw));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int s0 = warp * SUB;  // this warp's first row of the tile
  const int c0 = (blockIdx.x / RANKS) * CW;
  const int b = blockIdx.y;
  const int ch = c0 + lane;
  const bool live = ch < W;
  const int windows = (S + WINDOW - 1) / WINDOW;

  // thread 0: window w's tiles of x and a_log
  const uint32_t bar = smem_u32(&sm.bar);
  auto issue = [&](int w) {
    const int t0 = w * WINDOW + rank * STEPS;
    if (t0 >= S) return;
    // earlier generic reads and writes of the tiles come before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 2u * STEPS * CW * sizeof(E));
    tma_load_3d(smem_u32(&sm.x[0][0]), &map_x, bar, c0, t0, b);
    tma_load_3d(smem_u32(&sm.al[0][0]), &map_a, bar, c0, t0, b);
  };
  if (TMA && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    issue(0);
  }
  __syncthreads();

  for (int win = 0; win < windows; ++win) {
    const int buf = win & 1;
    const int t0 = win * WINDOW + rank * STEPS;  // this CTA's first step
    const bool idle = t0 + s0 >= S;              // this warp's rows lie beyond S
    if constexpr (!TMA) {
      const E zero = repro::from_f32<E>(0.f);
#pragma unroll 8
      for (int r = warp; r < STEPS; r += WARPS) {
        const bool in = live && t0 + r < S;
        const size_t g = (static_cast<size_t>(b) * S + t0 + r) * W + ch;
        sm.x[r][lane] = in ? X[g] : zero;
        sm.al[r][lane] = in ? AL[g] : zero;
      }
      __syncthreads();
    }
    // 1-2. this warp's rows, and its sub-segment's (A, B)
    float seg_a = 1.f;
    float seg_b = 0.f;
    if (!idle) {
      if constexpr (TMA) mbar_wait(bar, win & 1);
#pragma unroll 8
      for (int i = 0; i < SUB; ++i) {
        const int r = s0 + i;
        const float2 ab = lru_step(repro::to_f32(sm.al[r][lane]), repro::to_f32(sm.x[r][lane]));
        if constexpr (IN_PLACE) {
          sm.al[r][lane] = ab.x;
          sm.x[r][lane] = ab.y;
        }
        seg_b = fmaf(ab.x, seg_b, ab.y);
        seg_a *= ab.x;
      }
    }
    // 3. the CTA's (A, B), pushed to the later ranks; then this warp's carry
    sm.seg_a[warp][lane] = seg_a;
    sm.seg_b[warp][lane] = seg_b;
    __syncthreads();
    if (warp == 0 && rank + 1 < RANKS) {
      float pa = 1.f;
      float pb = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        pb = fmaf(sm.seg_a[k][lane], pb, sm.seg_b[k][lane]);
        pa *= sm.seg_a[k][lane];
      }
      for (int j = rank + 1; j < RANKS; ++j) {
        *cluster.map_shared_rank(&sm.from_a[buf][rank][lane], j) = pa;
        *cluster.map_shared_rank(&sm.from_b[buf][rank][lane], j) = pb;
      }
    }
    cluster.sync();
    float h;
    if (win > 0)
      h = sm.last[buf ^ 1][lane];
    else
      h = (h0 != nullptr && live) ? h0[static_cast<size_t>(b) * W + ch] : 0.f;
    for (int j = 0; j < rank; ++j) h = fmaf(sm.from_a[buf][j][lane], h, sm.from_b[buf][j][lane]);
    for (int k = 0; k < warp; ++k) h = fmaf(sm.seg_a[k][lane], h, sm.seg_b[k][lane]);
    // 4. the sub-segment again, from its carry, into h
    if (!idle) {
      const int n = min(SUB, S - (t0 + s0));  // rows of this sub-segment inside S
      float* o = O + (static_cast<size_t>(b) * S + t0 + s0) * W + ch;
#pragma unroll 8
      for (int i = 0; i < SUB; ++i) {
        const int r = s0 + i;
        const float2 ab =
            IN_PLACE ? make_float2(repro::to_f32(sm.al[r][lane]), repro::to_f32(sm.x[r][lane]))
                     : lru_step(repro::to_f32(sm.al[r][lane]), repro::to_f32(sm.x[r][lane]));
        h = fmaf(ab.x, h, ab.y);
        if (live && i < n) o[static_cast<size_t>(i) * W] = h;
      }
    }
    if (rank == RANKS - 1 && warp == WARPS - 1 && win + 1 < windows)
      for (int j = 0; j < RANKS; ++j) *cluster.map_shared_rank(&sm.last[buf][lane], j) = h;
    __syncthreads();  // the tiles and seg_a/seg_b are read before the next window refills them
    if (TMA && threadIdx.x == 0 && win + 1 < windows) issue(win + 1);
  }
  cluster.sync();  // no CTA leaves while another may still write to its shared memory
}

template <typename E>
CUtensorMapDataType map_type();
template <>
CUtensorMapDataType map_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <>
CUtensorMapDataType map_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }

template <typename E>
cudaLaunchConfig_t config(int b, int w, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((w + CW - 1) / CW) * RANKS, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<E>();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = RANKS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename E, bool TMA>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(rg_lru_cluster_kernel<E, TMA>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes<E>())));
}

template <typename E, bool TMA>
int launch(const void* x, const void* a_log, const float* h0, float* out, int b, int s, int w,
           cudaStream_t stream) {
  CUtensorMap map_x;
  CUtensorMap map_a;
  memset(&map_x, 0, sizeof map_x);
  memset(&map_a, 0, sizeof map_a);
  if constexpr (TMA) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * sizeof(E),
                                   static_cast<cuuint64_t>(s) * w * sizeof(E)};
    const cuuint32_t box[3] = {CW, STEPS, 1};
    int err = repro::sm90::encode_map(&map_x, map_type<E>(), x, 3, dims, strides, box,
                                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == 0)
      err = repro::sm90::encode_map(&map_a, map_type<E>(), a_log, 3, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  const int err = set_smem<E, TMA>();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<E>(b, w, stream, &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, rg_lru_cluster_kernel<E, TMA>, map_x, map_a,
                                             static_cast<const E*>(x),
                                             static_cast<const E*>(a_log), h0, out, s, w));
}

template <typename E>
int dispatch(const void* x, const void* a_log, const float* h0, float* out, int b, int s, int w,
             cudaStream_t stream) {
  const bool aligned = (static_cast<size_t>(w) * sizeof(E)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a_log) % 16 == 0;
  return aligned ? launch<E, true>(x, a_log, h0, out, b, s, w, stream)
                 : launch<E, false>(x, a_log, h0, out, b, s, w, stream);
}

template <typename E>
int occupancy(int* clusters, int* ctas_per_sm) {
  int err = set_smem<E, true>();
  if (err != 0) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, rg_lru_cluster_kernel<E, true>, THREADS, smem_bytes<E>()));
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<E>(1, CW, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, rg_lru_cluster_kernel<E, true>, &cfg));
}

}  // namespace

// x, a_log: (b, s, w) in `dtype` (f32 or bf16); out: (b, s, w) f32; h0
// (nullable): (b, w) f32; all contiguous.
extern "C" int rg_lru_fwd(const void* x, const void* a_log, const void* h0, void* out, int b,
                          int s, int w, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || w <= 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* hf = static_cast<const float*>(h0);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch<float>(x, a_log, hf, of, b, s, w, st);
  if (dtype == repro::DTYPE_BF16) return dispatch<__nv_bfloat16>(x, a_log, hf, of, b, s, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The TMA kernel's residency in `dtype`: clusters of RANKS CTAs the card holds
// at once (cudaOccupancyMaxActiveClusters) and CTAs an SM. Returns 0 or a
// CUDA error.
extern "C" int rg_lru_occupancy(int dtype, int* clusters, int* ctas_per_sm) {
  if (dtype == repro::DTYPE_F32) return occupancy<float>(clusters, ctas_per_sm);
  if (dtype == repro::DTYPE_BF16) return occupancy<__nv_bfloat16>(clusters, ctas_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_STRERROR(rg_lru)
