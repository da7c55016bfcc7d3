// A trial copy of mcmc_tpu_torch/csrc/fused_glm_xwide_body.cuh with clock
// counters (scripts/torch_wide_glm_trials.py --instr): with a buffer set by
// trial_set_prof, the first and last thread of each warpgroup of every
// block add clock64() spans into 16 int64 (index 11: the items with a
// product). XW_LOCAL_OPERAND: each block copies the whole operand itself
// (no multicast, its empty barrier local), a design trial. Otherwise the
// body is the package's.
//
// The fused GLM trajectory's two-pass body past 1024 padded columns, for
// Hopper (sm_90a), templated on its link as the other two GLM bodies are:
// fused_glm_trajectory_xwide.cu instantiates it on each built-in link for
// the package's library (launch_builtin), a traced link's translation unit
// on its own functor (mcmc_tpu_torch/ops/_cuda.py: build_link).
//
// Replaces the same two TPU kernels as fused_glm_body.cuh
// (mcmc_tpu/ops/fused_logreg.py: make_fused_trajectory, kernel body
// :163-199, pallas_call :215; make_fused_trajectory_rt, kernel body
// :498-535, pallas_call :551) at the widths the cluster body
// (fused_glm_wide_body.cuh) cannot hold, and computes the same function
// with the same precision contract: bf16(z) . X^T and bf16(r) . X on the
// tensor cores with f32 accumulation, the link once per element, z, p and
// U in f32, the RT flag's eps from a device pointer and diagonal inverse
// mass in the drift.
//
// Why another body. The cluster body gives each block one 128-column panel
// and keeps that panel's gradient accumulator (64 registers a thread) and
// bf16(z) (32 more) in registers beside its 237; a cluster holds at most 8
// blocks portably (16 on an H100 with a non-portable size, at 15 resident
// clusters of 224 KB blocks already at 8), so past 1024 columns, and
// certainly past 2048, a block must own several panels, and neither their
// accumulators nor their bf16(z) fit its registers. So each gradient runs
// in two passes over a cluster of c = min(8, row tiles) blocks sharing 128
// chains (two warpgroups of 64), with the gradient's one intermediate, bf16
// r, in device memory between them (128 chains x 2048 rows x 2 B = 0.5 MB a
// cluster at 2000 rows: it stays in the 50 MB L2):
// 1. eta, the link and r: block j takes the 128-row tiles j, j + c, ...;
//    for each, its warpgroups accumulate eta = bf16(z) . X_t^T over all
//    k = dim_padded / 128 panels in the wgmma accumulator (64 registers);
//    then the link on its own eta (no exchange: the block holds whole rows
//    of eta), and r's bf16 pairs go to device memory. With the last
//    gradient it sums mask * ll per chain.
// 2. g and the update: block j owns panels [k j / c, k (j + 1) / c); for
//    each it accumulates g_panel = bf16(r) . X over all row tiles, then
//    kicks and drifts that panel's z and p (f32 in z_out, p_out, each
//    element read and written by one thread) and writes bf16(z) for the
//    next gradient's first pass.
// A cluster barrier separates the passes (pass 2 reads every tile's r,
// the next pass 1 every panel's bf16(z)): two a gradient.
//
// The operands. Every block of a cluster holds the same 128 chains, so in
// its n-th item of a pass each block multiplies by the same operand:
// bf16(z) of panel n % k in pass 1, r of row tile n % n_tiles in pass 2
// (32 KB for the two warpgroups). Each item's stage of a ring of three
// holds X's tile (the panel's two 64-column halves under the 128-byte
// swizzle, by the tensor memory accelerator, as in the cluster body), that
// operand and y and mask; both wgmma operands come from shared memory. The
// operand is brought once per cluster: each block copies its 1/c share of
// it from device memory and multicasts it to every block of the cluster,
// so each block's "full" barrier expects its X and the whole operand. A
// stage is refilled only once every block of the cluster has released it:
// each warpgroup, after a barrier of its own 128 threads, arrives on the
// "empty" barrier of every block (2 c arrivals a phase), with
// mbarrier.arrive's default semantics. Thread 0 of each block starts its
// items two ahead. The operands are kept in device memory as the stage's
// own image (a 128 x 128 bf16 matrix, K-major, in two 64-wide halves of
// 128-byte rows under the 128-byte swizzle, as the descriptors read it),
// written by the threads through the generic proxy and read by the bulk
// copies through the async proxy: every writer fences the proxies
// (fence.proxy.async.global) before the cluster barrier that precedes the
// copies. The ring therefore starts each pass anew after that barrier.
//
// Blocks with fewer items. The multicast needs every block of a cluster to
// walk the same sequence of items, so every block runs the same number of
// rounds a pass, ceil(n_tiles / c) * k in pass 1 and ceil(k / c) * n_tiles
// in pass 2: a block whose share is smaller (1152 columns: 9 panels over 8
// blocks; a row count with n_tiles % c != 0) runs its last rounds without
// X and without products, and still sends its share of each operand and
// releases each stage. A wrong protocol traps in mbar_wait (a few seconds)
// rather than hanging the card.
//
// Each warpgroup keeps one product in flight: it issues item i's wgmma,
// then waits only for item i - 1's (wgmma.wait_group 1) and releases that
// item's stage, so its tensor cores always hold the next product; the
// accumulator is read only after wait_group 0, at the end of a tile's or
// a panel's sum, on no branch. The link runs as a loop over the tile's
// quads (link_tile), the accumulator staged through the last stage's
// X and operand, not as 16 unrolled copies of the link: a traced link's
// accurate functions unrolled 16 times cost more in instruction fetch than
// the loop (on an H100, the traced cloglog link at 2048 columns 5.13 ms
// unrolled, 3.49 ms as the loop; the built-in logistic 3.28 and 3.11 ms).
// With one instantiation a built-in link, in place of a switch on the
// link's code in the kernel, no instantiation spills.
//
// What bounds it on this card. The work: at 3072 columns x 2000 rows and
// 16384 chains a trajectory is 2.01 TFLOP of bf16 products (2.04 ms at the
// tensor cores' peak) against 0.094 ms of the logistic link's special
// functions. Each item (one 64 x 128 x 128 product a warpgroup, 4.2 MFLOP)
// lands 64 KB in the block's shared memory and reads 32 KB + 32 KB / c of
// it from the L2 (36 KB at c = 8; the first two-pass body read the whole
// operand as register fragments, 64 KB). On an H100 the L2 delivers about
// 6.2 TB/s to bulk copies and multicast lands up to 8 TB/s
// (scripts/torch_l2_read_rate.py), so at 3072 columns the landed bytes
// allow about 4.5 ms against 6.9 measured; clock counters
// (scripts/trials/glm_xwide_counters.cuh) put the rest in the waits for a
// stage's bytes (three stages of 65 KB keep two items in flight), the
// producer's issue on thread 0, each panel's update (z and p through the
// L2) and each item's release. Given up: 256 chains a cluster (two
// accumulators a warpgroup, two stages of 97 KB: ptxas serialised the
// wgmma for want of registers, C7512), a producer warpgroup with
// setmaxnreg (ptxas kept 168 registers and spilled 1.6-2.5 KB), a release
// at cluster scope (7,800 clocks an item), every warp releasing on its own
// (8 c arrivals), the producer's issue alternating between the
// warpgroups.
//
// Every sum has a fixed order (eta over the panels in order, g over the
// row tiles in order, U's parts per thread in tile or panel order, the four
// lanes of a row, then the blocks in rank order), so a launch is
// deterministic. Rows padded to the tile carry mask 0 (the ring's copies
// fill rows past n_rows with zeros), z, p columns past the model's
// dimension stay exactly zero (their X columns are zero), and chains past
// n_chains in the last cluster are computed on zeros and never stored.

#pragma once

#include "fused_glm_wide_body.cuh"

namespace {
namespace glm_xwide {

__device__ long long* g_prof = nullptr;
#define XW_T0(v) long long v = clock64()
#define XW_ADD(i, v)                                                   \
  do {                                                                 \
    if (g_prof != nullptr) prof_add(i, clock64() - (v));               \
  } while (0)
__device__ __forceinline__ bool prof_thread() {
  const int wt = threadIdx.x & 127;
  return wt == 0 || wt == 127;
}
__device__ __forceinline__ void prof_add(int i, long long v) {
  if (!prof_thread()) return;
  const int slot = (threadIdx.x >> 7) * 2 + ((threadIdx.x & 127) == 127);
  g_prof[((size_t)blockIdx.x * 4 + slot) * 16 + i] += v;
}
#ifdef XW_LOCAL_OPERAND
constexpr bool kLocalOp = true;
#else
constexpr bool kLocalOp = false;
#endif

constexpr int PW = glm_wide::PW;                // columns of a panel
constexpr int kTileRows = glm_wide::kTileRows;  // data rows of a tile
constexpr int kWGs = 2;
constexpr int kWGChains = 64;
constexpr int BC = kWGs * kWGChains;  // chains per cluster
constexpr int kThreads = kWGs * 128;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kXBytes = glm_wide::kXBytes;  // a panel of a tile, 32 KB
constexpr int kHalfBytes = glm_wide::kHalfBytes;
// an operand image: BC chains x 128 K bf16 in two 64-wide halves of
// 128-byte rows; chain row r at r * 128 in each half
constexpr int kOpHalf = BC * 128;
constexpr int kOpBytes = 2 * kOpHalf;
constexpr int kYMBytes = glm_wide::kYMBytes;  // y and mask of a tile
// a stage: X's tile, the operand, y and mask
constexpr int kStageBytes = kXBytes + kOpBytes + kYMBytes;
constexpr int kStages = 3;
// a thread that consumes item gi starts item gi + kAhead, whose stage item
// gi - 1 held
constexpr int kAhead = kStages - 1;
// quads of the link's loop a pass (link_tile)
constexpr int kLinkUnroll = 2;
static_assert(kStageBytes % 1024 == 0,
              "every stage's X and operand on the 128-byte swizzle's "
              "1024-byte period");
constexpr int kOffBar = kStages * kStageBytes;
constexpr int kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "fits a block");

// The work of a launch: panels, row tiles, cluster size, clusters; the
// workspace holds the operand images bf16(z) [n_clusters][k] and r
// [n_clusters][n_tiles], then U's parts [n_clusters * BC][cluster]
// (float2: the block's sum of mask * ll and of z^2 per chain).
struct Layout {
  int k, n_tiles, cluster, n_clusters;
  __host__ __device__ size_t zb_bytes() const {
    return (size_t)n_clusters * k * kOpBytes;
  }
  __host__ __device__ size_t rb_bytes() const {
    return (size_t)n_clusters * n_tiles * kOpBytes;
  }
  size_t bytes() const {
    return zb_bytes() + rb_bytes() + 8 * (size_t)n_clusters * BC * cluster;
  }
};

__host__ __device__ inline Layout layout_of(int n_chains, int n_rows,
                                            int dim_padded) {
  Layout l;
  l.k = dim_padded / PW;
  l.n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  l.cluster = l.n_tiles < kMaxCluster ? l.n_tiles : kMaxCluster;
  if (l.k < l.cluster) l.cluster = l.k;
  l.n_clusters = (n_chains + BC - 1) / BC;
  return l;
}

// A block's share of a gradient: pass 1's row tiles me, me + c, ... (nt of
// them, of s1 = ceil(n_tiles / c) rounds of k items), pass 2's panels
// [p_lo, p_hi) (of s2 = ceil(k / c) rounds of n_tiles items); its share of
// an operand image, bytes [op_lo, op_lo + op_bytes).
struct Plan {
  int k, n_tiles, c, me, nt, s1, p_lo, p_hi, s2, op_lo, op_bytes;
};

// The ring: item gi of the launch into stage gi % kStages; full[s]
// completes when the stage's X and the whole operand have landed, empty[s]
// when both warpgroups of every block of the cluster are done with it. zb,
// rb: the cluster's operand images.
struct Ring {
  const CUtensorMap* x;
  const CUtensorMap* y;
  const CUtensorMap* mask;
  uint32_t s0;  // stage 0: X, then the operand, then y and mask
  uint32_t full;
  uint32_t empty;
  const unsigned char* zb;
  const unsigned char* rb;
};

// One thread starts item gi, the i-th of its pass (pass 1 if `eta`), once
// every warpgroup of the cluster is done with the item its stage held:
// X's tile, y and mask if this block has a product there, and its share of
// the operand to every block.
__device__ __forceinline__ void start_item(const Ring& ring, const Plan& pl,
                                           int gi, bool eta, int i) {
  int tile, panel;
  const unsigned char* op;
  bool mine;
  if (eta) {
    const int round = i / pl.k;
    panel = i - round * pl.k;
    tile = pl.me + pl.c * round;
    mine = tile < pl.n_tiles;
    op = ring.zb + (size_t)panel * kOpBytes;
  } else {
    const int round = i / pl.n_tiles;
    tile = i - round * pl.n_tiles;
    panel = pl.p_lo + round;
    mine = panel < pl.p_hi;
    op = ring.rb + (size_t)tile * kOpBytes;
  }
  const int stage = gi % kStages;
  if (gi >= kStages) {
    XW_T0(t_e);
    mbar_wait_cluster(ring.empty + 8 * stage, ((gi / kStages) - 1) & 1);
    XW_ADD(9, t_e);
  }
  const uint32_t full = ring.full + 8 * stage;
  const uint32_t dst = ring.s0 + stage * kStageBytes;
  mbar_arrive_tx(full, (mine ? kXBytes + kYMBytes : 0) + kOpBytes);
  if (mine) {
    const int row0 = tile * kTileRows;
    glm_wide::tma_load_2d(dst, ring.x, panel * PW, row0, full);
    glm_wide::tma_load_2d(dst + kHalfBytes, ring.x, panel * PW + 64, row0,
                          full);
    const uint32_t ym = dst + kXBytes + kOpBytes;
    glm_wide::tma_load_1d(ym, ring.y, row0, full);
    glm_wide::tma_load_1d(ym + kTileRows * (int)sizeof(float), ring.mask,
                          row0, full);
  }
  if (pl.c == 1 || kLocalOp)
    bulk_from_global(dst + kXBytes, op, kOpBytes, full);
  else
    bulk_multicast(dst + kXBytes + pl.op_lo, op + pl.op_lo, pl.op_bytes,
                   full, (uint16_t)((1u << pl.c) - 1u));
}

// The first kAhead items of a pass, after the cluster barrier that
// published its operands.
__device__ __forceinline__ void start_pass(const Ring& ring, const Plan& pl,
                                           int g0, bool eta, int n) {
  if (threadIdx.x != 0) return;
  fence_proxy_async_global();
  for (int i = 0; i < kAhead && i < n; ++i)
    start_item(ring, pl, g0 + i, eta, i);
}

// This thread's warpgroup is done with stage s: a barrier of its 128
// threads, then its thread b arrives on block b's empty[s] (2 c arrivals
// complete a phase).
__device__ __forceinline__ void release(const Ring& ring, const Plan& pl,
                                        int stage) {
  XW_T0(t0);
  const int wt = threadIdx.x & 127;
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7))
               : "memory");
  if (kLocalOp) {
    if (wt == 0) mbar_arrive(ring.empty + 8 * stage);
  } else if (wt < pl.c) {
    mbar_arrive_remote(map_rank(ring.empty + 8 * stage, wt));
  }
  XW_ADD(2, t0);
}

// After item i of a pass of n, thread 0 starts item i + kAhead.
__device__ __forceinline__ void refill(const Ring& ring, const Plan& pl,
                                       int g0, bool eta, int i, int n) {
  if (threadIdx.x == 0 && i + kAhead < n) {
    XW_T0(t0);
    start_item(ring, pl, g0 + i + kAhead, eta, i + kAhead);
    XW_ADD(3, t0);
  }
}

// An item this block has no product in: wait for the stage (the operand's
// bytes land in every block) and release it.
__device__ __forceinline__ void idle_item(const Ring& ring, const Plan& pl,
                                          int g0, bool eta, int i, int n) {
  XW_T0(t0);
  const int gi = g0 + i, stage = gi % kStages;
  mbar_wait(ring.full + 8 * stage, (gi / kStages) & 1);
  release(ring, pl, stage);
  refill(ring, pl, g0, eta, i, n);
  XW_ADD(6, t0);
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d (64 x 128, f32) = or += A (64 x 16 bf16, shared, K-major) .
// B (16 x 128, shared; K-major, or with TRANS_B MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : ACC16(d, 0), ACC16(d, 16), ACC16(d, 32), ACC16(d, 48)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// The byte offset in an operand image of the bf16 pair at chain row `row`
// (of BC) and K index 8 j + 2 t (j < 16).
__device__ __forceinline__ uint32_t image_at(int row, int j, int t) {
  return (j >> 3) * kOpHalf + row * 128 + (((j & 7) ^ (row & 7)) << 4) +
         4 * t;
}

// A thread's 32 bf16 pairs in the accumulator's layout (pair 2 j + h: chain
// row + 8 h, K index 8 j + 2 t) into an operand image.
__device__ __forceinline__ void store_image(const uint32_t (&f)[32],
                                            unsigned char* img, int row,
                                            int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(img + image_at(row + 8 * h, j, t)) =
          f[2 * j + h];
}

// r of a warpgroup's 64 chains x 128 rows from its eta accumulator into
// the tile's operand image: quad u (elements 4 u .. 4 u + 3: chain rows r0
// and r0 + 8, at image rows row and row + 8, data rows 8 u + 2 t and + 1)
// gives two bf16 pairs. With WANT_U, adds this thread's share of
// sum(mask * ll) of its two chains to *ll0, *ll1, quad by quad. The
// accumulator goes through `scratch` (this thread's 16 float4 in shared
// memory, float4 u at scratch + 128 u) so that the link's code is a loop
// (the file's notes say why).
template <class L, bool WANT_U>
__device__ __forceinline__ void link_tile(const float (&e)[64], float4* scratch,
                                          unsigned char* img, int row,
                                          const float* ym, int t, float nu,
                                          float* ll0, float* ll1) {
#pragma unroll
  for (int u = 0; u < 16; ++u)
    scratch[128 * u] =
        make_float4(e[4 * u], e[4 * u + 1], e[4 * u + 2], e[4 * u + 3]);
#pragma unroll kLinkUnroll
  for (int u = 0; u < 16; ++u) {
    const float4 ev = scratch[128 * u];
    const int col = 8 * u + 2 * t;
    const float2 yv = *reinterpret_cast<const float2*>(ym + col);
    const float2 mv = *reinterpret_cast<const float2*>(ym + kTileRows + col);
    float l00, l01, l10, l11;
    const float r00 = L::template residual<WANT_U>(nu, ev.x, yv.x, &l00) * mv.x;
    const float r01 = L::template residual<WANT_U>(nu, ev.y, yv.y, &l01) * mv.y;
    const float r10 = L::template residual<WANT_U>(nu, ev.z, yv.x, &l10) * mv.x;
    const float r11 = L::template residual<WANT_U>(nu, ev.w, yv.y, &l11) * mv.y;
    if (WANT_U) {
      *ll0 += mv.x * l00;
      *ll0 += mv.y * l01;
      *ll1 += mv.x * l10;
      *ll1 += mv.y * l11;
    }
    *reinterpret_cast<uint32_t*>(img + image_at(row, u, t)) =
        pack_bf16(r00, r01);
    *reinterpret_cast<uint32_t*>(img + image_at(row + 8, u, t)) =
        pack_bf16(r10, r11);
  }
}

// Pass 1 for this thread's warpgroup: eta, the link and r of each of the
// block's row tiles, from item *gi on; then the rounds the block has no
// tile in. row: the thread's first chain row in the operand images.
template <class L, bool WANT_U>
__device__ __forceinline__ void pass_eta(const Ring& ring, const Plan& pl,
                                         int* gi, const unsigned char* sm,
                                         uint32_t sm_base, unsigned char* rb,
                                         int row, float nu,
                                         float* ll0, float* ll1) {
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 3;
  const int g0 = *gi, n = pl.s1 * pl.k;
  start_pass(ring, pl, g0, true, n);
  int i = 0;
  for (int it = 0; it < pl.nt; ++it) {
    const int tile = pl.me + pl.c * it;
    float e[64];
    int stage = 0;
    for (int panel = 0; panel < pl.k; ++panel, ++i) {
      const int g = g0 + i;
      stage = g % kStages;
      XW_T0(t0);
      mbar_wait(ring.full + 8 * stage, (g / kStages) & 1);
      XW_ADD(0, t0);
      XW_T0(t1);
      const uint32_t xs = ring.s0 + stage * kStageBytes;
      const uint32_t as = xs + kXBytes + wg * (kWGChains * 128);
      // e (+)= bf16(z_panel) . X_tile,panel^T, both K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PW / 16; ++kk) {
        const uint32_t ka = (kk >> 2) * kOpHalf + (kk & 3) * 32;
        const uint32_t kb = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
        wgmma_m64n128k16_ss<0>(e, smem_desc(as + ka, 16, 1024),
                               smem_desc(xs + kb, 16, 1024),
                               (panel > 0) || (kk > 0));
      }
      wgmma_commit();
      wgmma_wait1();
      XW_ADD(1, t1);
      if (g_prof != nullptr && prof_thread()) prof_add(11, 1);
      if (panel > 0) release(ring, pl, (g - 1) % kStages);
      refill(ring, pl, g0, true, i, n);
    }
    XW_T0(t4);
    wgmma_wait();
    fence_regs(e);
    // the tile's y and mask came with its last panel's stage, which is
    // released once the link has read them
    const float* ym = reinterpret_cast<const float*>(
        sm + (ring.s0 - sm_base) + stage * kStageBytes + kXBytes + kOpBytes);
    // the stage's X and operand (64 KB) are the warpgroups' scratch for
    // their accumulators once both warpgroups' products have read them:
    // nothing else reads or refills the stage before this block releases
    // it
    __syncthreads();
    float4* scratch = reinterpret_cast<float4*>(
        const_cast<unsigned char*>(sm) + (ring.s0 - sm_base) +
        stage * kStageBytes) + (size_t)wg * (kXBytes / 16) + (tid & 127);
    link_tile<L, WANT_U>(e, scratch, rb + (size_t)tile * kOpBytes, row, ym, t,
                         nu, ll0, ll1);
    fence_proxy_async();  // before the copies that refill the stage
    release(ring, pl, stage);
    XW_ADD(4, t4);
  }
  for (; i < n; ++i) idle_item(ring, pl, g0, true, i, n);
  *gi = g0 + n;
}

// Pass 2 for this thread's warpgroup, one panel: g = bf16(r) . X_panel over
// every row tile, items g0 + i .. of the pass's n, X MN-major.
__device__ __forceinline__ void pass_grad(float (&g)[64], const Ring& ring,
                                          const Plan& pl, int g0, int i,
                                          int n) {
  const int wg = threadIdx.x >> 7;
  for (int tile = 0; tile < pl.n_tiles; ++tile, ++i) {
    const int gi = g0 + i, stage = gi % kStages;
    XW_T0(t0);
    mbar_wait(ring.full + 8 * stage, (gi / kStages) & 1);
    XW_ADD(0, t0);
    XW_T0(t1);
    const uint32_t xs = ring.s0 + stage * kStageBytes;
    const uint32_t as = xs + kXBytes + wg * (kWGChains * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk)
      wgmma_m64n128k16_ss<1>(
          g, smem_desc(as + (kk >> 2) * kOpHalf + (kk & 3) * 32, 16, 1024),
          smem_desc(xs + kk * 16 * 128, kHalfBytes, 1024),
          (tile > 0) || (kk > 0));
    wgmma_commit();
    wgmma_wait1();
    XW_ADD(1, t1);
    if (g_prof != nullptr && prof_thread()) prof_add(11, 1);
    if (tile > 0) release(ring, pl, (gi - 1) % kStages);
    refill(ring, pl, g0, false, i, n);
  }
  wgmma_wait();
  fence_regs(g);
  release(ring, pl, (g0 + i - 1) % kStages);
}

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own. Launched
// in clusters of `cluster` blocks (layout_of); cluster q takes chains
// BC q .. BC q + BC - 1. z_out and p_out hold the state between leapfrogs;
// `work` is the workspace (Layout).
template <class L, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_glm_xwide_kernel(const float* __restrict__ z_in,
                           const float* __restrict__ p_in,
                           const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_y,
                           const __grid_constant__ CUtensorMap tmap_mask,
                           const float* __restrict__ eps_ptr,
                           const float* __restrict__ inv_mass,
                           float* __restrict__ z_out,
                           float* __restrict__ p_out,
                           float* __restrict__ u_out, void* work,
                           int n_chains, int n_rows, int dim_padded,
                           int n_leap, float half_eps, float eps,
                           float inv_pv, float nu) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw);
  const Layout lay = layout_of(n_chains, n_rows, dim_padded);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, t = wt & 3;
  const int cl = blockIdx.x / lay.cluster;  // the cluster's chain tile
  const int tile0 = cl * BC;
  const int c0 = tile0 + wg * kWGChains;  // the warpgroup's first chain
  if (RT) {
    eps = *eps_ptr;
    half_eps = 0.5f * eps;
  }

  Plan pl;
  pl.k = lay.k;
  pl.n_tiles = lay.n_tiles;
  pl.c = lay.cluster;
  pl.me = (int)cluster_rank();
  pl.nt = (pl.n_tiles - pl.me + pl.c - 1) / pl.c;
  pl.s1 = (pl.n_tiles + pl.c - 1) / pl.c;
  pl.p_lo = pl.k * pl.me / pl.c;
  pl.p_hi = pl.k * (pl.me + 1) / pl.c;
  pl.s2 = (pl.k + pl.c - 1) / pl.c;
  // the operand's share in whole KB (every copy 16-byte aligned)
  pl.op_lo = 1024 * ((kOpBytes / 1024) * pl.me / pl.c);
  pl.op_bytes = 1024 * ((kOpBytes / 1024) * (pl.me + 1) / pl.c) - pl.op_lo;
  unsigned char* zb = static_cast<unsigned char*>(work) +
                      (size_t)cl * lay.k * kOpBytes;
  unsigned char* rb = static_cast<unsigned char*>(work) + lay.zb_bytes() +
                      (size_t)cl * lay.n_tiles * kOpBytes;
  float2* up = reinterpret_cast<float2*>(static_cast<unsigned char*>(work) +
                                         lay.zb_bytes() + lay.rb_bytes());
  Ring ring;
  ring.x = &tmap_x;
  ring.y = &tmap_y;
  ring.mask = &tmap_mask;
  ring.s0 = base;
  ring.full = base + kOffBar;
  ring.empty = ring.full + 8 * kStages;
  ring.zb = zb;
  ring.rb = rb;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kLocalOp ? kWGs : kWGs * pl.c);
    }
    fence_mbarrier_init();
  }

  // The accumulator's layout, as in the other bodies: element 4 j + 2 h + c
  // of a thread is chain r0 + 8 h of its warpgroup, column 8 j + 2 t + c of
  // the 128-column panel, and zf[2 j + h] is the bf16 pair of z there; row
  // is chain r0's row in the operand images.
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  const int row = wg * kWGChains + r0;
  // bf16(z) of this block's panels from z_in, for the first pass
  for (int panel = pl.p_lo; panel < pl.p_hi; ++panel) {
    uint32_t zf[32];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c0 + r0 + 8 * h;
        float2 zv = make_float2(0.0f, 0.0f);
        if (ch < n_chains)
          zv = *reinterpret_cast<const float2*>(
              z_in + (size_t)ch * dim_padded + panel * PW + 8 * j + 2 * t);
        zf[2 * j + h] = pack_bf16(zv.x, zv.y);
      }
    store_image(zf, zb + (size_t)panel * kOpBytes, row, t);
  }
  fence_proxy_async_global();
  cluster_sync();  // the barriers are initialised, every panel's bf16(z) in zb

  XW_T0(t_all);
  float ll0 = 0.0f, ll1 = 0.0f, zz[2] = {0.0f, 0.0f};
  int gi = 0;
  const int n2 = pl.s2 * pl.n_tiles;
  for (int kl = 0; kl <= n_leap; ++kl) {
    if (kl == n_leap)
      pass_eta<L, true>(ring, pl, &gi, sm, base, rb, row, nu, &ll0, &ll1);
    else
      pass_eta<L, false>(ring, pl, &gi, sm, base, rb, row, nu, &ll0, &ll1);
    fence_proxy_async_global();
    XW_T0(t7);
    cluster_sync();  // every tile's r is in rb
    XW_ADD(7, t7);
    start_pass(ring, pl, gi, false, n2);
    const float* z_at = kl == 0 ? z_in : z_out;
    const float* p_at = kl == 0 ? p_in : p_out;
    int i = 0;
    for (int panel = pl.p_lo; panel < pl.p_hi; ++panel, i += pl.n_tiles) {
      float g[64];
      pass_grad(g, ring, pl, gi, i, n2);
      XW_T0(t5);
      // second half kick of step kl - 1, first half kick and drift of step
      // kl, as the cluster body's, on this panel's columns
      const int col0 = panel * PW;
      unsigned char* zimg = zb + (size_t)panel * kOpBytes;
#pragma unroll
      for (int jb = 0; jb < 16; jb += 4) {
        float2 zv[4][2], pv[4][2];
#pragma unroll
        for (int j = jb; j < jb + 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ch = c0 + r0 + 8 * h;
            zv[j - jb][h] = pv[j - jb][h] = make_float2(0.0f, 0.0f);
            if (ch < n_chains) {
              const size_t o = (size_t)ch * dim_padded + col0 + 8 * j + 2 * t;
              zv[j - jb][h] =
                  __ldcg(reinterpret_cast<const float2*>(z_at + o));
              pv[j - jb][h] =
                  __ldcg(reinterpret_cast<const float2*>(p_at + o));
            }
          }
#pragma unroll
        for (int j = jb; j < jb + 4; ++j) {
          float2 im = make_float2(1.0f, 1.0f);
          if (RT && kl < n_leap)
            im = *reinterpret_cast<const float2*>(inv_mass + col0 + 8 * j +
                                                  2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ii = 4 * j + 2 * h, ch = c0 + r0 + 8 * h;
            float2 z = zv[j - jb][h], p = pv[j - jb][h];
            const float g0 = fmaf(-z.x, inv_pv, g[ii]);
            const float g1 = fmaf(-z.y, inv_pv, g[ii + 1]);
            if (kl > 0) {
              p.x = fmaf(half_eps, g0, p.x);
              p.y = fmaf(half_eps, g1, p.y);
            }
            const size_t o = (size_t)ch * dim_padded + col0 + 8 * j + 2 * t;
            if (kl < n_leap) {
              p.x = fmaf(half_eps, g0, p.x);
              p.y = fmaf(half_eps, g1, p.y);
              z.x = fmaf(eps, RT ? im.x * p.x : p.x, z.x);
              z.y = fmaf(eps, RT ? im.y * p.y : p.y, z.y);
              *reinterpret_cast<uint32_t*>(zimg + image_at(row + 8 * h, j,
                                                           t)) =
                  pack_bf16(z.x, z.y);
              if (ch < n_chains) *reinterpret_cast<float2*>(z_out + o) = z;
            } else {
              zz[h] += z.x * z.x + z.y * z.y;
            }
            if (ch < n_chains) *reinterpret_cast<float2*>(p_out + o) = p;
          }
        }
      }
      XW_ADD(5, t5);
    }
    for (; i < n2; ++i) idle_item(ring, pl, gi, false, i, n2);
    gi += n2;
    if (kl < n_leap) {
      fence_proxy_async_global();
      XW_T0(t8);
      cluster_sync();  // every panel's bf16(z) is in zb
      XW_ADD(7, t8);
    }
  }

  XW_ADD(8, t_all);
  // U per chain: the thread's own sums of its two chains, the four lanes
  // that share a chain in a fixed order, then the cluster's blocks in rank
  // order
  float ll[2] = {ll0, ll1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ll[h] += __shfl_xor_sync(0xffffffffu, ll[h], off);
      zz[h] += __shfl_xor_sync(0xffffffffu, zz[h], off);
    }
    if (t == 0)
      up[(size_t)(c0 + r0 + 8 * h) * pl.c + pl.me] = make_float2(ll[h], zz[h]);
  }
  // also: no block leaves while another may still arrive on its barriers
  cluster_sync();
  if (pl.me == 0 && tid < BC && tile0 + tid < n_chains) {
    const float2* part = up + (size_t)(tile0 + tid) * pl.c;
    float2 s = __ldcg(part);
    for (int b = 1; b < pl.c; ++b) {
      const float2 v = __ldcg(part + b);
      s.x += v.x;
      s.y += v.y;
    }
    u_out[tile0 + tid] = -(s.x - 0.5f * s.y * inv_pv);
  }
}

// The workspace a launch needs, in bytes.
inline size_t workspace_bytes(int n_chains, int n_rows, int dim_padded) {
  return layout_of(n_chains, n_rows, dim_padded).bytes();
}

template <class L, bool RT>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr, const void* inv_mass,
                   void* z_out, void* p_out, void* u_out, void* work,
                   int n_chains, int n_rows, int dim_padded, int n_leap,
                   float half_eps, float eps, float inv_pv, int link, float nu,
                   cudaStream_t stream) {
  (void)link;  // the link is L
  if (work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_y, tmap_mask;
  cudaError_t err = glm_wide::make_tensor_maps(
      X, y, mask, n_rows, dim_padded, &tmap_x, &tmap_y, &tmap_mask);
  if (err != cudaSuccess) return err;
  auto kernel = fused_glm_xwide_kernel<L, RT>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const Layout lay = layout_of(n_chains, n_rows, dim_padded);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.cluster * lay.n_clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(z), static_cast<const float*>(p),
      tmap_x, tmap_y, tmap_mask, static_cast<const float*>(eps_ptr),
      static_cast<const float*>(inv_mass), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), work, n_chains,
      n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, nu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The body on the built-in link of code `link` (fused_glm_common.cuh),
// one instantiation a link, as the library's entries launch it.
template <bool RT>
cudaError_t launch_builtin(const void* z, const void* p, const void* X,
                           const void* y, const void* mask,
                           const void* eps_ptr, const void* inv_mass,
                           void* z_out, void* p_out, void* u_out, void* work,
                           int n_chains, int n_rows, int dim_padded,
                           int n_leap, float half_eps, float eps,
                           float inv_pv, int link, float nu,
                           cudaStream_t stream) {
#define GLM_XWIDE_LINK(CODE)                                               \
  launch<BuiltinLink<CODE>, RT>(z, p, X, y, mask, eps_ptr, inv_mass, z_out, \
                                p_out, u_out, work, n_chains, n_rows,       \
                                dim_padded, n_leap, half_eps, eps, inv_pv,  \
                                link, nu, stream)
  switch (link) {
    case kLogistic:
      return GLM_XWIDE_LINK(kLogistic);
    case kPoisson:
      return GLM_XWIDE_LINK(kPoisson);
    case kProbit:
      return GLM_XWIDE_LINK(kProbit);
    case kStudentT:
      return GLM_XWIDE_LINK(kStudentT);
    default:
      return GLM_XWIDE_LINK(kLinear);
  }
#undef GLM_XWIDE_LINK
}

}  // namespace glm_xwide
}  // namespace

extern "C" void trial_set_prof(void* buf) {
  long long* p = static_cast<long long*>(buf);
  cudaMemcpyToSymbol(glm_xwide::g_prof, &p, sizeof p);
}
