// The fused GLM trajectory's two-pass body past 1024 padded columns, for
// Hopper (sm_90a), templated on its link as the other two GLM bodies are:
// fused_glm_trajectory_xwide.cu instantiates it on BuiltinLinks for the
// package's library, a traced link's translation unit on its own functor
// (mcmc_tpu_torch/ops/_cuda.py: build_link).
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
//    k = dim_padded / 128 panels in the wgmma accumulator (64 registers),
//    bf16(z) of each panel read from device memory as the register A
//    operand, the next panel's read while this one's products run; then
//    the link on its own eta (no exchange: the block holds whole rows of
//    eta), and r's bf16 pairs, already in the A-operand layout of the
//    second product, go to device memory. With the last gradient it sums
//    mask * ll per chain.
// 2. g and the update: block j owns panels [k j / c, k (j + 1) / c); for
//    each it accumulates g_panel = bf16(r) . X over all row tiles (r read
//    back as the register A operand, the next tile's while this one's run),
//    then kicks and drifts that panel's z and p (f32 in z_out, p_out, each
//    element read and written by one thread) and writes bf16(z) for the
//    next gradient's first pass.
// A cluster barrier separates the passes (pass 2 reads every tile's r,
// the next pass 1 every panel's bf16(z)): two a gradient. X's tiles come
// through one ring of kStages stages by the tensor memory accelerator, the
// panel's two 64-column halves under the 128-byte swizzle the products'
// descriptors read (the cluster body's tensor maps), y and mask beside
// them, in the order the two passes consume them; the ring runs on across
// the passes and gradients, since X never changes.
//
// What bounds it on this card. The work: at 3072 columns x 2000 rows and
// 16384 chains a trajectory is 2.01 TFLOP of bf16 products (2.04 ms at the
// tensor cores' peak) against 0.094 ms of the logistic link's special
// functions. Against the cluster body it pays the bytes the exchange
// saved: each pass-1 item (one panel of one tile) reads a 33 KB stage of X
// and the warpgroups' 2 x 16 KB of bf16(z) from L2 for 4.2 MFLOP, each
// pass-2 item the stage and 2 x 16 KB of r; and a warpgroup's tensor cores
// wait on each of its products (one 64 x 128 x 128 product an item) while
// the other warpgroup's run. Not the exchange or the link: those are a
// 64-element pass per tile.
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

constexpr int PW = glm_wide::PW;                // columns of a panel
constexpr int kTileRows = glm_wide::kTileRows;  // data rows of a tile
constexpr int kWGs = 2;
constexpr int kWGChains = 64;
constexpr int BC = kWGs * kWGChains;  // chains per cluster
constexpr int kThreads = kWGs * 128;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kStages = 6;
// a thread that consumes item gi starts item gi + kAhead, whose stage the
// items up to gi - 2 held: every thread is long done with those
constexpr int kAhead = kStages - 2;
constexpr int kXBytes = glm_wide::kXBytes;  // a panel of a tile, 32 KB
constexpr int kHalfBytes = glm_wide::kHalfBytes;
constexpr int kYMBytes = glm_wide::kYMBytes;  // y and mask of a tile
constexpr int kStageBytes = kXBytes + kYMBytes;
static_assert(kStageBytes % 1024 == 0,
              "every stage's X on the 128-byte swizzle's 1024-byte period");
constexpr int kOffBar = kStages * kStageBytes;
constexpr int kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "fits a block");
// a warpgroup's 32-register A fragments of one 64 x 128 operand (bf16(z) of
// a panel, or r of a tile) in device memory: 8 uint4 a thread, the thread
// index fastest, so that a warp's load of each is 512 contiguous bytes
constexpr int kFragU4 = 8 * 128;

// The work of a launch: panels, row tiles, cluster size, clusters; the
// workspace holds bf16(z) [2 n_clusters][k] and r [2 n_clusters][n_tiles]
// as fragments, then U's parts [n_clusters * BC][cluster] (float2: the
// block's sum of mask * ll and of z^2 per chain).
struct Layout {
  int k, n_tiles, cluster, n_clusters;
  __host__ __device__ size_t zb_u4() const {
    return (size_t)2 * n_clusters * k * kFragU4;
  }
  __host__ __device__ size_t rb_u4() const {
    return (size_t)2 * n_clusters * n_tiles * kFragU4;
  }
  size_t bytes() const {
    return 16 * (zb_u4() + rb_u4()) + 8 * (size_t)n_clusters * BC * cluster;
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
// them), pass 2's panels [p_lo, p_hi); the ring's items in that order, per
// gradient and in all.
struct Plan {
  int k, n_tiles, c, me, nt, p_lo, p_hi, per_grad, total;
};

// The ring of X: item gi (tile, panel) into stage gi % kStages; full[s]
// completes when the stage's copies have landed, empty[s] when every thread
// is done with it.
struct Ring {
  const CUtensorMap* x;
  const CUtensorMap* y;
  const CUtensorMap* mask;
  uint32_t x_s;  // stage 0's X; its y and mask follow it
  uint32_t full;
  uint32_t empty;
};

// One thread starts the copies of item gi, if there is one, once every
// thread is done with the item its stage held.
__device__ __forceinline__ void start_item(const Ring& ring, const Plan& pl,
                                           int gi) {
  if (gi >= pl.total) return;
  int i = gi % pl.per_grad, tile, panel;
  const int n1 = pl.nt * pl.k;
  if (i < n1) {
    tile = pl.me + pl.c * (i / pl.k);
    panel = i % pl.k;
  } else {
    i -= n1;
    panel = pl.p_lo + i / pl.n_tiles;
    tile = i % pl.n_tiles;
  }
  const int stage = gi % kStages;
  if (gi >= kStages)
    mbar_wait(ring.empty + 8 * stage, ((gi / kStages) - 1) & 1);
  const uint32_t full = ring.full + 8 * stage;
  mbar_arrive_tx(full, kXBytes + kYMBytes);
  const uint32_t dst = ring.x_s + stage * kStageBytes;
  const int row0 = tile * kTileRows;
  glm_wide::tma_load_2d(dst, ring.x, panel * PW, row0, full);
  glm_wide::tma_load_2d(dst + kHalfBytes, ring.x, panel * PW + 64, row0,
                        full);
  glm_wide::tma_load_1d(dst + kXBytes, ring.y, row0, full);
  glm_wide::tma_load_1d(dst + kXBytes + kTileRows * (int)sizeof(float),
                        ring.mask, row0, full);
}

// Fragments between registers and device memory (`at`: the fragment's
// first uint4). Written by one block and read by another after a cluster
// barrier, so read past L1.
__device__ __forceinline__ void load_frag(uint32_t (&f)[32], const uint4* at,
                                          int wt) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 v = __ldcg(at + i * 128 + wt);
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_frag(const uint32_t (&f)[32], uint4* at,
                                           int wt) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    __stcg(at + i * 128 + wt,
           make_uint4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]));
}

// r of a warpgroup's 64 chains x 128 rows from its eta accumulator, as the
// A operand of the second product: quad u (elements 4 u .. 4 u + 3: chain
// rows r0 and r0 + 8, data rows 8 u + 2 t and + 1) gives the bf16 pairs
// a[2 u] and a[2 u + 1], as the cluster body's owners write them. With
// WANT_U, adds this thread's share of sum(mask * ll) of its two chains to
// *ll0, *ll1.
template <class L, bool WANT_U>
__device__ __forceinline__ void link_tile(const float (&e)[64],
                                          uint32_t (&a)[32], const float* ym,
                                          int t, float nu, float* ll0,
                                          float* ll1) {
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int col = 8 * u + 2 * t;
    const float2 yv = *reinterpret_cast<const float2*>(ym + col);
    const float2 mv = *reinterpret_cast<const float2*>(ym + kTileRows + col);
    float l00, l01, l10, l11;
    const float r00 =
        L::template residual<WANT_U>(nu, e[4 * u], yv.x, &l00) * mv.x;
    const float r01 =
        L::template residual<WANT_U>(nu, e[4 * u + 1], yv.y, &l01) * mv.y;
    const float r10 =
        L::template residual<WANT_U>(nu, e[4 * u + 2], yv.x, &l10) * mv.x;
    const float r11 =
        L::template residual<WANT_U>(nu, e[4 * u + 3], yv.y, &l11) * mv.y;
    if (WANT_U) {
      *ll0 += mv.x * l00;
      *ll0 += mv.y * l01;
      *ll1 += mv.x * l10;
      *ll1 += mv.y * l11;
    }
    a[2 * u] = pack_bf16(r00, r01);
    a[2 * u + 1] = pack_bf16(r10, r11);
  }
}

// link_tile on L's link, or with BuiltinLinks on the built-in link of code
// `link`, chosen once per tile; no wgmma under the switch (ptxas would
// serialise every wgmma of the kernel: its note C7512).
template <class L, bool WANT_U>
__device__ __forceinline__ void apply_link(int link, const float (&e)[64],
                                           uint32_t (&a)[32], const float* ym,
                                           int t, float nu, float* ll0,
                                           float* ll1) {
  if constexpr (std::is_same<L, BuiltinLinks>::value) {
    switch (link) {
      case kLogistic:
        link_tile<BuiltinLink<kLogistic>, WANT_U>(e, a, ym, t, nu, ll0, ll1);
        break;
      case kPoisson:
        link_tile<BuiltinLink<kPoisson>, WANT_U>(e, a, ym, t, nu, ll0, ll1);
        break;
      case kProbit:
        link_tile<BuiltinLink<kProbit>, WANT_U>(e, a, ym, t, nu, ll0, ll1);
        break;
      case kStudentT:
        link_tile<BuiltinLink<kStudentT>, WANT_U>(e, a, ym, t, nu, ll0, ll1);
        break;
      default:
        link_tile<BuiltinLink<kLinear>, WANT_U>(e, a, ym, t, nu, ll0, ll1);
        break;
    }
  } else {
    link_tile<L, WANT_U>(e, a, ym, t, nu, ll0, ll1);
  }
}

// Pass 1 for this thread's warpgroup: eta, the link and r of each of the
// block's row tiles. zb, rb: the warpgroup's bf16(z) [k] and r [n_tiles]
// fragments.
template <class L, bool WANT_U>
__device__ __forceinline__ void pass_eta(const Ring& ring, const Plan& pl,
                                         int* gi, const unsigned char* sm,
                                         uint32_t sm_base, const uint4* zb,
                                         uint4* rb, int link, float nu,
                                         float* ll0, float* ll1) {
  const int tid = threadIdx.x, wt = tid & 127, t = tid & 3;
  for (int i = 0; i < pl.nt; ++i) {
    const int tile = pl.me + pl.c * i;
    float e[64];
    uint32_t zf[32], zn[32];
    load_frag(zf, zb, wt);
    int stage = 0;
    for (int panel = 0; panel < pl.k; ++panel, ++*gi) {
      stage = *gi % kStages;
      mbar_wait(ring.full + 8 * stage, (*gi / kStages) & 1);
      const uint32_t xs = ring.x_s + stage * kStageBytes;
      // e (+)= bf16(z_panel) . X_tile,panel^T, the X tile K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PW / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
        glm_wide::wgmma_m64n128k16_rs_k(e, zf + 4 * kk,
                                        smem_desc(xs + off, 16, 1024),
                                        (panel > 0) || (kk > 0));
      }
      wgmma_commit();
      const bool more = panel + 1 < pl.k;
      if (more) load_frag(zn, zb + (size_t)(panel + 1) * kFragU4, wt);
      wgmma_wait();
      fence_regs(e);
      if (more) {
#pragma unroll
        for (int q = 0; q < 32; ++q) zf[q] = zn[q];
        mbar_arrive(ring.empty + 8 * stage);
      }
      if (tid == 0) start_item(ring, pl, *gi + kAhead);
    }
    // the tile's y and mask came with its last panel's stage, which is
    // released once the link has read them
    const float* ym =
        reinterpret_cast<const float*>(sm + (ring.x_s - sm_base) +
                                       stage * kStageBytes + kXBytes);
    uint32_t a[32];
    apply_link<L, WANT_U>(link, e, a, ym, t, nu, ll0, ll1);
    mbar_arrive(ring.empty + 8 * stage);
    store_frag(a, rb + (size_t)tile * kFragU4, wt);
  }
}

// Pass 2 for this thread's warpgroup, one panel: g = bf16(r) . X_panel over
// every row tile, r read back from rb, X MN-major.
__device__ __forceinline__ void pass_grad(float (&g)[64], const Ring& ring,
                                          const Plan& pl, int* gi,
                                          const uint4* rb) {
  const int tid = threadIdx.x, wt = tid & 127;
  uint32_t a[32], an[32];
  load_frag(a, rb, wt);
  for (int tile = 0; tile < pl.n_tiles; ++tile, ++*gi) {
    const int stage = *gi % kStages;
    mbar_wait(ring.full + 8 * stage, (*gi / kStages) & 1);
    const uint32_t xs = ring.x_s + stage * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk)
      wgmma_m64n128k16_rs(g, a + 4 * kk,
                          smem_desc(xs + kk * 16 * 128, kHalfBytes, 1024),
                          (tile > 0) || (kk > 0));
    wgmma_commit();
    const bool more = tile + 1 < pl.n_tiles;
    if (more) load_frag(an, rb + (size_t)(tile + 1) * kFragU4, wt);
    wgmma_wait();
    fence_regs(g);
    if (more) {
#pragma unroll
      for (int q = 0; q < 32; ++q) a[q] = an[q];
    }
    mbar_arrive(ring.empty + 8 * stage);
    if (tid == 0) start_item(ring, pl, *gi + kAhead);
  }
}

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own. Launched
// in clusters of `cluster` blocks (layout_of); cluster q takes chains
// 128 q .. 128 q + 127. z_out and p_out hold the state between leapfrogs;
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
                           float inv_pv, int link, float nu) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw);
  const Layout lay = layout_of(n_chains, n_rows, dim_padded);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, t = wt & 3;
  const int cl = blockIdx.x / lay.cluster;  // the cluster's chain tile
  const int tile0 = cl * BC;
  const int c0 = tile0 + wg * kWGChains;
  const int n_here = min(kWGChains, n_chains - c0);  // may be <= 0
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
  pl.p_lo = pl.k * pl.me / pl.c;
  pl.p_hi = pl.k * (pl.me + 1) / pl.c;
  pl.per_grad = pl.nt * pl.k + (pl.p_hi - pl.p_lo) * pl.n_tiles;
  pl.total = (n_leap + 1) * pl.per_grad;
  Ring ring;
  ring.x = &tmap_x;
  ring.y = &tmap_y;
  ring.mask = &tmap_mask;
  ring.x_s = base;
  ring.full = base + kOffBar;
  ring.empty = ring.full + 8 * kStages;
  // this warpgroup's fragments of bf16(z) and r, and U's parts
  uint4* zb = static_cast<uint4*>(work) +
              (size_t)(2 * cl + wg) * lay.k * kFragU4;
  uint4* rb = static_cast<uint4*>(work) + lay.zb_u4() +
              (size_t)(2 * cl + wg) * lay.n_tiles * kFragU4;
  float2* up = reinterpret_cast<float2*>(static_cast<uint4*>(work) +
                                         lay.zb_u4() + lay.rb_u4());
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kThreads);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int gi = 0; gi < kAhead; ++gi) start_item(ring, pl, gi);

  // The accumulator's layout, as in the other bodies: element 4 j + 2 h + c
  // of a thread is chain r0 + 8 h, column 8 j + 2 t + c of its warpgroup's
  // 64 x 128 panel, and zf[2 j + h] is the bf16 pair of z there.
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  // bf16(z) of this block's panels from z_in, for the first pass
  for (int panel = pl.p_lo; panel < pl.p_hi; ++panel) {
    uint32_t zf[32];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        float2 zv = make_float2(0.0f, 0.0f);
        if (row < n_here)
          zv = *reinterpret_cast<const float2*>(
              z_in + (size_t)(c0 + row) * dim_padded + panel * PW + 8 * j +
              2 * t);
        zf[2 * j + h] = pack_bf16(zv.x, zv.y);
      }
    store_frag(zf, zb + (size_t)panel * kFragU4, wt);
  }
  cluster_sync();

  float ll0 = 0.0f, ll1 = 0.0f, zz0 = 0.0f, zz1 = 0.0f;
  int gi = 0;
  for (int kl = 0; kl <= n_leap; ++kl) {
    if (kl == n_leap)
      pass_eta<L, true>(ring, pl, &gi, sm, base, zb, rb, link, nu, &ll0,
                        &ll1);
    else
      pass_eta<L, false>(ring, pl, &gi, sm, base, zb, rb, link, nu, &ll0,
                         &ll1);
    cluster_sync();  // every tile's r is in rb
    const float* z_at = kl == 0 ? z_in : z_out;
    const float* p_at = kl == 0 ? p_in : p_out;
    for (int panel = pl.p_lo; panel < pl.p_hi; ++panel) {
      float g[64];
      pass_grad(g, ring, pl, &gi, rb);
      // second half kick of step kl - 1, first half kick and drift of step
      // kl, as the cluster body's, on this panel's columns
      const int col0 = panel * PW;
      uint32_t zf[32];
#pragma unroll
      for (int jb = 0; jb < 16; jb += 4) {
        float2 zv[4][2], pv[4][2];
#pragma unroll
        for (int j = jb; j < jb + 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            zv[j - jb][h] = pv[j - jb][h] = make_float2(0.0f, 0.0f);
            if (row < n_here) {
              const size_t o =
                  (size_t)(c0 + row) * dim_padded + col0 + 8 * j + 2 * t;
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
            const int i = 4 * j + 2 * h, row = r0 + 8 * h;
            float2 z = zv[j - jb][h], p = pv[j - jb][h];
            const float g0 = fmaf(-z.x, inv_pv, g[i]);
            const float g1 = fmaf(-z.y, inv_pv, g[i + 1]);
            if (kl > 0) {
              p.x = fmaf(half_eps, g0, p.x);
              p.y = fmaf(half_eps, g1, p.y);
            }
            const size_t o =
                (size_t)(c0 + row) * dim_padded + col0 + 8 * j + 2 * t;
            if (kl < n_leap) {
              p.x = fmaf(half_eps, g0, p.x);
              p.y = fmaf(half_eps, g1, p.y);
              z.x = fmaf(eps, RT ? im.x * p.x : p.x, z.x);
              z.y = fmaf(eps, RT ? im.y * p.y : p.y, z.y);
              zf[2 * j + h] = pack_bf16(z.x, z.y);
              if (row < n_here) *reinterpret_cast<float2*>(z_out + o) = z;
            } else if (h == 0) {
              zz0 += z.x * z.x + z.y * z.y;
            } else {
              zz1 += z.x * z.x + z.y * z.y;
            }
            if (row < n_here) *reinterpret_cast<float2*>(p_out + o) = p;
          }
        }
      }
      if (kl < n_leap) store_frag(zf, zb + (size_t)panel * kFragU4, wt);
    }
    if (kl < n_leap) cluster_sync();  // every panel's bf16(z) is in zb
  }

  // U per chain: the thread's own sums of its two chains, the four lanes
  // that share a chain in a fixed order, then the cluster's blocks in rank
  // order
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    ll0 += __shfl_xor_sync(0xffffffffu, ll0, off);
    ll1 += __shfl_xor_sync(0xffffffffu, ll1, off);
    zz0 += __shfl_xor_sync(0xffffffffu, zz0, off);
    zz1 += __shfl_xor_sync(0xffffffffu, zz1, off);
  }
  if (t == 0) {
    const size_t ch = (size_t)tile0 + wg * kWGChains + r0;
    up[ch * pl.c + pl.me] = make_float2(ll0, zz0);
    up[(ch + 8) * pl.c + pl.me] = make_float2(ll1, zz1);
  }
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
      n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link, nu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace glm_xwide
}  // namespace
