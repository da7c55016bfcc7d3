// Fused HMC leapfrog trajectory on a GLM posterior at dim_padded 256 to
// 1024, for Hopper (sm_90a): the cluster body.
//
// Replaces the same two TPU kernels as fused_glm_trajectory.cu
// (mcmc_tpu/ops/fused_logreg.py: make_fused_trajectory, kernel body
// :163-199, pallas_call :215; make_fused_trajectory_rt, kernel body
// :498-535, pallas_call :551) at the widths that file's 128-column body
// cannot hold, and computes the same function (see there), with the same
// RT flag: eps from a device pointer and a diagonal inverse mass in the
// drift.
//
// What bounds it on this card: the bf16 products. They grow with the width
// and the link does not: at 784 columns (896 padded) x 2000 rows and 16384
// chains a trajectory is 514 GFLOP of bf16 products (0.52 ms at the tensor
// cores' peak) against 0.094 ms of the logistic link's special functions
// and 0.062 ms of bytes.
//
// Why not the 128 body, wider: at 128 k columns its gradient accumulator
// would need k times the 64 registers a thread already gives it, and z and
// p of 128 chains k times the 128 KB of shared memory. So a cluster of
// k = dim_padded / 128 blocks (k <= 8, the portable cluster size) shares
// 128 chains, and block j of the cluster owns column panel j: for it, the
// block holds what the 128 body holds for its whole width (z_j and p_j in
// shared memory, bf16(z_j) and the g_j accumulator in the registers of two
// warpgroups of 64 chains) and streams panel j of each 64-row tile of X
// through its own ring. Per row tile:
// - each block's partial eta_j = bf16(z_j) . X_tj^T (wgmma m64n64k16, A
//   from registers) goes to its shared memory; a cluster barrier;
// - a reduce-scatter through distributed shared memory: of the 8 quads (a
//   data column pair of both rows) of a thread's eta fragment, block j takes
//   its share (8 / k, rounded), sums the k blocks' partials of each in rank
//   order (one 16-byte load a block), applies the link, and writes the bf16
//   pairs of r into every block's r buffer (the all-gather), so that the
//   special functions run once per element, not k times; a cluster barrier;
// - each block loads r from its buffer as the register A operand of
//   g_j += bf16(r) . X_tj (wgmma m64n128k16, the tile read MN-major), the
//   128 body's second product.
// The cluster barriers also free the ring: after the first barrier of a
// tile every thread is done with the tile before it, whose stage the next
// copies refill, so the ring needs only its "full" barriers. Per chain, U's
// log-likelihood (each block has summed its share of the elements) and sum
// of z^2 (each block its panel) are summed over the cluster in rank order
// at the end. Every sum has a fixed order, so a launch is deterministic.
//
// What it gives up, as a first design that is right before it is fast: the
// tensor cores wait through each tile's exchange and link, the exchange
// crosses the SM-to-SM network twice a tile, and the ring is three tiles
// deep (the exchange buffers take the fourth stage's shared memory).
//
// Rows padded to the tile carry mask 0, and z, p columns past the model's
// dimension stay exactly zero (their X columns are zero). Chains past
// n_chains in the last tile are computed on zeros and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_glm_common.cuh"

namespace {

constexpr int PW = 128;             // columns of a block's panel
constexpr int kWGs = 2;             // warpgroups per block, one ring of X
constexpr int kWGChains = 64;       // chains per warpgroup (one wgmma M tile)
constexpr int BC = kWGs * kWGChains;  // chains per cluster
constexpr int kThreads = kWGs * 128;
constexpr int kMaxCluster = kMaxDimPadded / PW;
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;  // tiles in flight beyond the current
constexpr int kPairs = 16;  // register pairs of a thread's 64 x 64 eta tile
constexpr int kQuads = kPairs / 2;  // the pairs of one data column pair
constexpr int kXBytes = kRowTile * PW * (int)sizeof(bf16);  // 16 KB a tile
constexpr int kHalfBytes = kRowTile * 128;  // one 64-column block of a tile
constexpr int kYMBytes = 2 * kRowTile * (int)sizeof(float);
constexpr int kZBytes = kWGChains * PW * (int)sizeof(float);
// a warpgroup's partial eta (a float4 per quad and thread) and r (two bf16
// pairs per quad and thread), quad u of thread wt at slot u * 128 + wt:
// quad u is pairs 2 u and 2 u + 1, rows r0 and r0 + 8 of the same two data
// columns
constexpr int kEtaBytes = kQuads * 128 * (int)sizeof(float4);
constexpr int kRBytes = kQuads * 128 * (int)sizeof(uint2);

// Shared memory of one block, from a 1024-byte aligned base (the swizzle's
// period): the ring of X tiles, each warpgroup's z and p in f32, the ring of
// y and mask, the exchange buffers, the ring's barriers.
constexpr int kOffX = 0;
constexpr int kOffZ = kOffX + kStages * kXBytes;
constexpr int kOffP = kOffZ + kWGs * kZBytes;
constexpr int kOffYM = kOffP + kWGs * kZBytes;
constexpr int kOffEta = kOffYM + kStages * kYMBytes;
constexpr int kOffR = kOffEta + kWGs * kEtaBytes;
constexpr int kOffBar = kOffR + kWGs * kRBytes;
constexpr int kSmemBytes = kOffBar + kStages * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "fits a block");
static_assert(kWGs * kEtaBytes >= BC * (int)sizeof(float2),
              "U's per-chain sums fit the eta buffer");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: this thread's writes, to its own block's
// shared memory or another's, are seen by every thread after the barrier.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of this block's `addr`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_u2(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y)
               : "memory");
}

// The sum over the cluster's k blocks, in rank order, of the float2 at
// `addr` in each block's shared memory.
__device__ __forceinline__ float2 cluster_sum(uint32_t addr, int k) {
  float2 v[kMaxCluster];
#pragma unroll
  for (int b = 0; b < kMaxCluster; ++b)
    if (b < k) v[b] = ld_cluster_f2(map_rank(addr, b));
  float2 s = v[0];
#pragma unroll
  for (int b = 1; b < kMaxCluster; ++b)
    if (b < k) {
      s.x += v[b].x;
      s.y += v[b].y;
    }
  return s;
}

// The same for the float4 at `addr`, element by element.
__device__ __forceinline__ float4 cluster_sum4(uint32_t addr, int k) {
  float4 v[kMaxCluster];
#pragma unroll
  for (int b = 0; b < kMaxCluster; ++b)
    if (b < k) v[b] = ld_cluster_f4(map_rank(addr, b));
  float4 s = v[0];
#pragma unroll
  for (int b = 1; b < kMaxCluster; ++b)
    if (b < k) {
      s.x += v[b].x;
      s.y += v[b].y;
      s.z += v[b].z;
      s.w += v[b].w;
    }
  return s;
}

// The ring of the block's panel of X tiles: tile gi of the trajectory's
// (n_leap + 1) * n_tiles goes to stage gi % kStages, and is tile
// gi % n_tiles of X; full[s] completes when every thread's copies of the
// stage's tile have landed.
struct Ring {
  const bf16* X;  // column panel of the block: X + 128 * rank
  const float* y;
  const float* mask;
  int ld;  // X's row stride, dim_padded
  int n_tiles;
  int total;
  uint32_t x_s;  // shared addresses
  uint32_t ym_s;
  uint32_t full;
};

// Starts this thread's copies of tile gi, if there is one. Its stage held
// tile gi - kStages, which every thread of the cluster is done with.
__device__ __forceinline__ void start_tile(const Ring& ring, int gi, int tid) {
  if (gi >= ring.total) return;
  const int tile = gi % ring.n_tiles, stage = gi % kStages;
  const bf16* src = ring.X + (size_t)tile * kRowTile * ring.ld;
  const uint32_t dst = ring.x_s + stage * kXBytes;
#pragma unroll
  for (int i = 0; i < kRowTile * 16 / kThreads; ++i) {
    const int v = tid + i * kThreads, row = v >> 4, c = v & 15;
    cp_async16(dst + (c >> 3) * kHalfBytes + swizzled(row, c & 7),
               src + (size_t)row * ring.ld + c * 8);
  }
  if (tid < 32)
    cp_async16(ring.ym_s + stage * kYMBytes + tid * 16,
               (tid < 16 ? ring.y : ring.mask) + tile * kRowTile +
                   (tid & 15) * 4);
  cp_async_arrive(ring.full + 8 * stage);
}

// The block's share of a tile: for quads u_lo .. u_hi - 1 of this thread's
// slots, eta summed over the cluster (one 16-byte load a block and quad),
// the link, and r's two bf16 pairs written to the same slot of every
// block's r buffer. eta_s and r_s are the shared addresses of this thread's
// quad 0 slots; the fragment's quad u holds rows r0 and r0 + 8, data
// columns 8 u + 2 t and + 1 of the tile. With WANT_U, adds this thread's
// share of sum(mask * ll) of its two rows to *ll0, *ll1.
template <int LINK, bool WANT_U>
__device__ __forceinline__ void exchange_link(uint32_t eta_s, uint32_t r_s,
                                              const float* ym, int t,
                                              float nu, int k, int u_lo,
                                              int u_hi, float* ll0,
                                              float* ll1) {
  for (int u = u_lo; u < u_hi; ++u) {
    const float4 e = cluster_sum4(eta_s + u * 128 * 16, k);
    const int col = 8 * u + 2 * t;
    const float2 yv = *reinterpret_cast<const float2*>(ym + col);
    const float2 mv = *reinterpret_cast<const float2*>(ym + kRowTile + col);
    float l00, l01, l10, l11;
    const float r00 = link_residual<LINK, WANT_U>(nu, e.x, yv.x, &l00) * mv.x;
    const float r01 = link_residual<LINK, WANT_U>(nu, e.y, yv.y, &l01) * mv.y;
    const float r10 = link_residual<LINK, WANT_U>(nu, e.z, yv.x, &l10) * mv.x;
    const float r11 = link_residual<LINK, WANT_U>(nu, e.w, yv.y, &l11) * mv.y;
    const uint2 rv = make_uint2(pack_bf16(r00, r01), pack_bf16(r10, r11));
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b)
      if (b < k) st_cluster_u2(map_rank(r_s + u * 128 * 8, b), rv);
    if (WANT_U) {
      *ll0 += mv.x * l00;
      *ll0 += mv.y * l01;
      *ll1 += mv.x * l10;
      *ll1 += mv.y * l11;
    }
  }
}

// g_j <- bf16(r) . X_j over the n_tiles row tiles from global tile *gi on,
// for r from eta = bf16(z) . X^T summed over the cluster's panels; with
// WANT_U, adds this thread's share of sum(mask * ll) to *ll0, *ll1.
template <bool WANT_U>
__device__ __forceinline__ void gradient(float (&g)[64], float (&e)[32],
                                         const Ring& ring, int* gi,
                                         const uint32_t (&zf)[32],
                                         const unsigned char* sm,
                                         uint32_t eta_s, uint32_t r_s,
                                         int link, float nu, int k, int u_lo,
                                         int u_hi, float* ll0, float* ll1) {
  const int tid = threadIdx.x, t = tid & 3, wg = tid >> 7, wt = tid & 127;
  float4* eta_own = reinterpret_cast<float4*>(
                        const_cast<unsigned char*>(sm) + kOffEta +
                        wg * kEtaBytes) +
                    wt;
  const uint2* r_own =
      reinterpret_cast<const uint2*>(sm + kOffR + wg * kRBytes) + wt;
  for (int it = 0; it < ring.n_tiles; ++it, ++*gi) {
    const int stage = *gi % kStages;
    mbar_wait(ring.full + 8 * stage, (*gi / kStages) & 1);
    fence_proxy_async();
    const uint32_t xs = ring.x_s + stage * kXBytes;

    // this block's partial eta of the tile, to its shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PW / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_m64n64k16_rs(e, zf + 4 * kk, smem_desc(xs + off, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(e);
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
      eta_own[u * 128] =
          make_float4(e[4 * u], e[4 * u + 1], e[4 * u + 2], e[4 * u + 3]);
    cluster_sync();

    // every thread is done with the tile before this one: refill its stage
    start_tile(ring, *gi + kAhead, tid);
    const float* ym =
        reinterpret_cast<const float*>(sm + kOffYM + stage * kYMBytes);
    // Only the link is under the switch: with a wgmma inside a case ptxas
    // serialises every wgmma of the kernel (its note C7512).
    switch (link) {
      case kLogistic:
        exchange_link<kLogistic, WANT_U>(eta_s, r_s, ym, t, nu, k, u_lo,
                                         u_hi, ll0, ll1);
        break;
      case kPoisson:
        exchange_link<kPoisson, WANT_U>(eta_s, r_s, ym, t, nu, k, u_lo,
                                        u_hi, ll0, ll1);
        break;
      case kProbit:
        exchange_link<kProbit, WANT_U>(eta_s, r_s, ym, t, nu, k, u_lo, u_hi,
                                       ll0, ll1);
        break;
      case kStudentT:
        exchange_link<kStudentT, WANT_U>(eta_s, r_s, ym, t, nu, k, u_lo,
                                         u_hi, ll0, ll1);
        break;
      default:
        exchange_link<kLinear, WANT_U>(eta_s, r_s, ym, t, nu, k, u_lo, u_hi,
                                       ll0, ll1);
        break;
    }
    cluster_sync();

    // g_j += bf16(r) . tile_j, r as the register A operand
    uint32_t a[kPairs];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const uint2 rv = r_own[u * 128];
      a[2 * u] = rv.x;
      a[2 * u + 1] = rv.y;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowTile / 16; ++kk)
      wgmma_m64n128k16_rs(g, a + 4 * kk,
                          smem_desc(xs + kk * 16 * 128, kHalfBytes, 1024),
                          (it > 0) || (kk > 0));
    wgmma_commit();
    wgmma_wait();
    fence_regs(g);
  }
}

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own. Launched
// in clusters of dim_padded / 128 blocks; cluster c takes chains
// 128 c .. 128 c + 127.
template <bool RT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_glm_wide_kernel(const float* __restrict__ z_in,
                          const float* __restrict__ p_in,
                          const bf16* __restrict__ X,
                          const float* __restrict__ y,
                          const float* __restrict__ mask,
                          const float* __restrict__ eps_ptr,
                          const float* __restrict__ inv_mass,
                          float* __restrict__ z_out,
                          float* __restrict__ p_out,
                          float* __restrict__ u_out, int n_chains, int n_rows,
                          int dim_padded, int n_leap, float half_eps,
                          float eps, float inv_pv, int link, float nu) {
  extern __shared__ unsigned char smem_raw[];
  // the same offset in every block of the cluster, so that one address
  // maps to the same buffer in each
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int k = dim_padded / PW;
  const int panel = (int)cluster_rank();
  const int col0 = panel * PW;
  // this thread's warpgroup, its thread in it, and the group's 64 chains
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int tile0 = (blockIdx.x / k) * BC;
  const int c0 = tile0 + wg * kWGChains;
  const int n_here = min(kWGChains, n_chains - c0);  // may be <= 0
  // this block's share of each tile's eta quads
  const int u_lo = kQuads * panel / k, u_hi = kQuads * (panel + 1) / k;
  if (RT) {
    eps = *eps_ptr;
    half_eps = 0.5f * eps;
  }

  Ring ring;
  ring.X = X + col0;
  ring.y = y;
  ring.mask = mask;
  ring.ld = dim_padded;
  ring.n_tiles = n_rows / kRowTile;
  ring.total = (n_leap + 1) * ring.n_tiles;
  ring.x_s = base + kOffX;
  ring.ym_s = base + kOffYM;
  ring.full = base + kOffBar;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(ring.full + 8 * s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block of the cluster has started: from here on the blocks read
  // and write each other's shared memory
  cluster_sync();
  for (int gi = 0; gi < kAhead; ++gi) start_tile(ring, gi, tid);

  // The accumulator's layout, as in the 128 body: element 4 j + 2 h + c of
  // a thread is row r0 + 8 h, column 8 j + 2 t + c of its warpgroup's
  // 64 x 128 panel; z_s and p_s keep the pair (j, h) of the group's thread
  // wt at float2 index (2 j + h) * 128 + wt, and zf[2 j + h] is its bf16
  // pair.
  const int t = wt & 3;
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  float2* z_s = reinterpret_cast<float2*>(sm + kOffZ + wg * kZBytes);
  float2* p_s = reinterpret_cast<float2*>(sm + kOffP + wg * kZBytes);
  const uint32_t eta_s = base + kOffEta + wg * kEtaBytes + wt * 16;
  const uint32_t r_s = base + kOffR + wg * kRBytes + wt * 8;
  float g[64] = {}, e[32] = {};
  uint32_t zf[32];  // bf16(z): the A fragments of the first product
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h, col = col0 + 8 * j + 2 * t;
      float2 zv = make_float2(0.0f, 0.0f), pv = zv;
      if (row < n_here) {
        const size_t gi = (size_t)(c0 + row) * dim_padded + col;
        zv = *reinterpret_cast<const float2*>(z_in + gi);
        pv = *reinterpret_cast<const float2*>(p_in + gi);
      }
      z_s[(2 * j + h) * 128 + wt] = zv;
      p_s[(2 * j + h) * 128 + wt] = pv;
      zf[2 * j + h] = pack_bf16(zv.x, zv.y);
    }
  }

  float ll0 = 0.0f, ll1 = 0.0f;
  int gi = 0;
  for (int kl = 0; kl <= n_leap; ++kl) {
    if (kl == n_leap)
      gradient<true>(g, e, ring, &gi, zf, sm, eta_s, r_s, link, nu, k, u_lo,
                     u_hi, &ll0, &ll1);
    else
      gradient<false>(g, e, ring, &gi, zf, sm, eta_s, r_s, link, nu, k, u_lo,
                      u_hi, &ll0, &ll1);
    // second half kick of step kl - 1, first half kick and drift of step kl,
    // each thread on the elements it holds
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 im = make_float2(1.0f, 1.0f);
      if (RT && kl < n_leap)
        im = *reinterpret_cast<const float2*>(inv_mass + col0 + 8 * j +
                                              2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float2 zv = z_s[(2 * j + h) * 128 + wt];
        const float g0 = fmaf(-zv.x, inv_pv, g[i]);
        const float g1 = fmaf(-zv.y, inv_pv, g[i + 1]);
        float2 pv = p_s[(2 * j + h) * 128 + wt];
        if (kl > 0) {
          pv.x = fmaf(half_eps, g0, pv.x);
          pv.y = fmaf(half_eps, g1, pv.y);
        }
        if (kl < n_leap) {
          pv.x = fmaf(half_eps, g0, pv.x);
          pv.y = fmaf(half_eps, g1, pv.y);
          zv.x = fmaf(eps, RT ? im.x * pv.x : pv.x, zv.x);
          zv.y = fmaf(eps, RT ? im.y * pv.y : pv.y, zv.y);
          z_s[(2 * j + h) * 128 + wt] = zv;
          zf[2 * j + h] = pack_bf16(zv.x, zv.y);
        }
        p_s[(2 * j + h) * 128 + wt] = pv;
      }
    }
  }

  // U per chain, and the state: the thread's own sums of its two rows, the
  // four lanes that share a row in a fixed order, then the cluster's blocks
  // in rank order
  float zz0 = 0.0f, zz1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const float2 zv = z_s[(2 * j + h) * 128 + wt];
      if (h == 0)
        zz0 += zv.x * zv.x + zv.y * zv.y;
      else
        zz1 += zv.x * zv.x + zv.y * zv.y;
      if (row < n_here) {
        const size_t o = (size_t)(c0 + row) * dim_padded + col0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(z_out + o) = zv;
        *reinterpret_cast<float2*>(p_out + o) = p_s[(2 * j + h) * 128 + wt];
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    ll0 += __shfl_xor_sync(0xffffffffu, ll0, off);
    ll1 += __shfl_xor_sync(0xffffffffu, ll1, off);
    zz0 += __shfl_xor_sync(0xffffffffu, zz0, off);
    zz1 += __shfl_xor_sync(0xffffffffu, zz1, off);
  }
  // the eta buffer is free: every block has passed the last tile's barriers
  float2* part = reinterpret_cast<float2*>(sm + kOffEta);
  if (t == 0) {
    part[wg * kWGChains + r0] = make_float2(ll0, zz0);
    part[wg * kWGChains + r0 + 8] = make_float2(ll1, zz1);
  }
  cluster_sync();
  if (panel == 0 && tid < BC) {
    const float2 s = cluster_sum(base + kOffEta + tid * 8, k);
    if (tile0 + tid < n_chains)
      u_out[tile0 + tid] = -(s.x - 0.5f * s.y * inv_pv);
  }
  // no block leaves while the first reads its shared memory
  cluster_sync();
}

template <bool RT>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr, const void* inv_mass,
                   void* z_out, void* p_out, void* u_out, int n_chains,
                   int n_rows, int dim_padded, int n_leap, float half_eps,
                   float eps, float inv_pv, int link, float nu,
                   cudaStream_t stream) {
  auto kernel = fused_glm_wide_kernel<RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int k = dim_padded / PW;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * ((n_chains + BC - 1) / BC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const bf16*>(X), static_cast<const float*>(y),
      static_cast<const float*>(mask), static_cast<const float*>(eps_ptr),
      static_cast<const float*>(inv_mass), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_rows,
      dim_padded, n_leap, half_eps, eps, inv_pv, link, nu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

int fused_glm_wide_launch(bool rt, const void* z, const void* p,
                          const void* X, const void* y, const void* mask,
                          const void* eps_ptr, const void* inv_mass,
                          void* z_out, void* p_out, void* u_out, int n_chains,
                          int n_rows, int dim_padded, int n_leap,
                          float half_eps, float eps, float inv_pv, int link,
                          float nu, cudaStream_t stream) {
  if (dim_padded <= PW || dim_padded > kMaxDimPadded || dim_padded % PW != 0)
    return (int)cudaErrorInvalidValue;
  if (rt)
    return (int)launch<true>(z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out,
                             u_out, n_chains, n_rows, dim_padded, n_leap,
                             half_eps, eps, inv_pv, link, nu, stream);
  return (int)launch<false>(z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out,
                            u_out, n_chains, n_rows, dim_padded, n_leap,
                            half_eps, eps, inv_pv, link, nu, stream);
}
