// The fused GLM trajectory's body at dim_padded 128, for Hopper (sm_90a),
// templated on its link: a functor type with the built-in links'
// signature (fused_glm_common.cuh: BuiltinLink), or BuiltinLinks, the
// five built-in links chosen at run time by their code.
// fused_glm_trajectory.cu instantiates it on BuiltinLinks for the
// package's library; a link traced from torch is compiled into a
// translation unit of its own that includes this header
// (mcmc_tpu_torch/ops/_cuda.py: build_link).
//
// Replaces two TPU kernels of mcmc_tpu/ops/fused_logreg.py with one body:
// make_fused_trajectory (kernel body :163-199, pallas_call :215), and
// make_fused_trajectory_rt (kernel body :498-535, pallas_call :551), which
// is the same trajectory with the step size read at run time and a
// diagonal inverse mass in the drift, z += eps * (inv_mass * p). The
// template flag RT selects the second: eps then comes from a device
// pointer, so a caller that adapts it on the device never synchronises
// with the host, and inv_mass is a (dim_padded,) row. Without the flag the
// step size is a launch argument and the drift is z += eps * p; since
// 1.0f * p is exact, the RT kernel at inv_mass = 1 and the same eps gives
// the same bits.
//
// It computes exactly what those kernels compute, for each chain: n_leap
// leapfrog steps with a N(0, s^2) prior, the boundary gradient carried
// between steps (n_leap + 1 gradient evaluations), each gradient
//     eta = bf16(z) . X^T          (f32 accumulation)
//     (mu, ll) = link(eta, y)
//     r   = (y - mu) * mask
//     g   = bf16(r) . X - z / s^2  (f32 accumulation)
// and the potential U = -(sum(mask * ll) - 0.5 * sum(z^2) / s^2) from the
// last evaluation's bf16-path eta (ROADMAP C2, kept for parity).
//
// What bounds it on this card: arithmetic, of two kinds. At the flagship
// shapes (16384 chains, 128 padded dims, 1024 padded rows, n_leap 4) a
// trajectory is about 43 GFLOP of bf16 products (0.043 ms at the tensor
// cores' peak) and 84M link evaluations, each at least one exponential and
// one reciprocal on the special-function unit (0.040 ms at 16 a clock and
// SM), against 34 MB of state read and written once. The function is
// attention with an elementwise link in place of the softmax, so the design
// at 128 columns is FlashAttention's for this card:
//
// - A warpgroup (128 threads) owns 64 chains for the whole trajectory. The
//   gradient's accumulator (64 x 128 f32) stays in its registers across all
//   row tiles of a gradient, and bf16(z) with it, as the register A operand
//   of the first product. z and p (f32) lie in shared memory in a
//   thread-private order and are touched only at the n_leap + 1 updates,
//   which each thread applies to the elements it holds, with no barrier.
// - eta never leaves registers: the first product of a 64-row tile is
//   wgmma m64n64k16 with A = bf16(z) from registers and B = the X tile read
//   K-major; the link runs on the accumulator; its result is rounded to
//   bf16 in registers and is the register A operand of the second product,
//   wgmma m64n128k16, whose B is the same X tile read MN-major (the
//   instruction's transpose bit). Neither eta nor r nor bf16(z) is stored
//   to shared memory, and a tile costs no block-wide barrier. The second
//   product of a tile and the first of the next are one group of wgmma.
// - X tiles (and the tile's y and mask) arrive by cp.async into a ring of
//   four stages, written in the 128-byte swizzle both readings of wgmma
//   take. Two mbarriers a stage order it: "full" counts the threads' copies
//   as they land (cp.async.mbarrier.arrive, no thread waits for its own
//   copies), "empty" the threads that are done with the tile. The copies of
//   tile t + 3 start during tile t, and the ring runs on across the updates
//   between gradients.
// - Two warpgroups make a block of 128 chains and share the ring, so X
//   comes from L2 once per 128 chains; 16384 chains are 128 blocks, one on
//   each of 128 of the card's 132 SMs (195 KB of shared memory). A group may
//   run up to a tile ahead of the other.
// - The link pays for what is used: the log-likelihood term is compiled
//   into the last gradient only, the link is chosen once per tile, not per
//   element, and its exponential and quotients are the approximate
//   intrinsics __expf and __fdividef (the agreement with the plain version
//   is unchanged to its second digit).
// Per-chain sums are reduced in a fixed order (thread, then the four lanes
// that share a row), so a launch is deterministic.
//
// What still holds it back (measured with builds that each left one cost
// out, and with clock counters around each phase): the products alone reach
// the tensor cores' bound (about 1020 clocks a tile and SM) and the logistic
// link of both warpgroups its special-function bound (about 1080), but the
// two do not overlap: a warpgroup waits where it starts its wgmma until the
// tensor cores take them, so a product started before the link hides little
// of it, and both groups reach the link at the same time. State traffic,
// launch and the ring's barriers (a fifth of the time) overlap nothing.
//
// At dim_padded 256 to 1024 that accumulator does not fit a thread's
// registers, nor z and p a block's shared memory: those widths run the
// cluster body of fused_glm_wide_body.cuh, whose blocks each take one
// 128-column panel of this body's work.
//
// Rows padded to the tile carry mask 0, and z, p columns past the model's
// dimension stay exactly zero (their X columns are zero). Chains past
// n_chains in the last tile are computed on zeros and never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_glm_common.cuh"

namespace {
namespace glm128 {

// ---------------------------------------------------------------------------
// dim_padded 128: warpgroups of 64 chains.
// ---------------------------------------------------------------------------

constexpr int DP = 128;             // padded dimension of this body
constexpr int kWGs = 2;             // warpgroups per block, one ring of X
constexpr int kWGChains = 64;       // chains per warpgroup (one wgmma M tile)
constexpr int BC = kWGs * kWGChains;  // chains per block
constexpr int kThreads = kWGs * 128;
// X tiles in the ring: three were measured 12-15% slower, five no faster
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;  // tiles in flight beyond the current
constexpr int kXBytes = kRowTile * DP * (int)sizeof(bf16);  // 16 KB a tile
constexpr int kHalfBytes = kRowTile * 128;  // one 64-column block of a tile
constexpr int kYMBytes = 2 * kRowTile * (int)sizeof(float);
constexpr int kZBytes = kWGChains * DP * (int)sizeof(float);

// Shared memory of one block, from a 1024-byte aligned base (the swizzle's
// period): the ring of X tiles, each warpgroup's z and p in f32, the ring of
// y and mask, the ring's barriers.
constexpr int kOffX = 0;
constexpr int kOffZ = kOffX + kStages * kXBytes;
constexpr int kOffP = kOffZ + kWGs * kZBytes;
constexpr int kOffYM = kOffP + kWGs * kZBytes;
constexpr int kOffBar = kOffYM + kStages * kYMBytes;
constexpr int kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "fits a block");

// The ring of X tiles, shared by the block's warpgroups: tile gi of the
// trajectory's (n_leap + 1) * n_tiles goes to stage gi % kStages, and is
// tile gi % n_tiles of X. full[s] completes when every thread's copies of
// the stage's tile have landed, empty[s] when every thread is done with it.
// (One arrival a warp, after a wait for the warp's copies, was measured
// slower than these asynchronous arrivals of every thread.)
struct Ring {
  const bf16* X;
  const float* y;
  const float* mask;
  int n_tiles;
  int total;
  uint32_t x_s;   // shared addresses
  uint32_t ym_s;
  uint32_t full;
  uint32_t empty;
};

// Starts this thread's copies of tile gi, if there is one, once the tile
// that held its stage has been given up by every thread.
__device__ __forceinline__ void start_tile(const Ring& ring, int gi, int tid) {
  if (gi >= ring.total) return;
  const int tile = gi % ring.n_tiles, stage = gi % kStages;
  if (gi >= kStages)
    mbar_wait(ring.empty + 8 * stage, (gi / kStages - 1) & 1);
  const bf16* src = ring.X + (size_t)tile * kRowTile * DP;
  const uint32_t dst = ring.x_s + stage * kXBytes;
#pragma unroll
  for (int i = 0; i < kRowTile * 16 / kThreads; ++i) {
    const int v = tid + i * kThreads, row = v >> 4, c = v & 15;
    cp_async16(dst + (c >> 3) * kHalfBytes + swizzled(row, c & 7),
               src + row * DP + c * 8);
  }
  if (tid < 32)
    cp_async16(ring.ym_s + stage * kYMBytes + tid * 16,
               (tid < 16 ? ring.y : ring.mask) + tile * kRowTile +
                   (tid & 15) * 4);
  cp_async_arrive(ring.full + 8 * stage);
}

// The link on one tile's eta, in the accumulator's layout: thread (g, t) of
// a warp holds rows g and g + 8 of its warp's 16 chains and, of each group
// j of 8 data rows, rows 2t and 2t + 1. Writes bf16(r) as the A fragments
// of the second product (a[4 kk .. 4 kk + 3] for its k-step kk).
template <class L, bool WANT_U>
__device__ __forceinline__ void link_tile(const float (&e)[32],
                                          uint32_t (&a)[16], const float* ym,
                                          int t, float nu, float* ll0,
                                          float* ll1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 yv = *reinterpret_cast<const float2*>(ym + 8 * j + 2 * t);
    const float2 mv =
        *reinterpret_cast<const float2*>(ym + kRowTile + 8 * j + 2 * t);
    float l00, l01, l10, l11;
    const float r00 =
        L::template residual<WANT_U>(nu, e[4 * j + 0], yv.x, &l00) * mv.x;
    const float r01 =
        L::template residual<WANT_U>(nu, e[4 * j + 1], yv.y, &l01) * mv.y;
    const float r10 =
        L::template residual<WANT_U>(nu, e[4 * j + 2], yv.x, &l10) * mv.x;
    const float r11 =
        L::template residual<WANT_U>(nu, e[4 * j + 3], yv.y, &l11) * mv.y;
    a[2 * j + 0] = pack_bf16(r00, r01);
    a[2 * j + 1] = pack_bf16(r10, r11);
    if (WANT_U) {
      *ll0 += mv.x * l00;
      *ll0 += mv.y * l01;
      *ll1 += mv.x * l10;
      *ll1 += mv.y * l11;
    }
  }
}

// g <- bf16(r) . X over the n_tiles row tiles from global tile *gi on, for
// r from eta = bf16(z) . X^T; with WANT_U, adds this thread's share of
// sum(mask * ll) of its two rows to *ll0, *ll1.
template <class L, bool WANT_U>
__device__ __forceinline__ void gradient(float (&g)[64], const Ring& ring,
                                         int* gi, const uint32_t (&zf)[32],
                                         const unsigned char* sm, int link,
                                         float nu, float* ll0, float* ll1) {
  const int tid = threadIdx.x, t = tid & 3;
  float e0[32] = {}, e1[32] = {};
  uint32_t a[16];

  // eta of global tile gt = bf16(z) . tile^T into e, once every thread's
  // copies of the tile have landed; started and not yet waited for
  auto start_eta = [&](float (&e)[32], int gt) {
    const int stage = gt % kStages;
    mbar_wait(ring.full + 8 * stage, (gt / kStages) & 1);
    fence_proxy_async();
    const uint32_t xs = ring.x_s + stage * kXBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_m64n64k16_rs(e, zf + 4 * kk, smem_desc(xs + off, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
  };

  // One tile: its eta is in `cur`. The next tile's eta is started into
  // `nxt` first, so that the tensor cores work through this tile's link;
  // then the link on `cur`, then g += bf16(r) . tile.
  auto tile = [&](float (&cur)[32], float (&nxt)[32], int it) {
    const int stage = *gi % kStages;
    const bool more = it + 1 < ring.n_tiles;
    if (more) start_eta(nxt, *gi + 1);
    const float* ym =
        reinterpret_cast<const float*>(sm + kOffYM + stage * kYMBytes);
    // Only the link is under the switch: with a wgmma inside a case ptxas
    // serialises every wgmma of the kernel (its note C7512). A traced link
    // has no switch.
    if constexpr (std::is_same<L, BuiltinLinks>::value) {
      switch (link) {
        case kLogistic:
          link_tile<BuiltinLink<kLogistic>, WANT_U>(cur, a, ym, t, nu, ll0,
                                                    ll1);
          break;
        case kPoisson:
          link_tile<BuiltinLink<kPoisson>, WANT_U>(cur, a, ym, t, nu, ll0,
                                                   ll1);
          break;
        case kProbit:
          link_tile<BuiltinLink<kProbit>, WANT_U>(cur, a, ym, t, nu, ll0,
                                                  ll1);
          break;
        case kStudentT:
          link_tile<BuiltinLink<kStudentT>, WANT_U>(cur, a, ym, t, nu, ll0,
                                                    ll1);
          break;
        default:
          link_tile<BuiltinLink<kLinear>, WANT_U>(cur, a, ym, t, nu, ll0,
                                                  ll1);
          break;
      }
    } else {
      link_tile<L, WANT_U>(cur, a, ym, t, nu, ll0, ll1);
    }

    const uint32_t xs = ring.x_s + stage * kXBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowTile / 16; ++kk)
      wgmma_m64n128k16_rs(g, a + 4 * kk,
                          smem_desc(xs + kk * 16 * 128, kHalfBytes, 1024),
                          (it > 0) || (kk > 0));
    wgmma_commit();
    // The copies of tile *gi + 1 + kAhead start as soon as both warpgroups
    // have given up its stage, so a warpgroup may run a tile ahead of the
    // other. They start behind the products and the fence in start_eta:
    // that fence waits for the thread's copies in flight, and would wait
    // for these.
    if (more) start_tile(ring, *gi + 1 + kAhead, tid);
    wgmma_wait();
    fence_regs(g);
    fence_regs(nxt);
    mbar_arrive(ring.empty + 8 * stage);  // this thread is done with the tile
    ++*gi;
  };

  start_eta(e0, *gi);
  start_tile(ring, *gi + kAhead, tid);
  wgmma_wait();
  fence_regs(e0);
  for (int it = 0; it < ring.n_tiles; it += 2) {
    tile(e0, e1, it);
    if (it + 1 < ring.n_tiles) tile(e1, e0, it + 1);
  }
}

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own.
template <class L, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_glm_trajectory_kernel(const float* __restrict__ z_in,
                                const float* __restrict__ p_in,
                                const bf16* __restrict__ X,
                                const float* __restrict__ y,
                                const float* __restrict__ mask,
                                const float* __restrict__ eps_ptr,
                                const float* __restrict__ inv_mass,
                                float* __restrict__ z_out,
                                float* __restrict__ p_out,
                                float* __restrict__ u_out, int n_chains,
                                int n_rows, int n_leap, float half_eps,
                                float eps, float inv_pv, int link, float nu) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  // this thread's warpgroup, its thread in it, and the group's 64 chains
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  float2* z_s = reinterpret_cast<float2*>(sm + kOffZ + wg * kZBytes);
  const int c0 = blockIdx.x * BC + wg * kWGChains;
  const int n_here = min(kWGChains, n_chains - c0);  // may be <= 0
  if (RT) {
    eps = *eps_ptr;
    half_eps = 0.5f * eps;
  }

  Ring ring;
  ring.X = X;
  ring.y = y;
  ring.mask = mask;
  ring.n_tiles = n_rows / kRowTile;
  ring.total = (n_leap + 1) * ring.n_tiles;
  ring.x_s = base + kOffX;
  ring.ym_s = base + kOffYM;
  ring.full = base + kOffBar;
  ring.empty = base + kOffBar + 8 * kStages;
  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s)
      mbar_init(ring.full + 8 * s, kThreads);
    fence_mbarrier_init();
  }
  __syncthreads();
  for (int gi = 0; gi < kAhead; ++gi) start_tile(ring, gi, tid);

  // The accumulator's layout: element 4 j + 2 h + c of a thread is row
  // r0 + 8 h, column 8 j + 2 t + c of its warpgroup's 64 x 128. z_s and p_s
  // keep the pair (j, h) of the group's thread wt at float2 index
  // (2 j + h) * 128 + wt, and zf[2 j + h] is its bf16 pair: the first
  // product's A fragment of k-step kk is zf[4 kk .. 4 kk + 3].
  const int t = wt & 3;
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  float2* p_s = reinterpret_cast<float2*>(sm + kOffP + wg * kZBytes);
  float g[64] = {};
  uint32_t zf[32];  // bf16(z): the A fragments of the first product
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h, col = 8 * j + 2 * t;
      float2 zv = make_float2(0.0f, 0.0f), pv = zv;
      if (row < n_here) {
        const size_t gi = (size_t)(c0 + row) * DP + col;
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
  for (int k = 0; k <= n_leap; ++k) {
    if (k == n_leap)
      gradient<L, true>(g, ring, &gi, zf, sm, link, nu, &ll0, &ll1);
    else
      gradient<L, false>(g, ring, &gi, zf, sm, link, nu, &ll0, &ll1);
    // second half kick of step k - 1, first half kick and drift of step k,
    // each thread on the elements it holds
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 im = make_float2(1.0f, 1.0f);
      if (RT && k < n_leap)
        im = *reinterpret_cast<const float2*>(inv_mass + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float2 zv = z_s[(2 * j + h) * 128 + wt];
        const float g0 = fmaf(-zv.x, inv_pv, g[i]);
        const float g1 = fmaf(-zv.y, inv_pv, g[i + 1]);
        float2 pv = p_s[(2 * j + h) * 128 + wt];
        if (k > 0) {
          pv.x = fmaf(half_eps, g0, pv.x);
          pv.y = fmaf(half_eps, g1, pv.y);
        }
        if (k < n_leap) {
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

  // U per chain, and the state: the thread's own sums of its two rows, then
  // the four lanes that share a row in a fixed order
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
        const size_t o = (size_t)(c0 + row) * DP + 8 * j + 2 * t;
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
  if (t == 0) {
    if (r0 < n_here) u_out[c0 + r0] = -(ll0 - 0.5f * zz0 * inv_pv);
    if (r0 + 8 < n_here) u_out[c0 + r0 + 8] = -(ll1 - 0.5f * zz1 * inv_pv);
  }
}

template <class L, bool RT>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr, const void* inv_mass,
                   void* z_out, void* p_out, void* u_out, int n_chains,
                   int n_rows, int n_leap, float half_eps, float eps,
                   float inv_pv, int link, float nu, cudaStream_t stream) {
  auto kernel = fused_glm_trajectory_kernel<L, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_chains + BC - 1) / BC);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const bf16*>(X), static_cast<const float*>(y),
      static_cast<const float*>(mask), static_cast<const float*>(eps_ptr),
      static_cast<const float*>(inv_mass), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_rows,
      n_leap, half_eps, eps, inv_pv, link, nu);
  return cudaGetLastError();
}

}  // namespace glm128
}  // namespace
