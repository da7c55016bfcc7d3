// The fused GLM trajectory's cluster body at dim_padded 256 to 1024, for
// Hopper (sm_90a), templated on its link as fused_glm_body.cuh's 128
// body is: fused_glm_trajectory_wide.cu instantiates it on BuiltinLinks
// for the package's library, a traced link's translation unit on its own
// functor (mcmc_tpu_torch/ops/_cuda.py: build_link).
//
// Replaces the same two TPU kernels as fused_glm_body.cuh
// (mcmc_tpu/ops/fused_logreg.py: make_fused_trajectory, kernel body
// :163-199, pallas_call :215; make_fused_trajectory_rt, kernel body
// :498-535, pallas_call :551) at the widths that file's 128-column body
// cannot hold, and computes the same function (see there), with the same
// RT flag: eps from a device pointer and a diagonal inverse mass in the
// drift.
//
// Why a cluster: at 128 k columns the 128 body's gradient accumulator would
// need k times the 64 registers a thread already gives it. So a cluster of
// k = dim_padded / 128 blocks (k <= 8, the portable cluster size) shares 128
// chains, and block j of the cluster owns column panel j: for it, two
// warpgroups of 64 chains hold what the 128 body holds for its whole width
// (bf16(z_j) and the g_j accumulator in registers; z_j and p_j in f32 in
// device memory, read and written by their own thread once a leapfrog) and
// stream panel j of each 128-row tile of X through the block's ring. The
// linear predictor eta = bf16(z) . X^T is a sum over the cluster's panels,
// every tile: each block's partial eta_j goes to the block that owns its
// rows, which sums the k partials, applies the link and sends bf16(r) back
// to every block for g_j += bf16(r) . X_tj.
//
// What bounds it on this card. The work: at 784 columns (896 padded) x 2000
// rows and 16384 chains a trajectory is 514 GFLOP of bf16 products (0.52 ms
// at the tensor cores' peak) against 0.094 ms of the logistic link's special
// functions and 0.062 ms of bytes. But a tile's gradient is one dependent
// chain through the cluster (product, exchange, link, exchange, product):
// clock counters around each link of that chain in the first cluster body
// (two cluster-wide barriers a 64-row tile, the owners pulling the partials
// with remote loads) put 31-48% of a tile's 7,700-8,400 clocks in the two
// barriers and 18-22% in the remote loads, against 15% in the products. So
// the design takes the exchange off the barriers and cuts what it costs:
// - No cluster-wide barrier in the loop. A warpgroup pushes its partial eta
//   quads (a data-row pair of two chains, 16 bytes) straight into the
//   owning block's slots with st.async, whose bytes complete the owner's
//   mbarrier; the owner's threads wait on that barrier only, sum the k slots
//   in rank order, apply the link once per element, and write r's bf16
//   pairs to their own r buffer, from which one thread of the warpgroup
//   sends the owned rows to every other block in one bulk copy each (an
//   8-byte remote store per thread and quad cost about 2,900 more clocks a
//   tile at k = 2); each warpgroup waits only on its own r barrier. Each buffer is refilled only after the data
//   that answers it has come back (a block pushes tile t + 1's eta after
//   tile t's r reached it, which its owners sent after reading tile t's eta;
//   an owner writes tile t + 1's r after tile t + 1's eta, which its sender
//   pushed after reading tile t's r), so one buffer of each and one barrier
//   phase a tile suffice, with no "empty" signal.
// - 128-row tiles: the fixed latency of an exchange is paid once per 128
//   rows. A row count that is a multiple of 64 only has a last tile of 64
//   rows, whose other half the ring's copies fill with zeros.
// - The ring is filled by the tensor memory accelerator: one thread asks for
//   the panel's two 64-column halves (128-byte swizzle) and y and mask, once
//   both warpgroups have arrived on the stage's "empty" barrier.
// Each block owns quads [16 j / k, 16 (j + 1) / k) of a thread's 16; the k
// partials of each are summed in rank order, as in the first cluster body,
// so z and p keep its bits; U's log-likelihood is summed per block over the
// owner's share of each 128-row tile where the first body took a share of
// each 64-row tile, so its last bits differ. Every sum has a fixed order, so
// a launch is deterministic.
//
// What bounds it now, and what it gives up (clock counters, 7,400-7,700
// clocks a 128-row tile at every cluster size): at k = 2 the owner's part
// (the link's special functions, which both warpgroups reach together) is
// 45% of a tile; at k = 7 a block waits on the slowest of its cluster
// (owners of 2 or 3 quads) for a third of a tile, and the eta pushes,
// per-thread remote stores, take a fifth (bulk copies for them would need
// a staging buffer that does not fit beside the ring at k = 7). A
// warpgroup's tensor cores wait through its own exchange, the other
// warpgroup filling some of that; z and p make a round trip through L2
// each leapfrog (a tenth of the time at 16 tiles a gradient); the exchange
// moves about 96 KB a block and 128-row tile through the SM-to-SM network.
//
// Rows padded to the tile carry mask 0, and z, p columns past the model's
// dimension stay exactly zero (their X columns are zero). Chains past
// n_chains in the last cluster are computed on zeros and never stored.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_glm_common.cuh"

namespace {
namespace glm_wide {

constexpr int PW = 128;             // columns of a block's panel
constexpr int kWGs = 2;             // warpgroups per block, one ring of X
constexpr int kWGChains = 64;       // chains per warpgroup (one wgmma M tile)
constexpr int BC = kWGs * kWGChains;  // chains per cluster
constexpr int kThreads = kWGs * 128;
constexpr int kMaxCluster = kMaxDimPadded / PW;
constexpr int kTileRows = 2 * kRowTile;  // data rows per exchange
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;  // tiles in flight beyond the current
// quads of a thread's eta tile (64 chains x kTileRows rows): quad u holds
// rows r0 and r0 + 8 of data rows 8 u + 2 t and + 1, the accumulator's
// elements 4 u .. 4 u + 3, and r's A-operand pairs 2 u and 2 u + 1
constexpr int kQuads = kTileRows / 8;
constexpr int kXBytes = kTileRows * PW * (int)sizeof(bf16);  // 32 KB a tile
constexpr int kHalfBytes = kTileRows * 128;  // one 64-column block of a tile
constexpr int kYMBytes = 2 * kTileRows * (int)sizeof(float);

// The most quads a block owns, and the slots its eta buffer needs: one per
// source block and owned quad.
__host__ __device__ constexpr int own_cap(int k) {
  return (kQuads + k - 1) / k;
}
constexpr int max_slots(int k) {
  return k > kMaxCluster ? 0
                         : (k * own_cap(k) > max_slots(k + 1)
                                ? k * own_cap(k)
                                : max_slots(k + 1));
}
constexpr int kSlots = max_slots(2);
// a warpgroup's eta slots (a float4 per slot and thread: slot
// (src * own_cap + q) * 128 + wt) and r buffer (a uint2 per quad and thread:
// u * 128 + wt)
constexpr int kEtaBytes = kSlots * 128 * (int)sizeof(float4);
constexpr int kRBytes = kQuads * 128 * (int)sizeof(uint2);

// Shared memory of one block, from a 1024-byte aligned base (the swizzle's
// period): the ring of X tiles, the ring of y and mask, each warpgroup's
// eta slots and r buffer, the barriers (the ring's full and empty, each
// warpgroup's eta and r).
constexpr int kOffX = 0;
constexpr int kOffYM = kOffX + kStages * kXBytes;
constexpr int kOffEta = kOffYM + kStages * kYMBytes;
constexpr int kOffR = kOffEta + kWGs * kEtaBytes;
constexpr int kOffBar = kOffR + kWGs * kRBytes;
constexpr int kBars = 2 * kStages + 2 * kWGs;
constexpr int kSmemBytes = kOffBar + kBars * 8 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "fits a block");
static_assert(kSlots <= 32 && kMaxCluster <= 8,
              "a quad's slot and owner fit a byte (Exchange::dst)");
static_assert(kEtaBytes >= kWGChains * (int)sizeof(float2),
              "a warpgroup's per-chain sums of U fit its eta slots");

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// A store to another block's shared memory (a cluster address from
// map_rank) whose bytes complete the transaction count of that block's
// mbarrier `bar`.
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The tensor copies of the ring: a box of `map` at the given coordinates
// into shared memory at `dst`, completing `bar`'s transactions; rows past
// the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// d (64 x 128, f32) = or += A (64 x 16 bf16, registers) .
// B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs_k(float (&d)[64],
                                                      const uint32_t* a,
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ACC16(d, 0), ACC16(d, 16), ACC16(d, 32), ACC16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// e = bf16(z_j) . X_tj^T, this block's partial eta of the tile at xs (the
// X tile K-major: its rows are the product's columns).
__device__ __forceinline__ void eta_product(float (&e)[64],
                                            const uint32_t (&zf)[32],
                                            uint32_t xs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PW / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
    wgmma_m64n128k16_rs_k(e, zf + 4 * kk, smem_desc(xs + off, 16, 1024),
                          kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(e);
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

// The ring of the block's panel of X tiles: tile gi of the trajectory's
// (n_leap + 1) * n_tiles goes to stage gi % kStages, and is tile
// gi % n_tiles of X; full[s] completes when the stage's copies have landed,
// empty[s] when every thread is done with its tile.
struct Ring {
  const CUtensorMap* x;  // X (n_rows x dim_padded bf16), boxes 128 x 64
  const CUtensorMap* y;  // y and mask (n_rows f32), boxes of 128
  const CUtensorMap* mask;
  int col0;  // the block's panel
  int n_tiles;
  int total;
  uint32_t x_s;  // shared addresses
  uint32_t ym_s;
  uint32_t full;
  uint32_t empty;
};

// One thread starts the copies of tile gi, if there is one, once every
// thread is done with the tile its stage held: the panel's two 64-column
// halves, y and mask. Rows past n_rows (the second half of a last 64-row
// tile) arrive as zeros.
__device__ __forceinline__ void start_tile(const Ring& ring, int gi) {
  if (gi >= ring.total) return;
  const int tile = gi % ring.n_tiles, stage = gi % kStages;
  if (gi >= kStages)
    mbar_wait(ring.empty + 8 * stage, ((gi / kStages) - 1) & 1);
  const uint32_t full = ring.full + 8 * stage;
  const int row0 = tile * kTileRows;
  mbar_arrive_tx(full, kXBytes + kYMBytes);
  const uint32_t dst = ring.x_s + stage * kXBytes;
  tma_load_2d(dst, ring.x, ring.col0, row0, full);
  tma_load_2d(dst + kHalfBytes, ring.x, ring.col0 + 64, row0, full);
  const uint32_t ym = ring.ym_s + stage * kYMBytes;
  tma_load_1d(ym, ring.y, row0, full);
  tma_load_1d(ym + kTileRows * (int)sizeof(float), ring.mask, row0, full);
}

// Where this thread's partials and r go: its warpgroup's eta slots, r
// buffer, and their barriers, all at the same offset in every block.
struct Exchange {
  uint32_t eta;    // slot (0, 0) of thread wt
  uint32_t r;      // r quad 0 of thread wt
  uint32_t eta_bar;
  uint32_t r_bar;
  int k;
  int me;          // cluster rank
  int cap;         // own_cap(k): slots per source block
  int u_lo, u_hi;  // the quads this block owns
  // where each quad u of this block's partial goes, in byte u % 4 of
  // dst[u / 4]: its owner's rank << 5 | its slot there (no division in the
  // tile loop)
  uint32_t dst[kQuads / 4];
};

// Quad u of the tile for its owner: the k partials in `slot` (the first
// source's; the others cap * 128 float4 apart) summed in rank order, the
// link, and r's two bf16 pairs. With WANT_U, adds this thread's share of
// sum(mask * ll) of its two rows to *ll0, *ll1.
template <class L, bool WANT_U>
__device__ __forceinline__ uint2 link_quad(const Exchange& x,
                                           const float4* slot,
                                           const float* ym, int t, float nu,
                                           int u, float* ll0, float* ll1) {
  float4 e = slot[0];
#pragma unroll
  for (int b = 1; b < kMaxCluster; ++b)
    if (b < x.k) {
      const float4 v = slot[b * x.cap * 128];
      e.x += v.x;
      e.y += v.y;
      e.z += v.z;
      e.w += v.w;
    }
  const int col = 8 * u + 2 * t;
  const float2 yv = *reinterpret_cast<const float2*>(ym + col);
  const float2 mv = *reinterpret_cast<const float2*>(ym + kTileRows + col);
  float l00, l01, l10, l11;
  const float r00 = L::template residual<WANT_U>(nu, e.x, yv.x, &l00) * mv.x;
  const float r01 = L::template residual<WANT_U>(nu, e.y, yv.y, &l01) * mv.y;
  const float r10 = L::template residual<WANT_U>(nu, e.z, yv.x, &l10) * mv.x;
  const float r11 = L::template residual<WANT_U>(nu, e.w, yv.y, &l11) * mv.y;
  if (WANT_U) {
    *ll0 += mv.x * l00;
    *ll0 += mv.y * l01;
    *ll1 += mv.x * l10;
    *ll1 += mv.y * l11;
  }
  return make_uint2(pack_bf16(r00, r01), pack_bf16(r10, r11));
}

// r of quad u to this block's r buffer; gradient sends the owned quads' r
// to the other blocks.
__device__ __forceinline__ void store_r(const Exchange& x, int u, uint2 rv) {
  const uint32_t r_at = x.r + u * 128 * 8;
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(r_at), "r"(rv.x),
               "r"(rv.y)
               : "memory");
}

// The owner's part of a tile: every quad it owns linked and its r stored,
// two quads at a time so that their loads and special functions overlap.
template <class L, bool WANT_U>
__device__ __forceinline__ void own_quads(const Exchange& x,
                                          const unsigned char* sm,
                                          uint32_t sm_base, const float* ym,
                                          int t, float nu, float* ll0,
                                          float* ll1) {
  const float4* slots =
      reinterpret_cast<const float4*>(sm + (x.eta - sm_base)) -
      x.u_lo * 128;
  int u = x.u_lo;
  for (; u + 1 < x.u_hi; u += 2) {
    const uint2 r0 = link_quad<L, WANT_U>(x, slots + u * 128, ym, t, nu, u,
                                             ll0, ll1);
    const uint2 r1 = link_quad<L, WANT_U>(x, slots + (u + 1) * 128, ym, t,
                                             nu, u + 1, ll0, ll1);
    store_r(x, u, r0);
    store_r(x, u + 1, r1);
  }
  if (u < x.u_hi)
    store_r(x, u, link_quad<L, WANT_U>(x, slots + u * 128, ym, t, nu, u,
                                          ll0, ll1));
}

// The owner's part of a tile on L's link, or with BuiltinLinks on the
// built-in link of code `link`, chosen once per tile. Only the link is under
// the switch: with a wgmma inside a case ptxas serialises every wgmma of the
// kernel (its note C7512).
template <class L, bool WANT_U>
__device__ __forceinline__ void apply_own(int link, const Exchange& x,
                                          const unsigned char* sm,
                                          uint32_t sm_base, const float* ym,
                                          int t, float nu, float* ll0,
                                          float* ll1) {
  if constexpr (std::is_same<L, BuiltinLinks>::value) {
    switch (link) {
      case kLogistic:
        own_quads<BuiltinLink<kLogistic>, WANT_U>(x, sm, sm_base, ym, t, nu,
                                                  ll0, ll1);
        break;
      case kPoisson:
        own_quads<BuiltinLink<kPoisson>, WANT_U>(x, sm, sm_base, ym, t, nu,
                                                 ll0, ll1);
        break;
      case kProbit:
        own_quads<BuiltinLink<kProbit>, WANT_U>(x, sm, sm_base, ym, t, nu,
                                                ll0, ll1);
        break;
      case kStudentT:
        own_quads<BuiltinLink<kStudentT>, WANT_U>(x, sm, sm_base, ym, t, nu,
                                                  ll0, ll1);
        break;
      default:
        own_quads<BuiltinLink<kLinear>, WANT_U>(x, sm, sm_base, ym, t, nu,
                                                ll0, ll1);
        break;
    }
  } else {
    own_quads<L, WANT_U>(x, sm, sm_base, ym, t, nu, ll0, ll1);
  }
}

// g_j <- bf16(r) . X_j over the n_tiles row tiles from global tile *gi on,
// for r from eta = bf16(z) . X^T summed over the cluster's panels; with
// WANT_U, adds this thread's share of sum(mask * ll) to *ll0, *ll1.
template <class L, bool WANT_U>
__device__ __forceinline__ void gradient(float (&g)[64], const Ring& ring,
                                         int* gi, const uint32_t (&zf)[32],
                                         const unsigned char* sm,
                                         uint32_t sm_base, const Exchange& x,
                                         int link,
                                         float nu, float* ll0, float* ll1) {
  const int tid = threadIdx.x, t = tid & 3;
  const int n_own = x.u_hi - x.u_lo;
  for (int it = 0; it < ring.n_tiles; ++it, ++*gi) {
    const int stage = *gi % kStages;
    const uint32_t phase = *gi & 1;
    mbar_wait(ring.full + 8 * stage, (*gi / kStages) & 1);
    const uint32_t xs = ring.x_s + stage * kXBytes;

    // this block's partial eta of the tile
    float e[4 * kQuads];
    eta_product(e, zf, xs);

    // each quad to the slot of this block's rank in its owner's buffer
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const uint32_t code = (x.dst[u >> 2] >> (8 * (u & 3))) & 0xffu;
      const int o = (int)(code >> 5);
      const uint32_t at = x.eta + (code & 31u) * 128 * 16;
      const float4 v =
          make_float4(e[4 * u], e[4 * u + 1], e[4 * u + 2], e[4 * u + 3]);
      if (o == x.me)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                     "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                     : "memory");
      else
        st_async_f4(map_rank(at, o), v, map_rank(x.eta_bar, o));
    }

    // while the partials travel: refill the stage of the tile before this
    // one, once both warpgroups are done with it
    if (tid == 0) start_tile(ring, *gi + kAhead);

    mbar_arrive_tx(x.eta_bar, (x.k - 1) * n_own * 16);
    mbar_wait_cluster(x.eta_bar, phase);
    const float* ym =
        reinterpret_cast<const float*>(sm + kOffYM + stage * kYMBytes);
    apply_own<L, WANT_U>(link, x, sm, sm_base, ym, t, nu, ll0, ll1);
    // the owned quads' r, written by the warpgroup's threads, to the same
    // place in every other block: one bulk copy each
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (tid >> 7)) : "memory");
    if ((tid & 127) == 0) {
      const uint32_t own = x.r + x.u_lo * 128 * 8;
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)
        if (b < x.k && b != x.me)
          bulk_to_block(map_rank(own, b), own, n_own * 128 * 8,
                        map_rank(x.r_bar, b));
    }
    mbar_arrive_tx(x.r_bar, (kQuads - n_own) * 8);
    mbar_wait_cluster(x.r_bar, phase);

    // g_j += bf16(r) . tile_j, r as the register A operand
    uint32_t a[2 * kQuads];
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                   : "=r"(a[2 * u]), "=r"(a[2 * u + 1])
                   : "r"(x.r + u * 128 * 8)
                   : "memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk)
      wgmma_m64n128k16_rs(g, a + 4 * kk,
                          smem_desc(xs + kk * 16 * 128, kHalfBytes, 1024),
                          (it > 0) || (kk > 0));
    wgmma_commit();
    wgmma_wait();
    fence_regs(g);
    mbar_arrive(ring.empty + 8 * stage);
  }
}

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own. Launched
// in clusters of dim_padded / 128 blocks; cluster c takes chains
// 128 c .. 128 c + 127. z_out and p_out hold the state between leapfrogs.
template <class L, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_glm_wide_kernel(const float* __restrict__ z_in,
                          const float* __restrict__ p_in,
                          const __grid_constant__ CUtensorMap tmap_x,
                          const __grid_constant__ CUtensorMap tmap_y,
                          const __grid_constant__ CUtensorMap tmap_mask,
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
  if (RT) {
    eps = *eps_ptr;
    half_eps = 0.5f * eps;
  }

  Ring ring;
  ring.x = &tmap_x;
  ring.y = &tmap_y;
  ring.mask = &tmap_mask;
  ring.col0 = col0;
  ring.n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  ring.total = (n_leap + 1) * ring.n_tiles;
  ring.x_s = base + kOffX;
  ring.ym_s = base + kOffYM;
  ring.full = base + kOffBar;
  ring.empty = ring.full + 8 * kStages;
  Exchange x;
  x.k = k;
  x.me = panel;
  x.cap = own_cap(k);
  x.u_lo = kQuads * panel / k;
  x.u_hi = kQuads * (panel + 1) / k;
#pragma unroll
  for (int i = 0; i < kQuads / 4; ++i) x.dst[i] = 0;
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int o = (k * (u + 1) - 1) / kQuads;  // the last j, kQuads j / k <= u
    const uint32_t slot = x.me * x.cap + u - kQuads * o / k;
    x.dst[u >> 2] |= ((uint32_t)o << 5 | slot) << (8 * (u & 3));
  }
  x.eta = base + kOffEta + wg * kEtaBytes + wt * 16;
  x.r = base + kOffR + wg * kRBytes + wt * 8;
  x.eta_bar = ring.empty + 8 * kStages + 8 * wg;
  x.r_bar = x.eta_bar + 8 * kWGs;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kThreads);
    }
    for (int w = 0; w < kWGs; ++w) {
      mbar_init(base + kOffBar + 8 * (2 * kStages + w), 128);
      mbar_init(base + kOffBar + 8 * (2 * kStages + kWGs + w), 128);
    }
    fence_mbarrier_init();
  }
  // every block of the cluster has started and set up its barriers: from
  // here on the blocks write into each other's shared memory
  cluster_sync();
  if (tid == 0)
    for (int gi = 0; gi < kAhead; ++gi) start_tile(ring, gi);

  // The accumulator's layout, as in the 128 body: element 4 j + 2 h + c of
  // a thread is row r0 + 8 h, column 8 j + 2 t + c of its warpgroup's
  // 64 x 128 panel, and zf[2 j + h] is the bf16 pair of z there.
  const int t = wt & 3;
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  float g[64] = {};
  uint32_t zf[32];  // bf16(z): the A fragments of the first product
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h, col = col0 + 8 * j + 2 * t;
      float2 zv = make_float2(0.0f, 0.0f);
      if (row < n_here)
        zv = *reinterpret_cast<const float2*>(
            z_in + (size_t)(c0 + row) * dim_padded + col);
      zf[2 * j + h] = pack_bf16(zv.x, zv.y);
    }
  }

  float ll0 = 0.0f, ll1 = 0.0f, zz0 = 0.0f, zz1 = 0.0f;
  int gi = 0;
  for (int kl = 0; kl <= n_leap; ++kl) {
    if (kl == n_leap)
      gradient<L, true>(g, ring, &gi, zf, sm, base, x, link, nu, &ll0, &ll1);
    else
      gradient<L, false>(g, ring, &gi, zf, sm, base, x, link, nu, &ll0,
                      &ll1);
    // second half kick of step kl - 1, first half kick and drift of step kl,
    // each thread on the elements it holds, z and p from where the last
    // leapfrog left them, four columns of eight at a time
    const float* z_at = kl == 0 ? z_in : z_out;
    const float* p_at = kl == 0 ? p_in : p_out;
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
            zv[j - jb][h] = __ldcg(reinterpret_cast<const float2*>(z_at + o));
            pv[j - jb][h] = __ldcg(reinterpret_cast<const float2*>(p_at + o));
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
  }

  // U per chain: the thread's own sums of its two rows, the four lanes that
  // share a row in a fixed order, then the cluster's blocks in rank order
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    ll0 += __shfl_xor_sync(0xffffffffu, ll0, off);
    ll1 += __shfl_xor_sync(0xffffffffu, ll1, off);
    zz0 += __shfl_xor_sync(0xffffffffu, zz0, off);
    zz1 += __shfl_xor_sync(0xffffffffu, zz1, off);
  }
  // the warpgroup's eta slots are free: every partial sent to it has been
  // summed, and no block sends more
  float2* part = reinterpret_cast<float2*>(sm + kOffEta + wg * kEtaBytes);
  if (t == 0) {
    part[r0] = make_float2(ll0, zz0);
    part[r0 + 8] = make_float2(ll1, zz1);
  }
  cluster_sync();
  if (panel == 0 && tid < BC) {
    const float2 s = cluster_sum(base + kOffEta + (tid >> 6) * kEtaBytes +
                                     (tid & 63) * 8,
                                 k);
    if (tile0 + tid < n_chains)
      u_out[tile0 + tid] = -(s.x - 0.5f * s.y * inv_pv);
  }
  // no block leaves while the first reads its shared memory
  cluster_sync();
}

// The ring's tensor maps: X in boxes of 128 rows x 64 columns under the
// 128-byte swizzle the products' descriptors read, y and mask in boxes of
// 128; out-of-range rows read as zeros. cuTensorMapEncodeTiled is looked
// up through the runtime's entry-point query, so the library does not link
// libcuda.
cudaError_t make_tensor_maps(const void* X, const void* y, const void* mask,
                             int n_rows, int dim_padded, CUtensorMap* tx,
                             CUtensorMap* ty, CUtensorMap* tm) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t x_dim[2] = {(cuuint64_t)dim_padded, (cuuint64_t)n_rows};
  const cuuint64_t x_stride[1] = {(cuuint64_t)dim_padded * sizeof(bf16)};
  const cuuint32_t x_box[2] = {64, kTileRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(X),
             x_dim, x_stride, x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t v_dim[1] = {(cuuint64_t)n_rows};
  const cuuint64_t v_stride[1] = {(cuuint64_t)sizeof(float)};
  const cuuint32_t v_box[1] = {kTileRows};
  const void* v[2] = {y, mask};
  CUtensorMap* out[2] = {ty, tm};
  for (int i = 0; i < 2; ++i)
    if (encode(out[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
               const_cast<void*>(v[i]), v_dim, v_stride, v_box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <class L, bool RT>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr, const void* inv_mass,
                   void* z_out, void* p_out, void* u_out, int n_chains,
                   int n_rows, int dim_padded, int n_leap, float half_eps,
                   float eps, float inv_pv, int link, float nu,
                   cudaStream_t stream) {
  CUtensorMap tmap_x, tmap_y, tmap_mask;
  cudaError_t err = make_tensor_maps(X, y, mask, n_rows, dim_padded, &tmap_x,
                                     &tmap_y, &tmap_mask);
  if (err != cudaSuccess) return err;
  auto kernel = fused_glm_wide_kernel<L, RT>;
  err = cudaFuncSetAttribute(
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
      tmap_x, tmap_y, tmap_mask, static_cast<const float*>(eps_ptr),
      static_cast<const float*>(inv_mass), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_rows,
      dim_padded, n_leap, half_eps, eps, inv_pv, link, nu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace glm_wide
}  // namespace
