// Fused HMC leapfrog trajectory on N(m, P^-1) past 1024 padded columns,
// for Hopper (sm_90a): the products on the tensor cores in 3xTF32 (wgmma,
// f32 accumulators), on a grid that fills the card in one wave.
//
// Replaces the TPU kernel of mcmc_tpu/ops/fused_logreg.py
// (make_fused_gaussian_trajectory: kernel body :330-365, pallas_call :381)
// at the widths the body of fused_gaussian_trajectory_wide.cu cannot hold,
// and computes the same function (see fused_gaussian_trajectory.cu): n_leap
// + 1 dependent products g = -(z - m) . P with the update between them,
// the step read from device memory, U = 0.5 * sum(d * (d . P)) from the
// last product; the update explicitly rounded as in the other bodies.
//
// The products are f32-accurate, not f32 FMAs: each operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (tf32: round to nearest, ties
// away, to 10 mantissa bits; x - hi is exact), and d . P is accumulated in
// f32 as d_hi . P_hi + d_hi . P_lo + d_lo . P_hi, three TF32 products into
// one accumulator. That is the card's counterpart of the TPU kernel's own
// 3-pass bf16 decomposition of its f32 matmul on the MXU
// (mcmc_tpu/ops/fused_logreg.py:344-350): a diagonal P does not give the
// plain version's bits (the dropped lo . lo term and lo's rounding leave a
// few units of 2^-24 of each term), and the card's checks hold the kernel
// to float64 instead.
//
// What bounds it: the tensor cores, at 3 TF32 products a product (495
// TFLOP/s of TF32: 7.8 TFLOP at 2,048 x 2,000 and 157 leapfrogs, 15.7 ms),
// and the L2 that feeds them. The design:
// - A block takes a tile of 128 chains (two consumer warpgroups of 64) and
//   a 128-column slice of the product (a wgmma m64n128k8 accumulator, 64
//   registers a thread); a producer warpgroup, one thread of it at work and
//   its registers given to the consumers (setmaxnreg), keeps a ring of
//   kStages (4) stages full by the tensor memory accelerator: a stage is a
//   16-deep panel of K of P's slice and of the tile's d, hi and lo, 8 KB
//   each, K-major under the 64-byte swizzle wgmma's descriptors read.
// - The tensor cores' f32 adds truncate: summed over a whole product (375
//   steps at 1,104 columns, 750 at 2,000) the dense case's error grew with
//   K to 40-170 times the f32 plain version's against float64 (a sum every
//   2 panels: 1.7-2.6 times, and past chip_smoke.py's bound on the plain
//   version at 2,048). So each panel's products (6 steps) run on the
//   tensor cores from zero, and each panel's sum is added rounded to
//   nearest to an f32 sum in registers (64 more a thread: with the
//   128-column slice, why a slice is not 256 columns). The two warpgroups'
//   panels interleave on the tensor cores while each adds its sum. No
//   access of the accumulator lies on a branch, and none is read while a
//   wgmma of the warpgroup is in flight: either way ptxas would serialize
//   every wgmma (two accumulators in turn, to overlap a panel's add with
//   the next one's products, were refused so).
// - P's split and transpose (the B operand must be K-major for tf32:
//   PT[n][k] = P[k][n], so P need not be symmetric) is computed once a
//   launch into the workspace by a pre-pass kernel; d's split is written by
//   the update, where d = z - m is formed, into device memory,
//   double-buffered (a product reads one buffer while the updates write
//   the other).
// - The grid: tiles of 128 chains, and each tile's slices split over c
//   blocks, c the most the occupancy query lets run at once, so the whole
//   grid is one wave (at 2,048 chains: 16 tiles x 8 blocks = 128 blocks on
//   the 132 SMs). The blocks of a tile meet through flags in device memory
//   (one a slice: how far its d is written), not a cluster barrier, so no
//   cluster shape limits the grid; the launch is cooperative, which
//   guarantees that every block is resident, since a block waits on its
//   tile's other blocks. A grid of more tiles than the card holds runs one
//   block a tile (every slice), which waits on itself only.
// - Each output slice reads its K panels from its own first (its d is ready
//   the moment its own update ends), then on around, so a block waits on
//   another only for skew; the order depends on the slice alone, so the
//   bits do not depend on the grid.
// - P's bytes: 128-chain tiles read P's split slice once per 128 chains
//   ((chains / 128) x Dp^2 x 8 bytes a product, 0.5 GB at 2,048 x 2,048,
//   from the L2: the split P, 32 MB, fits it). At 4,096 columns the split P
//   (134 MB) does not: the blocks on one slice index in every tile read the
//   same panels in the same order, start together and run at one rate, so
//   the tiles read each panel at about the same time and all but the first
//   find it in the L2. That keeps P's split in device memory, made once a
//   launch, rather than splitting an f32 P in shared memory every panel,
//   which would cost the consumers a pass over every stage.
//
// Chains past n_chains are computed on zeros and never stored; columns at
// and past the live width (the model's dimension rounded up to 16) are
// copied from the input. Each output's sums have a fixed order (a column's
// K panels in its slice's order, each panel's sum the wgmma's; U's slice
// parts a thread's columns in order, the four lanes of a row by butterfly,
// then the slices in order), so a launch is deterministic.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {
namespace gauss_xwide {

constexpr int BM = 128;           // chains per tile (two warpgroups of 64)
constexpr int BN = 128;           // columns per slice (one wgmma N)
constexpr int KP = 16;            // K depth of a panel (64 bytes of tf32)
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
constexpr int kStages = 4;
constexpr int kLiveMultiple = 16;
constexpr int kPBytes = BN * KP * 4;   // a panel of P's slice, hi or lo
constexpr int kDBytes = BM * KP * 4;   // a panel of the tile's d, hi or lo
constexpr int kStageBytes = 2 * kPBytes + 2 * kDBytes;
// the ring, its barriers, and 1024 bytes to align the ring's base to the
// swizzle's period
constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
static_assert(kSmemBytes <= 232448, "fits a block");
static_assert(kStageBytes % 1024 == 0, "every stage 1024-byte aligned");
static_assert(kLiveMultiple % KP == 0, "the live width is whole panels");

__host__ __device__ inline int live_of(int dim) {
  return (dim + kLiveMultiple - 1) / kLiveMultiple * kLiveMultiple;
}

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

// The work of a launch: the live width, its slices and K panels, the chain
// tiles (rows the tiles cover) and the blocks a tile. The workspace holds,
// at 256-byte aligned offsets: PT_hi, PT_lo [live][live]; d_hi, d_lo
// [2 * rows][live] (two buffers of [rows][live]); U's slice parts
// [rows][slices]; the flags [tiles][slices] (uint32).
struct Layout {
  int live, slices, panels, tiles, rows, per_tile;
  __host__ __device__ size_t pt_bytes() const {
    return align256((size_t)4 * live * live);
  }
  __host__ __device__ size_t d_bytes() const {
    return align256((size_t)4 * 2 * rows * live);
  }
  __host__ __device__ size_t up_bytes() const {
    return align256((size_t)4 * rows * slices);
  }
  __host__ __device__ size_t flag_bytes() const {
    return align256((size_t)4 * tiles * slices);
  }
  __host__ __device__ size_t off_pt_lo() const { return pt_bytes(); }
  __host__ __device__ size_t off_d_hi() const { return 2 * pt_bytes(); }
  __host__ __device__ size_t off_d_lo() const { return off_d_hi() + d_bytes(); }
  __host__ __device__ size_t off_up() const { return off_d_lo() + d_bytes(); }
  __host__ __device__ size_t off_flags() const {
    return off_up() + up_bytes();
  }
  __host__ __device__ size_t bytes() const {
    return off_flags() + flag_bytes();
  }
};

inline Layout layout_of(int n_chains, int dim) {
  Layout l;
  l.live = live_of(dim);
  l.slices = (l.live + BN - 1) / BN;
  l.panels = l.live / KP;
  l.tiles = (n_chains + BM - 1) / BM;
  l.rows = l.tiles * BM;
  l.per_tile = 1;
  return l;
}

// ---------------------------------------------------------------------------
// PTX wrappers this body alone uses.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, float* hi, float* lo) {
  const float h = __uint_as_float(to_tf32(x));
  *hi = h;
  *lo = __uint_as_float(to_tf32(__fsub_rn(x, h)));
}

// A box of `map` at (c0, c1) into shared memory at `dst`, completing
// `bar`'s transactions; elements past the tensor's edge arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Orders this thread's generic-proxy accesses of global memory with the
// async proxy's (the tensor copies that read what the updates wrote).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Waits until *flag >= want. A wait of more than a few seconds is a fault
// (a block that never runs): it traps, so that a launch fails instead of
// hanging the card.
__device__ __forceinline__ void wait_flag(const uint32_t* flag,
                                          uint32_t want) {
  long long t0 = 0;
  while (ld_acquire(flag) < want) {
    if (t0 == 0) t0 = clock64();
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// The warpgroup's register budget, down (the producer) or up (the
// consumers); every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The consumers' own barrier (named barrier 1): the producer's warpgroup is
// not in it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving uses of the accumulator across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory matrix descriptor of a K-major operand under the
// 64-byte swizzle: rows of 64 bytes (16 tf32), 8-row groups 512 bytes
// apart; the leading byte offset is unused for this layout.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

#define K2X_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define K2X_ACC16(d, i) \
  K2X_ACC4(d, i), K2X_ACC4(d, i + 4), K2X_ACC4(d, i + 8), K2X_ACC4(d, i + 12)

// d (64 x 128, f32) = or += A (64 x 8 tf32, shared, K-major) .
// B (8 x 128 tf32, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : K2X_ACC16(d, 0), K2X_ACC16(d, 16), K2X_ACC16(d, 32), K2X_ACC16(d, 48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The pre-pass: PT_hi[n][k], PT_lo[n][k] = the split of P[k][n] over the
// live block, through a 32 x 32 tile in shared memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    split_transpose_kernel(const float* __restrict__ P, int dim_padded,
                           int live, float* __restrict__ pt_hi,
                           float* __restrict__ pt_lo) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = k < live && n < live ? P[(size_t)k * dim_padded + n] : 0.0f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < live && k < live) {
      float hi, lo;
      split_tf32(tile[tx][i], &hi, &lo);
      pt_hi[(size_t)n * live + k] = hi;
      pt_lo[(size_t)n * live + k] = lo;
    }
  }
}

// ---------------------------------------------------------------------------
// The trajectory.
// ---------------------------------------------------------------------------

// Tensor maps of the operands: PT_hi, PT_lo ([live][live], boxes of 256
// rows x 16 columns) and d_hi, d_lo ([2 * rows][live], boxes of 128 x 16).
struct Maps {
  CUtensorMap p_hi, p_lo, d_hi, d_lo;
};

// Launched as tiles x per_tile blocks (layout_of, launch below): block b
// takes chain tile b / per_tile and, of the tile's slices, those of its
// rank b % per_tile. z_out and p_out hold the state between updates;
// `work` is the workspace (Layout).
__global__ void __launch_bounds__(kThreads, 1)
    fused_gaussian_xwide_kernel(const float* z_in, const float* p_in,
                                const __grid_constant__ Maps maps,
                                const float* __restrict__ mean,
                                const float* __restrict__ eps_ptr,
                                float* z_out, float* p_out,
                                float* __restrict__ u_out, unsigned char* work,
                                int n_chains, int dim_padded, int n_leap,
                                Layout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x;
  const int live = lay.live, slices = lay.slices, panels = lay.panels;
  const int ct = blockIdx.x / lay.per_tile, rank = blockIdx.x % lay.per_tile;
  const int s_lo = slices * rank / lay.per_tile;
  const int s_hi = slices * (rank + 1) / lay.per_tile;
  uint32_t* flags = reinterpret_cast<uint32_t*>(work + lay.off_flags()) +
                    (size_t)ct * slices;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: item gi (product t, this block's slice s, the slice's
    // kq-th panel, panel (8 s + kq) mod panels of K) into stage
    // gi % kStages once every consumer warp is done with the item it held:
    // P's panel at once, d's once the slice that writes those columns has
    // written them for this product.
    setmaxnreg_dec<40>();
    if (tid != kConsumers) return;
    int gi = 0;
    for (int t = 0; t <= n_leap; ++t)
      for (int s = s_lo; s < s_hi; ++s) {
        int known = -1;  // the slice whose flag this product has seen
        for (int kq = 0; kq < panels; ++kq, ++gi) {
          const int kp = (s * (BN / KP) + kq) % panels;
          const int st = gi % kStages;
          if (gi >= kStages)
            mbar_wait(empty + 8 * st, ((gi / kStages) - 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t base = ring + st * kStageBytes;
          mbar_arrive_tx(bar, kStageBytes);
          tma_load_2d(base, &maps.p_hi, kp * KP, s * BN, bar);
          tma_load_2d(base + kPBytes, &maps.p_lo, kp * KP, s * BN, bar);
          const int owner = kp * KP / BN;
          if (owner != known) {
            wait_flag(flags + owner, (uint32_t)t + 1);
            fence_proxy_async_global();
            known = owner;
          }
          const int row = (t & 1) * lay.rows + ct * BM;
          tma_load_2d(base + 2 * kPBytes, &maps.d_hi, kp * KP, row, bar);
          tma_load_2d(base + 2 * kPBytes + kDBytes, &maps.d_lo, kp * KP, row,
                      bar);
        }
      }
    return;
  }

  setmaxnreg_inc<232>();
  // The consumers: warpgroup wg owns the tile's rows 64 wg .. 64 wg + 63;
  // a thread the accumulator's rows r0 and r0 + 8 and columns
  // 8 j + 2 q, + 1 of each 8-column group j of the slice.
  const int wg = tid >> 7, lane = tid & 31, q = lane & 3;
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int chain[2] = {ct * BM + r0, ct * BM + r0 + 8};
  const bool ok[2] = {chain[0] < n_chains, chain[1] < n_chains};
  float* d_hi = reinterpret_cast<float*>(work + lay.off_d_hi());
  float* d_lo = reinterpret_cast<float*>(work + lay.off_d_lo());
  float* up = reinterpret_cast<float*>(work + lay.off_up());
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);

  // the start's d = z - m of this thread's elements of slice s, split, into
  // buffer 0 (zeros for chains past n_chains)
  auto write_d0 = [&](int s) {
#pragma unroll 4
    for (int j = 0; j < BN / 8; ++j) {
      const int col = s * BN + 8 * j + 2 * q;
      if (col >= live) continue;
      const float2 m = __ldg(reinterpret_cast<const float2*>(mean + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 z = make_float2(0.0f, 0.0f);
        if (ok[h])
          z = __ldcg(reinterpret_cast<const float2*>(
              z_in + (size_t)chain[h] * dim_padded + col));
        float2 hi = make_float2(0.0f, 0.0f), lo = hi;
        if (ok[h]) {
          split_tf32(__fsub_rn(z.x, m.x), &hi.x, &lo.x);
          split_tf32(__fsub_rn(z.y, m.y), &hi.y, &lo.y);
        }
        const size_t o = (size_t)chain[h] * live + col;
        *reinterpret_cast<float2*>(d_hi + o) = hi;
        *reinterpret_cast<float2*>(d_lo + o) = lo;
      }
    }
  };
  // this block's writes of slice s's d (or of its U parts) are done:
  // every consumer's stores, then the slice's flag
  auto publish = [&](int s, uint32_t v) {
    fence_proxy_async_global();
    consumers_sync();
    if (tid == 0) {
      __threadfence();
      st_release(flags + s, v);
    }
  };

  // the start's d for this block's slices
  for (int s = s_lo; s < s_hi; ++s) {
    write_d0(s);
    publish(s, 1);
  }

  // A product's sum over K runs on the tensor cores a panel at a time,
  // from zero, and each panel's sum is added to `sum` rounded to nearest
  // (see the note at the top).
  float acc[64], sum[64];
  int gi = 0;
  for (int t = 0; t <= n_leap; ++t) {
    const float* z_src = t == 0 ? z_in : z_out;
    const float* p_src = t == 0 ? p_in : p_out;
    const size_t nbuf = (size_t)((t + 1) & 1) * lay.rows * live;
    for (int s = s_lo; s < s_hi; ++s) {
      // the product of the tile's d with P's slice s, panel by panel
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
      for (int kq = 0; kq < panels; ++kq, ++gi) {
        const int st = gi % kStages;
        mbar_wait(full + 8 * st, (gi / kStages) & 1);
        const uint32_t base = ring + st * kStageBytes;
        const uint32_t p_h = base, p_l = base + kPBytes;
        const uint32_t a_h = base + 2 * kPBytes + wg * (kDBytes / 2);
        const uint32_t a_l = a_h + kDBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP / 8; ++kk) {
          const uint32_t o = 32 * kk;
          wgmma_tf32(acc, desc_sw64(a_l + o), desc_sw64(p_h + o), kk > 0);
          wgmma_tf32(acc, desc_sw64(a_h + o), desc_sw64(p_l + o), 1);
          wgmma_tf32(acc, desc_sw64(a_h + o), desc_sw64(p_h + o), 1);
        }
        wgmma_commit();
        // the panel's products are done: its stage is free, and its sum
        // goes into `sum`
        wgmma_wait();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty + 8 * st);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }

      // the last leapfrog's second half kick with the gradient -sum, then
      // (but after the last product) this one's first and the drift, and
      // the next product's d; after the last, U's part of the slice
      float u[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = s * BN + 8 * j + 2 * q;
        if (col < live) {
          const float2 m = __ldg(reinterpret_cast<const float2*>(mean + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)chain[h] * dim_padded + col;
            float2 z = make_float2(0.0f, 0.0f), p = z;
            if (ok[h]) {
              z = __ldcg(reinterpret_cast<const float2*>(z_src + at));
              p = __ldcg(reinterpret_cast<const float2*>(p_src + at));
            }
            float zv[2] = {z.x, z.y}, pv[2] = {p.x, p.y};
            const float mv[2] = {m.x, m.y};
            float dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = sum[4 * j + 2 * h + e];
              if (t > 0) pv[e] = __fadd_rn(pv[e], __fmul_rn(half_eps, -a));
              if (t < n_leap) {
                pv[e] = __fadd_rn(pv[e], __fmul_rn(half_eps, -a));
                zv[e] = __fadd_rn(zv[e], __fmul_rn(eps, pv[e]));
              }
              dv[e] = ok[h] ? __fsub_rn(zv[e], mv[e]) : 0.0f;
            }
            if (ok[h])
              *reinterpret_cast<float2*>(p_out + at) =
                  make_float2(pv[0], pv[1]);
            if (t < n_leap) {
              if (ok[h])
                *reinterpret_cast<float2*>(z_out + at) =
                    make_float2(zv[0], zv[1]);
              float2 hi, lo;
              split_tf32(dv[0], &hi.x, &lo.x);
              split_tf32(dv[1], &hi.y, &lo.y);
              const size_t o = nbuf + (size_t)chain[h] * live + col;
              *reinterpret_cast<float2*>(d_hi + o) = hi;
              *reinterpret_cast<float2*>(d_lo + o) = lo;
            } else {
              // U = 0.5 * sum_j d_j (d . P)_j, with (d . P) = sum at the
              // end position
              u[h] = __fadd_rn(
                  u[h], __fadd_rn(__fmul_rn(dv[0], sum[4 * j + 2 * h]),
                                  __fmul_rn(dv[1], sum[4 * j + 2 * h + 1])));
            }
          }
        }
      }
      if (t == n_leap) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u[h] = __fadd_rn(u[h], __shfl_xor_sync(0xffffffffu, u[h], 1));
          u[h] = __fadd_rn(u[h], __shfl_xor_sync(0xffffffffu, u[h], 2));
          if (q == 0) up[(size_t)chain[h] * slices + s] = u[h];
        }
      }
      // slice s's d for product t + 1 (after the last product: its U
      // parts) is written
      publish(s, (uint32_t)t + 2);
    }
  }

  // U: the slices' parts in order, by the tile's first block, once every
  // slice's are written; and the columns at and past the live width
  if (rank != 0) return;
  if (tid == 0)
    for (int s = 0; s < slices; ++s) wait_flag(flags + s, (uint32_t)n_leap + 2);
  consumers_sync();
  const int c0 = ct * BM;
  const int n_here = min(BM, n_chains - c0);
  if (tid < n_here) {
    const float* ur = up + (size_t)(c0 + tid) * slices;
    float us = __ldcg(ur);
    for (int i = 1; i < slices; ++i) us = __fadd_rn(us, __ldcg(ur + i));
    u_out[c0 + tid] = __fmul_rn(0.5f, us);
  }
  const int n_pad = dim_padded - live;
  for (int i = tid; i < n_here * n_pad; i += kConsumers) {
    const size_t o = (size_t)(c0 + i / n_pad) * dim_padded + live + i % n_pad;
    z_out[o] = z_in[o];
    p_out[o] = p_in[o];
  }
}

// A 2-d tensor map of f32 [rows][cols] (row stride cols), boxes of
// box_rows x 16 under the 64-byte swizzle; elements past the edge read as
// zeros. cuTensorMapEncodeTiled is looked up through the runtime's
// entry-point query, so the library does not link libcuda.
cudaError_t tensor_map(const void* base, int cols, int rows, int box_rows,
                       CUtensorMap* map) {
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
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {KP, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// How many of the trajectory kernel's blocks the current device runs at
// once (the occupancy query at its shared memory, times the SMs), cached
// per device.
cudaError_t capacity(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fused_gaussian_xwide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_gaussian_xwide_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = per_sm * sms;
  *out = per_sm * sms;
  return cudaSuccess;
}

// The layout of a launch on the current device: the blocks a tile are the
// most the card runs at once with every tile's, at most one a slice; with
// more tiles than the card holds, one.
cudaError_t launch_layout(int n_chains, int dim, Layout* lay, int* cap) {
  *lay = layout_of(n_chains, dim);
  const cudaError_t err = capacity(cap);
  if (err != cudaSuccess) return err;
  int per = *cap / lay->tiles;
  if (per > lay->slices) per = lay->slices;
  lay->per_tile = per < 1 ? 1 : per;
  return cudaSuccess;
}

}  // namespace gauss_xwide
}  // namespace

// The workspace of a launch at these sizes, in bytes (`dim` the model's
// dimension).
extern "C" long long fused_gaussian_xwide_workspace_bytes(int n_chains,
                                                          int dim) {
  return (long long)gauss_xwide::layout_of(n_chains, dim).bytes();
}

// The grid of a launch at these sizes on the current device, into out[0..4]:
// blocks, chain tiles, blocks a tile, the blocks the card runs at once, and
// the waves (blocks over that, rounded up). Returns a CUDA error code.
extern "C" int fused_gaussian_xwide_grid(int n_chains, int dim, int* out) {
  using namespace gauss_xwide;
  if (n_chains < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  Layout lay;
  int cap = 0;
  const cudaError_t err = launch_layout(n_chains, dim, &lay, &cap);
  if (err != cudaSuccess) return (int)err;
  const int blocks = lay.tiles * lay.per_tile;
  out[0] = blocks;
  out[1] = lay.tiles;
  out[2] = lay.per_tile;
  out[3] = cap;
  out[4] = (blocks + cap - 1) / cap;
  return 0;
}

// fused_gaussian_trajectory_launch's arguments for dim_padded a multiple of
// 128 past 1024, and `work`, the workspace on the device. Returns a CUDA
// error code.
extern "C" int fused_gaussian_xwide_trajectory_launch(
    const void* z, const void* p, const void* P, const void* mean,
    const void* eps, void* z_out, void* p_out, void* u_out, int n_chains,
    int dim_padded, int dim, int n_leap, void* work, void* stream) {
  using namespace gauss_xwide;
  if (n_chains < 1 || n_leap < 1 || dim < 1 || dim > dim_padded ||
      dim_padded <= 1024 || dim_padded % 128 != 0 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  Layout lay;
  int cap = 0;
  cudaError_t err = launch_layout(n_chains, dim, &lay, &cap);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  float* pt_hi = reinterpret_cast<float*>(w);
  float* pt_lo = reinterpret_cast<float*>(w + lay.off_pt_lo());
  Maps maps;
  const int live = lay.live;
  if ((err = tensor_map(pt_hi, live, live, BN, &maps.p_hi)) != cudaSuccess ||
      (err = tensor_map(pt_lo, live, live, BN, &maps.p_lo)) != cudaSuccess ||
      (err = tensor_map(w + lay.off_d_hi(), live, 2 * lay.rows, BM,
                        &maps.d_hi)) != cudaSuccess ||
      (err = tensor_map(w + lay.off_d_lo(), live, 2 * lay.rows, BM,
                        &maps.d_lo)) != cudaSuccess)
    return (int)err;
  err = cudaMemsetAsync(w + lay.off_flags(), 0, lay.flag_bytes(), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 tgrid((live + 31) / 32, (live + 31) / 32);
  split_transpose_kernel<<<tgrid, 256, 0, st>>>(
      static_cast<const float*>(P), dim_padded, live, pt_hi, pt_lo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = lay.tiles * lay.per_tile;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  // one block a tile waits on itself only: no need for all to be resident
  cfg.numAttrs = lay.per_tile > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, fused_gaussian_xwide_kernel, static_cast<const float*>(z),
      static_cast<const float*>(p), maps, static_cast<const float*>(mean),
      static_cast<const float*>(eps), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), w, n_chains,
      dim_padded, n_leap, lay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
