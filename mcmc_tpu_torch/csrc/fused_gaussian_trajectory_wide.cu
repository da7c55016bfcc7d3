// Fused HMC leapfrog trajectory on N(m, P^-1) at dim_padded 256 to 1024,
// for Hopper (sm_90a): P streamed from L2 into each block by bulk copies on
// an mbarrier ring.
//
// Replaces the TPU kernel of mcmc_tpu/ops/fused_logreg.py
// (make_fused_gaussian_trajectory: kernel body :330-365, pallas_call :381)
// at the widths the register-resident body of fused_gaussian_trajectory.cu
// cannot hold, and computes the same function (see there): n_leap + 1
// dependent f32 products g = -(z - m) . P with the update between them, the
// step read from device memory, U = 0.5 * sum(d * (d . P)) from the last
// product. All f32, as the reference (the target is ill-conditioned on
// purpose): the products are FP32 FMAs, not TF32.
//
// What bounds it on this card: the work is the FP32 FMA pipe's, 158
// dependent products at the suite's protocol: 2 * 2048 * 250^2 * 158 flop =
// 40 GFLOP at 250 dims (0.60 ms at 67 TFLOP/s), 9.66 ms at 1000. P does not
// fit an SM (256 KB at 256 columns, 4 MB at 1024), so a block takes 16
// chains for the whole trajectory (2048 chains are 128 blocks, one an SM)
// and streams P's live rows from the 50 MB L2 through shared memory once a
// product, in panels of kt whole padded rows (one contiguous range of P).
// Clock counters in the first body of this shape (a thread on 8 chains x 4
// columns, 512 threads, z and p in registers, one block barrier a panel, a
// cp.async ring filled by every thread) put a panel at about 2,500 clocks:
// 1,680 in the FMA loop, as long with the panel resident in shared memory
// as streamed, and 700-960 in issuing the copies. Not the L2: the loop was
// bound by shared-memory cycles (a row of P cost a warp three 16-byte loads,
// four cycles each, to 8 cycles of FMA issue), and the rest by the ring. So:
// - a thread accumulates 8 chains x 8 columns (two groups of 4 adjacent
//   columns, 128 apart, so that a warp's load of each group is 512
//   contiguous bytes; the 8 chains' d two 16-byte loads every lane shares):
//   a row is 64 FMAs to four loads, 16 shared-memory cycles to 16 of FMA
//   issue. 8 warps of 256 threads, up to 255 registers each;
// - z and p live in z_out and p_out between updates and in registers a
//   column group at a time around them: with their 128 registers held
//   across the products the loop took 1,850 clocks a panel, alone 1,190;
// - one instantiation a padded width, so that every stride and the split-K
//   groups' size are constants and their addresses immediates;
// - the rows are software-pipelined across panels: a warp loads the next
//   panel's first row before this panel's last FMAs (a barrier wait or
//   arrival between panels is a fence no load crosses, and the pipeline
//   drained there: 13% of the loop);
// - a panel comes in as one bulk copy, so no thread issues copies (the
//   same panel multicast to clusters of 2 blocks measured the same on an
//   H100 at 256-896 columns and 1.2% faster at 1024: the L2 is not the
//   limit, so the blocks share nothing);
// - the ring of kStages panels runs on mbarriers, with no block barrier a
//   panel: a stage's "full" barrier completes with its copy's bytes; its
//   "empty" barrier when every warp has arrived on it after reading the
//   stage; the warps take turns to issue, each waiting on "empty" first.
//   Two block barriers a product remain (d_s written; the split-K
//   hand-off);
// - narrow models split each panel's rows over ks groups of warps (split-K),
//   the first group adding the other groups' sums in group order and
//   updating;
// - it does not multiply the padding: the wrapper passes the model's
//   dimension, the kernel's live width is that rounded up to 16, and the
//   columns past it are copied from the input to the output (P the
//   identity there, z, p and m zero: they come out exactly zero).
// What bounds it now: shared-memory cycles (the loads, and the copies'
// 32 KB a panel written into every block) and, at 256 columns, the update
// between products (z and p through L2, d's stores into shared memory, 20%
// of a product there).
// Every output's sum keeps the order of the first body (the same panels,
// the same split-K groups, each group's rows in order, the groups added in
// order, U's lanes by the same butterfly and its 128-column parts in
// order), so z, p and U are that body's bits.
//
// Chains past n_chains are computed on zeros and never stored. Per-chain
// sums for U are reduced in a fixed order, so a launch is deterministic. As
// in the 128 body, the update uses explicitly rounded multiplies and adds,
// so that it rounds where the plain tensor code rounds; on a diagonal P
// every product has one non-zero term and z, p equal the plain version's
// bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

constexpr int C = 16;      // chains per block
constexpr int CT = 8;      // chains per thread
constexpr int kCols = 4;   // adjacent columns per thread and column group
constexpr int kGroups = 2;  // column groups per thread, 128 columns apart
constexpr int kWarpCols = 32 * kCols * kGroups;  // a warp's 256 columns
constexpr int kMaxWarps = 8;
constexpr int kStages = 5;  // ring stages: the most that fit at 1024
// a warp that starts panel gp + 1 has had panels up to gp + 1 + kAhead issued
constexpr int kAhead = kStages - 2;
constexpr int kStageFloats = 8192;  // 32 KB: a panel's rows x live columns
constexpr int kLiveMultiple = 16;
constexpr int kMaxLive = 1024;
constexpr int kSlots = CT * kCols * kGroups;  // a thread's accumulators

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One row of the product: a thread's 4 + 4 columns of P (pa at j0, pb at
// jb) and its 8 chains of d (da, db), and their 64 FMAs into acc
struct Row {
  float4 pa, pb, da, db;
};

__device__ __forceinline__ Row load_row(const float* p_row, const float* d_row,
                                        int j0, int jb) {
  return Row{load4(p_row + j0), load4(p_row + jb), load4(d_row),
             load4(d_row + 4)};
}

__device__ __forceinline__ void fma_row(float (&acc)[CT][kSlots / CT],
                                        const Row& o) {
  const float dv[CT] = {o.da.x, o.da.y, o.da.z, o.da.w,
                        o.db.x, o.db.y, o.db.z, o.db.w};
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    acc[c][0] = __fmaf_rn(dv[c], o.pa.x, acc[c][0]);
    acc[c][1] = __fmaf_rn(dv[c], o.pa.y, acc[c][1]);
    acc[c][2] = __fmaf_rn(dv[c], o.pa.z, acc[c][2]);
    acc[c][3] = __fmaf_rn(dv[c], o.pa.w, acc[c][3]);
    acc[c][4] = __fmaf_rn(dv[c], o.pb.x, acc[c][4]);
    acc[c][5] = __fmaf_rn(dv[c], o.pb.y, acc[c][5]);
    acc[c][6] = __fmaf_rn(dv[c], o.pb.z, acc[c][6]);
    acc[c][7] = __fmaf_rn(dv[c], o.pb.w, acc[c][7]);
  }
}

// The work split at live width `live` of a model padded to `dp` columns:
// column warps of 256 columns, split-K groups, rows of P per panel, and
// shared memory in 4-byte words (the ring of panels [kStages][kt][dp]:
// whole padded rows, so that a panel is one contiguous range of P; d
// [live][C]; the other groups' partial sums [ks - 1][kSlots][group
// threads]; U's partial sums [C][128-column parts]; the ring's barriers).
// The groups are those of the first body, which put as many warps of 128
// columns on the SM as made 16, so every sum keeps its order: here they
// make at most 8 warps of 256. A group's rows of a panel are 4 or 8.
struct Split {
  int ncw, ks, kt, threads, floats;
};

__host__ __device__ inline Split split_of(int live, int dp) {
  Split s;
  s.ncw = (live + kWarpCols - 1) / kWarpCols;
  s.kt = 8;
  for (int kt = 32; kt > 8; kt /= 2)
    if (kt * dp <= kStageFloats && live % kt == 0) {
      s.kt = kt;
      break;
    }
  const int parts = (live + 127) / 128;
  s.ks = 1;
  while (2 * s.ks * 2 * parts <= 2 * kMaxWarps && s.kt % (2 * s.ks) == 0)
    s.ks *= 2;
  s.threads = 32 * 2 * s.ncw * s.ks;
  s.floats = kStages * s.kt * dp + live * C +
             (s.ks - 1) * kSlots * (s.threads / s.ks) + C * kGroups * s.ncw +
             4 * kStages;
  return s;
}

// One instantiation a padded width DP, so that the column warps, the
// split-K groups' size and every stride are constants: the addresses of
// the hand-off's 64 sums, z, p and P's rows are immediates, which leaves the
// registers to the products.
template <int DP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    fused_gaussian_wide_kernel(const float* z_in, const float* p_in,
                               const float* __restrict__ P,
                               const float* __restrict__ mean,
                               const float* __restrict__ eps_ptr,
                               float* z_out, float* p_out,
                               float* __restrict__ u_out, int n_chains,
                               int live, int n_leap) {
  extern __shared__ __align__(16) float smem[];
  constexpr int dim_padded = DP;
  // every live width of a model padded to DP has this many column warps
  constexpr int n_cw = (DP + kWarpCols - 1) / kWarpCols;
  constexpr int group_threads = 2 * 32 * n_cw;
  const Split sp = split_of(live, dim_padded);
  const int kt = sp.kt;
  const int panel_floats = kt * dim_padded;
  float* p_s = smem;                          // [kStages][kt][dim_padded]
  float* d_s = p_s + kStages * panel_floats;  // [live][C]
  float* red_s = d_s + live * C;              // [ks - 1][kSlots][group]
  float* ured_s = red_s + (sp.ks - 1) * kSlots * group_threads;
  // the ring's barriers: full[s] at bars + 8 s, empty[s] after them
  const uint32_t bars = smem_u32(ured_s + C * kGroups * n_cw);

  const int tid = threadIdx.x, lane = tid % 32, n_warps = sp.threads / 32;
  // split-K group kg takes rows kg * rows .. + rows - 1 of each panel; in
  // it, chains 8 half .. 8 half + 7 of the tile, columns j0 + 128 g .. + 3
  // of column group g
  const int kg = tid / group_threads, tig = tid % group_threads;
  const int warp = tig / 32, half = warp / n_cw, cw = warp % n_cw;
  const int row0 = kg * (kt / sp.ks);  // a group's rows: 4 or 8
  const int j0 = cw * kWarpCols + kCols * lane;
  bool live_g[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) live_g[g] = j0 + 128 * g < live;
  // a dead second group reads the first group's columns (never used), so
  // that no load leaves the row
  const int jb = live_g[1] ? j0 + 128 : j0;
  const bool leader = kg == 0;  // updates z and p
  const int c0 = blockIdx.x * C;
  const int n_here = min(C, n_chains - c0);
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);
  const int n_panels = live / kt;
  const int total = (n_leap + 1) * n_panels;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), n_warps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();  // the barriers are set up before a copy reaches them

  // one thread: panel q (rows (q % n_panels) * kt .. + kt - 1 of P) into
  // stage q % kStages, once every warp is done with the panel it held
  auto issue = [&](int q) {
    const int s = q % kStages;
    if (q >= kStages) mbar_wait(bars + 8 * (kStages + s), (q / kStages - 1) & 1);
    mbar_arrive_tx(bars + 8 * s, 4 * panel_floats);
    bulk_from_global(smem_u32(p_s + s * panel_floats),
                     P + (size_t)(q % n_panels) * panel_floats,
                     4 * panel_floats, bars + 8 * s);
  };

  // z and p of the leader's chains and columns live in z_out and p_out
  // (read back, so not __restrict__) between updates, and in registers a
  // column group at a time around them, which leaves the registers to the
  // products: v <- src, or dst <- v, for column group g
  bool ok[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) ok[c] = leader && CT * half + c < n_here;
  auto at = [&](int c, int g) {
    return (size_t)(c0 + CT * half + c) * dim_padded + j0 + 128 * g;
  };
  auto load_zp = [&](float (&v)[CT][kCols], const float* src, int g) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok[c] && live_g[g]) x = load4(src + at(c, g));
      v[c][0] = x.x, v[c][1] = x.y, v[c][2] = x.z, v[c][3] = x.w;
    }
  };
  auto store_zp = [&](const float (&v)[CT][kCols], float* dst, int g) {
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (ok[c] && live_g[g])
        *reinterpret_cast<float4*>(dst + at(c, g)) =
            make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
  };
  // d = z - m of column group g of the leader's chains, to d_s (chains past
  // n_chains 0)
  auto store_d = [&](const float (&z)[CT][kCols], int g) {
    if (!live_g[g]) return;
    const float4 mv = load4(mean + j0 + 128 * g);
    const float m[kCols] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      float d[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        d[c] = ok[c] ? __fsub_rn(z[c][e], m[e]) : 0.0f;
      float* row = d_s + (j0 + 128 * g + e) * C + CT * half;
      *reinterpret_cast<float4*>(row) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(d[4], d[5], d[6], d[7]);
    }
  };

  // acc[c][4 g + e] <- sum over the live rows k of d[chain c][k] *
  // P[k][j0 + 128 g + e]: each group sums its rows of every panel in
  // order. The global panel index gp runs on from product to product.
  // The rows are software-pipelined across panels: a warp loads the next
  // panel's first row before the FMAs of this panel's last, since a wait or
  // an arrival on a barrier is a fence no load is moved across (without it,
  // the pipeline drained at every panel: 13% of the loop). Lanes past the
  // live width compute on P's padding, and nothing of theirs is stored.
  float acc[CT][kSlots / CT];
  int gp = 0;
  int turn = kAhead % n_warps;  // the warp that issues panel gp + kAhead
  const float* d_half = d_s + CT * half;
  auto p_row = [&](int g, int i) {
    return p_s + (g % kStages) * panel_floats + (row0 + i) * dim_padded;
  };
  auto panels = [&](auto rows_c) {
    constexpr int R = decltype(rows_c)::value;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < kSlots / CT; ++e) acc[c][e] = 0.0f;
    __syncthreads();  // d_s is written
    mbar_wait(bars + 8 * (gp % kStages), (gp / kStages) & 1);
    Row cur = load_row(p_row(gp, 0), d_half + row0 * C, j0, jb);
    for (int pi = 0; pi < n_panels; ++pi, ++gp) {
      const int r0 = pi * kt + row0;  // this group's first row of d
#pragma unroll
      for (int i = 0; i < R; ++i) {
        Row next = cur;
        if (i + 1 < R) {
          next = load_row(p_row(gp, i + 1), d_half + (r0 + i + 1) * C, j0, jb);
        } else {
          // the next panel of this product has landed: its first row
          if (pi + 1 < n_panels) {
            mbar_wait(bars + 8 * ((gp + 1) % kStages),
                      ((gp + 1) / kStages) & 1);
            next = load_row(p_row(gp + 1, 0), d_half + (r0 + kt) * C, j0,
                            jb);
          }
          // the block's warps take turns to issue the panel kAhead ahead
          const int q = gp + 1 + kAhead;
          turn = turn + 1 == n_warps ? 0 : turn + 1;
          if (lane == 0 && turn == tid / 32 && q < total) issue(q);
        }
        fma_row(acc, cur);
        cur = next;
      }
      // this warp is done with the stage: one arrival on its "empty"
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + gp % kStages));
    }
  };
  // the leader adds the other groups' sums in group order
  auto hand_off = [&]() {
    if (!leader) {
      float* out = red_s + (kg - 1) * kSlots * group_threads + tig;
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int e = 0; e < kSlots / CT; ++e)
          out[(c * (kSlots / CT) + e) * group_threads] = acc[c][e];
    }
    __syncthreads();  // every thread is done reading d_s; the sums are in
    if (leader) {
      for (int g = 0; g < sp.ks - 1; ++g) {
        const float* in = red_s + g * kSlots * group_threads + tig;
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int e = 0; e < kSlots / CT; ++e)
            acc[c][e] = __fadd_rn(
                acc[c][e], in[(c * (kSlots / CT) + e) * group_threads]);
      }
    }
  };

  if (tid == 0)
    for (int q = 0; q <= kAhead && q < total; ++q) issue(q);
  float z[CT][kCols], p[CT][kCols];
  if (leader)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      load_zp(z, z_in, g);
      store_d(z, g);
    }
  // U's part of each chain and column group: the group's four columns
  float ug[CT][kGroups];
  for (int t = 0; t <= n_leap; ++t) {
    const float* z_src = t == 0 ? z_in : z_out;
    const float* p_src = t == 0 ? p_in : p_out;
    if (kt / sp.ks == 8)
      panels(std::integral_constant<int, 8>{});
    else
      panels(std::integral_constant<int, 4>{});
    // the leader's first column group is read while the other split-K
    // groups hand off
    if (leader) {
      load_zp(z, z_src, 0);
      load_zp(p, p_src, 0);
    }
    hand_off();
    if (!leader) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (g > 0) {
        load_zp(z, z_src, g);
        load_zp(p, p_src, g);
      }
      // the last leapfrog's second half kick with the gradient g = -acc,
      // then (but after the last product) this one's first and the drift
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float a = acc[c][4 * g + e];
          if (t > 0) p[c][e] = __fadd_rn(p[c][e], __fmul_rn(half_eps, -a));
          if (t < n_leap) {
            p[c][e] = __fadd_rn(p[c][e], __fmul_rn(half_eps, -a));
            z[c][e] = __fadd_rn(z[c][e], __fmul_rn(eps, p[c][e]));
          }
        }
      store_zp(p, p_out, g);
      if (t < n_leap) {
        store_zp(z, z_out, g);
        store_d(z, g);
        continue;
      }
      // U = 0.5 * sum_j d_j (d . P)_j per chain, with (d . P) = acc at the
      // end position; a dead group's sums are another group's (its loads
      // aliased)
      float4 mv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live_g[g]) mv = load4(mean + j0 + 128 * g);
      const float m[kCols] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float d[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          d[e] = ok[c] && live_g[g] ? __fsub_rn(z[c][e], m[e]) : 0.0f;
        const float* a = acc[c] + 4 * g;
        ug[c][g] = live_g[g] ? __fadd_rn(__fadd_rn(__fmul_rn(d[0], a[0]),
                                                   __fmul_rn(d[1], a[1])),
                                         __fadd_rn(__fmul_rn(d[2], a[2]),
                                                   __fmul_rn(d[3], a[3])))
                             : 0.0f;
      }
    }
  }
  // U: each column group's part over its 32 lanes by butterfly, then the
  // 128-column parts in order
  const int parts = (live + 127) / 128;
  if (leader) {
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float u = ug[c][g];
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          u = __fadd_rn(u, __shfl_xor_sync(0xffffffffu, u, off));
        if (lane == 0)
          ured_s[(CT * half + c) * kGroups * n_cw + kGroups * cw + g] = u;
      }
  }
  __syncthreads();
  if (tid < n_here) {
    const float* ur = ured_s + tid * kGroups * n_cw;
    float us = ur[0];
    for (int w = 1; w < parts; ++w) us = __fadd_rn(us, ur[w]);
    u_out[c0 + tid] = __fmul_rn(0.5f, us);
  }

  // columns at and past the live width pass through
  const int n_pad = dim_padded - live;
  for (int i = tid; i < n_here * n_pad; i += sp.threads) {
    const size_t o = (size_t)(c0 + i / n_pad) * dim_padded + live + i % n_pad;
    z_out[o] = z_in[o];
    p_out[o] = p_in[o];
  }
}

using WideKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           int, int, int);

// The instantiation for dim_padded, a multiple of 128 in (128, 1024].
WideKernel wide_kernel(int dim_padded) {
  switch (dim_padded) {
    case 256: return fused_gaussian_wide_kernel<256>;
    case 384: return fused_gaussian_wide_kernel<384>;
    case 512: return fused_gaussian_wide_kernel<512>;
    case 640: return fused_gaussian_wide_kernel<640>;
    case 768: return fused_gaussian_wide_kernel<768>;
    case 896: return fused_gaussian_wide_kernel<896>;
    default: return fused_gaussian_wide_kernel<1024>;
  }
}

}  // namespace

// dim_padded a multiple of 128 in (128, 1024]; dim the model's dimension,
// at and past which P is the identity and z, p, mean are zero. Returns a
// CUDA error code.
int fused_gaussian_wide_launch(const void* z, const void* p, const void* P,
                               const void* mean, const void* eps, void* z_out,
                               void* p_out, void* u_out, int n_chains,
                               int dim_padded, int dim, int n_leap,
                               cudaStream_t stream) {
  if (dim_padded <= 128 || dim_padded > kMaxLive || dim_padded % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const int live = (dim + kLiveMultiple - 1) / kLiveMultiple * kLiveMultiple;
  const Split sp = split_of(live, dim_padded);
  const int bytes = 4 * sp.floats;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const WideKernel kernel = wide_kernel(dim_padded);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_chains + C - 1) / C);
  cfg.blockDim = dim3(sp.threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(z),
      static_cast<const float*>(p), static_cast<const float*>(P),
      static_cast<const float*>(mean), static_cast<const float*>(eps),
      static_cast<float*>(z_out), static_cast<float*>(p_out),
      static_cast<float*>(u_out), n_chains, live, n_leap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
