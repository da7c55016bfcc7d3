// The first wide body of the fused Gaussian trajectory (mcmc_tpu_torch/
// csrc/fused_gaussian_trajectory_wide.cu at commit 8dca0bf) with clock64()
// counters, for scripts/torch_wide_gaussian_trials.py. Its bits are that
// body's. Counters, in clocks summed over the trajectory, for the first
// and the last thread of every block (trial_set_prof installs the buffer:
// int64 [blocks][2][16]):
//   0 ring wait (cp.async.wait_group), per panel
//   1 the panel's block barrier, per panel
//   2 cp.async issue of the panel kStages - 1 ahead, per panel
//   3 the FMA loop over the panel's rows, per panel
//   4 split-K hand-off (partials to shared memory, barrier, the leader's
//     adds), per product
//   5 the update between products with store_d, per product
//   14 products, 15 panels
// Built with -DRESIDENT every panel reads stage 0, loaded once: no copies
// and no ring wait, so the numbers are wrong and the time is the FMA and
// shared-memory floor with the per-panel barrier; -DNO_PANEL_BARRIER also
// drops that barrier (one barrier after store_d takes its place).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ long long* g_prof = nullptr;

constexpr int C = 16;     // chains per block
constexpr int CT = 8;     // chains per thread
constexpr int kCols = 4;  // adjacent columns per thread
constexpr int kWarpCols = 32 * kCols;
constexpr int kStages = 3;  // panels of P in flight: the current and two
constexpr int kStageFloats = 8192;  // 32 KB: a panel's rows x live columns
constexpr int kLiveMultiple = 16;
constexpr int kMaxLive = 1024;
constexpr int kMaxWarps = 16;
constexpr int kSlots = CT * kCols;  // a thread's accumulators

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until all but the newest kStages - 2 groups of this thread's
// copies have landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The work split at live width `live` of a model padded to `dp` columns:
// column warps of 128 columns, split-K groups (each takes rows / ks of every
// panel of P, so that narrow models still put kMaxWarps warps on the SM),
// rows of P per panel, and shared memory in floats (the ring of panels
// [kStages][kt][dp]: whole padded rows, so that a panel is one contiguous
// range of P; d transposed [live][C]; the other groups' partial sums
// [ks - 1][kSlots][group threads]; U's partial sums [C][column warps]).
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
  s.ks = 1;
  while (2 * s.ks * 2 * s.ncw <= kMaxWarps && s.kt % (2 * s.ks) == 0)
    s.ks *= 2;
  s.threads = 32 * 2 * s.ncw * s.ks;
  s.floats = kStages * s.kt * dp + live * C +
             (s.ks - 1) * kSlots * (s.threads / s.ks) + C * s.ncw;
  return s;
}

__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    fused_gaussian_wide_kernel(const float* __restrict__ z_in,
                               const float* __restrict__ p_in,
                               const float* __restrict__ P,
                               const float* __restrict__ mean,
                               const float* __restrict__ eps_ptr,
                               float* __restrict__ z_out,
                               float* __restrict__ p_out,
                               float* __restrict__ u_out, int n_chains,
                               int dim_padded, int live, int n_leap) {
  extern __shared__ __align__(16) float smem[];
  const Split sp = split_of(live, dim_padded);
  const int n_cw = sp.ncw, kt = sp.kt, group_threads = sp.threads / sp.ks;
  const int panel_floats = kt * dim_padded;
  float* p_s = smem;                          // [kStages][kt][dim_padded]
  float* d_s = p_s + kStages * panel_floats;  // [live][C]
  float* red_s = d_s + live * C;              // [ks - 1][kSlots][group]
  float* ured_s = red_s + (sp.ks - 1) * kSlots * group_threads;  // [C][ncw]

  const int tid = threadIdx.x, lane = tid % 32;
  // split-K group kg takes rows kg * rows .. + rows - 1 of each panel; in
  // it, chains 8 half .. 8 half + 7 of the tile, columns j0 .. j0 + 3
  const int kg = tid / group_threads, tig = tid % group_threads;
  const int warp = tig / 32, half = warp / n_cw, cw = warp % n_cw;
  const int rows = kt / sp.ks, row0 = kg * rows;
  const int j0 = cw * kWarpCols + kCols * lane;
  const bool live_cols = j0 < live;
  const bool leader = kg == 0;  // holds z and p, and updates them
  const int c0 = blockIdx.x * C;
  const int n_here = min(C, n_chains - c0);
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);
  const int n_panels = live / kt;
  const int total = (n_leap + 1) * n_panels;
  long long* const prof = g_prof;
  const bool rec = prof != nullptr && (tid == 0 || tid == sp.threads - 1);
  long long cnt[6] = {0, 0, 0, 0, 0, 0};
  long long t_last = clock64();
  long long n_products = 0, n_panels_seen = 0;
#define MARK(i)                      \
  {                                  \
    const long long now = clock64(); \
    cnt[i] += now - t_last;          \
    t_last = now;                    \
  }

  // the copies of panel gp (rows (gp % n_panels) * kt .. + kt - 1 of P,
  // one contiguous range) into stage gp % kStages; a group is committed
  // even past the last panel, so that the ring's wait counts alike
  auto start_panel = [&](int gp) {
#ifdef RESIDENT
    if (gp == 0) {
#else
    if (gp < total) {
#endif
      const float* src = P + (size_t)(gp % n_panels) * panel_floats;
      const uint32_t dst = smem_u32(p_s + (gp % kStages) * panel_floats);
      for (int v = tid; v < panel_floats / 4; v += sp.threads)
        cp_async16(dst + 16 * v, src + 4 * v);
    }
    cp_async_commit();
  };

  float z[CT][kCols], p[CT][kCols], acc[CT][kCols], m[kCols];
  bool ok[CT];
  {
    float4 mv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live_cols) mv = load4(mean + j0);
    m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
  }
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int q = CT * half + c;
    ok[c] = leader && live_cols && q < n_here;
    float4 zv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pv = zv;
    if (ok[c]) {
      const size_t gi = (size_t)(c0 + q) * dim_padded + j0;
      zv = load4(z_in + gi);
      pv = load4(p_in + gi);
    }
    z[c][0] = zv.x, z[c][1] = zv.y, z[c][2] = zv.z, z[c][3] = zv.w;
    p[c][0] = pv.x, p[c][1] = pv.y, p[c][2] = pv.z, p[c][3] = pv.w;
  }

  // d = z - m of the leader's chains and columns, to d_s
  auto store_d = [&]() {
    if (!leader || !live_cols) return;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      float d[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c)
        d[c] = ok[c] ? __fsub_rn(z[c][e], m[e]) : 0.0f;
      float* row = d_s + (j0 + e) * C + CT * half;
      *reinterpret_cast<float4*>(row) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(d[4], d[5], d[6], d[7]);
    }
  };

  // the leader's acc[c][e] <- sum over the live rows k of d[chain c][k] *
  // P[k][j0 + e]: each group sums its rows of every panel in order, then
  // the leader adds the other groups' sums in group order. The global
  // panel index gp runs on from product to product.
  int gp = 0;
  auto product = [&]() {
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[c][e] = 0.0f;
#ifdef NO_PANEL_BARRIER
    __syncthreads();  // d_s is written
#endif
    MARK(5);
    for (int pi = 0; pi < n_panels; ++pi, ++gp) {
#ifndef RESIDENT
      cp_async_wait_ring();  // this thread's copies of panel gp
#endif
      MARK(0);
      // every thread's copies have landed, d_s is written, and every
      // thread is done with panel gp - 1, whose stage is refilled now
#ifndef NO_PANEL_BARRIER
      __syncthreads();
#endif
      MARK(1);
      start_panel(gp + kStages - 1);
      MARK(2);
      if (live_cols) {
#ifdef RESIDENT
        const float* pp = p_s + j0;
#else
        const float* pp = p_s + (gp % kStages) * panel_floats + j0;
#endif
        const float* dd = d_s + (pi * kt + row0) * C + CT * half;
#pragma unroll 4
        for (int r = row0; r < row0 + rows; ++r, dd += C) {
          const float4 pv = load4(pp + r * dim_padded);
          const float4 da = load4(dd);
          const float4 db = load4(dd + 4);
          const float dv[CT] = {da.x, da.y, da.z, da.w,
                                db.x, db.y, db.z, db.w};
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            acc[c][0] = __fmaf_rn(dv[c], pv.x, acc[c][0]);
            acc[c][1] = __fmaf_rn(dv[c], pv.y, acc[c][1]);
            acc[c][2] = __fmaf_rn(dv[c], pv.z, acc[c][2]);
            acc[c][3] = __fmaf_rn(dv[c], pv.w, acc[c][3]);
          }
        }
      }
      MARK(3);
      ++n_panels_seen;
    }
    if (!leader) {
      float* out = red_s + (kg - 1) * kSlots * group_threads + tig;
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          out[(c * kCols + e) * group_threads] = acc[c][e];
    }
    __syncthreads();  // every thread is done reading d_s; the sums are in
    if (leader) {
      for (int g = 0; g < sp.ks - 1; ++g) {
        const float* in = red_s + g * kSlots * group_threads + tig;
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            acc[c][e] = __fadd_rn(acc[c][e],
                                  in[(c * kCols + e) * group_threads]);
      }
    }
    MARK(4);
    ++n_products;
  };

  start_panel(0);
  start_panel(1);
#ifdef RESIDENT
  cp_async_wait_all();
  __syncthreads();
#endif
  store_d();
  product();
  for (int k = 0; k < n_leap; ++k) {
    // half kick with the carried gradient g = -acc, then drift
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        p[c][e] = __fadd_rn(p[c][e], __fmul_rn(half_eps, -acc[c][e]));
        z[c][e] = __fadd_rn(z[c][e], __fmul_rn(eps, p[c][e]));
      }
    store_d();
    product();
    // second half kick
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        p[c][e] = __fadd_rn(p[c][e], __fmul_rn(half_eps, -acc[c][e]));
  }

  // U = 0.5 * sum_j d_j (d . P)_j per chain, with (d . P) = acc at the end
  // position: the leader's four columns, its warp's lanes by butterfly,
  // then the column warps in order
  if (leader) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float d[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        d[e] = ok[c] ? __fsub_rn(z[c][e], m[e]) : 0.0f;
      float u = __fadd_rn(
          __fadd_rn(__fmul_rn(d[0], acc[c][0]), __fmul_rn(d[1], acc[c][1])),
          __fadd_rn(__fmul_rn(d[2], acc[c][2]), __fmul_rn(d[3], acc[c][3])));
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        u = __fadd_rn(u, __shfl_xor_sync(0xffffffffu, u, off));
      if (lane == 0) ured_s[(CT * half + c) * n_cw + cw] = u;
    }
  }
  __syncthreads();
  if (rec) {
    long long* out = prof + (blockIdx.x * 2 + (tid == 0 ? 0 : 1)) * 16;
    for (int i = 0; i < 6; ++i) out[i] = cnt[i];
    out[14] = n_products;
    out[15] = n_panels_seen;
  }
#undef MARK
  if (tid < n_here) {
    float us = ured_s[tid * n_cw];
    for (int w = 1; w < n_cw; ++w) us = __fadd_rn(us, ured_s[tid * n_cw + w]);
    u_out[c0 + tid] = __fmul_rn(0.5f, us);
  }

#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (ok[c]) {
      const size_t gi = (size_t)(c0 + CT * half + c) * dim_padded + j0;
      *reinterpret_cast<float4*>(z_out + gi) =
          make_float4(z[c][0], z[c][1], z[c][2], z[c][3]);
      *reinterpret_cast<float4*>(p_out + gi) =
          make_float4(p[c][0], p[c][1], p[c][2], p[c][3]);
    }
  }
  // columns at and past the live width pass through
  const int n_pad = dim_padded - live;
  for (int i = tid; i < n_here * n_pad; i += sp.threads) {
    const size_t o = (size_t)(c0 + i / n_pad) * dim_padded + live + i % n_pad;
    z_out[o] = z_in[o];
    p_out[o] = p_in[o];
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
  cudaError_t err = cudaFuncSetAttribute(
      fused_gaussian_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_chains + C - 1) / C);
  fused_gaussian_wide_kernel<<<grid, sp.threads, bytes, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const float*>(P), static_cast<const float*>(mean),
      static_cast<const float*>(eps), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains,
      dim_padded, live, n_leap);
  return (int)cudaGetLastError();
}

extern "C" int trial_set_prof(void* p) {
  return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p));
}
