// Fused HMC leapfrog trajectory on a multivariate Gaussian N(m, P^-1), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of mcmc_tpu/ops/fused_logreg.py
// (make_fused_gaussian_trajectory: kernel body :330-365, pallas_call :381).
// For each chain it computes what that kernel computes: n_leap leapfrog
// steps with the gradient g = -(z - m) . P carried between steps (n_leap + 1
// products of a row vector with P), the step size read at run time from a
// device pointer (the sampler draws a jittered step per transition on the
// device), and the potential U = 0.5 * sum(d * (d . P)) at the end position
// d = z - m. The reference computes U from one more product at the same
// position; its value is the last gradient's product, which is reused here.
//
// Everything is f32, as in the reference (the target is ill-conditioned on
// purpose): the products are FP32 FMAs, not tensor-core TF32 or bf16.
//
// What bounds it on this card: the FP32 FMA pipe and the shared-memory
// loads that feed it, through a chain of dependent products. At the suite's
// shapes (2048 chains, 100 dims padded to 128, 157 leapfrogs) a trajectory
// is 158 products of 2 * 2048 * 100 * 100 flop, 6.5 GFLOP, against 3.3 MB of
// state and P. The 158 products of a chain depend on each other, so the
// time is 158 times what one block takes for one step of its tile, and
// every instruction and barrier of that step beside the FMAs counts 158
// times. As built, a warp runs about 530 instructions a step, 416 of them
// FMAs; seven warps a block put four warps of two blocks on three of an
// SM's schedulers and two on the fourth, and the crowded schedulers, about
// 88% busy, set the pace (clock counters around each phase of the step).
//
// This body is for dim_padded 128; wider models run the body that streams
// P from L2 (fused_gaussian_trajectory_wide.cu), which the launch below
// picks by width.
//
// What the design does about it (the step's costs were measured one by one
// with builds that each left one out; the largest beside the FMAs is the
// shared-memory loads' return path, 128 bytes a clock and SM: every lane
// needs every d of its rows, so a thread must use each loaded value for at
// least four columns or the loads, not the FMAs, set the pace):
//
// - It does not multiply the padding. The wrapper pads to 128 columns as
//   the JAX package does and passes the model's dimension; the kernel is
//   instantiated for live widths DL = 32, 64, 104 and 128 and runs the
//   smallest that holds the dimension (104 for the suite's 100). Only that
//   block of P is held and multiplied. Columns at and past DL are copied
//   from the input to the output: they are zero by the wrapper's contract
//   (P is the identity there, z, p and m zero), and come out exactly zero.
// - P never changes, so its live block lives in registers for the whole
//   trajectory: a thread owns FOUR adjacent columns and one of eight slices
//   of DL / 8 rows (52 registers at DL 104). A product reads only the
//   tile's d = z - m from shared memory, in 16-byte loads shared by the
//   lanes of a slice, sixteen FMAs to a load.
// - The eight slices of a column group are eight lanes of ONE warp (lane =
//   4 * slice + group), so their partial sums meet by a reduce-scatter of
//   28 shuffles in a fixed order, not through shared memory. Lane q keeps
//   chain s ^ q in accumulator slot s, so every round sends the upper half
//   of the slots and keeps the lower, with no selects; it ends with lane q
//   holding the sums of chain q and its four columns, whose z, p and g it
//   keeps in registers. A step is then: update in registers, store d, ONE
//   barrier, product, shuffles. d is double-buffered, so the one barrier is
//   enough.
// - A tile of 8 chains is one block (7 warps at DL 104); two blocks share an
//   SM and fill each other's barrier and latency gaps. 2048 chains are 256
//   blocks, all resident at once on the card's 132 SMs.
//
// Chains past n_chains in the last tile are computed on zeros and never
// stored. Per-chain sums for U are reduced in a fixed order, so a launch is
// deterministic. The update uses explicitly rounded multiplies and adds (no
// contraction into FMA), so that it rounds where the plain tensor code
// rounds and only the summation order of the products differs; on a
// diagonal P every product has one non-zero term and z, p equal the plain
// version's bit for bit.

#include <cuda_runtime.h>

// dim_padded past 128: the body that streams P from L2
// (fused_gaussian_trajectory_wide.cu).
int fused_gaussian_wide_launch(const void* z, const void* p, const void* P,
                               const void* mean, const void* eps, void* z_out,
                               void* p_out, void* u_out, int n_chains,
                               int dim_padded, int dim, int n_leap,
                               cudaStream_t stream);

namespace {

constexpr int BC = 8;     // chains per block, and row slices of P
constexpr int kCols = 4;  // adjacent columns of P per thread

// Work split and shared memory of one block at live width DL.
template <int DL>
struct Cfg {
  static constexpr int KS = DL / BC;             // rows of P per thread
  static constexpr int KSP = (KS + 3) / 4 * 4;   // padded to 16-byte loads
  // floats between the slices' segments of a chain's d, an odd multiple of
  // 4: the eight 16-byte loads of a warp then fall into different banks
  static constexpr int SEG = (KSP / 4) % 2 ? KSP : KSP + 4;
  static constexpr int LDD = BC * SEG;           // floats per chain row of d
  static constexpr int GROUPS = DL / kCols;      // column groups
  static constexpr int WARPS = (GROUPS + 3) / 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = THREADS > 224 ? 1 : 2;
  static constexpr int D_FLOATS = 2 * BC * LDD;  // d, double-buffered
  static constexpr size_t BYTES = sizeof(float) * (D_FLOATS + BC * WARPS);
  static_assert(DL % 8 == 0 && DL <= 128, "live widths are multiples of 8");
};

// a[s][e] <- sum over the thread's KS rows k of d[c][k] * P[k][j0 + e] for
// the chain c = s ^ q whose d segment starts at d_buf + off[s]: the
// thread's slice of the product.
template <int DL>
__device__ __forceinline__ void product(
    const float (&Pr)[Cfg<DL>::KS][kCols], const float* d_buf,
    const int (&off)[BC], float (&a)[BC][kCols]) {
  using C = Cfg<DL>;
#pragma unroll
  for (int s = 0; s < BC; ++s) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) a[s][e] = 0.0f;
    const float* d_q = d_buf + off[s];
#pragma unroll
    for (int kk = 0; kk < C::KS; kk += 4) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kk + 4 <= C::KS) {
        const float4 dv = *reinterpret_cast<const float4*>(d_q + kk);
        v[0] = dv.x, v[1] = dv.y, v[2] = dv.z, v[3] = dv.w;
      } else {
        if (C::KS - kk >= 2) {
          const float2 dv = *reinterpret_cast<const float2*>(d_q + kk);
          v[0] = dv.x, v[1] = dv.y;
        }
        if ((C::KS - kk) % 2) v[(C::KS - kk) - 1] = d_q[C::KS - 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kk + i < C::KS) {
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            a[s][e] = __fmaf_rn(v[i], Pr[kk + i][e], a[s][e]);
        }
      }
    }
  }
}

// r[e] <- the eight slices' sum for chain q: a reduce-scatter over the
// lanes 4 q' + group, q' = 0..7. Slot s of lane q holds chain s ^ q, so
// slot s + h of lane q ^ h holds the same chain as slot s of lane q. The
// order is fixed: ((a_q + a_{q^4}) + (a_{q^2} + a_{q^6})) + ((a_{q^1} +
// a_{q^5}) + (a_{q^3} + a_{q^7})).
__device__ __forceinline__ void slice_sums(float (&a)[BC][kCols],
                                           float (&r)[kCols]) {
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1)
#pragma unroll
    for (int s = 0; s < h; ++s)
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        a[s][e] = __fadd_rn(
            a[s][e], __shfl_xor_sync(0xffffffffu, a[s + h][e], 4 * h));
#pragma unroll
  for (int e = 0; e < kCols; ++e) r[e] = a[0][e];
}

template <int DL>
__global__ void __launch_bounds__(Cfg<DL>::THREADS, Cfg<DL>::MIN_BLOCKS)
    fused_gaussian_trajectory_kernel(const float* __restrict__ z_in,
                                     const float* __restrict__ p_in,
                                     const float* __restrict__ P,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ eps_ptr,
                                     float* __restrict__ z_out,
                                     float* __restrict__ p_out,
                                     float* __restrict__ u_out, int n_chains,
                                     int dim_padded, int n_leap) {
  using C = Cfg<DL>;
  extern __shared__ __align__(16) float smem[];
  float* d_s = smem;                  // [2][BC][LDD]
  float* red_s = smem + C::D_FLOATS;  // [BC][WARPS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * BC;
  const int n_here = min(BC, n_chains - c0);
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);

  // slice q of P's rows, columns j0 .. j0 + 3; lanes past the last group
  // of the last warp hold zeros and store nothing
  const int q = lane / 4, jg = warp * 4 + lane % 4;
  const bool live = jg < C::GROUPS;
  const int j0 = kCols * jg;
  float Pr[C::KS][kCols];
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live)
      v = *reinterpret_cast<const float4*>(
          P + (size_t)(q * C::KS + kk) * dim_padded + j0);
    Pr[kk][0] = v.x, Pr[kk][1] = v.y, Pr[kk][2] = v.z, Pr[kk][3] = v.w;
  }
  // product role: slot s reads the rows of slice q of chain s ^ q
  int off[BC];
#pragma unroll
  for (int s = 0; s < BC; ++s) off[s] = (s ^ q) * C::LDD + q * C::SEG;

  // update role: chain q of the tile, columns j0 .. j0 + 3; column j of d
  // lies in slice j / KS of the rows, at w_off
  const bool ok = live && q < n_here;
  const size_t gi = (size_t)(c0 + q) * dim_padded + j0;
  float z[kCols], p[kCols], g[kCols], d[kCols], m[kCols];
  int w_off[kCols];
  {
    float4 zv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pv = zv, mv = zv;
    if (live) mv = *reinterpret_cast<const float4*>(mean + j0);
    if (ok) {
      zv = *reinterpret_cast<const float4*>(z_in + gi);
      pv = *reinterpret_cast<const float4*>(p_in + gi);
    }
    z[0] = zv.x, z[1] = zv.y, z[2] = zv.z, z[3] = zv.w;
    p[0] = pv.x, p[1] = pv.y, p[2] = pv.z, p[3] = pv.w;
    m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int j = live ? j0 + e : 0;
    w_off[e] = q * C::LDD + (j / C::KS) * C::SEG + j % C::KS;
    d[e] = ok ? __fsub_rn(z[e], m[e]) : 0.0f;
    if (live) d_s[w_off[e]] = d[e];
  }
  // the padding floats of d's segments are never read
  __syncthreads();

  float a[BC][kCols], r[kCols];
  product<DL>(Pr, d_s, off, a);
  slice_sums(a, r);
#pragma unroll
  for (int e = 0; e < kCols; ++e) g[e] = -r[e];

  for (int k = 0; k < n_leap; ++k) {
    float* d_k = d_s + ((k + 1) & 1) * (BC * C::LDD);
    // half kick with the carried gradient, then drift
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      p[e] = __fadd_rn(p[e], __fmul_rn(half_eps, g[e]));
      z[e] = __fadd_rn(z[e], __fmul_rn(eps, p[e]));
      d[e] = ok ? __fsub_rn(z[e], m[e]) : 0.0f;
      if (live) d_k[w_off[e]] = d[e];
    }
    // the other buffer was read two products ago, before the last
    // barrier: one barrier per step is enough
    __syncthreads();
    product<DL>(Pr, d_k, off, a);
    slice_sums(a, r);
    // second half kick
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      g[e] = -r[e];
      p[e] = __fadd_rn(p[e], __fmul_rn(half_eps, g[e]));
    }
  }

  // U = 0.5 * sum_j d_j (d . P)_j per chain, with (d . P) = -g at the end
  // position: the thread's four columns, the four lanes of chain q by
  // butterfly, then the warps in order
  float u = __fadd_rn(__fadd_rn(__fmul_rn(d[0], -g[0]), __fmul_rn(d[1], -g[1])),
                      __fadd_rn(__fmul_rn(d[2], -g[2]), __fmul_rn(d[3], -g[3])));
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  u += __shfl_xor_sync(0xffffffffu, u, 2);
  if (lane % 4 == 0) red_s[q * C::WARPS + warp] = u;
  __syncthreads();
  if (tid < n_here) {
    float us = red_s[tid * C::WARPS];
#pragma unroll
    for (int w = 1; w < C::WARPS; ++w)
      us = __fadd_rn(us, red_s[tid * C::WARPS + w]);
    u_out[c0 + tid] = __fmul_rn(0.5f, us);
  }

  if (ok) {
    *reinterpret_cast<float4*>(z_out + gi) = make_float4(z[0], z[1], z[2], z[3]);
    *reinterpret_cast<float4*>(p_out + gi) = make_float4(p[0], p[1], p[2], p[3]);
  }
  // columns at and past the live width pass through
  const int n_pad = dim_padded - DL;
  for (int i = tid; i < n_here * n_pad; i += C::THREADS) {
    const size_t o = (size_t)(c0 + i / n_pad) * dim_padded + DL + i % n_pad;
    z_out[o] = z_in[o];
    p_out[o] = p_in[o];
  }
}

template <int DL>
cudaError_t launch(const void* z, const void* p, const void* P,
                   const void* mean, const void* eps, void* z_out, void* p_out,
                   void* u_out, int n_chains, int dim_padded, int n_leap,
                   cudaStream_t stream) {
  using C = Cfg<DL>;
  const dim3 grid((n_chains + BC - 1) / BC);
  fused_gaussian_trajectory_kernel<DL><<<grid, C::THREADS, C::BYTES, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const float*>(P), static_cast<const float*>(mean),
      static_cast<const float*>(eps), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains,
      dim_padded, n_leap);
  return cudaGetLastError();
}

}  // namespace

// Launch one fused Gaussian trajectory on `stream`. z, p, z_out, p_out:
// (n_chains, dim_padded) f32; P: (dim_padded, dim_padded) f32; mean:
// (dim_padded,) f32; eps: one f32; u_out: (n_chains,) f32; all contiguous
// on the device; dim_padded 128, or a multiple of 128 up to 1024. `dim` is
// the model's dimension: at and past it P is the identity and z, p, mean
// are zero. Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_gaussian_trajectory_launch(
    const void* z, const void* p, const void* P, const void* mean,
    const void* eps, void* z_out, void* p_out, void* u_out, int n_chains,
    int dim_padded, int dim, int n_leap, void* stream) {
  if (n_chains < 1 || n_leap < 1 || dim < 1 || dim > dim_padded ||
      eps == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_padded != 128)
    return fused_gaussian_wide_launch(z, p, P, mean, eps, z_out, p_out, u_out,
                                      n_chains, dim_padded, dim, n_leap, s);
#define K2_LAUNCH(DL)                                                      \
  return (int)launch<DL>(z, p, P, mean, eps, z_out, p_out, u_out, n_chains, \
                         dim_padded, n_leap, s)
  // the live widths that are built: the smallest that holds dim
  if (dim <= 32) K2_LAUNCH(32);
  if (dim <= 64) K2_LAUNCH(64);
  if (dim <= 104) K2_LAUNCH(104);
  K2_LAUNCH(128);
#undef K2_LAUNCH
}
