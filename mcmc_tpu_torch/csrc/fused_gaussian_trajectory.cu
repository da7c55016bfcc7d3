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
// What bounds it on this card: arithmetic, and the chain of dependent
// products. At the suite's shapes (2048 chains, 128 padded dims, 157
// leapfrogs) a trajectory is 158 products of 2 * 2048 * 128 * 128 flop, 10.6
// GFLOP of FP32 FMA, against 4.2 MB of state read and written once and a 64
// KB P. The 158 products of a chain depend on each other, so the time is
// 158 times what one block takes for one product of its tile.
//
// What the design does about it: P is the operand that never changes, so it
// lives in registers for the whole trajectory. The 256 threads of a block
// hold all of the 128 x 128 P, 64 values each: thread t owns two adjacent
// columns and one slice of 32 rows. A product then reads only the tile's
// d = z - m from shared memory, as 16-byte loads that every lane of a warp
// shares (a broadcast), four FMAs per loaded value and thread; the four
// row slices leave partial sums in shared memory, and the leapfrog update,
// elementwise over the tile with z and p in registers, adds them in a
// fixed order. A tile of BC = 8 chains is one block. The small tile is the
// fast one (16 and 32 were measured slower at every chain count): the time
// is that of the dependent products of one tile, two 8-chain blocks fit on
// an SM (123 registers a thread), and 2048 chains are then 256 blocks, all
// resident at once on the card's 132 SMs. Chains past n_chains
// in the last tile are computed on zeros and never stored. Per-chain sums
// for U are reduced in a fixed order, so a launch is deterministic. The
// update uses explicitly rounded multiplies and adds (no contraction into
// FMA), so that it rounds where the plain tensor code rounds and only the
// summation order of the products differs.
//
// Columns past the model's dimension stay exactly zero: P is the identity
// there, and z, p, m start at zero.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int DP = 128;               // padded dimension
constexpr int kSlices = 4;            // row slices of P, two warps each
constexpr int kSliceK = DP / kSlices; // rows of P per thread
constexpr int kGroup = 4;             // chains per inner product group
constexpr int BC = 8;                 // chains per block

static_assert(kThreads == kSlices * (DP / 2), "two columns and one slice each");
static_assert(kThreads == 2 * DP, "update: two chains per pass over columns");

// Shared memory of one block of BC chains.
struct Cfg {
  static constexpr int EPT = BC * DP / kThreads;  // update elements per thread
  static constexpr size_t D = 0;                  // d = z - m, BC x DP
  static constexpr size_t PART = D + sizeof(float) * BC * DP;  // slices x BC x DP
  static constexpr size_t RED = PART + sizeof(float) * kSlices * BC * DP;
  static constexpr size_t BYTES = RED + sizeof(float) * BC * 4;  // U partials
  static_assert(BC % kGroup == 0 && EPT >= 1, "tile shape");
  static_assert(BYTES <= 232448, "fits the 227 KB a block may use");
};

// part_s[q] <- d_s . P[32q : 32q + 32, 2jp : 2jp + 2] for the thread's slice
// q and column pair jp, P in registers.
__device__ __forceinline__ void product(const float (&P0)[kSliceK],
                                        const float (&P1)[kSliceK],
                                        const float* d_s, float* part_s, int q,
                                        int jp) {
  for (int c0 = 0; c0 < BC; c0 += kGroup) {
    float a0[kGroup], a1[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) a0[i] = a1[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSliceK; kk += 4) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float4 dv = *reinterpret_cast<const float4*>(
            d_s + (c0 + i) * DP + q * kSliceK + kk);
        a0[i] = __fmaf_rn(dv.x, P0[kk], a0[i]);
        a1[i] = __fmaf_rn(dv.x, P1[kk], a1[i]);
        a0[i] = __fmaf_rn(dv.y, P0[kk + 1], a0[i]);
        a1[i] = __fmaf_rn(dv.y, P1[kk + 1], a1[i]);
        a0[i] = __fmaf_rn(dv.z, P0[kk + 2], a0[i]);
        a1[i] = __fmaf_rn(dv.z, P1[kk + 2], a1[i]);
        a0[i] = __fmaf_rn(dv.w, P0[kk + 3], a0[i]);
        a1[i] = __fmaf_rn(dv.w, P1[kk + 3], a1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      *reinterpret_cast<float2*>(part_s + ((size_t)q * BC + c0 + i) * DP +
                                 2 * jp) = make_float2(a0[i], a1[i]);
  }
}

// (d . P)[c][j]: the four slices' partial sums, in slice order.
__device__ __forceinline__ float slice_sum(const float* part_s, int c, int j) {
  float s = part_s[(size_t)c * DP + j];
#pragma unroll
  for (int q = 1; q < kSlices; ++q)
    s = __fadd_rn(s, part_s[((size_t)q * BC + c) * DP + j]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
    fused_gaussian_trajectory_kernel(const float* __restrict__ z_in,
                                     const float* __restrict__ p_in,
                                     const float* __restrict__ P,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ eps_ptr,
                                     float* __restrict__ z_out,
                                     float* __restrict__ p_out,
                                     float* __restrict__ u_out, int n_chains,
                                     int n_leap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d_s = reinterpret_cast<float*>(smem + Cfg::D);
  float* part_s = reinterpret_cast<float*>(smem + Cfg::PART);
  float* red_s = reinterpret_cast<float*>(smem + Cfg::RED);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BC;
  const int n_here = min(BC, n_chains - c0);
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);

  // product role: slice q of P's rows, columns 2jp and 2jp + 1
  const int q = tid / (DP / 2), jp = tid % (DP / 2);
  float P0[kSliceK], P1[kSliceK];
#pragma unroll
  for (int kk = 0; kk < kSliceK; ++kk) {
    const float2 v = *reinterpret_cast<const float2*>(
        P + (size_t)(q * kSliceK + kk) * DP + 2 * jp);
    P0[kk] = v.x;
    P1[kk] = v.y;
  }

  // update role: column j of chains 2i + h, i < EPT
  const int j = tid % DP, h = tid / DP;
  const float m = mean[j];
  float z[Cfg::EPT], p[Cfg::EPT], g[Cfg::EPT];
#pragma unroll
  for (int i = 0; i < Cfg::EPT; ++i) {
    const int c = 2 * i + h;
    const bool ok = c < n_here;
    const size_t gi = (size_t)(c0 + c) * DP + j;
    z[i] = ok ? z_in[gi] : 0.0f;
    p[i] = ok ? p_in[gi] : 0.0f;
    d_s[c * DP + j] = ok ? __fsub_rn(z[i], m) : 0.0f;
  }
  __syncthreads();

  product(P0, P1, d_s, part_s, q, jp);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Cfg::EPT; ++i) g[i] = -slice_sum(part_s, 2 * i + h, j);

  for (int k = 0; k < n_leap; ++k) {
    // half kick with the carried gradient, then drift
#pragma unroll
    for (int i = 0; i < Cfg::EPT; ++i) {
      const int c = 2 * i + h;
      p[i] = __fadd_rn(p[i], __fmul_rn(half_eps, g[i]));
      z[i] = __fadd_rn(z[i], __fmul_rn(eps, p[i]));
      d_s[c * DP + j] = c < n_here ? __fsub_rn(z[i], m) : 0.0f;
    }
    __syncthreads();
    product(P0, P1, d_s, part_s, q, jp);
    __syncthreads();
    // second half kick
#pragma unroll
    for (int i = 0; i < Cfg::EPT; ++i) {
      g[i] = -slice_sum(part_s, 2 * i + h, j);
      p[i] = __fadd_rn(p[i], __fmul_rn(half_eps, g[i]));
    }
  }

  // U = 0.5 * sum_j d_j (d . P)_j per chain, with (d . P) = -g at the end
  // position: lanes by butterfly, then the chain's four warps in order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < Cfg::EPT; ++i) {
    const int c = 2 * i + h;
    float u = __fmul_rn(d_s[c * DP + j], -g[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      u += __shfl_xor_sync(0xffffffffu, u, off);
    if (lane == 0) red_s[c * 4 + warp % 4] = u;
  }
  __syncthreads();
  if (tid < n_here) {
    const float* r = red_s + tid * 4;
    u_out[c0 + tid] =
        __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[1]), r[2]), r[3]));
  }

#pragma unroll
  for (int i = 0; i < Cfg::EPT; ++i) {
    const int c = 2 * i + h;
    if (c < n_here) {
      const size_t gi = (size_t)(c0 + c) * DP + j;
      z_out[gi] = z[i];
      p_out[gi] = p[i];
    }
  }
}

cudaError_t launch(const void* z, const void* p, const void* P,
                   const void* mean, const void* eps, void* z_out, void* p_out,
                   void* u_out, int n_chains, int n_leap, cudaStream_t stream) {
  auto kernel = fused_gaussian_trajectory_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_chains + BC - 1) / BC);
  kernel<<<grid, kThreads, Cfg::BYTES, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const float*>(P), static_cast<const float*>(mean),
      static_cast<const float*>(eps), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_leap);
  return cudaGetLastError();
}

}  // namespace

// Launch one fused Gaussian trajectory on `stream`. z, p, z_out, p_out:
// (n_chains, dim_padded) f32; P: (dim_padded, dim_padded) f32; mean:
// (dim_padded,) f32; eps: one f32; u_out: (n_chains,) f32; all contiguous
// on the device. Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_gaussian_trajectory_launch(
    const void* z, const void* p, const void* P, const void* mean,
    const void* eps, void* z_out, void* p_out, void* u_out, int n_chains,
    int dim_padded, int n_leap, void* stream) {
  if (n_chains < 1 || n_leap < 1 || dim_padded != DP || eps == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch(z, p, P, mean, eps, z_out, p_out, u_out, n_chains, n_leap,
                     static_cast<cudaStream_t>(stream));
}
