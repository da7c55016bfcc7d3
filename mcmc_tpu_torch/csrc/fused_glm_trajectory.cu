// Fused HMC leapfrog trajectory on a GLM posterior, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mcmc_tpu/ops/fused_logreg.py
// (make_fused_trajectory: kernel body :163-199, pallas_call :215). It
// computes exactly what that kernel computes, for each chain: n_leap
// leapfrog steps with a N(0, s^2) prior, the boundary gradient carried
// between steps (n_leap + 1 gradient evaluations), each gradient
//     eta = bf16(z) . X^T          (f32 accumulation)
//     (mu, ll) = link(eta, y)
//     r   = (y - mu) * mask
//     g   = bf16(r) . X - z / s^2  (f32 accumulation)
// and the potential U = -(sum(mask * ll) - 0.5 * sum(z^2) / s^2) from the
// last evaluation's bf16-path eta (ROADMAP C2, kept for parity).
//
// What bounds it on this card: arithmetic. At the flagship shapes (16384
// chains, 128 padded dims, 1024 padded rows, n_leap 4) a trajectory is
// about 43 GFLOP of bf16 products plus 84M link evaluations
// (transcendentals), against 34 MB of state read and written once. Under
// plain tensor code each gradient also writes and reads the
// (chains, rows) eta, 64 MB in f32.
//
// What the design does about it: one block owns a tile of 32 chains and
// keeps its z, p and g in shared memory across all n_leap steps; at 128
// dims two blocks fit on an SM, so one block's link phase overlaps the
// other's products (1.24x over one 64-chain block per SM on the logistic
// link, 1.40x on probit, measured on an H100). The design matrix (256 KB
// in bf16 at the flagship shapes, above the 227 KB a block may use) is
// streamed in tiles of 64 rows; each tile serves both products of a
// gradient (as X^T for eta, as X for g), so one orientation of X is enough
// and X is read once per block per gradient evaluation (from L2, where it
// stays resident). eta for a tile lives in shared memory only. The
// products run on the tensor cores through WMMA (bf16 in, f32
// accumulate). Per-chain sums are reduced in a fixed order, so a launch
// is deterministic. TMA, wgmma and pipelined tile loads are left for
// later work.
//
// Rows padded to the tile carry mask 0, and z, p columns past the model's
// dimension stay exactly zero (their X columns are zero). Chains past
// n_chains in the last tile are computed on zeros and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 64;  // data rows per streamed tile of X
constexpr int kSkewH = 8;     // bf16 row padding (16 B) against bank conflicts
constexpr int kSkewF = 4;     // f32 row padding (16 B)

enum Link : int { kLogistic = 0, kPoisson = 1, kLinear = 2, kProbit = 3 };

// Shared-memory layout and work split of one block: BC chains, DP padded
// dimensions. Every region starts on a 32-byte boundary, as WMMA requires.
template <int BC, int DP>
struct Cfg {
  static constexpr int LDZ = DP + kSkewH;        // bf16(z) rows
  static constexpr int LDX = DP + kSkewH;        // X tile rows
  static constexpr int LDR = kRowTile + kSkewH;  // bf16(r) rows
  static constexpr int LDE = kRowTile + kSkewF;  // eta rows (f32)
  static constexpr int LDG = DP + kSkewF;        // gradient rows (f32)

  static constexpr size_t Z = 0;
  static constexpr size_t P = Z + sizeof(float) * BC * DP;
  static constexpr size_t G = P + sizeof(float) * BC * DP;
  static constexpr size_t E = G + sizeof(float) * BC * LDG;
  static constexpr size_t ZB = E + sizeof(float) * BC * LDE;
  static constexpr size_t XT = ZB + sizeof(bf16) * BC * LDZ;
  static constexpr size_t R = XT + sizeof(bf16) * kRowTile * LDX;
  static constexpr size_t Y = R + sizeof(bf16) * BC * LDR;
  static constexpr size_t M = Y + sizeof(float) * kRowTile;
  static constexpr size_t BYTES = M + sizeof(float) * kRowTile;

  // link phase: TPC adjacent threads share one chain row of eta
  static constexpr int TPC = kThreads / BC;
  static constexpr int COLS = kRowTile / TPC;
  // WMMA tiles of 16 x 16 per warp, all in one 16-chain row block
  static constexpr int E_TILES = (BC / 16) * (kRowTile / 16) / kWarps;
  static constexpr int G_TILES = (BC / 16) * (DP / 16) / kWarps;

  static_assert(kThreads % BC == 0 && 32 % TPC == 0, "chain rows per warp");
  static_assert(E_TILES >= 1 && (kRowTile / 16) % E_TILES == 0, "eta split");
  static_assert(G_TILES >= 1 && (DP / 16) % G_TILES == 0, "gradient split");
  static_assert(Z % 32 == 0 && P % 32 == 0 && G % 32 == 0 && E % 32 == 0 &&
                    ZB % 32 == 0 && XT % 32 == 0 && R % 32 == 0 && Y % 32 == 0,
                "32-byte aligned regions");
  static_assert(BYTES <= 232448, "fits the 227 KB a block may use");
  // blocks that fit on one SM's 228 KB (each block also reserves 1 KB)
  static constexpr int BLOCKS_PER_SM = 2 * (BYTES + 1024) <= 233472 ? 2 : 1;
};

// erf by Abramowitz & Stegun 7.1.26, the polynomial the JAX package uses
// (fused_logreg.py _erf_poly): in the reference the polynomial is the model.
__device__ __forceinline__ float erf_poly(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f;
  const float p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float y = 1.0f - poly * expf(-ax * ax);
  return x > 0.0f ? y : (x < 0.0f ? -y : 0.0f * y);
}

// y - mu_eff of the link, and the per-datum log-likelihood in *ll
// (fused_logreg.py _link_eval_fns: d ll / d eta = y - mu_eff).
__device__ __forceinline__ float link_residual(int link, float eta, float y,
                                               float* ll) {
  if (link == kLogistic) {
    const float mu = 1.0f / (1.0f + expf(-eta));
    const float softplus = fmaxf(eta, 0.0f) + log1pf(expf(-fabsf(eta)));
    *ll = y * eta - softplus;
    return y - mu;
  }
  if (link == kPoisson) {
    const float mu = expf(eta);
    *ll = y * eta - mu;
    return y - mu;
  }
  if (link == kProbit) {
    const float inv_sqrt_2pi = 0.3989422804014327f;
    const float inv_sqrt_2 = 0.7071067811865476f;
    const float hi = (float)(1.0 - 1e-7);
    const float phi = expf(-0.5f * eta * eta) * inv_sqrt_2pi;
    float cdf = 0.5f * (1.0f + erf_poly(eta * inv_sqrt_2));
    cdf = fminf(fmaxf(cdf, 1e-30f), hi);
    const float score = y * phi / cdf - (1.0f - y) * phi / (1.0f - cdf);
    *ll = y * logf(cdf) + (1.0f - y) * logf(1.0f - cdf);
    const float mu = y - score;
    return y - mu;
  }
  const float d = y - eta;  // linear
  *ll = -0.5f * (d * d);
  return d;
}

// g_s <- bf16(r) . X over all row tiles, for r from eta = zb_s . X^T;
// with want_u, adds this thread's share of sum(mask * ll) to *ll_part.
template <int BC, int DP>
__device__ void gradient(const bf16* __restrict__ X,
                         const float* __restrict__ y,
                         const float* __restrict__ mask, int n_rows, int link,
                         bool want_u, unsigned char* smem, float* ll_part) {
  using C = Cfg<BC, DP>;
  const bf16* zb_s = reinterpret_cast<const bf16*>(smem + C::ZB);
  bf16* x_s = reinterpret_cast<bf16*>(smem + C::XT);
  float* e_s = reinterpret_cast<float*>(smem + C::E);
  bf16* r_s = reinterpret_cast<bf16*>(smem + C::R);
  float* y_s = reinterpret_cast<float*>(smem + C::Y);
  float* m_s = reinterpret_cast<float*>(smem + C::M);
  float* g_s = reinterpret_cast<float*>(smem + C::G);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int e_first = warp * C::E_TILES;
  const int e_row = e_first / (kRowTile / 16);
  const int g_first = warp * C::G_TILES;
  const int g_row = g_first / (DP / 16);
  const int lc = tid / C::TPC;  // chain row of the link phase
  const int lq = tid % C::TPC;  // its column phase

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> gacc[C::G_TILES];
#pragma unroll
  for (int f = 0; f < C::G_TILES; ++f) wmma::fill_fragment(gacc[f], 0.0f);

  constexpr int kVecPerRow = DP * (int)sizeof(bf16) / 16;
  for (int t0 = 0; t0 < n_rows; t0 += kRowTile) {
    // stage the tile: rows [t0, t0 + kRowTile) of X, 16-byte vectors
    const uint4* src = reinterpret_cast<const uint4*>(X + (size_t)t0 * DP);
    for (int v = tid; v < kRowTile * kVecPerRow; v += kThreads) {
      const int r = v / kVecPerRow, q = v % kVecPerRow;
      *reinterpret_cast<uint4*>(x_s + r * C::LDX + q * 8) = src[v];
    }
    if (tid < kRowTile) {
      y_s[tid] = y[t0 + tid];
      m_s[tid] = mask[t0 + tid];
    }
    __syncthreads();

    {  // eta (BC x kRowTile) = bf16(z) . tile^T
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::E_TILES];
#pragma unroll
      for (int f = 0; f < C::E_TILES; ++f) wmma::fill_fragment(acc[f], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(a, zb_s + e_row * 16 * C::LDZ + kk * 16, C::LDZ);
#pragma unroll
        for (int f = 0; f < C::E_TILES; ++f) {
          const int j = (e_first + f) % (kRowTile / 16);
          wmma::load_matrix_sync(b, x_s + j * 16 * C::LDX + kk * 16, C::LDX);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < C::E_TILES; ++f) {
        const int j = (e_first + f) % (kRowTile / 16);
        wmma::store_matrix_sync(e_s + e_row * 16 * C::LDE + j * 16, acc[f],
                                C::LDE, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // link, elementwise: r = (y - mu) * mask, rounded to bf16
#pragma unroll 4
    for (int i = 0; i < C::COLS; ++i) {
      const int col = lq + i * C::TPC;
      const float mv = m_s[col];
      float ll;
      const float r = link_residual(link, e_s[lc * C::LDE + col], y_s[col], &ll);
      r_s[lc * C::LDR + col] = __float2bfloat16_rn(r * mv);
      if (want_u) *ll_part += mv * ll;
    }
    __syncthreads();

    {  // g (BC x DP) += bf16(r) . tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
      for (int kk = 0; kk < kRowTile / 16; ++kk) {
        wmma::load_matrix_sync(a, r_s + g_row * 16 * C::LDR + kk * 16, C::LDR);
#pragma unroll
        for (int f = 0; f < C::G_TILES; ++f) {
          const int j = (g_first + f) % (DP / 16);
          wmma::load_matrix_sync(b, x_s + kk * 16 * C::LDX + j * 16, C::LDX);
          wmma::mma_sync(gacc[f], a, b, gacc[f]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites x_s, e_s and r_s
  }
#pragma unroll
  for (int f = 0; f < C::G_TILES; ++f) {
    const int j = (g_first + f) % (DP / 16);
    wmma::store_matrix_sync(g_s + g_row * 16 * C::LDG + j * 16, gacc[f], C::LDG,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

template <int BC, int DP>
__global__ void __launch_bounds__(kThreads, (Cfg<BC, DP>::BLOCKS_PER_SM))
    fused_glm_trajectory_kernel(const float* __restrict__ z_in,
                                const float* __restrict__ p_in,
                                const bf16* __restrict__ X,
                                const float* __restrict__ y,
                                const float* __restrict__ mask,
                                float* __restrict__ z_out,
                                float* __restrict__ p_out,
                                float* __restrict__ u_out, int n_chains,
                                int n_rows, int n_leap, float half_eps,
                                float eps, float inv_pv, int link) {
  using C = Cfg<BC, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* z_s = reinterpret_cast<float*>(smem + C::Z);
  float* p_s = reinterpret_cast<float*>(smem + C::P);
  const float* g_s = reinterpret_cast<const float*>(smem + C::G);
  bf16* zb_s = reinterpret_cast<bf16*>(smem + C::ZB);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BC;
  const int n_here = min(BC, n_chains - c0);

  for (int e = tid; e < BC * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const bool ok = r < n_here;
    const size_t gi = (size_t)(c0 + r) * DP + c;
    const float zv = ok ? z_in[gi] : 0.0f;
    z_s[e] = zv;
    p_s[e] = ok ? p_in[gi] : 0.0f;
    zb_s[r * C::LDZ + c] = __float2bfloat16_rn(zv);
  }
  __syncthreads();

  float ll_part = 0.0f;
  gradient<BC, DP>(X, y, mask, n_rows, link, false, smem, &ll_part);
  for (int k = 0; k < n_leap; ++k) {
    // half kick with the carried gradient, then drift
    for (int e = tid; e < BC * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      const float g = g_s[r * C::LDG + c] - z_s[e] * inv_pv;
      const float p = p_s[e] + half_eps * g;
      const float z = z_s[e] + eps * p;
      p_s[e] = p;
      z_s[e] = z;
      zb_s[r * C::LDZ + c] = __float2bfloat16_rn(z);
    }
    __syncthreads();
    gradient<BC, DP>(X, y, mask, n_rows, link, k == n_leap - 1, smem,
                     &ll_part);
    // second half kick; each thread touches only its own elements
    for (int e = tid; e < BC * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      const float g = g_s[r * C::LDG + c] - z_s[e] * inv_pv;
      p_s[e] = p_s[e] + half_eps * g;
    }
  }

  // U per chain: the TPC adjacent lanes of a chain row reduce in a fixed
  // order, so the result does not vary from launch to launch
  const int lc = tid / C::TPC, lq = tid % C::TPC;
  float zz = 0.0f;
  for (int c = lq; c < DP; c += C::TPC) {
    const float v = z_s[lc * DP + c];
    zz += v * v;
  }
#pragma unroll
  for (int off = C::TPC / 2; off > 0; off >>= 1) {
    ll_part += __shfl_xor_sync(0xffffffffu, ll_part, off);
    zz += __shfl_xor_sync(0xffffffffu, zz, off);
  }
  if (lq == 0 && lc < n_here) u_out[c0 + lc] = -(ll_part - 0.5f * zz * inv_pv);

  for (int e = tid; e < BC * DP; e += kThreads) {
    const int r = e / DP;
    if (r < n_here) {
      const size_t gi = (size_t)(c0 + r) * DP + e % DP;
      z_out[gi] = z_s[e];
      p_out[gi] = p_s[e];
    }
  }
}

template <int BC, int DP>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, void* z_out, void* p_out, void* u_out,
                   int n_chains, int n_rows, int n_leap, float half_eps,
                   float eps, float inv_pv, int link, cudaStream_t stream) {
  using C = Cfg<BC, DP>;
  auto kernel = fused_glm_trajectory_kernel<BC, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_chains + BC - 1) / BC);
  kernel<<<grid, kThreads, C::BYTES, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const bf16*>(X), static_cast<const float*>(y),
      static_cast<const float*>(mask), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_rows,
      n_leap, half_eps, eps, inv_pv, link);
  return cudaGetLastError();
}

}  // namespace

// Launch one fused trajectory on `stream`. z, p, z_out, p_out:
// (n_chains, dim_padded) f32; X: (n_rows, dim_padded) bf16; y, mask:
// (n_rows,) f32; u_out: (n_chains,) f32; all contiguous on the device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_glm_trajectory_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, int n_chains,
    int n_rows, int dim_padded, int n_leap, float half_eps, float eps,
    float inv_pv, int link, void* stream) {
  if (n_chains < 1 || n_rows < kRowTile || n_rows % kRowTile != 0 ||
      n_leap < 1 || link < kLogistic || link > kProbit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim_padded == 128)
    return (int)launch<32, 128>(z, p, X, y, mask, z_out, p_out, u_out,
                                n_chains, n_rows, n_leap, half_eps, eps,
                                inv_pv, link, s);
  if (dim_padded == 256)
    return (int)launch<32, 256>(z, p, X, y, mask, z_out, p_out, u_out,
                                n_chains, n_rows, n_leap, half_eps, eps,
                                inv_pv, link, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_glm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
