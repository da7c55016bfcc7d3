// The fused GLM trajectory's body for dim_padded 256, on WMMA tiles.
//
// Included by fused_glm_trajectory.cu, after its link functions. At 256
// columns the warpgroup design of that file would need 128 accumulator
// registers a thread for the gradient beside 128 for the momentum, which
// does not fit; this width therefore keeps the earlier design: one 8-warp
// block owns 32 chains, z, p and g live in shared memory, each 64-row tile
// of X is staged synchronously and serves both products through WMMA
// (bf16 in, f32 accumulate), with eta and r passing through shared memory
// and four block-wide barriers per tile. One block fits on an SM. It is
// bound by those barriers, not by the tensor cores.

#pragma once

#include <mma.h>

namespace wmma_body {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkewH = 8;     // bf16 row padding (16 B) against bank conflicts
constexpr int kSkewF = 4;     // f32 row padding (16 B)

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

// g_s <- bf16(r) . X over all row tiles, for r from eta = zb_s . X^T;
// with want_u, adds this thread's share of sum(mask * ll) to *ll_part.
template <int BC, int DP>
__device__ void gradient(const bf16* __restrict__ X,
                         const float* __restrict__ y,
                         const float* __restrict__ mask, int n_rows, int link,
                         float nu, bool want_u, unsigned char* smem,
                         float* ll_part) {
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
      const float r =
          link_residual(link, nu, e_s[lc * C::LDE + col], y_s[col], &ll);
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

// RT: eps is read from eps_ptr and the drift carries inv_mass; otherwise
// both pointers are unused and half_eps, eps are the launch's own.
template <int BC, int DP, bool RT>
__global__ void __launch_bounds__(kThreads, (Cfg<BC, DP>::BLOCKS_PER_SM))
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
  using C = Cfg<BC, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* z_s = reinterpret_cast<float*>(smem + C::Z);
  float* p_s = reinterpret_cast<float*>(smem + C::P);
  const float* g_s = reinterpret_cast<const float*>(smem + C::G);
  bf16* zb_s = reinterpret_cast<bf16*>(smem + C::ZB);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BC;
  const int n_here = min(BC, n_chains - c0);
  if (RT) {
    eps = *eps_ptr;
    half_eps = 0.5f * eps;
  }

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
  gradient<BC, DP>(X, y, mask, n_rows, link, nu, false, smem, &ll_part);
  for (int k = 0; k < n_leap; ++k) {
    // half kick with the carried gradient, then drift
    for (int e = tid; e < BC * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      const float g = g_s[r * C::LDG + c] - z_s[e] * inv_pv;
      const float p = p_s[e] + half_eps * g;
      const float z = z_s[e] + eps * (RT ? inv_mass[c] * p : p);
      p_s[e] = p;
      z_s[e] = z;
      zb_s[r * C::LDZ + c] = __float2bfloat16_rn(z);
    }
    __syncthreads();
    gradient<BC, DP>(X, y, mask, n_rows, link, nu, k == n_leap - 1, smem,
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

template <int BC, int DP, bool RT>
cudaError_t launch(const void* z, const void* p, const void* X, const void* y,
                   const void* mask, const void* eps_ptr, const void* inv_mass,
                   void* z_out, void* p_out, void* u_out, int n_chains,
                   int n_rows, int n_leap, float half_eps, float eps,
                   float inv_pv, int link, float nu, cudaStream_t stream) {
  using C = Cfg<BC, DP>;
  auto kernel = fused_glm_trajectory_kernel<BC, DP, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_chains + BC - 1) / BC);
  kernel<<<grid, kThreads, C::BYTES, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const bf16*>(X), static_cast<const float*>(y),
      static_cast<const float*>(mask), static_cast<const float*>(eps_ptr),
      static_cast<const float*>(inv_mass), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out), n_chains, n_rows,
      n_leap, half_eps, eps, inv_pv, link, nu);
  return cudaGetLastError();
}

}  // namespace wmma_body
