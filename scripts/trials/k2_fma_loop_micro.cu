// The FMA loop of the wide Gaussian trajectory (csrc/
// fused_gaussian_trajectory_wide.cu) alone, for scripts/
// torch_wide_gaussian_trials.py: no trajectory and wrong numbers, but the
// same FMAs a block as a trajectory at the given width, on one panel of P
// resident in shared memory, with no copies, no barriers and no z or p.
// MB_WARPS warps of 32 threads, each on 8 chains x MB_COLS columns (4: one
// 16-byte load of P a row; 8: two, 128 columns apart), MB_ROWS rows a panel;
// MB_FENCE puts a warp barrier and a compiler fence between panels, as the
// ring's waits and arrivals do.
#include <cuda_runtime.h>
#include <cstdint>
namespace {
#ifndef MB_WARPS
#define MB_WARPS 16
#endif
#ifndef MB_COLS
#define MB_COLS 8
#endif
#ifndef MB_ROWS
#define MB_ROWS 8
#endif
constexpr int kLiveMultiple = 16;
struct Split { int ncw, ks, kt, threads, floats; };
__host__ __device__ inline Split split_of(int live, int dp) {
  Split s; s.ncw = 1; s.ks = 1; s.kt = 8; s.threads = 32 * MB_WARPS;
  s.floats = 8192 + 1024 * 16; return s;
}
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__global__ void __launch_bounds__(32 * MB_WARPS, 1)
fused_gaussian_wide_kernel(const float* P, float* u_out, int n_panels_total, int dp) {
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem; float* d_s = smem + 8192;
  for (int i = threadIdx.x; i < 8192 + 16384; i += blockDim.x) smem[i] = 0.001f * (i % 13);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = warp & 1;
  const int j0 = (MB_COLS == 8 ? 256 * ((warp >> 1) & 3) : 128 * ((warp >> 1) & 7)) % 1024 + 4 * lane;
  float acc[8][MB_COLS];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < MB_COLS; ++e) acc[c][e] = 0.0f;
  for (int gp = 0; gp < n_panels_total; ++gp) {
#ifdef MB_FENCE
    __syncwarp();
    asm volatile("" ::: "memory");
#endif
    const float* pp = p_s;
    const float* dd = d_s + ((gp * MB_ROWS) % 1000) * 16 + 8 * half;
#pragma unroll
    for (int r = 0; r < MB_ROWS; ++r, dd += 16) {
      const float4 pa = load4(pp + r * dp + j0);
      const float4 da = load4(dd), db = load4(dd + 4);
      const float dv[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#if MB_COLS == 8
      const float4 pb = load4(pp + r * dp + j0 + 128);
#endif
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[c][0] = __fmaf_rn(dv[c], pa.x, acc[c][0]);
        acc[c][1] = __fmaf_rn(dv[c], pa.y, acc[c][1]);
        acc[c][2] = __fmaf_rn(dv[c], pa.z, acc[c][2]);
        acc[c][3] = __fmaf_rn(dv[c], pa.w, acc[c][3]);
#if MB_COLS == 8
        acc[c][4] = __fmaf_rn(dv[c], pb.x, acc[c][4]);
        acc[c][5] = __fmaf_rn(dv[c], pb.y, acc[c][5]);
        acc[c][6] = __fmaf_rn(dv[c], pb.z, acc[c][6]);
        acc[c][7] = __fmaf_rn(dv[c], pb.w, acc[c][7]);
#endif
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < MB_COLS; ++e) s += acc[c][e];
  if (s == 12345.0f) u_out[threadIdx.x] = s;
}
}  // namespace
// the harness's launch: n_leap + 1 products of live / 8 panels (each warp 8 rows a panel)
int fused_gaussian_wide_launch(const void* z, const void* p, const void* P,
                               const void* mean, const void* eps, void* z_out,
                               void* p_out, void* u_out, int n_chains,
                               int dim_padded, int dim, int n_leap,
                               cudaStream_t stream) {
  const int live = (dim + 15) / 16 * 16;
  // the same FMA count per SM as the real kernel: 16 chains x live^2 per product
  const long long fma = 16ll * live * live * (n_leap + 1);
  const long long per_panel = (long long)MB_WARPS * 32 * 8 * MB_COLS * MB_ROWS;
  const int panels = (int)(fma / per_panel);
  const int bytes = 4 * (8192 + 16384);
  cudaFuncSetAttribute(fused_gaussian_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fused_gaussian_wide_kernel<<<(n_chains + 15) / 16, 32 * MB_WARPS, bytes, stream>>>(
      (const float*)P, (float*)u_out, panels, 1024);
  return (int)cudaGetLastError();
}
