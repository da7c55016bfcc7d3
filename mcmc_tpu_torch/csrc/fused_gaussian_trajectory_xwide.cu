// Fused HMC leapfrog trajectory on N(m, P^-1) past 1024 padded columns,
// for Hopper (sm_90a): a cluster of blocks shares a tile of 64 chains, each
// block owns 256-column slices of the product, and every block streams its
// slices of P and the tile's d = z - m from L2 by bulk copies on an
// mbarrier ring.
//
// Replaces the TPU kernel of mcmc_tpu/ops/fused_logreg.py
// (make_fused_gaussian_trajectory: kernel body :330-365, pallas_call :381)
// at the widths the body of fused_gaussian_trajectory_wide.cu cannot hold,
// and computes the same function (see fused_gaussian_trajectory.cu): n_leap
// + 1 dependent f32 products g = -(z - m) . P with the update between them,
// the step read from device memory, U = 0.5 * sum(d * (d . P)) from the
// last product. All f32, FP32 FMAs, the update explicitly rounded as in
// the other two bodies: on a diagonal P every product has one non-zero
// term and z, p equal the plain version's bit for bit.
//
// Why another body. The wide body gives a block 16 chains for the whole
// trajectory, keeps their d for every live column in shared memory (64 KB
// at 1024 columns, 128 KB at 2048, beside a 160 KB ring: more than a block
// has) and spreads the columns over its 8 warps of 256 (2048 at most); and
// every block streams all of P every product. Past about 3,500 columns P
// (f32 Dp^2: 67 MB at 4096) no longer fits the 50 MB L2, and 128 blocks of
// 16 chains would read all of it from device memory every product (8.6 GB,
// 2.6 ms at 3.35 TB/s, against 1.0 ms of FMAs at 2048 chains). So here:
// - a block takes 64 chains (a thread 8 chains x 8 columns, the wide body's
//   tile: two groups of 4 adjacent columns, 128 apart; a warp 8 chains x
//   256 columns, 8 warps the 64 chains), four times the wide body's, so a
//   panel of P brought into shared memory serves four times the chains;
// - the columns are split over a cluster of c = min(8, slices) blocks on
//   the same 64 chains: block j owns 256-column slices [s j / c, s (j + 1)
//   / c) of the live width and streams only those columns of P, so P's
//   bytes a product are (chains / 64) x Dp^2 x 4 in all (2.1 GB at 4096 and
//   2048 chains, less than a product's FMAs take at the memory's rate);
// - d = z - m of the tile is in device memory ([live][64] floats, 1 MB at
//   4096 columns, double-buffered: a product reads one buffer while the
//   blocks' updates write the other), read a panel of 16 rows at a time
//   beside P's: a stage is 16 rows of P's slice (16 KB, one copy of the
//   tensor memory accelerator, which fills the columns past P's edge with
//   zeros) and of d (4 KB, one bulk copy), on a ring of kStages stages, all
//   issued by one thread;
// - one cluster barrier a product: every block has written its columns of
//   the next d before any block reads it.
// What bounds it: the FP32 FMA pipe and the shared-memory loads that feed
// it (four 16-byte loads a warp and row for 64 FMAs a thread, as in the
// wide body), and at the product boundary the ring's refill (the next
// product's d is not there before the barrier).
//
// Chains past n_chains are computed on zeros and never stored; columns at
// and past the live width (the model's dimension rounded up to 16) are
// copied from the input. Each output's sums have a fixed order (a column's
// product over the live rows in order; U's four columns a thread, its
// 32 lanes by butterfly, then its 128-column parts in order), so a launch
// is deterministic.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {
namespace gauss_xwide {

constexpr int CB = 64;      // chains per block and cluster
constexpr int CT = 8;       // chains per thread (and warp)
constexpr int kCols = 4;    // adjacent columns per thread and column group
constexpr int kGroups = 2;  // column groups per thread, 128 columns apart
constexpr int W = 32 * kCols * kGroups;  // a slice's 256 columns
constexpr int KT = 16;                   // rows of P and d per stage
constexpr int kWarps = CB / CT;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 8;
// a warp that consumes item gi has item gi + kAhead issued, whose stage
// items up to gi - 2 held
constexpr int kAhead = kStages - 2;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kLiveMultiple = 16;
constexpr int kPFloats = KT * W;
constexpr int kDFloats = KT * CB;
constexpr int kStageFloats = kPFloats + kDFloats;
// the ring, its barriers, and 128 bytes to align the ring's base for the
// tensor copies
constexpr int kSmemBytes = 4 * kStages * kStageFloats + 16 * kStages + 128;
static_assert(kSmemBytes <= 232448, "fits a block");
static_assert((4 * kStageFloats) % 128 == 0, "every stage 128-byte aligned");

// The work of a launch: the live width, its slices, the cluster size and
// the chain tiles. The workspace holds d [2][tiles][live][CB] and U's
// 128-column parts [tiles * CB][parts], in floats.
struct Layout {
  int live, slices, cluster, tiles, parts;
  size_t d_floats() const { return (size_t)tiles * live * CB; }
  size_t bytes() const {
    return 4 * (2 * d_floats() + (size_t)tiles * CB * parts);
  }
};

__host__ __device__ inline int live_of(int dim) {
  return (dim + kLiveMultiple - 1) / kLiveMultiple * kLiveMultiple;
}

inline Layout layout_of(int n_chains, int dim) {
  Layout l;
  l.live = live_of(dim);
  l.slices = (l.live + W - 1) / W;
  l.cluster = l.slices < kMaxCluster ? l.slices : kMaxCluster;
  l.tiles = (n_chains + CB - 1) / CB;
  l.parts = (l.live + 127) / 128;
  return l;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A box of `map` at (c0, c1) into shared memory at `dst`, completing
// `bar`'s transactions; elements past the tensor's edge arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Makes this thread's generic-proxy writes to global memory visible to
// bulk copies (the async proxy) that read them after a barrier.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A row of the product: a thread's 4 + 4 columns of P and its warp's 8
// chains of d, and their 64 FMAs into acc (the wide body's).
__device__ __forceinline__ void fma_row(float (&acc)[CT][kCols * kGroups],
                                       const float4& pa, const float4& pb,
                                       const float4& da, const float4& db) {
  const float dv[CT] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    acc[c][0] = __fmaf_rn(dv[c], pa.x, acc[c][0]);
    acc[c][1] = __fmaf_rn(dv[c], pa.y, acc[c][1]);
    acc[c][2] = __fmaf_rn(dv[c], pa.z, acc[c][2]);
    acc[c][3] = __fmaf_rn(dv[c], pa.w, acc[c][3]);
    acc[c][4] = __fmaf_rn(dv[c], pb.x, acc[c][4]);
    acc[c][5] = __fmaf_rn(dv[c], pb.y, acc[c][5]);
    acc[c][6] = __fmaf_rn(dv[c], pb.z, acc[c][6]);
    acc[c][7] = __fmaf_rn(dv[c], pb.w, acc[c][7]);
  }
}

// Launched in clusters of `cluster` blocks (layout_of); cluster q takes
// chains 64 q .. 64 q + 63. z_out and p_out hold the state between updates;
// `work` is the workspace (Layout).
__global__ void __launch_bounds__(kThreads, 1)
    fused_gaussian_xwide_kernel(const float* z_in, const float* p_in,
                                const __grid_constant__ CUtensorMap tmap_p,
                                const float* __restrict__ mean,
                                const float* __restrict__ eps_ptr,
                                float* z_out, float* p_out,
                                float* __restrict__ u_out, float* work,
                                int n_chains, int dim_padded, int live,
                                int n_leap, int cluster) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u));
  const uint32_t bars = smem_u32(smem + kStages * kStageFloats);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = cluster, me = (int)cluster_rank();
  const int ct = blockIdx.x / c;  // the cluster's chain tile
  const int slices = (live + W - 1) / W;
  const int s_lo = slices * me / c, s_hi = slices * (me + 1) / c;
  const int np = live / KT;  // panels a product and slice
  const int per_prod = (s_hi - s_lo) * np;
  const int c0 = ct * CB;
  const int n_here = min(CB, n_chains - c0);
  const int tiles = (n_chains + CB - 1) / CB;
  const int parts = (live + 127) / 128;
  const size_t d_floats = (size_t)tiles * live * CB;
  float* up = work + 2 * d_floats;
  const float eps = *eps_ptr;
  const float half_eps = __fmul_rn(0.5f, eps);
  const int j0 = kCols * lane;  // in the slice; the second group + 128
  bool ok[CT];
#pragma unroll
  for (int q = 0; q < CT; ++q) ok[q] = CT * w + q < n_here;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // one thread: item gi (slice s_lo + q / np, panel q % np of product
  // gi / per_prod) into stage gi % kStages, once every warp is done with
  // the item the stage held: the panel's rows of P's slice (a last slice of
  // 128 columns gets zeros past P's edge), and of d from the product's
  // buffer
  auto issue = [&](int gi) {
    const int prod = gi / per_prod, q = gi % per_prod;
    const int s = s_lo + q / np, row0 = (q % np) * KT;
    const int st = gi % kStages;
    if (gi >= kStages)
      mbar_wait(bars + 8 * (kStages + st), ((gi / kStages) - 1) & 1);
    const uint32_t full = bars + 8 * st;
    mbar_arrive_tx(full, 4 * (kPFloats + kDFloats));
    float* ps = smem + st * kStageFloats;
    tma_load_2d(smem_u32(ps), &tmap_p, s * W, row0, full);
    bulk_from_global(smem_u32(ps + kPFloats),
                     work + (prod & 1) * d_floats +
                         ((size_t)ct * live + row0) * CB,
                     4 * kDFloats, full);
  };

  auto at = [&](int q, int col) {
    return (size_t)(c0 + CT * w + q) * dim_padded + col;
  };
  // d = z - m of column group g (4 columns from col) of the warp's chains
  // into buffer `buf`; chains past n_chains 0
  auto store_d = [&](const float (&z)[CT][kCols], int col, int buf) {
    const float4 mv = load4(mean + col);
    const float m[kCols] = {mv.x, mv.y, mv.z, mv.w};
    float* dst = work + buf * d_floats + ((size_t)ct * live + col) * CB +
                 CT * w;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      float d[CT];
#pragma unroll
      for (int q = 0; q < CT; ++q)
        d[q] = ok[q] ? __fsub_rn(z[q][e], m[e]) : 0.0f;
      *reinterpret_cast<float4*>(dst + e * CB) =
          make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(dst + e * CB + 4) =
          make_float4(d[4], d[5], d[6], d[7]);
    }
  };
  auto load_zp = [&](float (&v)[CT][kCols], const float* src, int col) {
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok[q]) x = __ldcg(reinterpret_cast<const float4*>(src + at(q, col)));
      v[q][0] = x.x, v[q][1] = x.y, v[q][2] = x.z, v[q][3] = x.w;
    }
  };
  auto store_zp = [&](const float (&v)[CT][kCols], float* dst, int col) {
#pragma unroll
    for (int q = 0; q < CT; ++q)
      if (ok[q])
        *reinterpret_cast<float4*>(dst + at(q, col)) =
            make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  };

  // the start's d for this block's slices
  for (int s = s_lo; s < s_hi; ++s)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int col = s * W + j0 + 128 * g;
      if (col >= live) continue;
      float z[CT][kCols];
      load_zp(z, z_in, col);
      store_d(z, col, 0);
    }
  fence_proxy_async_global();
  cluster_sync();

  float acc[CT][kCols * kGroups];
  int gi = 0;
  for (int t = 0; t <= n_leap; ++t) {
    const int end = (t + 1) * per_prod;
    // the product's first items: its d is complete since the barrier
    if (tid == 0)
      for (int q = gi; q < gi + kAhead && q < end; ++q) issue(q);
    const float* z_src = t == 0 ? z_in : z_out;
    const float* p_src = t == 0 ? p_in : p_out;
    for (int s = s_lo; s < s_hi; ++s) {
#pragma unroll
      for (int q = 0; q < CT; ++q)
#pragma unroll
        for (int e = 0; e < kCols * kGroups; ++e) acc[q][e] = 0.0f;
      for (int pi = 0; pi < np; ++pi, ++gi) {
        const int st = gi % kStages;
        mbar_wait(bars + 8 * st, (gi / kStages) & 1);
        const float* ps = smem + st * kStageFloats;
        const float* ds = ps + kPFloats + CT * w;
#pragma unroll
        for (int r = 0; r < KT; ++r)
          fma_row(acc, load4(ps + r * W + j0), load4(ps + r * W + j0 + 128),
                  load4(ds + r * CB), load4(ds + r * CB + 4));
        // this warp is done with the stage: one arrival on its "empty"
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));
        if (tid == 0 && gi + kAhead < end) issue(gi + kAhead);
      }
      // the last leapfrog's second half kick with the gradient -acc, then
      // (but after the last product) this one's first and the drift; at
      // the end U's part of each column group
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int col = s * W + j0 + 128 * g;
        const bool live_g = col < live;
        float z[CT][kCols], p[CT][kCols];
        float ug[CT];
        if (live_g) {
          load_zp(z, z_src, col);
          load_zp(p, p_src, col);
#pragma unroll
          for (int q = 0; q < CT; ++q)
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              const float a = acc[q][4 * g + e];
              if (t > 0) p[q][e] = __fadd_rn(p[q][e], __fmul_rn(half_eps, -a));
              if (t < n_leap) {
                p[q][e] = __fadd_rn(p[q][e], __fmul_rn(half_eps, -a));
                z[q][e] = __fadd_rn(z[q][e], __fmul_rn(eps, p[q][e]));
              }
            }
          store_zp(p, p_out, col);
          if (t < n_leap) {
            store_zp(z, z_out, col);
            store_d(z, col, (t + 1) & 1);
          }
        }
        if (t < n_leap) continue;
        // U = 0.5 * sum_j d_j (d . P)_j, with (d . P) = acc at the end
        // position; a dead group's part 0, its lanes still in the butterfly
        float4 mv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live_g) mv = load4(mean + col);
        const float m[kCols] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int q = 0; q < CT; ++q) {
          float d[kCols];
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            d[e] = ok[q] && live_g ? __fsub_rn(z[q][e], m[e]) : 0.0f;
          const float* a = acc[q] + 4 * g;
          ug[q] = live_g ? __fadd_rn(__fadd_rn(__fmul_rn(d[0], a[0]),
                                               __fmul_rn(d[1], a[1])),
                                     __fadd_rn(__fmul_rn(d[2], a[2]),
                                               __fmul_rn(d[3], a[3])))
                         : 0.0f;
#pragma unroll
          for (int off = 16; off >= 1; off >>= 1)
            ug[q] = __fadd_rn(ug[q], __shfl_xor_sync(0xffffffffu, ug[q], off));
        }
        const int part = (s * W + 128 * g) / 128;
        if (lane == 0 && part < parts) {
#pragma unroll
          for (int q = 0; q < CT; ++q)
            up[(size_t)(c0 + CT * w + q) * parts + part] = ug[q];
        }
      }
    }
    if (t < n_leap) {
      // every block's columns of the next d are written before any block
      // reads them
      fence_proxy_async_global();
      cluster_sync();
    }
  }

  // U: the 128-column parts in order, by the cluster's first block
  cluster_sync();
  if (me == 0) {
    if (tid < n_here) {
      const float* ur = up + (size_t)(c0 + tid) * parts;
      float us = __ldcg(ur);
      for (int i = 1; i < parts; ++i) us = __fadd_rn(us, __ldcg(ur + i));
      u_out[c0 + tid] = __fmul_rn(0.5f, us);
    }
    // columns at and past the live width pass through
    const int n_pad = dim_padded - live;
    for (int i = tid; i < n_here * n_pad; i += kThreads) {
      const size_t o = (size_t)(c0 + i / n_pad) * dim_padded + live + i % n_pad;
      z_out[o] = z_in[o];
      p_out[o] = p_in[o];
    }
  }
}

// P's tensor map: boxes of KT rows x W columns, unswizzled, as the ring's
// stages hold them; columns past dim_padded read as zeros.
// cuTensorMapEncodeTiled is looked up through the runtime's entry-point
// query, so the library does not link libcuda.
cudaError_t p_tensor_map(const void* P, int dim_padded, CUtensorMap* map) {
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
  const cuuint64_t dims[2] = {(cuuint64_t)dim_padded, (cuuint64_t)dim_padded};
  const cuuint64_t stride[1] = {(cuuint64_t)dim_padded * sizeof(float)};
  const cuuint32_t box[2] = {W, KT};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(P),
             dims, stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
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
  const Layout lay = layout_of(n_chains, dim);
  CUtensorMap tmap_p;
  cudaError_t err = p_tensor_map(P, dim_padded, &tmap_p);
  if (err != cudaSuccess) return (int)err;
  auto kernel = fused_gaussian_xwide_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.cluster * lay.tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(z), static_cast<const float*>(p),
      tmap_p, static_cast<const float*>(mean),
      static_cast<const float*>(eps), static_cast<float*>(z_out),
      static_cast<float*>(p_out), static_cast<float*>(u_out),
      static_cast<float*>(work), n_chains, dim_padded, lay.live, n_leap,
      lay.cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
