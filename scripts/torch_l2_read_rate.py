"""The L2 cache's read rate on an NVIDIA GPU, as the fused GLM bodies read it.

Three small kernels, compiled with the package's nvcc flags, read a buffer
of ``--mb`` MB (default 24: it stays in the H100's 50 MB L2 once warm) over
and over, every block on its own slice of it:

- ``ldcg``: 16-byte ``ld.global.cg`` loads by every thread (what the first
  two-pass body did to read its operand fragments);
- ``bulk``: one thread of each block brings pieces of 16, 32 or 64 KB into
  a ring of 2 to 12 stages of shared memory by ``cp.async.bulk`` on
  ``mbarrier``s (what the tensor memory accelerator does for the bodies'
  rings), so that the bytes in flight an SM vary from 32 to 192 KB;
- ``multicast``: the same in clusters of ``--cluster`` blocks, each block
  bringing 1/c of each piece and multicasting it to the cluster, or one
  block in turn bringing the whole piece (the two-pass body's operands):
  the bytes read from the L2 and the bytes landed in shared memory are
  both counted. Every stage is released and refilled as the two-pass body
  does it (``csrc/fused_glm_xwide_body.cuh``).

Each is timed with CUDA events over ``--reps`` launches after a warm-up (so
the reads are warm), at one block an SM; the rate is bytes over seconds.
A read of ``--dram-mb`` MB (default 1,024) beside them gives device memory's
rate for comparison. Prints the card's name and power limit first.

From the repository root, with a card:

    python3 scripts/torch_l2_read_rate.py
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from mcmc_tpu_torch.ops import _cuda  # noqa: E402

SOURCE = r"""
#include "hopper_ptx.cuh"
#include <cstdint>

__global__ void ldcg(const uint4* buf, long long n16, int rounds,
                     unsigned* sink) {
  const long long per = n16 / gridDim.x;
  const uint4* mine = buf + per * blockIdx.x;
  unsigned acc = 0;
  for (int r = 0; r < rounds; ++r)
    for (long long i = threadIdx.x; i < per; i += blockDim.x) {
      const uint4 v = __ldcg(mine + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  if (acc == 0x12345678u) sink[threadIdx.x] = acc;
}

// pieces of kPiece bytes into a ring of kStages; with c > 1 each block of a
// cluster of c copies its 1/c of the piece and multicasts it to the
// cluster. As in the two-pass body: a stage's "full" barrier expects the
// whole piece; each half of a block (128 threads, a warpgroup) releases a
// stage with one arrival on the "empty" barrier of every block of the
// cluster, and a block refills a stage once every half of the cluster has
// released it.
template <int kStages, int kPiece>
__global__ void bulk(const unsigned char* buf, long long bytes, int rounds,
                     int c, int whole, unsigned* sink) {
  extern __shared__ __align__(1024) unsigned char sm[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const uint32_t s0 = smem_u32(sm), f0 = smem_u32(full);
  const uint32_t e0 = smem_u32(empty);
  const int me = c > 1 ? (int)cluster_rank() : 0;
  const int group = blockIdx.x / c, groups = gridDim.x / c;
  const long long per = bytes / groups / kPiece;  // pieces of this group
  const unsigned char* mine = buf + (long long)group * per * kPiece;
  const int lo = kPiece * me / c, hi = kPiece * (me + 1) / c;
  const long long total = per * rounds;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(f0 + 8 * s, 1);
      mbar_init(e0 + 8 * s, 2 * c);
    }
    fence_mbarrier_init();
  }
  cluster_sync();
  auto issue = [&](long long i) {
    const int s = (int)(i % kStages);
    if (i >= kStages)
      mbar_wait_cluster(e0 + 8 * s, (uint32_t)(((i / kStages) - 1) & 1));
    const unsigned char* src = mine + (i % per) * kPiece;
    mbar_arrive_tx(f0 + 8 * s, kPiece);
    if (c > 1 && whole) {  // block i % c multicasts the whole piece
      if (i % c == me)
        bulk_multicast(s0 + s * kPiece, src, kPiece, f0 + 8 * s,
                       (uint16_t)((1u << c) - 1u));
    } else if (c > 1)
      bulk_multicast(s0 + s * kPiece + lo, src + lo, hi - lo, f0 + 8 * s,
                     (uint16_t)((1u << c) - 1u));
    else
      bulk_from_global(s0 + s * kPiece, src, kPiece, f0 + 8 * s);
  };
  if (threadIdx.x == 0)
    for (long long i = 0; i < kStages && i < total; ++i) issue(i);
  unsigned acc = 0;
  for (long long j = 0; j < total; ++j) {
    const int s = (int)(j % kStages);
    mbar_wait(f0 + 8 * s, (uint32_t)((j / kStages) & 1));
    acc ^= sm[s * kPiece + threadIdx.x * 16];
    // each half of the block: a barrier of its 128 threads, then thread b
    // of the half arrives on block b's empty barrier
    asm volatile("bar.sync %0, 128;" ::"r"(1 + (int)(threadIdx.x >> 7))
                 : "memory");
    if ((threadIdx.x & 127) < c) {
      const uint32_t bar = map_rank(e0 + 8 * s, threadIdx.x & 127);
      asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar)
                   : "memory");
    }
    if (threadIdx.x == 0 && j + kStages < total) issue(j + kStages);
  }
  if (acc == 0x7fu) sink[threadIdx.x] = acc;
  cluster_sync();
}

extern "C" int run_ldcg(const void* buf, long long bytes, int rounds,
                        int blocks, void* sink) {
  ldcg<<<blocks, 512>>>((const uint4*)buf, bytes / 16, rounds,
                        (unsigned*)sink);
  return (int)cudaGetLastError();
}

template <int kStages, int kPiece>
int run_ring(const void* buf, long long bytes, int rounds, int blocks, int c,
             int whole, void* sink) {
  const int smem = kStages * kPiece;
  auto kernel = bulk<kStages, kPiece>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks / c * c);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const unsigned char*)buf, bytes, rounds, c, whole,
      (unsigned*)sink);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ring `ring` of RINGS (stages, KB a piece)
extern "C" int run_bulk(const void* buf, long long bytes, int rounds,
                        int blocks, int c, int whole, int ring, void* sink) {
  switch (ring) {
    case 0:
      return run_ring<2, 32768>(buf, bytes, rounds, blocks, c, whole, sink);
    case 1:
      return run_ring<4, 32768>(buf, bytes, rounds, blocks, c, whole, sink);
    case 2:
      return run_ring<6, 32768>(buf, bytes, rounds, blocks, c, whole, sink);
    case 3:
      return run_ring<3, 65536>(buf, bytes, rounds, blocks, c, whole, sink);
    case 4:
      return run_ring<12, 16384>(buf, bytes, rounds, blocks, c, whole, sink);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
# the rings run_bulk takes: (stages, KB a piece)
RINGS = ((2, 32), (4, 32), (6, 32), (3, 64), (12, 16))


def build():
    tmp = Path(tempfile.mkdtemp(prefix="l2rate-"))
    (tmp / "l2.cu").write_text(SOURCE)
    so = tmp / "l2.so"
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        str(_cuda.CSRC), "-o", str(so), str(tmp / "l2.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.run_ldcg.argtypes = [vp, ll, ci, ci, vp]
    lib.run_bulk.argtypes = [vp, ll, ci, ci, ci, ci, ci, vp]
    return lib


def seconds(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        if fn() != 0:
            raise SystemExit("launch failed")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=24)
    ap.add_argument("--dram-mb", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cluster", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1024, dtype=torch.int32, device="cuda")
    c = args.cluster
    for mb, rounds in ((args.mb, args.rounds), (args.dram_mb, 1)):
        buf = torch.ones(mb << 20, dtype=torch.uint8, device="cuda")
        n = buf.numel()
        where = "L2 (warm)" if mb <= 40 else "device memory"
        s = seconds(lambda: lib.run_ldcg(buf.data_ptr(), n, rounds, sms,
                                         sink.data_ptr()), args.reps)
        print(f"{where}, {mb} MB: ldcg, 512 threads a block: "
              f"{n // sms * sms * rounds / s / 1e12:.3f} TB/s "
              f"({1e3 * s:.3f} ms a launch)")
        for ring, (stages, kb) in enumerate(RINGS):
            for cc, whole in ((1, 0), (c, 0), (c, 1)):
                groups = sms // cc
                s = seconds(lambda: lib.run_bulk(
                    buf.data_ptr(), n, rounds, groups * cc, cc, whole, ring,
                    sink.data_ptr()), args.reps)
                # whole pieces of each block's (or cluster's) slice, every
                # round
                total = n // groups // (kb << 10) * (kb << 10) * groups \
                    * rounds
                what = "bulk copies" if cc == 1 else \
                    f"multicast to clusters of {cc}" + (
                        ", each piece by one block in turn" if whole else
                        ", 1/c of each piece by each block")
                print(f"{where}, {mb} MB: {what}, {stages} stages of {kb} "
                      f"KB ({stages * kb} KB a block): "
                      f"{total / s / 1e12:.3f} TB/s read"
                      + (f", {total * cc / s / 1e12:.3f} TB/s landed in "
                         "shared memory" if cc > 1 else "")
                      + f" ({1e3 * s:.3f} ms a launch)")
        del buf


if __name__ == "__main__":
    main()
