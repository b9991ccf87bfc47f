// Window kernel: tau sequential eq.-1 VQ steps for M stacked workers, one
// launch.
//
// Replaces the TPU kernel repro/kernels/vq_fused.py::_window_kernel (called
// through vq_window_pallas): the whole tau-step window in one dispatch.
//
// Inputs:  zwin (M, tau, d) f32, w0 (kappa, d) f32 shared by all workers,
//          eps (tau,) f32 step sizes.
// Output:  wout (M, kappa, d) f32, each worker's codebook after its window.
//
// What bounds it on an H100.  The function moves little (a codebook in, M
// codebooks out: ~19 MB at M=8, kappa=4096, d=128, a few microseconds of
// device memory), so its bound is bytes.  The kernel itself is held back by
// the steps being sequential: each step must sweep the worker's whole
// codebook (2 MiB at that size) to find the winner before the next step
// can start, so the time of one sweep, tau times, is what it pays.
//
// What the design does about it.  Each worker gets a thread-block cluster,
// and all M clusters run in one launch.  Block r of a cluster owns rows
// [r * rows, (r + 1) * rows) and keeps their norms ||w||^2 in shared
// memory.  The C partial (min, argmin) pairs of a step meet through
// distributed shared memory after one cluster barrier.  Only the winning
// row changes in a step (every other row gets w - eps*0 = w exactly), so
// only its norm is recomputed, with the routine that computed it first.
// Two routes, chosen by kernels/vq_fused.py::_window_plan:
//
// resident (window_resident_kernel), where the codebook fits the cluster
//   on chip: its rows stay in the blocks for the whole window, as the TPU
//   kernel holds the codebook in VMEM.  Clusters of 8 blocks, as the
//   streaming route's: an H100 holds 15 of them at one block an SM, so M =
//   8 workers run in one wave (vq_window_clusters reads it).  At
//   kappa=4096, d=128 a block owns 512 rows (256 KiB): 433 in shared
//   memory (227 KB) and 79 in registers.  A shared-memory row takes one
//   thread: it reads the row as float4s (rows padded to an odd number of
//   float4s, so 8 neighbouring rows hit 32 distinct banks), keeps the 32
//   lane partials of vq::warp_dot in registers (partial l takes k = l,
//   l + 32, ... with fma) and adds them in warp_sum's butterfly tree
//   (row_dot below), so each distance has the bits of the warp-per-row
//   sweep.  A register row (d <= 128, 5 a warp) is held as warp_dot reads
//   it, lane l keeping k = l + 32c, and is swept one warp a row.  The
//   winner's update stays on chip; wout is written once, at the end of the
//   window.
// streaming (window_stream_kernel), where it does not (d=3072: 48 MiB a
//   worker, or past kappa = 4,104 at d=128) or where the caller's
//   shared-memory budget is smaller than a resident block: 8 blocks a
//   worker sweep their kappa/8 rows from global memory, where the
//   codebooks stay in L2 while they fit it, one warp per row, and update
//   wout in place.
//
// The update is w - eps*(w - z), each operation rounded on its own, which is
// what the per-step path (delta kernel + eager PyTorch elementwise ops)
// computes; the distances come from vq_common.cuh, shared with the delta
// kernel.  So both routes give the per-step path's codebook bit for bit.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>

#include "vq_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;  // blocks a worker, both routes
constexpr int kThreads = 512;      // threads a block, both routes at most
constexpr int kWarps = kThreads / 32;
constexpr int kRegRows = 5;  // resident rows a warp holds in registers
constexpr int kRegCols = 4;  // their columns a lane holds: d <= 128
// The five above are mirrored in kernels/vq_fused.py.

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kThreads)
    window_stream_kernel(const float* __restrict__ zwin,
                     const float* __restrict__ w0,
                     const float* __restrict__ eps, float* __restrict__ wout,
                     int tau, int K, int D, int rows_per_block) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = rank * rows_per_block;
  const int row1 = min(K, row0 + rows_per_block);

  extern __shared__ float smem[];
  float* w2s = smem;                    // [rows_per_block] row norms
  float* zbuf = smem + rows_per_block;  // [2][D] the step's point
  __shared__ float warp_min[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ float part_min[2];  // this block's partial, by step parity
  __shared__ int part_idx[2];

  const float* zm = zwin + static_cast<size_t>(m) * tau * D;
  float* w = wout + static_cast<size_t>(m) * K * D;

  // This block's rows of w0 become its rows of wout; the window then
  // updates them in place.
  for (int r = row0 + warp; r < row1; r += kWarps) {
    const float* src = w0 + static_cast<size_t>(r) * D;
    float* dst = w + static_cast<size_t>(r) * D;
    for (int k = lane; k < D; k += 32) dst[k] = src[k];
    const float n2 = vq::warp_dot(src, src, D, lane);
    if (lane == 0) w2s[r - row0] = n2;
  }

  for (int t = 0; t < tau; ++t) {
    const int buf = t & 1;
    // Double-buffered: warp 0 may still read the previous point while the
    // other warps load this one.
    float* zs = zbuf + buf * D;
    for (int k = threadIdx.x; k < D; k += kThreads)
      zs[k] = zm[static_cast<size_t>(t) * D + k];
    __syncthreads();

    const float z2 = vq::warp_dot(zs, zs, D, lane);
    float best = VQ_BIG;
    int bidx = INT_MAX;
    for (int r = row0 + warp; r < row1; r += kWarps) {
      const float cross =
          vq::warp_dot(zs, w + static_cast<size_t>(r) * D, D, lane);
      const float d2 = vq::sq_dist(z2, cross, w2s[r - row0]);
      if (vq::better(d2, r, best, bidx)) {
        best = d2;
        bidx = r;
      }
    }
    if (lane == 0) {
      warp_min[warp] = best;
      warp_idx[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < kWarps ? warp_min[lane] : VQ_BIG;
      int i = lane < kWarps ? warp_idx[lane] : INT_MAX;
      vq::warp_argmin(v, i);
      if (lane == 0) {
        part_min[buf] = v;
        part_idx[buf] = i;
      }
    }
    cluster.sync();
    if (warp == 0) {
      float v = VQ_BIG;
      int i = INT_MAX;
      if (lane < kClusterBlocks) {
        v = *cluster.map_shared_rank(&part_min[buf], lane);
        i = *cluster.map_shared_rank(&part_idx[buf], lane);
      }
      vq::warp_argmin(v, i);
      if (i >= row0 && i < row1) {  // this block owns the winning row
        float* wr = w + static_cast<size_t>(i) * D;
        const float e = eps[t];
        float acc = 0.f;
        for (int k = lane; k < D; k += 32) {
          const float wv = wr[k];
          const float nv = __fsub_rn(wv, __fmul_rn(e, __fsub_rn(wv, zs[k])));
          wr[k] = nv;
          acc = __fmaf_rn(nv, nv, acc);  // warp_dot's order, on the new row
        }
        acc = vq::warp_sum(acc);
        if (lane == 0) w2s[i - row0] = acc;
      }
    }
    // The next step's __syncthreads orders this update before its sweep.
  }
  // No block may leave while another can still read its partials.
  cluster.sync();
}

// vq::warp_dot(a, b) for rows of n4 float4s (4 * n4 >= d, the columns
// past d zero in a or b) in one thread: the 32 lane partials, each an fma
// chain over k = l, l + 32, ..., then warp_sum's tree (lane 0's additions
// in its order; IEEE addition commutes, so every lane's are the same).
// A zero column adds fma(0, 0, p) = p: a partial is never -0, as it
// starts at +0 and x + y rounds to -0 only where both are -0.
__device__ __forceinline__ float row_dot(const float4* __restrict__ a,
                                         const float4* __restrict__ b,
                                         int n4) {
  float p[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) p[l] = 0.f;
  for (int g = 0; g < n4; g += 8) {  // 32 columns a step, lane l in p[l]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (g + j < n4) {
        const float4 x = a[g + j];
        const float4 y = b[g + j];
        p[4 * j] = __fmaf_rn(x.x, y.x, p[4 * j]);
        p[4 * j + 1] = __fmaf_rn(x.y, y.y, p[4 * j + 1]);
        p[4 * j + 2] = __fmaf_rn(x.z, y.z, p[4 * j + 2]);
        p[4 * j + 3] = __fmaf_rn(x.w, y.w, p[4 * j + 3]);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < 16; ++l) p[l] = __fadd_rn(p[l], p[l + 16]);
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = __fadd_rn(p[l], p[l + 8]);
#pragma unroll
  for (int l = 0; l < 4; ++l) p[l] = __fadd_rn(p[l], p[l + 4]);
  p[0] = __fadd_rn(p[0], p[2]);
  p[1] = __fadd_rn(p[1], p[3]);
  return __fadd_rn(p[0], p[1]);
}

// Loads 4 columns [4c, 4c + 4) of a d-wide row, zero past d.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c,
                                        int D) {
  const int k = 4 * c;
  return make_float4(k < D ? row[k] : 0.f, k + 1 < D ? row[k + 1] : 0.f,
                     k + 2 < D ? row[k + 2] : 0.f,
                     k + 3 < D ? row[k + 3] : 0.f);
}

// The resident route.  Block r of worker m's cluster owns rows [row0,
// row0 + nrows), none where a small kappa leaves it without: the first
// `srows` in shared memory, swept one thread a row (thread i takes rows
// i, i + blockDim, ...); the rest (kRegs) in
// registers, kRegRows a warp, lane l holding columns k = l + 32c as
// vq::warp_dot reads them, swept one warp a row.  A step has one barrier,
// the cluster's.  Before it each warp folds its (min, argmin), as
// vq::argmin_key, into its block's key for the step (atomicMin in shared
// memory), the last warp forms ||z||^2 of the next point, and the block
// stores the point after it (four point buffers, so no store meets a read
// of a step still running).  After it every warp reads the cluster's C
// keys, and the warp that sweeps the winning row updates it, so no other
// warp ever reads that row.
template <bool kRegs>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kThreads)
    window_resident_kernel(const float* __restrict__ zwin,
                           const float* __restrict__ w0,
                           const float* __restrict__ eps,
                           float* __restrict__ wout, int tau, int K, int D,
                           int rows, int srows, int stride4) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int row0 = rank * rows;
  const int nrows = max(0, min(K, row0 + rows) - row0);
  const int ns = min(srows, nrows);  // rows in shared memory
  const int n4 = (D + 3) / 4;

  extern __shared__ float4 smem4[];
  float4* ws = smem4;                                       // [srows][stride4]
  float4* zbuf = smem4 + static_cast<size_t>(srows) * stride4;  // [4][n4]
  float* w2s = reinterpret_cast<float*>(zbuf + 4 * n4);     // [srows]
  // the block's (min, argmin) of step t as vq::argmin_key in part_key[t %
  // 3]: filled by its warps' atomicMin before the step's barrier, read by
  // the cluster after it, and cleared two steps ahead, when no block reads
  // it and no warp fills it yet
  __shared__ unsigned long long part_key[3];
  __shared__ float z2s[2];  // ||z||^2 of step t in z2s[t & 1]

  const float* zm = zwin + static_cast<size_t>(m) * tau * D;
  const float* wsrc = w0 + static_cast<size_t>(row0) * D;
  float* wo = wout + (static_cast<size_t>(m) * K + row0) * D;
  // 16-byte rows in and out: every load of the block in flight at once
  const bool vec = (D & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(w0) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(wout) & 15) == 0;
  for (int r = warp; r < ns; r += nwarps) {
    float4* dst = ws + static_cast<size_t>(r) * stride4;
    const float* src = wsrc + static_cast<size_t>(r) * D;
    for (int c = lane; c < n4; c += 32) {
      if (vec)
        __pipeline_memcpy_async(dst + c, src + 4 * c, 16);
      else
        dst[c] = load4(src, c, D);
    }
  }
  __pipeline_commit();
  for (int c = threadIdx.x; c < 2 * n4; c += blockDim.x)  // z_0 and z_1
    if (c / n4 < tau) zbuf[c] = load4(zm + (c / n4) * D, c % n4, D);
  // register rows: slot i of this warp is block row srows + warp*kRegRows+i
  float reg[kRegs ? kRegRows : 1][kRegCols];
  float regn[kRegs ? kRegRows : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int lr = srows + warp * kRegRows + i;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kRegCols; ++c) {
        const int k = lane + 32 * c;
        reg[i][c] = lr < nrows && k < D ? wsrc[static_cast<size_t>(lr) * D + k]
                                        : 0.f;
        if (k < D) acc = __fmaf_rn(reg[i][c], reg[i][c], acc);
      }
      regn[i] = vq::warp_sum(acc);
    }
  }
  // The point two steps ahead and the next step size are loaded early, so
  // their latency hides behind a sweep (columns past blockDim: when
  // stored).
  float4 znext = threadIdx.x < n4 && tau > 2
                     ? load4(zm + 2 * D, threadIdx.x, D)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  float enext = tau > 0 ? eps[0] : 0.f;
  if (threadIdx.x < 3) part_key[threadIdx.x] = ~0ull;
  __pipeline_wait_prior(0);
  // every block has started and cleared its keys before any key is filled
  cluster.sync();
  for (int r = threadIdx.x; r < ns; r += blockDim.x) {
    const float4* wr = ws + static_cast<size_t>(r) * stride4;
    w2s[r] = row_dot(wr, wr, n4);
  }
  float z2 = vq::warp_dot(reinterpret_cast<const float*>(zbuf),
                          reinterpret_cast<const float*>(zbuf), D, lane);

  for (int t = 0; t < tau; ++t) {
    const float4* zs = zbuf + (t % 4) * n4;
    const float* zf = reinterpret_cast<const float*>(zs);
    const float e = enext;
    if (t + 1 < tau) enext = eps[t + 1];
    float best = VQ_BIG;
    int bidx = INT_MAX;
    for (int r = threadIdx.x; r < ns; r += blockDim.x) {
      const float cross = row_dot(zs, ws + static_cast<size_t>(r) * stride4,
                                  n4);
      const float d2 = vq::sq_dist(z2, cross, w2s[r]);
      if (vq::better(d2, row0 + r, best, bidx)) {
        best = d2;
        bidx = row0 + r;
      }
    }
    if constexpr (kRegs) {
      float acc[kRegRows];  // warp_dot's lane partials, then its sums
#pragma unroll
      for (int i = 0; i < kRegRows; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kRegCols; ++c) {
          const int k = lane + 32 * c;
          if (k < D) acc[i] = __fmaf_rn(zf[k], reg[i][c], acc[i]);
        }
      }
      vq::warp_sum_n<kRegRows>(acc);
#pragma unroll
      for (int i = 0; i < kRegRows; ++i) {
        const int lr = srows + warp * kRegRows + i;
        const float d2 = vq::sq_dist(z2, acc[i], regn[i]);
        if (lr < nrows && vq::better(d2, row0 + lr, best, bidx)) {
          best = d2;
          bidx = row0 + lr;
        }
      }
    }
    vq::warp_argmin(best, bidx);
    if (lane == 0) atomicMin(&part_key[t % 3], vq::argmin_key(best, bidx));
    if (t + 1 < tau && warp == nwarps - 1) {
      const float* zn =
          reinterpret_cast<const float*>(zbuf + ((t + 1) % 4) * n4);
      const float v = vq::warp_dot(zn, zn, D, lane);
      if (lane == 0) z2s[(t + 1) & 1] = v;
    }
    if (t + 2 < tau) {  // the point after next into the free buffer
      float4* zn = zbuf + ((t + 2) % 4) * n4;
      if (threadIdx.x < n4) zn[threadIdx.x] = znext;
      for (int c = threadIdx.x + blockDim.x; c < n4; c += blockDim.x)
        zn[c] = load4(zm + static_cast<size_t>(t + 2) * D, c, D);
      if (t + 3 < tau && threadIdx.x < n4)
        znext = load4(zm + static_cast<size_t>(t + 3) * D, threadIdx.x, D);
    }
    cluster.sync();
    unsigned long long key = ~0ull;
    if (lane < kClusterBlocks)
      key = *cluster.map_shared_rank(&part_key[t % 3], lane);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      key = min(key, __shfl_xor_sync(VQ_FULL_MASK, key, off));
    const int win = static_cast<int>(key & 0xffffffffu);
    if (t + 1 < tau) z2 = z2s[(t + 1) & 1];
    if (threadIdx.x == 0) part_key[(t + 2) % 3] = ~0ull;
    const int li = win - row0;
    if (li >= 0 && li < ns && warp == (li % blockDim.x) >> 5) {
      // the warp of the thread that sweeps this row: w - eps*(w - z), each
      // operation rounded, then its norm in warp_dot's order
      float* wr =
          reinterpret_cast<float*>(ws + static_cast<size_t>(li) * stride4);
      float acc = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float wv = wr[k];
        const float nv = __fsub_rn(wv, __fmul_rn(e, __fsub_rn(wv, zf[k])));
        wr[k] = nv;
        acc = __fmaf_rn(nv, nv, acc);
      }
      acc = vq::warp_sum(acc);
      if (lane == 0) w2s[li] = acc;
      __syncwarp();  // the sweeping lane reads the row and norm next step
    }
    if constexpr (kRegs) {
      if (li >= srows && li < nrows && (li - srows) / kRegRows == warp) {
        const int slot = (li - srows) % kRegRows;
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) {
          if (i == slot) {  // static register indices
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < kRegCols; ++c) {
              const int k = lane + 32 * c;
              if (k < D) {
                const float wv = reg[i][c];
                const float nv =
                    __fsub_rn(wv, __fmul_rn(e, __fsub_rn(wv, zf[k])));
                reg[i][c] = nv;
                acc = __fmaf_rn(nv, nv, acc);
              }
            }
            regn[i] = vq::warp_sum(acc);
          }
        }
      }
    }
  }
  // No block may leave while another can still read its keys; the
  // barrier also orders the last updates before the write-out.
  cluster.sync();
  for (int r = warp; r < ns; r += nwarps) {
    const float4* src = ws + static_cast<size_t>(r) * stride4;
    float* dst = wo + static_cast<size_t>(r) * D;
    if (vec) {
      for (int c = lane; c < n4; c += 32)
        reinterpret_cast<float4*>(dst)[c] = src[c];
    } else {
      for (int k = lane; k < D; k += 32)
        dst[k] = reinterpret_cast<const float*>(src)[k];
    }
  }
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int lr = srows + warp * kRegRows + i;
#pragma unroll
      for (int c = 0; c < kRegCols; ++c) {
        const int k = lane + 32 * c;
        if (lr < nrows && k < D)
          wo[static_cast<size_t>(lr) * D + k] = reg[i][c];
      }
    }
  }
}

}  // namespace

// The launch plan comes from kernels/vq_fused.py::_window_plan: `resident`
// 0 takes the streaming route; 1 the resident route with clusters of 8
// blocks of `threads` threads a worker, `rows` rows a block, the first
// `srows` of them in shared memory at `stride4` float4s a row and the rest
// in registers (then d <= 128 and 16 warps), and `smem` bytes of dynamic
// shared memory.
extern "C" int vq_window_f32(const float* zwin, const float* w0,
                             const float* eps, float* wout, int M, int tau,
                             int K, int D, int resident, int threads,
                             int rows, int srows, int stride4, int smem,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(kClusterBlocks, M);
  cudaError_t e;
  if (!resident) {
    const int rows8 = (K + kClusterBlocks - 1) / kClusterBlocks;
    const size_t smem8 =
        sizeof(float) * (static_cast<size_t>(rows8) + 2 * D);
    if ((e = vq::allow_smem(window_stream_kernel, smem8)) != cudaSuccess)
      return static_cast<int>(e);
    window_stream_kernel<<<grid, kThreads, smem8, st>>>(zwin, w0, eps, wout,
                                                        tau, K, D, rows8);
    return static_cast<int>(cudaGetLastError());
  }
  const bool regs = srows < rows;
  if (threads < 32 || threads > kThreads || threads % 32 != 0 ||
      static_cast<long>(rows) * kClusterBlocks < K ||
      stride4 < (D + 3) / 4 || srows < 0 || srows > rows ||
      (regs && (D > 32 * kRegCols || threads != kThreads ||
                rows - srows > kWarps * kRegRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (regs) {
    if ((e = vq::allow_smem(window_resident_kernel<true>, smem)) !=
        cudaSuccess)
      return static_cast<int>(e);
    window_resident_kernel<true><<<grid, threads, smem, st>>>(
        zwin, w0, eps, wout, tau, K, D, rows, srows, stride4);
  } else {
    if ((e = vq::allow_smem(window_resident_kernel<false>, smem)) !=
        cudaSuccess)
      return static_cast<int>(e);
    window_resident_kernel<false><<<grid, threads, smem, st>>>(
        zwin, w0, eps, wout, tau, K, D, rows, srows, stride4);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many 8-block clusters of the resident route (register rows or none)
// the card holds at once at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveClusters); chip_smoke.py prints it beside the
// plan.
extern "C" int vq_window_clusters(int threads, int smem, int regs,
                                  int* out) {
  cudaError_t e = regs ? vq::allow_smem(window_resident_kernel<true>, smem)
                       : vq::allow_smem(window_resident_kernel<false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};  // the cluster size is the kernel's own
  cfg.gridDim = dim3(kClusterBlocks, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(
      regs ? cudaOccupancyMaxActiveClusters(
                 out, window_resident_kernel<true>, &cfg)
           : cudaOccupancyMaxActiveClusters(
                 out, window_resident_kernel<false>, &cfg));
}
