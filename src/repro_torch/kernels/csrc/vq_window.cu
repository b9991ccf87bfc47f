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
// codebook (2 MiB at that size, far past one block's 227 KB of shared
// memory) to find the winner before the next step can start.
//
// What the design does about it.  Each worker gets a thread-block cluster of
// 8 blocks, and all M clusters run in one launch.  A block owns kappa/8 rows
// and sweeps them from global memory, where the M codebooks (16 MiB) stay in
// the 50 MB L2; the rows' norms ||w||^2 live in shared memory.  The 8
// partial (min, argmin) pairs meet through distributed shared memory after
// one cluster barrier per step.  Only the winning row changes in a step
// (every other row gets w - eps*0 = w exactly), so only its norm is
// recomputed, with the same routine that computed it first.  Keeping the
// codebook itself in the cluster's shared memory is later work.
//
// The update is w - eps*(w - z), each operation rounded on its own, which is
// what the per-step path (delta kernel + eager PyTorch elementwise ops)
// computes; the distances come from vq_common.cuh, shared with the delta
// kernel.  So the two paths give the same codebook bit for bit.
#include <cooperative_groups.h>

#include "vq_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;  // mirrored in kernels/vq_fused.py
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kThreads)
    vq_window_kernel(const float* __restrict__ zwin,
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

}  // namespace

extern "C" int vq_window_f32(const float* zwin, const float* w0,
                             const float* eps, float* wout, int M, int tau,
                             int K, int D, void* stream) {
  const int rows = (K + kClusterBlocks - 1) / kClusterBlocks;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rows) + 2 * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vq_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(kClusterBlocks, M);
  vq_window_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(zwin, w0, eps, wout,
                                                          tau, K, D, rows);
  return static_cast<int>(cudaGetLastError());
}
