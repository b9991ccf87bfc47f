// Device routines shared by the window kernel (vq_window.cu), the delta and
// assign kernels (vq_delta.cu) and the blocked assign+delta kernel
// (vq_blocked.cu).
//
// All of them must give a row the same squared distance to the last bit, so
// that the window kernel and the per-step path through the delta kernel
// produce the same codebook.  Every floating-point operation here is spelled
// with a round-to-nearest intrinsic so that nvcc cannot contract or reorder
// it differently in the translation units.
#pragma once

#include <climits>
#include <cuda_runtime.h>

// Distance of a masked codebook row, as in the reference kernels.
#define VQ_BIG 3e38f
#define VQ_FULL_MASK 0xffffffffu

namespace vq {

// xor butterfly over the warp; IEEE addition commutes, so every lane ends
// with the same bits.
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(VQ_FULL_MASK, acc, off));
  return acc;
}

// warp_sum of N values at once: each value takes warp_sum's additions in
// its order, with the N butterflies' shuffles interleaved.
template <int N>
__device__ __forceinline__ void warp_sum_n(float* v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(VQ_FULL_MASK, v[i], off));
  }
}

// The one row dot product of both kernels: lane l accumulates
// k = l, l + 32, l + 64, ... in that order with fma, then warp_sum.
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int d, int lane) {
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) acc = __fmaf_rn(a[k], b[k], acc);
  return warp_sum(acc);
}

// warp_sum of N outputs held transposed, one shuffle-add an output a lane
// where warp_sum_n pays five.  Slot i of lane l holds output i ^ f(l), where
// f puts lane bit 4 on the slot's top bit, lane bit 3 on the next, and so on
// for the first log2(N) offsets (at most five).  At offset 16 the lane keeps
// v[0, N/2) and adds its partner's v[N/2 + i]: the partner, lane l ^ 16,
// holds the same output there, so the pair adds what warp_sum's first level
// adds for that output, and each later level halves again; once one slot is
// left the levels go on as warp_sum's.  Every output gets warp_sum's tree
// (IEEE addition commutes).  After the call v[i], i < max(1, N / 32), holds
// output i ^ f(l).
template <int N, int kOff = 16>
__device__ __forceinline__ void warp_sum_transposed(float* v) {
  static_assert(N >= 1 && (N & (N - 1)) == 0, "N is a power of two");
  if constexpr (kOff > 0) {
    if constexpr (N > 1) {
      constexpr int h = N / 2;
#pragma unroll
      for (int i = 0; i < h; ++i)
        v[i] = __fadd_rn(v[i], __shfl_xor_sync(VQ_FULL_MASK, v[h + i], kOff));
      warp_sum_transposed<h, kOff / 2>(v);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(VQ_FULL_MASK, v[0], kOff));
      warp_sum_transposed<1, kOff / 2>(v);
    }
  }
}

// ||z||^2 - 2 z.w + ||w||^2, in the reference's order.
__device__ __forceinline__ float sq_dist(float z2, float cross, float w2) {
  return __fadd_rn(__fsub_rn(z2, __fmul_rn(2.f, cross)), w2);
}

// Strict total order of (distance, index): ties go to the lowest index, as
// jnp.argmin and torch.argmin break them.
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// (distance, index) as one 64-bit key whose unsigned order is `better`'s
// on distances that are not NaN: the distance's bits made order-preserving
// (-0.0 taken as +0.0, which `better` holds equal to it) above the index.
__device__ __forceinline__ unsigned long long argmin_key(float d, int i) {
  unsigned u = __float_as_uint(d == 0.f ? 0.f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}

// Warp-wide argmin under `better`; every lane ends with the winner.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(VQ_FULL_MASK, v, off);
    const int oi = __shfl_xor_sync(VQ_FULL_MASK, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Shared memory one block may use on an H100 after opting in (227 KB),
// static and dynamic together.
constexpr size_t kSmemMax = 232448;

// Opt a kernel in to `bytes` of dynamic shared memory where the default
// 48 KB, which holds its static shared memory too, may not be enough (no
// kernel here holds more than 2 KB static).
template <typename Kernel>
cudaError_t allow_smem(Kernel* fn, size_t bytes) {
  if (bytes + 2048 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Largest batch the argmin engine's sweep takes; past it the tiled route.
constexpr int kSmallB = 8;

// CUDA kernel launches the entries of vq_delta.cu and vq_blocked.cu have
// made, counted on the host after each launch and read through the C entry
// vq_argmin_launches, so that a caller can show how many kernels one
// wrapper call launches.
extern long long argmin_launches;

// The argmin engine, defined in vq_delta.cu: the nearest row of w (M, K, D)
// for each point of z (M, B, D), into mind and assign (M, B), every distance
// in warp_dot's order, so that every route and kernel assigns with the same
// bits.  Both routes leave (min, argmin) partials of each kappa chunk of
// kchunk rows in pmin/pidx (M, B, S), S = ceil(K / kchunk), and the last
// block of a worker (sweep) or of a point tile (tiled) to take a ticket
// combines them; the tickets, all 0 at the launch, are left 0.
//
// launch_sweep, B <= kSmallB: one launch, a block per (kappa chunk, worker)
// with all B points, the rows' norms folded into the same loads.  With
// counts and zsum it also writes the delta statistics: the rows it sweeps
// zeroed, the winners' counts and point sums (in point order from 0) by the
// last block; with residual and delta too, the displacement
// counts * w - zsum + residual, as eager PyTorch rounds it.  Tickets: M.
cudaError_t launch_sweep(const float* z, const float* w, const float* residual,
                         float* counts, float* zsum, float* delta,
                         float* mind, int* assign, float* pmin, int* pidx,
                         unsigned* tickets, int M, int B, int K, int D,
                         int kchunk, cudaStream_t st);

// launch_tiled, B > kSmallB: one launch, a block per (kappa chunk, tile of
// kTilePoints points, worker), register-tiled, reduced by
// warp_sum_transposed.  Tickets: M * ceil(B / kTilePoints).
constexpr int kTilePoints = 32;
cudaError_t launch_tiled(const float* z, const float* w, float* mind,
                         int* assign, float* pmin, int* pidx,
                         unsigned* tickets, int M, int B, int K, int D,
                         int kchunk, cudaStream_t st);

}  // namespace vq
