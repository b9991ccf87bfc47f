// Device routines shared by the window kernel (vq_window.cu) and the delta
// kernel (vq_delta.cu).
//
// Both kernels must give a row the same squared distance to the last bit, so
// that the window kernel and the per-step path through the delta kernel
// produce the same codebook.  Every floating-point operation here is spelled
// with a round-to-nearest intrinsic so that nvcc cannot contract or reorder
// it differently in the two translation units.
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

// The one row dot product of both kernels: lane l accumulates
// k = l, l + 32, l + 64, ... in that order with fma, then warp_sum.
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int d, int lane) {
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) acc = __fmaf_rn(a[k], b[k], acc);
  return warp_sum(acc);
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

}  // namespace vq
