// Device routines shared by the window kernel (vq_window.cu), the delta
// kernel (vq_delta.cu) and the blocked assign+delta kernel (vq_blocked.cu).
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

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Passes 1-3 of the delta kernel, defined in vq_delta.cu: row norms, partial
// (min, argmin) over kchunk-row kappa chunks, and the fixed-order combine
// into assign and mind.  vq_delta_f32 past 8 points, vq_assign_f32 and
// vq_delta_blocked_f32 assign through it; the delta kernel's sweep (8
// points or fewer) takes every distance in the same order, so all of them
// assign with the same bits.
cudaError_t launch_assign(const float* z, const float* w, float* mind,
                          int* assign, float* w2, float* pmin, int* pidx,
                          int M, int B, int K, int D, int kchunk,
                          cudaStream_t st);

}  // namespace vq
