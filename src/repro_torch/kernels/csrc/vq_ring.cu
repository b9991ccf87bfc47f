// Ring all-reduce kernel: the sum over M stacked workers of their flattened
// payloads, in the fold order of the bandwidth-optimal two-phase ring.
//
// Replaces the TPU kernel repro/comm/ring.py::_ring_kernel (called through
// _ring_pallas and ring_all_reduce): the dense merge of RingTransport.  On
// the TPU each device holds its own payload and the hops are remote copies
// to the right neighbour.
//
// Inputs:  x (M, N) f32, contiguous; mask (M,) f32 or NULL.
// Output:  out (N,) f32, the full sum of mask[i] * x[i].
// Each row is cut into M chunks of chunk = ceil(N / M) entries.  In the
// reduce-scatter hops of ring.py, hop s has worker i fold its left
// neighbour's partial of chunk (i - s - 1) mod M into its own, the received
// partial as the left operand, so chunk c sums as the left fold
// (...((x_c + x_{c+1}) + x_{c+2}) ... + x_{c-1}), worker indices mod M, and
// is complete after M - 1 hops; the all-gather hops only copy it.  This
// kernel keeps that chunking and that fold order, entry by entry: entry g
// of chunk c = g / chunk is acc = m_c * x_c[g], then acc = acc + m_{c+j} *
// x_{c+j}[g] for j = 1 .. M - 1.  The arithmetic is spelled __fmul_rn /
// __fadd_rn so that nvcc cannot contract mask * x into the sum.  So it
// gives the bits of ring_all_reduce_plain, which runs the hops themselves.
//
// Why the hops are not run as copies.  Offset p of chunk c only ever meets
// offset p of chunk c on the other workers, and here the M workers are the
// rows of one tensor on one card: every partial a hop would send is already
// in the same memory.  A hop is a move that the stacked layout does not
// need, as the all-gather's copies were not.  With one worker a process
// the hops move data between the processes' buffers again: that is
// vq_ring_hop.cu, in the same chunking and fold order.
//
// What bounds it on an H100.  It reads x once and writes out once, 4 * (M +
// 1) * N bytes (18.9 MB at M=8, N=524,288; 453 MB at N=12,582,912), and
// does (M - 1) * N additions: bytes, 0.0056 ms and 0.1352 ms at 3.35 TB/s,
// the bytes of the dense torch.sum over dimension 0.
//
// What the design does about it: nothing but streaming.  Block (x, c) takes
// chunk c (blockIdx.y, so no index is divided); each thread owns 4
// consecutive offsets of it, issues the M 16-byte loads of the M workers
// (8 at a time) before it folds, and stores one float4.  No shared memory,
// no barrier, no atomics; 64-bit offsets.  Where N or chunk is not a
// multiple of 4, or a pointer is not 16-byte aligned, the same fold runs on
// one offset a thread with 4-byte loads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // workers' loads a thread has in flight

__device__ __forceinline__ float mul(float m, float v) {
  return __fmul_rn(m, v);
}
__device__ __forceinline__ float4 mul(float m, float4 v) {
  return make_float4(__fmul_rn(m, v.x), __fmul_rn(m, v.y), __fmul_rn(m, v.z),
                     __fmul_rn(m, v.w));
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// V = float4 (4 offsets a thread) or float (1).  Grid (offset blocks, M).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    vq_ring_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                   float* __restrict__ out, int M, int64_t N, int64_t chunk) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int c = blockIdx.y;
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kW;
  const int64_t g = static_cast<int64_t>(c) * chunk + p;
  if (p >= chunk || g >= N) return;  // with kW = 4, g + 3 < N then
  V acc{};
  for (int j0 = 0; j0 < M; j0 += kBatch) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u;
      if (j < M) {
        const int i = c + j < M ? c + j : c + j - M;
        v[u] = *reinterpret_cast<const V*>(x + static_cast<int64_t>(i) * N + g);
        if (mask != nullptr) v[u] = mul(mask[i], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u;
      if (j < M) acc = j == 0 ? v[u] : add(acc, v[u]);
    }
  }
  *reinterpret_cast<V*>(out + g) = acc;
}

}  // namespace

extern "C" int vq_ring_f32(const float* x, const float* mask, float* out,
                           int M, long long N, void* stream) {
  if (M <= 0 || M > 65535 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = (N + M - 1) / M;
  const bool vec = chunk % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? 4 : 1);
  const int64_t blocks = (chunk + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(M));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    vq_ring_kernel<float4><<<grid, kThreads, 0, st>>>(
        x, mask, out, M, static_cast<int64_t>(N), chunk);
  else
    vq_ring_kernel<float><<<grid, kThreads, 0, st>>>(
        x, mask, out, M, static_cast<int64_t>(N), chunk);
  return static_cast<int>(cudaGetLastError());
}
