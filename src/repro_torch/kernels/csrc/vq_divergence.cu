// Codebook divergence: for each of M stacked workers, the squared distance
// between its codebook and the shared one, sum_j (a[m, j] - b[j])^2 over the
// N = kappa * d entries.
//
// Not a port of a TPU kernel.  An observed sync window of the reference
// computes this inside its compiled window scan (repro/engine/mesh.py:590,
// jnp.sum((w_fin - w_srd) ** 2)), where XLA fuses the difference, the square
// and the sum into one pass.  Eagerly the same expression is a broadcast
// subtraction that writes an (M, N) temporary and a reduction that reads it
// back: ~50 MB a window at (8, 4096, 128), about 3.5% of a sync window on an
// H100, the reference's whole budget for instrumentation.  This kernel is
// that one pass, in one launch.
//
// Inputs:  a (M, N) f32 contiguous (the workers' window results), b (N,) f32
//          (the merged codebook).
// Scratch: partial (M, G) f32; tickets (M,) u32, all 0, left 0 again.
// Output:  out (M,) f32.
// Block (g, m) of the (G, M) grid sums the squared differences of its
// contiguous slice of row m: each thread a strided run of entries, four
// loads of a and b in flight before it adds (16-byte loads where N % 4 == 0
// and the pointers are 16-byte aligned), then the block's threads in a fixed
// tree.  The last block of worker m to take its ticket (after
// __threadfence) sums the G partials in a fixed tree, writes out[m] and puts
// the ticket back.  No float atomics: the same inputs give the same bits,
// call after call, in another order of additions than PyTorch's sum.
//
// What bounds it on an H100: it reads a once and b once a block (b is 2 MB
// at (4096, 128) and stays in L2), 4 * (M + 1) * N bytes, and does 3 M N
// flops: bytes, 0.0056 ms at M = 8, N = 524,288 and 3.35 TB/s.  The caller
// sizes G so that every block of the grid is resident at once (G = 64 a
// worker there: 512 blocks of 256 threads).  It is an ordinary launch on
// the caller's stream, after the window's merge.  Alone it takes 0.0131 ms
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's kernel_ms), a
// launch's ramp and tail more than its bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // a thread's loads of a (and of b) in flight

__device__ __forceinline__ float sq_diff(float x, float y) {
  const float t = x - y;
  return t * t;
}
__device__ __forceinline__ float sq_diff(float4 x, float4 y) {
  return sq_diff(x.x, y.x) + sq_diff(x.y, y.y) + sq_diff(x.z, y.z) +
         sq_diff(x.w, y.w);
}

// The block's sum of v, a fixed tree; thread 0 holds it.  Ends with every
// thread past a barrier, so the shared words can be written again.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0)
    for (int o = kThreads / 64; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

// V = float4 (4 entries a load) or float.  Block (g, m) owns entries
// [g * per, min((g + 1) * per, N)) of row m, per a multiple of 4 for float4.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    vq_divergence_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ partial,
                         unsigned* __restrict__ tickets,
                         float* __restrict__ out, int64_t N, int64_t per) {
  constexpr int kW = sizeof(V) / sizeof(float);
  constexpr int64_t kStride = static_cast<int64_t>(kThreads) * kW;
  const int g = blockIdx.x, m = blockIdx.y, G = gridDim.x;
  const int64_t lo = static_cast<int64_t>(g) * per;
  const int64_t hi = lo + per < N ? lo + per : N;
  const float* row = a + static_cast<int64_t>(m) * N;
  float acc = 0.0f;
  for (int64_t i = lo + static_cast<int64_t>(threadIdx.x) * kW; i < hi;
       i += kStride * kUnroll) {
    V x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * kStride;
      if (j < hi) {
        x[u] = *reinterpret_cast<const V*>(row + j);
        y[u] = *reinterpret_cast<const V*>(b + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kStride < hi) acc += sq_diff(x[u], y[u]);
  }
  acc = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[static_cast<int64_t>(m) * G + g] = acc;
    __threadfence();
    last = atomicAdd(&tickets[m], 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int k = threadIdx.x; k < G; k += kThreads)
    s += __ldcg(partial + static_cast<int64_t>(m) * G + k);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    out[m] = s;
    tickets[m] = 0u;
  }
}

}  // namespace

extern "C" int vq_divergence_f32(const float* a, const float* b,
                                 float* partial, unsigned* tickets,
                                 float* out, int M, long long N, int G,
                                 void* stream) {
  if (M <= 0 || M > 65535 || N <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  int64_t per = (N + G - 1) / G;
  if (vec) per = (per + 3) / 4 * 4;
  const dim3 grid(static_cast<unsigned>(G), static_cast<unsigned>(M));
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(N);
  if (vec)
    vq_divergence_kernel<float4><<<grid, kThreads, 0, s>>>(a, b, partial,
                                                           tickets, out, n,
                                                           per);
  else
    vq_divergence_kernel<float><<<grid, kThreads, 0, s>>>(a, b, partial,
                                                          tickets, out, n,
                                                          per);
  return static_cast<int>(cudaGetLastError());
}
