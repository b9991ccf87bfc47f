// Ring all-reduce kernel: the sum over M stacked workers of their flattened
// payloads, by the hops of the bandwidth-optimal two-phase ring.
//
// Replaces the TPU kernel repro/comm/ring.py::_ring_kernel (called through
// _ring_pallas and ring_all_reduce): the dense merge of RingTransport.  On
// the TPU each device holds its own payload and the hops are remote copies
// to the right neighbour; here the M workers are the rows of one tensor on
// one card, so a hop is a move between worker slots in shared memory.
//
// Inputs:  x (M, N) f32, contiguous; mask (M,) f32 or NULL.
// Output:  out (N,) f32, the full sum of mask[i] * x[i].
// Each row is cut into M chunks of chunk = ceil(N / M) entries; entries past
// N are zeros that no output entry reads (offset p of chunk c only ever
// meets offset p of chunk c on the other workers).  The hops are the
// reduce-scatter hops of ring.py: in hop s worker i folds its left
// neighbour's partial of chunk (i - s - 1) mod M into its own, the received
// partial as the left operand.  So chunk c sums as the left fold
// (...((x_c + x_{c+1}) + x_{c+2}) ... + x_{c-1}), worker indices mod M, and
// after M - 1 hops it is complete on worker (c - 1) mod M, which stores it.
// The all-gather phase of ring.py only copies completed chunks to the other
// devices; the M workers share one card here, so one stored copy is what a
// caller reads and the copies are left out.  Within one hop worker i writes
// chunk (i - s - 1) and its right neighbour reads chunk (i - s) of it, so
// no hop reads what the same hop writes: one __syncthreads() between hops
// orders them.  The arithmetic is spelled __fmul_rn / __fadd_rn so that
// nvcc cannot contract mask * x into the sum.
//
// What bounds it on an H100.  It reads x once and writes out once, 4 * (M +
// 1) * N bytes (18.9 MB at M=8, N=524,288; 453 MB at N=12,582,912), and
// does (M - 1) * N additions: bytes, 0.0056 ms and 0.1352 ms at 3.35 TB/s,
// the bytes of the dense torch.sum over dimension 0.
//
// What the design does about it: every byte crosses device memory once.
// One block takes a tile of T offsets of every chunk of every worker (M * M
// * T floats, 8 KiB at M=8, T=32), loads it coalesced (T consecutive floats
// per worker and chunk, 8 loads in flight a thread), runs the M - 1 hops in
// shared memory and stores the M completed chunks.  One launch, no
// grid-wide barrier, no atomics; the hops cost shared-memory traffic only.
// 64-bit offsets throughout.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileMax = 32;                 // offsets a block takes
constexpr int kBatch = 8;                    // loads a thread has in flight
constexpr int kSmemBytes = 48 * 1024;        // no opt-in needed below it

// Offset p of chunk c within a row, or -1 past the ragged edge (past N, or
// past the last chunk's length).
__device__ __forceinline__ int64_t entry(int c, int64_t p, int64_t N,
                                         int64_t chunk) {
  const int64_t g = static_cast<int64_t>(c) * chunk + p;
  return (p < chunk && g < N) ? g : -1;
}

// T = 1 << log_t offsets a block, T dividing kThreads.
__global__ void __launch_bounds__(kThreads)
    vq_ring_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                   float* __restrict__ out, int M, int64_t N, int64_t chunk,
                   int log_t) {
  extern __shared__ float slot[];  // [worker i][chunk c][offset t]
  const int T = 1 << log_t;
  const int t = threadIdx.x & (T - 1);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * T + t;
  const int pairs = M * M;                   // (worker, chunk) pairs
  const int q0 = threadIdx.x >> log_t;
  const int q_step = kThreads >> log_t;

  // load every worker's tile of every chunk, mask applied on load
  for (int q = q0; q < pairs; q += kBatch * q_step) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int pr = q + j * q_step;
      v[j] = 0.f;
      if (pr < pairs) {
        const int i = pr / M;
        const int64_t g = entry(pr - i * M, p, N, chunk);
        if (g >= 0) {
          v[j] = x[static_cast<int64_t>(i) * N + g];
          if (mask != nullptr) v[j] = __fmul_rn(mask[i], v[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int pr = q + j * q_step;
      if (pr < pairs) slot[(pr << log_t) + t] = v[j];
    }
  }
  __syncthreads();

  // reduce-scatter: M - 1 hops
  for (int s = 0; s < M - 1; ++s) {
    for (int e = threadIdx.x; e < (M << log_t); e += kThreads) {
      const int i = e >> log_t;
      const int left = i == 0 ? M - 1 : i - 1;
      const int r = i - s - 1 < 0 ? i - s - 1 + M : i - s - 1;
      float* own = slot + ((i * M + r) << log_t) + t;
      *own = __fadd_rn(slot[((left * M + r) << log_t) + t], *own);
    }
    __syncthreads();
  }

  // chunk c is complete on worker (c - 1) mod M: one store each
  for (int e = threadIdx.x; e < (M << log_t); e += kThreads) {
    const int c = e >> log_t;
    const int64_t g = entry(c, p, N, chunk);
    const int holder = c == 0 ? M - 1 : c - 1;
    if (g >= 0) out[g] = slot[((holder * M + c) << log_t) + t];
  }
}

}  // namespace

extern "C" int vq_ring_f32(const float* x, const float* mask, float* out,
                           int M, long long N, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = (N + M - 1) / M;
  // the tile: the largest power of two up to kTileMax whose M * M * T
  // floats fit kSmemBytes
  int log_t = 0;
  while ((1 << (log_t + 1)) <= kTileMax &&
         4 * static_cast<int64_t>(M) * M * (2 << log_t) <= kSmemBytes)
    ++log_t;
  if (4 * static_cast<int64_t>(M) * M > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (chunk + (1 << log_t) - 1) >> log_t;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(M) * M << log_t;
  vq_ring_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, mask, out, M, static_cast<int64_t>(N), chunk, log_t);
  return static_cast<int>(cudaGetLastError());
}
