// Top-k kernel: for each of M stacked workers, the k entries of largest |x|
// of its flattened displacement, and the error-feedback residual.
//
// Replaces the TPU kernel repro/kernels/vq_fused.py::_topk_kernel (called
// through vq_topk_pallas): the sparse transport's per-worker selection
// (repro/comm/sparse.py::sparse_allsum before its gather).
//
// Inputs:  full (M, N) f32, finite; 1 <= k <= N.
// Outputs: vals (M, k) f32 and idx (M, k) int32, the kept entries and their
//          indices in ascending index order; residual (M, N) f32, full with
//          the kept entries set to +0.0 (bit for bit full - kept).
// The kept set is lax.top_k's: the k largest |x|, the lower index first
// among equal |x| (so -0.0 and +0.0 tie, in index order).  The reference
// returns the pairs in top_k's order; a worker's indices are distinct, so
// the scatter downstream gives the same sum in any order, and no consumer
// needs the pairs sorted by value.
//
// What bounds it on an H100.  It reads full and writes residual, 32 MiB at
// M=8, N=524,288, plus M*k*8 bytes of pairs, and does no arithmetic beyond
// comparisons: bytes, about 0.010 ms at 3.35 TB/s.
//
// What the design does about it, in this first version: little.  One block
// of 1024 threads per worker, so M blocks in all; no global scratch, no host
// sync, k a launch argument.  The key of x is its bit pattern with the sign
// cleared, which orders like |x| for finite x.  Four passes of a
// most-significant-digit radix select (8 bits a pass, histograms in shared
// memory with warp-aggregated integer atomics, exact) find the k-th largest
// key T and the count c_gt of keys above it; the row (2 MiB at N=524,288)
// is read from L2 in each pass.  A last pass walks the row in index order,
// 4 contiguous entries a thread, and keeps an entry if its key is above T or
// if it equals T and its rank among the T-ties is below k - c_gt; one
// block-wide scan a round of (above, tie) counts places every kept pair.
// A multi-block or cluster version that splits a row over many SMs is later
// work.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // contiguous entries per thread per round
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned key_of(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// Exclusive scan of v over the block; every thread gets its prefix and the
// block's total.  `sums` holds kWarps + 1 words of shared memory.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* sums,
                                                         unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = sums[lane];  // kWarps == 32
    unsigned wincl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, wincl, off);
      if (lane >= off) wincl += t;
    }
    sums[lane] = wincl - s;
    if (lane == 31) sums[kWarps] = wincl;
  }
  __syncthreads();
  const unsigned out = sums[warp] + incl - v;
  total = sums[kWarps];
  __syncthreads();  // sums is reused by the next call
  return out;
}

__global__ void __launch_bounds__(kThreads)
    vq_topk_kernel(const float* __restrict__ full, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ residual, int N,
                   int k) {
  static_assert(kWarps == 32, "the scan's second level is one warp");
  static_assert(kThreads * kItems < (1 << 16), "a round's counts pack in 16 bits");
  __shared__ unsigned hist[kBins];
  __shared__ unsigned sums[kWarps + 1];
  __shared__ unsigned s_digit, s_above;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.x;
  const float* x = full + row * static_cast<size_t>(N);
  float* res = residual + row * static_cast<size_t>(N);
  float* v_out = vals + row * static_cast<size_t>(k);
  int* i_out = idx + row * static_cast<size_t>(k);

  // -- radix select: T = the k-th largest key, c_gt = keys above T ----------
  unsigned prefix = 0, mask = 0;
  // rank of T among the keys that match the prefix: k less the keys found
  // above it so far, so k - c_gt once the prefix is the whole key
  unsigned want = static_cast<unsigned>(k);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    // every lane runs the same trip count, so __match_any_sync sees the
    // whole warp; entries out of range or off the prefix use bin kBins
    for (int base = 0; base < N; base += kThreads) {
      const int i = base + tid;
      unsigned bin = kBins;
      if (i < N) {
        const unsigned u = key_of(x[i]);
        if ((u & mask) == prefix) bin = (u >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255-8l .. 248-8l, high to low
      unsigned local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += hist[255 - 8 * lane - j];
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned cum = incl - local;  // matches with a higher digit
      if (cum < want && want <= incl) {  // exactly one lane
        for (int j = 0; j < 8; ++j) {
          const int dgt = 255 - 8 * lane - j;
          const unsigned h = hist[dgt];
          if (cum + h >= want) {
            s_digit = static_cast<unsigned>(dgt);
            s_above = cum;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    mask |= 0xffu << shift;
    want -= s_above;
    __syncthreads();  // s_digit / s_above are rewritten next pass
  }
  const unsigned T = prefix;
  const unsigned need_eq = want;  // T-ties to keep, lowest index first

  // -- compaction in index order ---------------------------------------------
  unsigned gt_carry = 0, eq_carry = 0;  // counts before this round
  for (int base = 0; base < N; base += kThreads * kItems) {
    const int i0 = base + tid * kItems;
    float xv[kItems];
    unsigned n_gt = 0, n_eq = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      xv[j] = i < N ? x[i] : 0.f;
      if (i < N) {
        const unsigned u = key_of(xv[j]);
        n_gt += u > T;
        n_eq += u == T;
      }
    }
    // (above, tie) counts packed in one word: each is below 2^16 a round
    unsigned total;
    const unsigned before =
        block_exclusive_scan((n_gt << 16) | n_eq, sums, total);
    const unsigned gt_before = gt_carry + (before >> 16);
    unsigned eq_before = eq_carry + (before & 0xffffu);
    // kept before this thread: every key above T, and the first need_eq ties
    unsigned out = gt_before + min(eq_before, need_eq);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j;
      if (i < N) {
        const unsigned u = key_of(xv[j]);
        bool keep = u > T;
        if (u == T) keep = eq_before++ < need_eq;
        if (keep) {
          v_out[out] = xv[j];
          i_out[out] = i;
          ++out;
        }
        res[i] = keep ? 0.f : xv[j];
      }
    }
    gt_carry += total >> 16;
    eq_carry += total & 0xffffu;
  }
}

}  // namespace

extern "C" int vq_topk_f32(const float* full, float* vals, int* idx,
                           float* residual, int M, int N, int k,
                           void* stream) {
  if (M <= 0 || N <= 0 || k < 1 || k > N || N > INT_MAX - kThreads * kItems)
    return static_cast<int>(cudaErrorInvalidValue);
  vq_topk_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      full, vals, idx, residual, N, k);
  return static_cast<int>(cudaGetLastError());
}
