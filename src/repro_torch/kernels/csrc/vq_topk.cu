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
// needs the pairs sorted by value.  The kept set and the index order are
// unique, so the pairs and the residual have one set of bits.
//
// What bounds it on an H100.  It reads full and writes residual, 32 MiB at
// M=8, N=524,288, plus M*k*8 bytes of pairs, and does no arithmetic beyond
// comparisons: bytes, about 0.010 ms at 3.35 TB/s.  One SM moves about a
// 132nd of that rate, so a row must be spread over many SMs, and each entry
// should cross device memory once each way.
//
// What the design does about it.  A row is split over a thread-block
// cluster of kCluster = 8 blocks, M * 8 blocks in one launch (64 SMs at
// M = 8); block r of a cluster owns the contiguous slice [r * L, (r + 1) *
// L) of its row, and each of its 32 warps a contiguous segment of that.
// The slice length L is vq_fused._topk_plan's.  (16-block clusters, the
// non-portable size, were tried: an H100 holds 7 of them at one 1024-thread
// block an SM, so at M = 8 they ran in two waves, 1.5-2x slower; keeping a
// 16-block slice in shared memory did not pay for that.)  The key of x is
// its bit pattern with the sign cleared, which orders like |x| for finite
// x.  A most-significant-digit radix select of three digit passes (11 + 10
// + 10 bits) finds the k-th largest key T: in each pass every block
// histograms its slice in shared memory, a cluster barrier follows, and
// every block reads the 8 histograms through distributed shared memory and
// picks the same digit.  Key 0 (the bulk of a window's displacement, zero
// outside the rows a worker touched) takes no atomic: a warp counts its
// non-zero keys in registers and zeros = length - non-zero.  When fewer
// than k keys of the row are non-zero, T = 0, the later passes are
// skipped, and pass 1's counts are each warp's (above, tie) counts; else a
// counting walk gives them.  Every pass after the first reads the slice
// again: at the main shape the 16.8 MB of full stay in L2 (50 MB) after
// the first.  The blocks publish their (above, tie) totals, and after a
// cluster barrier each warp's offset is the exclusive prefix over the
// lower ranks and the lower warps (rank and warp order is index order, so
// a tie run that crosses a boundary keeps its lower indices first).  The
// compaction then runs in each warp alone, in index order, 32 float4s a
// step, a warp-wide scan of (above, tie) counts placing every kept pair:
// no block barrier, loads of four steps in flight.  Integer counts only,
// so no step depends on an order of atomics.  Shared memory is static,
// 16,816 B a block, so a launch sets no function attribute.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins1 = 2048;     // key bits 30..20
constexpr int kBins2 = 1024;     // key bits 19..10, then 9..0
constexpr int kPub = 8;          // published words, see below
constexpr int kSums = 36;        // the scan's kWarps + 1 words, padded
constexpr int kCluster = 8;      // blocks a row; vq_fused.TOPK_CLUSTER
// shared-memory words: three histograms, kPub, kSums and each warp's
// (above, tie) counts
constexpr int kWords = kBins1 + 2 * kBins2 + kPub + kSums + 2 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// published words: what other blocks of the cluster read, and broadcasts
constexpr int kNonZero = 0, kAbove = 1, kTies = 2, kDigit = 3, kHigher = 4;

__device__ __forceinline__ unsigned key_of(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// A unit is what a lane loads at once: a float4 (4 entries) or a float.
template <typename V>
struct Unit;
template <>
struct Unit<float4> {
  static constexpr int kW = 4;
  static constexpr int kBatch = 4;  // units a lane has in flight
  __device__ static float get(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ static void zero(float4& v, int j) {
    if (j == 0) v.x = 0.f;
    else if (j == 1) v.y = 0.f;
    else if (j == 2) v.z = 0.f;
    else v.w = 0.f;
  }
};
template <>
struct Unit<float> {
  static constexpr int kW = 1;
  static constexpr int kBatch = 8;
  __device__ static float get(float v, int) { return v; }
  __device__ static void zero(float& v, int) { v = 0.f; }
};

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

// One warp's contiguous segment [u0, u1) of a slice's units, walked in
// steps of 32 units (lane l takes unit base + l) with kBatch steps' loads
// in flight.  Every lane of the warp calls f(value, unit, in range) for
// every step, in index order.
template <typename V, typename F>
__device__ __forceinline__ void walk(const V* __restrict__ xv, int u0, int u1,
                                     F&& f) {
  constexpr int kB = Unit<V>::kBatch;
  const int lane = threadIdx.x & 31;
  for (int base = u0; base < u1; base += 32 * kB) {
    V v[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int u = base + 32 * j + lane;
      v[j] = u < u1 ? xv[u] : V{};
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int u = base + 32 * j + lane;
      f(v[j], u, u < u1);
    }
  }
}

// One digit of T.  The cluster's kBins histograms of the keys that match
// the digits found so far, summed (zeros0 more in bin 0: the zero keys,
// where the prefix is 0), are scanned from the top bin down; the digit is
// the bin holding the want-th key.  Every block reads the same sums, so
// every block picks the same digit.  want drops by the keys in higher bins.
template <int kBins>
__device__ __forceinline__ unsigned pick_digit(cg::cluster_group& cluster,
                                               unsigned* hist,
                                               unsigned zeros0,
                                               unsigned& want, unsigned* pub,
                                               unsigned* sums) {
  constexpr int kPer = kBins / kThreads;  // bins a thread, high to low
  unsigned tot[kPer], local = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = kBins - 1 - (threadIdx.x * kPer + j);
    unsigned s = b == 0 ? zeros0 : 0u;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      s += cluster.map_shared_rank(hist, r)[b];
    tot[j] = s;
    local += s;
  }
  unsigned total;
  unsigned cum = block_exclusive_scan(local, sums, total);
  if (cum < want && want <= cum + local) {  // exactly one thread
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (cum + tot[j] >= want) {
        pub[kDigit] =
            static_cast<unsigned>(kBins - 1 - (threadIdx.x * kPer + j));
        pub[kHigher] = cum;
        break;
      }
      cum += tot[j];
    }
  }
  __syncthreads();
  want -= pub[kHigher];
  return pub[kDigit];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launched as M clusters of kCluster blocks.  L: slice length (a multiple
// of 4, kCluster * L >= N).  V = float4 where row starts are 16-byte
// aligned (N % 4 == 0, aligned full and residual), else float.
template <typename V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    vq_topk_kernel(const float* __restrict__ full, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ residual, int N,
                   int k, int L) {
  static_assert(kWarps == 32, "one warp scans the warps' counts");
  constexpr int kW = Unit<V>::kW;
  __shared__ unsigned smem[kWords];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x / kCluster;
  const int lo = static_cast<int>(
      min(static_cast<int64_t>(N), static_cast<int64_t>(rank) * L));
  const int len = min(N - lo, L);  // a multiple of kW
  // warp w's contiguous segment of units: index order is (warp, step, lane)
  const int units = len / kW;
  const int seg = (units + kWarps - 1) / kWarps;
  const int u0 = min(units, warp * seg);
  const int u1 = min(units, u0 + seg);
  const V* xv =
      reinterpret_cast<const V*>(full + row * static_cast<size_t>(N) + lo);
  V* rv = reinterpret_cast<V*>(residual + row * static_cast<size_t>(N) + lo);
  float* v_out = vals + row * static_cast<size_t>(k);
  int* i_out = idx + row * static_cast<size_t>(k);

  unsigned* h1 = smem;
  unsigned* h2 = h1 + kBins1;
  unsigned* h3 = h2 + kBins2;
  unsigned* pub = h3 + kBins2;
  unsigned* sums = pub + kPub;
  unsigned* warp_gt = sums + kSums;      // per warp: keys above T, then the
  unsigned* warp_eq = warp_gt + kWarps;  // ties; then both as offsets
  for (int b = tid; b < kBins1 + 2 * kBins2 + kPub; b += kThreads) h1[b] = 0;
  __syncthreads();

  // -- pass 1: count non-zero keys, histogram their top 11 bits -------------
  unsigned nz = 0;
  walk(xv, u0, u1, [&](const V& v, int, bool in) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const unsigned u = key_of(Unit<V>::get(v, j));
      if (in && u != 0) {
        ++nz;
        atomicAdd(&h1[u >> 20], 1u);
      }
    }
  });
  nz = __reduce_add_sync(kFull, nz);
  if (lane == 0) {
    warp_gt[warp] = nz;
    warp_eq[warp] = static_cast<unsigned>((u1 - u0) * kW) - nz;
    if (nz != 0) atomicAdd(&pub[kNonZero], nz);
  }
  cluster.sync();

  unsigned nz_row = 0;  // every warp sums the cluster's counts itself
  if (lane < kCluster) nz_row = cluster.map_shared_rank(pub, lane)[kNonZero];
  nz_row = __reduce_add_sync(kFull, nz_row);
  const unsigned zeros_row = static_cast<unsigned>(N) - nz_row;

  unsigned T = 0, need_eq;
  if (nz_row < static_cast<unsigned>(k)) {
    // fewer than k non-zero keys: T = 0 (the smallest key); every non-zero
    // key is above it and every zero ties with it, as pass 1 counted
    need_eq = static_cast<unsigned>(k) - nz_row;
  } else {
    unsigned want = static_cast<unsigned>(k);
    const unsigned d1 =
        pick_digit<kBins1>(cluster, h1, zeros_row, want, pub, sums);
    // -- pass 2: bits 19..10 of the keys whose top 11 bits are d1 ----------
    walk(xv, u0, u1, [&](const V& v, int, bool in) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const unsigned u = key_of(Unit<V>::get(v, j));
        if (in && u != 0 && (u >> 20) == d1)
          atomicAdd(&h2[(u >> 10) & 1023u], 1u);
      }
    });
    cluster.sync();
    const unsigned d2 = pick_digit<kBins2>(
        cluster, h2, d1 == 0 ? zeros_row : 0u, want, pub, sums);
    // -- pass 3: bits 9..0 of the keys whose top 21 bits are (d1, d2) ------
    const unsigned pre = (d1 << 10) | d2;
    walk(xv, u0, u1, [&](const V& v, int, bool in) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const unsigned u = key_of(Unit<V>::get(v, j));
        if (in && u != 0 && (u >> 10) == pre) atomicAdd(&h3[u & 1023u], 1u);
      }
    });
    cluster.sync();
    const unsigned d3 = pick_digit<kBins2>(
        cluster, h3, pre == 0 ? zeros_row : 0u, want, pub, sums);
    T = (pre << 10) | d3;
    need_eq = want;
    // -- each warp's (above, tie) counts over its segment --------------------
    unsigned gt = 0, eq = 0;
    walk(xv, u0, u1, [&](const V& v, int, bool in) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const unsigned u = key_of(Unit<V>::get(v, j));
        gt += in && u > T;
        eq += in && u == T;
      }
    });
    gt = __reduce_add_sync(kFull, gt);
    eq = __reduce_add_sync(kFull, eq);
    if (lane == 0) {
      warp_gt[warp] = gt;
      warp_eq[warp] = eq;
    }
  }
  __syncthreads();
  // the block's totals, published, and each warp's offset in the block
  if (warp == 0) {
    const unsigned g = warp_gt[lane], e = warp_eq[lane];
    unsigned gi = g, ei = e;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned tg = __shfl_up_sync(kFull, gi, off);
      const unsigned te = __shfl_up_sync(kFull, ei, off);
      if (lane >= off) {
        gi += tg;
        ei += te;
      }
    }
    warp_gt[lane] = gi - g;
    warp_eq[lane] = ei - e;
    if (lane == 31) {
      pub[kAbove] = gi;
      pub[kTies] = ei;
    }
  }
  cluster.sync();

  // -- this warp's place in its row: the lower ranks' counts, then the
  //    lower warps' ------------------------------------------------------------
  unsigned gt_carry = 0, eq_carry = 0;
  if (lane < rank) {
    const unsigned* p = cluster.map_shared_rank(pub, lane);
    gt_carry = p[kAbove];
    eq_carry = p[kTies];
  }
  gt_carry = __reduce_add_sync(kFull, gt_carry) + warp_gt[warp];
  eq_carry = __reduce_add_sync(kFull, eq_carry) + warp_eq[warp];
  // no block reads another's shared memory past this point; one may exit
  // once every block has arrived here
  cluster_arrive();

  // -- compaction in index order: one warp-wide scan of (above, tie) counts
  //    a step places the kept pairs; no block barrier ------------------------
  walk(xv, u0, u1, [&](V v, int unit, bool in) {
    unsigned n_gt = 0, n_eq = 0;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const unsigned u = key_of(Unit<V>::get(v, j));
      n_gt += in && u > T;
      n_eq += in && u == T;
    }
    // (above, tie) packed in one word: each is at most 32 * kW a step
    const unsigned mine = (n_gt << 16) | n_eq;
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned before = incl - mine;
    const unsigned step = __shfl_sync(kFull, incl, 31);
    unsigned eq_before = eq_carry + (before & 0xffffu);
    // kept before this lane: every key above T, and the first need_eq ties
    unsigned out = gt_carry + (before >> 16) + min(eq_before, need_eq);
    gt_carry += step >> 16;
    eq_carry += step & 0xffffu;
    if (!in) return;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const float x = Unit<V>::get(v, j);
      const unsigned u = key_of(x);
      bool keep = u > T;
      if (u == T) keep = eq_before++ < need_eq;
      if (keep) {
        v_out[out] = x;
        i_out[out] = lo + unit * kW + j;
        ++out;
        Unit<V>::zero(v, j);  // the residual of a kept entry is +0.0
      }
    }
    rv[unit] = v;
  });
  cluster_wait();
}

}  // namespace

// The slice length L comes from vq_fused._topk_plan; it is checked here
// against the kernel's layout.
extern "C" int vq_topk_f32(const float* full, float* vals, int* idx,
                           float* residual, int M, int N, int k, int L,
                           void* stream) {
  if (M <= 0 || N <= 0 || k < 1 || k > N || L < 4 || L % 4 != 0 ||
      static_cast<int64_t>(kCluster) * L < N ||
      static_cast<int64_t>(M) * kCluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(full) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(residual) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(M) * kCluster;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    vq_topk_kernel<float4><<<blocks, kThreads, 0, st>>>(full, vals, idx,
                                                        residual, N, k, L);
  else
    vq_topk_kernel<float><<<blocks, kThreads, 0, st>>>(full, vals, idx,
                                                       residual, N, k, L);
  return static_cast<int>(cudaGetLastError());
}
