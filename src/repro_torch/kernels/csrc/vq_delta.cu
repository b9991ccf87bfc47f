// Delta kernel: nearest prototype per point, then the per-prototype count
// and sum of the points assigned to it, for M stacked workers; and the
// assign kernel, the same nearest-prototype passes without the sums.
//
// vq_delta_f32 replaces the TPU kernel repro/kernels/vq_assign.py::
// _delta_kernel (called through vq_delta_pallas): argmin over the whole
// codebook, counts and zsum (the one-hot scatter-add), and the per-point min
// distance for eq. 2.  vq_assign_f32 replaces repro/kernels/vq_assign.py::
// _assign_kernel (called through vq_assign_pallas): the (assign, min
// distance) of every point, the distances never written to global memory.
// It runs passes 1-3 below and stops, so a served assignment has the bits
// of the training kernels' assignment.
//
// Inputs:  z (M, B, d) f32, w (M, kappa, d) f32.
// Outputs: counts (M, kappa) f32, zsum (M, kappa, d) f32 (delta only),
//          mind (M, B) f32, assign (M, B) int32.
// Scratch: pmin/pidx (M, B, S) with S = ceil(kappa/kchunk); w2 (M, kappa)
//          for the passes; tickets (M) uint32, all 0, for the sweep (below),
//          which leaves them 0 again.
// The port does not pad rows, so no row needs masking; codebook rows past
// kappa in a block are skipped, which is the reference's BIG mask.
//
// What bounds it on an H100.  At the per-step shape (B = 1) it must read
// the codebooks and write zsum, 32 MiB at M=8, kappa=4096, d=128: bytes.  At
// the eval shape (B = 1000) the distance product, 2*B*kappa*d flops per
// worker, on the f32 pipes: operations.  The assign kernel at the serving
// flush (B = 128, M = 1) reads 2 MiB of codebook and does 134 MFLOP: 0.6 us
// by bytes, 2 us by operations, so launch latency and the 16 kappa chunks
// of pass 2 set its time.
//
// What the design does about it.  A TPU kernel revisits one accumulator
// block after block in order; GPU blocks run in no order, and float atomics
// would make the sums depend on the schedule.  Two routes, by B:
//
// B <= 8, the per-step shape: one launch, the sweep (delta_sweep_kernel).
//   A block takes all B points and one chunk of kchunk codebook rows, so a
//   batch of one spreads over ceil(kappa/kchunk) * M blocks and does no
//   arithmetic for padding points.  Each warp walks 8 rows at a time with
//   all their loads in flight, and computes each row's norm ||w||^2 from
//   the same loads as its dot products with the points, in warp_dot's
//   order, so the codebooks are read once and every distance keeps its
//   bits.  The block writes zeros to its own rows of zsum and counts as it
//   sweeps them: the dense zsum, written once by every SM at once.  It then
//   leaves its (min, argmin) partials in pmin/pidx and takes a ticket
//   (after __threadfence); the last block of a worker combines the S
//   partials, one warp a point, and writes the winners' counts and zsum
//   rows and mind and assign, then puts the ticket back to 0.  `better` is
//   a strict total order on (distance, index), so the combine's tree finds
//   the winner the fixed order finds, whatever block is last; and the
//   ticket's fence orders every block's zeros before the winners' rows.
// B > 8: four passes, each deterministic without atomics:
//   1. row norms ||w||^2, one warp per row (the routine the window kernel
//      uses, so both kernels see the same bits);
//   2. partial (min, argmin): a block takes 8 points and one chunk of
//      kchunk codebook rows.  The 8 points are staged in shared memory
//      while 8 * d floats fit (d <= 7,247) and read in place from global
//      memory past that, in the same order, so the bits agree;
//   3. the S partials of each point combined in a fixed order;
//   4. one owner block per 32 codebook rows scans every point's assignment
//      in point order and accumulates counts and zsum in shared memory.
// Both routes add each zsum row's points in point order from 0, and both
// take every distance from the same fma order, so they agree to the bit.
#include <cstdint>

#include "vq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // points per block in pass 2 (== kWarps)
constexpr int kOwnRows = 32;  // codebook rows per owner block in pass 4
constexpr int kChunk = 256;   // assignments staged in shared memory at once
constexpr int kSmallB = 8;    // largest batch the sweep takes
constexpr int kSweepRows = 8;  // rows a warp of the sweep has in flight
// The five above are mirrored in kernels/vq_assign.py.
static_assert(kRows == kWarps, "pass 2 gives each warp one point's norm");

__global__ void __launch_bounds__(kThreads)
    row_norms_kernel(const float* __restrict__ w, float* __restrict__ w2,
                     long rows, int D) {
  const long r = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform across the warp
  const float* wr = w + static_cast<size_t>(r) * D;
  const float n2 = vq::warp_dot(wr, wr, D, lane);
  if (lane == 0) w2[r] = n2;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    partial_argmin_kernel(const float* __restrict__ z,
                          const float* __restrict__ w,
                          const float* __restrict__ w2,
                          float* __restrict__ pmin, int* __restrict__ pidx,
                          int B, int K, int D, int kchunk, int S) {
  const int s = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int m = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nrows = min(kRows, B - b0);

  extern __shared__ float zs[];  // [kRows][D] if staged, rows past B zeroed
  __shared__ float z2s[kRows];
  __shared__ float wmin[kWarps][kRows];
  __shared__ int widx[kWarps][kRows];

  const float* zm = z + (static_cast<size_t>(m) * B + b0) * D;
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < kRows * D; i += kThreads)
      zs[i] = i < nrows * D ? zm[i] : 0.f;
    __syncthreads();
  }
  // Point j's row: staged, or in place with rows past B on the last valid
  // row (their results are dropped below).
  auto zrow = [&](int j) -> const float* {
    if constexpr (kStaged) return zs + j * D;
    return zm + static_cast<size_t>(min(j, nrows - 1)) * D;
  };
  {
    const float* zr = zrow(warp);
    const float v = vq::warp_dot(zr, zr, D, lane);
    if (lane == 0) z2s[warp] = v;
  }
  __syncthreads();

  float best[kRows];
  int bidx[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    best[j] = VQ_BIG;
    bidx[j] = INT_MAX;
  }
  const int k0 = s * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const float* wm = w + static_cast<size_t>(m) * K * D;
  const float* w2m = w2 + static_cast<size_t>(m) * K;
  for (int r = k0 + warp; r < k1; r += kWarps) {
    const float* wr = wm + static_cast<size_t>(r) * D;
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    // warp_dot(zs_j, wr) for all kRows points at once: same order per point
    for (int k = lane; k < D; k += 32) {
      const float wv = wr[k];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] = __fmaf_rn(zrow(j)[k], wv, acc[j]);
    }
    const float wn = w2m[r];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float d2 = vq::sq_dist(z2s[j], vq::warp_sum(acc[j]), wn);
      if (vq::better(d2, r, best[j], bidx[j])) {
        best[j] = d2;
        bidx[j] = r;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      wmin[warp][j] = best[j];
      widx[warp][j] = bidx[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int j = threadIdx.x;
    float v = VQ_BIG;
    int i = INT_MAX;
    for (int q = 0; q < kWarps; ++q) {
      if (vq::better(wmin[q][j], widx[q][j], v, i)) {
        v = wmin[q][j];
        i = widx[q][j];
      }
    }
    const size_t o = (static_cast<size_t>(m) * B + b0 + j) * S + s;
    pmin[o] = v;
    pidx[o] = i;
  }
}

__global__ void combine_kernel(const float* __restrict__ pmin,
                               const int* __restrict__ pidx,
                               int* __restrict__ assign,
                               float* __restrict__ mind, long rows, int S) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float v = VQ_BIG;
  int i = INT_MAX;
  for (int s = 0; s < S; ++s) {
    const size_t o = static_cast<size_t>(r) * S + s;
    if (vq::better(pmin[o], pidx[o], v, i)) {
      v = pmin[o];
      i = pidx[o];
    }
  }
  assign[r] = i;
  mind[r] = v;
}

__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const float* __restrict__ z,
                      const int* __restrict__ assign,
                      float* __restrict__ counts, float* __restrict__ zsum,
                      int B, int K, int D) {
  const int k0 = blockIdx.x * kOwnRows;
  const int m = blockIdx.y;
  const int nown = min(kOwnRows, K - k0);

  extern __shared__ float acc[];  // [kOwnRows][D]
  __shared__ int as[kChunk];
  __shared__ float cnt[kOwnRows];
  for (int i = threadIdx.x; i < nown * D; i += kThreads) acc[i] = 0.f;
  if (threadIdx.x < kOwnRows) cnt[threadIdx.x] = 0.f;

  const float* zm = z + static_cast<size_t>(m) * B * D;
  const int* am = assign + static_cast<size_t>(m) * B;
  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int n = min(kChunk, B - c0);
    __syncthreads();  // zeroing done, previous chunk no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) as[i] = am[c0 + i];
    __syncthreads();
    // Points in order; thread t owns columns k = t (mod kThreads), so each
    // (row, column) sum is taken in point order by one thread.
    for (int b = 0; b < n; ++b) {
      const int a = as[b] - k0;
      if (a < 0 || a >= nown) continue;
      const float* zb = zm + static_cast<size_t>(c0 + b) * D;
      for (int k = threadIdx.x; k < D; k += kThreads)
        acc[a * D + k] = __fadd_rn(acc[a * D + k], zb[k]);
      if (threadIdx.x == 0) cnt[a] = __fadd_rn(cnt[a], 1.f);
    }
  }
  __syncthreads();
  float* cm = counts + static_cast<size_t>(m) * K + k0;
  float* zsm = zsum + (static_cast<size_t>(m) * K + k0) * D;
  for (int i = threadIdx.x; i < nown; i += kThreads) cm[i] = cnt[i];
  for (int i = threadIdx.x; i < nown * D; i += kThreads) zsm[i] = acc[i];
}

// Zeros n floats from p; `stride` threads from thread t share the stores,
// 16 bytes a store where p is aligned for it.
__device__ __forceinline__ void zero_floats(float* p, size_t n, int t,
                                            int stride) {
  size_t head = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    head = n & ~static_cast<size_t>(3);
    for (size_t i = t; i < head / 4; i += stride)
      p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (size_t i = head + t; i < n; i += stride) p[i] = 0.f;
}

constexpr int kSweepCols = 4;  // columns a lane loads per row and step

// The B <= 8 route, one launch (see the header): block (s, m) sweeps rows
// [s * kchunk, (s + 1) * kchunk) of worker m's codebook against its kB
// points (B of them live), zeroing those rows of zsum and counts; the last
// block of worker m to take a ticket combines and writes the winners.
template <int kB>
__global__ void __launch_bounds__(kThreads)
    delta_sweep_kernel(const float* __restrict__ z,
                       const float* __restrict__ w, float* __restrict__ counts,
                       float* __restrict__ zsum, float* __restrict__ mind,
                       int* __restrict__ assign, float* __restrict__ pmin,
                       int* __restrict__ pidx, unsigned* __restrict__ tickets,
                       int B, int K, int D, int kchunk, int S) {
  static_assert(kB <= kWarps, "one warp a point for its norm and combine");
  const int s = blockIdx.x;
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float zs[];  // [B][D] the points
  __shared__ float z2s[kB];
  __shared__ float wmin[kWarps][kB];
  __shared__ int widx[kWarps][kB];
  __shared__ int won[kB];
  __shared__ bool last;

  const float* zm = z + static_cast<size_t>(m) * B * D;
  for (int i = threadIdx.x; i < B * D; i += kThreads) zs[i] = zm[i];
  __syncthreads();
  if (warp < B) {
    const float v = vq::warp_dot(zs + warp * D, zs + warp * D, D, lane);
    if (lane == 0) z2s[warp] = v;
  }
  __syncthreads();

  float best[kB];
  int bidx[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    best[j] = VQ_BIG;
    bidx[j] = INT_MAX;
  }
  const int k0 = s * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const float* wm = w + static_cast<size_t>(m) * K * D;
  float* zsm = zsum + static_cast<size_t>(m) * K * D;
  float* cm = counts + static_cast<size_t>(m) * K;
  for (int r0 = k0 + warp * kSweepRows; r0 < k1;
       r0 += kWarps * kSweepRows) {
    const int nr = min(kSweepRows, k1 - r0);  // uniform across the warp
    // sums[i * (kB + 1)] is row i's norm, sums[i * (kB + 1) + 1 + j] its
    // product with point j
    constexpr int kSums = kSweepRows * (kB + 1);
    float sums[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) sums[q] = 0.f;
    // warp_dot's order for every (row, point) pair and for each row's
    // norm: lane l takes k = l, l + 32, ... with fma; all kSweepRows *
    // kSweepCols loads of a step are issued before the first fma
    for (int k = lane; k < D; k += 32 * kSweepCols) {
      float wv[kSweepRows][kSweepCols];
#pragma unroll
      for (int i = 0; i < kSweepRows; ++i) {
#pragma unroll
        for (int c = 0; c < kSweepCols; ++c) {
          const int kk = k + 32 * c;
          wv[i][c] = i < nr && kk < D
                         ? wm[static_cast<size_t>(r0 + i) * D + kk]
                         : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kSweepCols; ++c) {
        const int kk = k + 32 * c;
        if (kk < D) {
#pragma unroll
          for (int i = 0; i < kSweepRows; ++i) {
            float* si = sums + i * (kB + 1);
            si[0] = __fmaf_rn(wv[i][c], wv[i][c], si[0]);
#pragma unroll
            for (int j = 0; j < kB; ++j)
              if (j < B) si[1 + j] = __fmaf_rn(zs[j * D + kk], wv[i][c],
                                               si[1 + j]);
          }
        }
      }
    }
    // every row's sums in one interleaved butterfly (rows past nr and
    // points past B sum zeros, and are dropped below)
    vq::warp_sum_n<kSums>(sums);
#pragma unroll
    for (int i = 0; i < kSweepRows; ++i) {
      if (i < nr) {
        const float* si = sums + i * (kB + 1);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (j < B) {
            const float d2 = vq::sq_dist(z2s[j], si[1 + j], si[0]);
            if (vq::better(d2, r0 + i, best[j], bidx[j])) {
              best[j] = d2;
              bidx[j] = r0 + i;
            }
          }
        }
      }
    }
    // these rows stay 0 unless they win: the last block writes winners
    zero_floats(zsm + static_cast<size_t>(r0) * D,
                static_cast<size_t>(nr) * D, lane, 32);
    if (lane < nr) cm[r0 + lane] = 0.f;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      wmin[warp][j] = best[j];
      widx[warp][j] = bidx[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < B) {
    const int j = threadIdx.x;
    float v = VQ_BIG;
    int i = INT_MAX;
    for (int q = 0; q < kWarps; ++q) {
      if (vq::better(wmin[q][j], widx[q][j], v, i)) {
        v = wmin[q][j];
        i = widx[q][j];
      }
    }
    const size_t o = (static_cast<size_t>(m) * B + j) * S + s;
    pmin[o] = v;
    pidx[o] = i;
  }
  // every thread's zeros and partials are visible before the ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[m], 1u) == static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block of worker m: warp j combines point j's S partials
  // (lane l takes s = l, l + 32, ...; any order meets the same winner
  // under `better`), then the winners' rows.
  if (warp < B) {
    const int j = warp;
    const size_t o = (static_cast<size_t>(m) * B + j) * S;
    float v = VQ_BIG;
    int i = INT_MAX;
    for (int q = lane; q < S; q += 32) {
      const float pv = __ldcg(pmin + o + q);
      const int pi = __ldcg(pidx + o + q);
      if (vq::better(pv, pi, v, i)) {
        v = pv;
        i = pi;
      }
    }
    vq::warp_argmin(v, i);
    if (lane == 0) {
      won[j] = i;
      mind[static_cast<size_t>(m) * B + j] = v;
      assign[static_cast<size_t>(m) * B + j] = i;
    }
  }
  __syncthreads();
  // Each winning row once, by the warp of its first point: its points in
  // point order from 0, the sums and count pass 4 forms.  A point that met
  // no row (every distance NaN) keeps INT_MAX and adds nowhere, as there.
  if (warp < B) {
    const int j = warp;
    const int a = won[j];
    bool first = a >= 0 && a < K;
    for (int q = 0; q < j; ++q) first = first && won[q] != a;
    if (first) {
      float* row = zsm + static_cast<size_t>(a) * D;
      for (int k = lane; k < D; k += 32) {
        float sum = 0.f;
        for (int q = j; q < B; ++q)
          if (won[q] == a) sum = __fadd_rn(sum, zs[q * D + k]);
        row[k] = sum;
      }
      if (lane == 0) {
        float c = 0.f;
        for (int q = j; q < B; ++q)
          if (won[q] == a) c = __fadd_rn(c, 1.f);
        cm[a] = c;
      }
    }
  }
  if (threadIdx.x == 0) tickets[m] = 0;  // as the launch found it
}

template <int kB>
cudaError_t launch_sweep(const float* z, const float* w, float* counts,
                         float* zsum, float* mind, int* assign, float* pmin,
                         int* pidx, unsigned* tickets, int M, int B, int K,
                         int D, int kchunk, cudaStream_t st) {
  const int S = (K + kchunk - 1) / kchunk;
  const size_t smem = sizeof(float) * static_cast<size_t>(B) * D;
  cudaError_t e = vq::allow_smem(delta_sweep_kernel<kB>, smem);
  if (e != cudaSuccess) return e;
  delta_sweep_kernel<kB><<<dim3(S, M), kThreads, smem, st>>>(
      z, w, counts, zsum, mind, assign, pmin, pidx, tickets, B, K, D, kchunk,
      S);
  return cudaGetLastError();
}

}  // namespace

cudaError_t vq::launch_assign(const float* z, const float* w, float* mind,
                              int* assign, float* w2, float* pmin, int* pidx,
                              int M, int B, int K, int D, int kchunk,
                              cudaStream_t st) {
  const int S = (K + kchunk - 1) / kchunk;
  cudaError_t e;

  const long wrows = static_cast<long>(M) * K;
  row_norms_kernel<<<static_cast<unsigned>((wrows + kWarps - 1) / kWarps),
                     kThreads, 0, st>>>(w, w2, wrows, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // kernels/vq_assign.py::argmin_smem_bytes mirrors this choice
  const dim3 grid2(S, (B + kRows - 1) / kRows, M);
  const size_t stage = sizeof(float) * kRows * D;
  const size_t fixed = sizeof(float) * kRows +
                       (sizeof(float) + sizeof(int)) * kWarps * kRows;
  if (stage + fixed <= vq::kSmemMax) {
    if ((e = vq::allow_smem(partial_argmin_kernel<true>, stage)) !=
        cudaSuccess)
      return e;
    partial_argmin_kernel<true><<<grid2, kThreads, stage, st>>>(
        z, w, w2, pmin, pidx, B, K, D, kchunk, S);
  } else {
    partial_argmin_kernel<false><<<grid2, kThreads, 0, st>>>(
        z, w, w2, pmin, pidx, B, K, D, kchunk, S);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long rows = static_cast<long>(M) * B;
  combine_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      pmin, pidx, assign, mind, rows, S);
  return cudaGetLastError();
}

extern "C" int vq_assign_f32(const float* z, const float* w, float* mind,
                             int* assign, float* w2, float* pmin, int* pidx,
                             int M, int B, int K, int D, int kchunk,
                             void* stream) {
  return static_cast<int>(vq::launch_assign(z, w, mind, assign, w2, pmin,
                                            pidx, M, B, K, D, kchunk,
                                            static_cast<cudaStream_t>(stream)));
}

extern "C" int vq_delta_f32(const float* z, const float* w, float* counts,
                            float* zsum, float* mind, int* assign, float* w2,
                            float* pmin, int* pidx, unsigned* tickets, int M,
                            int B, int K, int D, int kchunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= kSmallB) {  // the sweep; w2 is not read
    if (tickets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        B == 1 ? launch_sweep<1>(z, w, counts, zsum, mind, assign, pmin, pidx,
                                 tickets, M, B, K, D, kchunk, st)
               : launch_sweep<kSmallB>(z, w, counts, zsum, mind, assign, pmin,
                                       pidx, tickets, M, B, K, D, kchunk, st));
  }
  cudaError_t e = vq::launch_assign(z, w, mind, assign, w2, pmin, pidx, M, B,
                                    K, D, kchunk, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem4 = sizeof(float) * kOwnRows * D;
  if ((e = vq::allow_smem(accumulate_kernel, smem4)) != cudaSuccess)
    return static_cast<int>(e);
  accumulate_kernel<<<dim3((K + kOwnRows - 1) / kOwnRows, M), kThreads, smem4,
                      st>>>(z, assign, counts, zsum, B, K, D);
  return static_cast<int>(cudaGetLastError());
}
