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
// Scratch: w2 (M, kappa), pmin/pidx (M, B, S) with S = ceil(kappa/kchunk).
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
// would make the sums depend on the schedule.  So the work goes in passes,
// each deterministic without atomics:
//   1. row norms ||w||^2, one warp per row (the routine the window kernel
//      uses, so both kernels see the same bits);
//   2. partial (min, argmin): a block takes 8 points and one chunk of
//      kchunk codebook rows, so a batch of one still spreads over
//      ceil(kappa/kchunk) * M blocks.  The 8 points are staged in shared
//      memory while 8 * d floats fit (d <= 7,247) and read in place from
//      global memory past that, in the same order, so the bits agree;
//   3. the S partials of each point combined in a fixed order;
//   4. one owner block per 32 codebook rows scans every point's assignment
//      in point order and accumulates counts and zsum in shared memory.
#include "vq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // points per block in pass 2 (== kWarps)
constexpr int kOwnRows = 32;  // codebook rows per owner block in pass 4
constexpr int kChunk = 256;   // assignments staged in shared memory at once
// The three above are mirrored in kernels/vq_assign.py.
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
                            float* pmin, int* pidx, int M, int B, int K, int D,
                            int kchunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
