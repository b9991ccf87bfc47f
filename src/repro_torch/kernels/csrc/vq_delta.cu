// Delta kernel: nearest prototype per point, then the per-prototype count
// and sum of the points assigned to it, for M stacked workers; the assign
// kernel, the nearest prototype alone; and the argmin engine both share with
// the blocked kernel (vq_blocked.cu).
//
// vq_delta_f32 replaces the TPU kernel repro/kernels/vq_assign.py::
// _delta_kernel (called through vq_delta_pallas): argmin over the whole
// codebook, counts and zsum (the one-hot scatter-add), and the per-point min
// distance for eq. 2.  vq_assign_f32 replaces repro/kernels/vq_assign.py::
// _assign_kernel (called through vq_assign_pallas): the (assign, min
// distance) of every point, the distances never written to global memory.
// It runs the engine and stops, so a served assignment has the bits of the
// training kernels' assignment.
//
// Inputs:  z (M, B, d) f32, w (M, kappa, d) f32.
// Outputs: counts (M, kappa) f32, zsum (M, kappa, d) f32 (delta only),
//          mind (M, B) f32, assign (M, B) int32.
// Scratch: pmin/pidx (M, B, S) with S = ceil(kappa/kchunk); tickets, all 0,
//          M of them at B <= 8 and M * ceil(B / 32) past it, which the
//          launch leaves 0 again.
// The port does not pad rows, so no row needs masking; codebook rows past
// kappa in a block are skipped, which is the reference's BIG mask.
//
// What bounds it on an H100.  At the per-step shape (B = 1) it must read
// the codebooks and write zsum, 32 MiB at M=8, kappa=4096, d=128: bytes.  At
// the eval shape (B = 1000) the distance product, 2*B*kappa*d flops per
// worker, on the f32 pipes: operations (8.39 GFLOP, 0.127 ms).  The assign
// kernel at the serving flush (B = 128, M = 1) reads 2 MiB of codebook and
// does 134 MFLOP: 2 us by operations, so its launches and its parallelism
// set its time.
//
// What the design does about it.  Every distance keeps vq::warp_dot's
// order (lane l takes k = l, l + 32, ... by fma, then the xor butterfly's
// tree), so every route, and the window kernel, assigns with the same bits.
// GPU blocks run in no order, and float atomics would make the sums depend
// on the schedule; each kappa chunk's (min, argmin) goes to pmin/pidx and
// the last block to take a ticket (after __threadfence) combines them:
// `better` is a strict total order on (distance, index), so any order of
// the combine meets the winner the fixed order meets.  Two routes, by B:
//
// B <= 8, the per-step shape: the sweep (sweep_kernel), one launch for the
//   assign, delta and blocked kernels alike.  A block takes all B points
//   and one chunk of kchunk codebook rows, so a batch of one spreads over
//   ceil(kappa/kchunk) * M blocks and does no arithmetic for padding
//   points.  The points are staged in shared memory where B * d floats fit
//   (at B = 8 to d = 7,232) and read in place past that, in the same order.
//   Each warp walks 8 rows at a time with all their loads in flight, and
//   computes each row's norm ||w||^2 from the same loads as its dot
//   products with the points, so the codebooks are read once.  With the
//   statistics, the block writes zeros to its own rows of zsum and counts
//   as it sweeps them (the dense zsum, written once by every SM at once),
//   and with the epilogue each row's count-0 displacement
//   0 * w - 0 + residual from the w it loaded; the last block writes the
//   winners' counts, zsum rows (their points in point order from 0) and
//   displacements, and mind and assign, then puts the ticket back to 0.
//   The ticket's fence orders every block's rows before the winners'.
// B > 8: the tiled argmin (tiled_argmin_kernel).  A block takes 32 points
//   and one kappa chunk, and stages 16 codebook rows by 128 columns at a
//   time with cp.async, three stages in flight in a ring of four (the
//   points once where d <= 128, else beside each column tile).  Each warp
//   owns an 8-point by 8-row register tile: lane l accumulates its lane
//   class's partial of all 64 products and of the 8 rows' norms from the
//   same loads, reading point p ^ f and row q ^ g (f, g from its lane bits)
//   into slot (p, q), so that vq::warp_sum_transposed reduces the tile with
//   about one shuffle-add an output instead of warp_sum's five, in
//   warp_sum's tree.  Per output and lane at d = 128: 4 fmas, one shared
//   load and one shuffle-add; the block is bound by issue.  The
//   delta kernel then
//   runs accumulate_kernel: one owner block per 32 codebook rows scans
//   every point's assignment in point order and accumulates counts and
//   zsum in shared memory.
// Both routes add each zsum row's points in point order from 0, and both
// take every distance from the same fma order, so they agree to the bit.
#include <cstdint>

#include "vq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOwnRows = 32;   // codebook rows per owner block (accumulate)
constexpr int kChunk = 256;    // assignments staged in shared memory at once
constexpr int kSweepRows = 8;  // rows a warp of the sweep has in flight
constexpr int kSweepCols = 4;  // columns a lane loads per row and step
// bound on the static shared memory of a sweep or tiled block
constexpr size_t kStaticSmem = 1024;
// the tiled route: rows and columns a block stages at once, and a warp's
// register tile (kWarpPoints x kWarpRows, 64 products)
constexpr int kTileRows = 16;
constexpr int kTileCols = 128;
constexpr int kStages = 4;  // the tiled route's staging ring
constexpr int kWarpPoints = 8;
constexpr int kWarpRows = 8;
// The constants above, vq::kSmallB and vq::kTilePoints are mirrored in
// kernels/vq_assign.py.
static_assert(vq::kSmallB <= kWarps, "the sweep gives each point a warp");
static_assert((vq::kTilePoints / kWarpPoints) * (kTileRows / kWarpRows) ==
                  kWarps,
              "the tiled block's warps cover its point and row tiles");

// What a sweep writes besides mind and assign.
enum SweepOut { kAssignOnly = 0, kStats = 1, kStatsDelta = 2 };

// Do B points fit the sweep's shared memory?  vq_assign.argmin_plan
// mirrors it.
bool sweep_staged(int B, int D) {
  return sizeof(float) * static_cast<size_t>(B) * D + kStaticSmem <=
         vq::kSmemMax;
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

// The eager counts * w - zsum + residual, rounded as PyTorch rounds it and
// spelled so that nvcc cannot contract it into an fma.
__device__ __forceinline__ float displacement(float cnt, float w, float zs,
                                              float res) {
  return __fadd_rn(__fsub_rn(__fmul_rn(cnt, w), zs), res);
}

// The last block of a group to take its ticket (after every thread's
// writes are fenced); the caller's partials are then all visible.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned arrivals) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == arrivals - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// (min, argmin) over the S partials at o, one warp: lane l folds s = l,
// l + 32, ... (any order meets the same winner under `better`).
__device__ __forceinline__ void combine_partials(const float* pmin,
                                                 const int* pidx, size_t o,
                                                 int S, int lane, float& v,
                                                 int& i) {
  v = VQ_BIG;
  i = INT_MAX;
  for (int q = lane; q < S; q += 32) {
    const float pv = __ldcg(pmin + o + q);
    const int pi = __ldcg(pidx + o + q);
    if (vq::better(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  vq::warp_argmin(v, i);
}

// The B <= 8 route, one launch (see the header): block (s, m) sweeps rows
// [s * kchunk, (s + 1) * kchunk) of worker m's codebook against its kB
// point slots (B of them live); with kOut >= kStats it zeroes those rows of
// zsum and counts, with kStatsDelta it writes their count-0 delta; the last
// block of worker m to take a ticket combines and writes the winners.
template <int kB, int kOut, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ z, const float* __restrict__ w,
                 const float* __restrict__ residual,
                 float* __restrict__ counts, float* __restrict__ zsum,
                 float* __restrict__ delta, float* __restrict__ mind,
                 int* __restrict__ assign, float* __restrict__ pmin,
                 int* __restrict__ pidx, unsigned* __restrict__ tickets,
                 int B, int K, int D, int kchunk, int S) {
  static_assert(kB <= kWarps, "one warp a point for its norm and combine");
  const int s = blockIdx.x;
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float zs[];  // [B][D] the points, if staged
  __shared__ float z2s[kB];
  __shared__ float wmin[kWarps][kB];
  __shared__ int widx[kWarps][kB];
  __shared__ int won[kB];

  const float* zm = z + static_cast<size_t>(m) * B * D;
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < B * D; i += kThreads) zs[i] = zm[i];
    __syncthreads();
  }
  // point j's row, staged or in place: the same values in the same order
  auto zrow = [&](int j) -> const float* {
    if constexpr (kStaged) return zs + static_cast<size_t>(j) * D;
    return zm + static_cast<size_t>(j) * D;
  };
  if (warp < B) {
    const float v = vq::warp_dot(zrow(warp), zrow(warp), D, lane);
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
  const size_t wbase = static_cast<size_t>(m) * K * D;
  const float* wm = w + wbase;
  float* zsm = zsum + wbase;  // unused without the statistics
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
      // with the epilogue, the residual's loads go out with w's
      float rv[kOut == kStatsDelta ? kSweepRows : 1][kSweepCols];
#pragma unroll
      for (int i = 0; i < kSweepRows; ++i) {
#pragma unroll
        for (int c = 0; c < kSweepCols; ++c) {
          const int kk = k + 32 * c;
          const bool live = i < nr && kk < D;
          const size_t o = static_cast<size_t>(r0 + i) * D + kk;
          wv[i][c] = live ? wm[o] : 0.f;
          if constexpr (kOut == kStatsDelta)
            rv[i][c] = live ? residual[wbase + o] : 0.f;
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
              if (j < B) si[1 + j] = __fmaf_rn(zrow(j)[kk], wv[i][c],
                                               si[1 + j]);
          }
        }
      }
      if constexpr (kOut == kStatsDelta) {
        // these rows' displacement at count 0; the last block rewrites
        // the winners'
#pragma unroll
        for (int i = 0; i < kSweepRows; ++i) {
#pragma unroll
          for (int c = 0; c < kSweepCols; ++c) {
            const int kk = k + 32 * c;
            if (i < nr && kk < D)
              delta[wbase + static_cast<size_t>(r0 + i) * D + kk] =
                  displacement(0.f, wv[i][c], 0.f, rv[i][c]);
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
    if constexpr (kOut != kAssignOnly) {
      // these rows stay 0 unless they win: the last block writes winners
      zero_floats(zsm + static_cast<size_t>(r0) * D,
                  static_cast<size_t>(nr) * D, lane, 32);
      if (lane < nr) cm[r0 + lane] = 0.f;
    }
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
  if (!last_to_arrive(&tickets[m], static_cast<unsigned>(S))) return;

  // The last block of worker m: warp j combines point j's S partials, then
  // the winners' rows.
  if (warp < B) {
    const int j = warp;
    float v;
    int i;
    combine_partials(pmin, pidx, (static_cast<size_t>(m) * B + j) * S, S,
                     lane, v, i);
    if (lane == 0) {
      won[j] = i;
      mind[static_cast<size_t>(m) * B + j] = v;
      assign[static_cast<size_t>(m) * B + j] = i;
    }
  }
  if constexpr (kOut != kAssignOnly) {
    __syncthreads();
    // Each winning row once, by the warp of its first point: its points in
    // point order from 0, the sums and count the accumulate pass forms.  A
    // point that met no row (every distance NaN) keeps INT_MAX and adds
    // nowhere, as there.
    if (warp < B) {
      const int j = warp;
      const int a = won[j];
      bool first = a >= 0 && a < K;
      for (int q = 0; q < j; ++q) first = first && won[q] != a;
      if (first) {
        float cnt = 0.f;
        for (int q = j; q < B; ++q)
          if (won[q] == a) cnt = __fadd_rn(cnt, 1.f);
        const size_t row = static_cast<size_t>(a) * D;
        for (int k = lane; k < D; k += 32) {
          float sum = 0.f;
          for (int q = j; q < B; ++q)
            if (won[q] == a) sum = __fadd_rn(sum, zrow(q)[k]);
          zsm[row + k] = sum;
          if constexpr (kOut == kStatsDelta)
            delta[wbase + row + k] = displacement(cnt, wm[row + k], sum,
                                                  residual[wbase + row + k]);
        }
        if (lane == 0) cm[a] = cnt;
      }
    }
  }
  if (threadIdx.x == 0) tickets[m] = 0;  // as the launch found it
}

template <int kB, int kOut, bool kStaged>
cudaError_t sweep_as(const float* z, const float* w, const float* residual,
                     float* counts, float* zsum, float* delta, float* mind,
                     int* assign, float* pmin, int* pidx, unsigned* tickets,
                     int M, int B, int K, int D, int kchunk,
                     cudaStream_t st) {
  const int S = (K + kchunk - 1) / kchunk;
  const size_t smem =
      kStaged ? sizeof(float) * static_cast<size_t>(B) * D : 0;
  cudaError_t e = vq::allow_smem(sweep_kernel<kB, kOut, kStaged>, smem);
  if (e != cudaSuccess) return e;
  sweep_kernel<kB, kOut, kStaged><<<dim3(S, M), kThreads, smem, st>>>(
      z, w, residual, counts, zsum, delta, mind, assign, pmin, pidx, tickets,
      B, K, D, kchunk, S);
  ++vq::argmin_launches;
  return cudaGetLastError();
}

template <int kB, int kOut>
cudaError_t sweep_with(const float* z, const float* w, const float* residual,
                       float* counts, float* zsum, float* delta, float* mind,
                       int* assign, float* pmin, int* pidx, unsigned* tickets,
                       int M, int B, int K, int D, int kchunk,
                       cudaStream_t st) {
  auto* launch = sweep_staged(B, D) ? &sweep_as<kB, kOut, true>
                                    : &sweep_as<kB, kOut, false>;
  return launch(z, w, residual, counts, zsum, delta, mind, assign, pmin, pidx,
                tickets, M, B, K, D, kchunk, st);
}

template <int kB>
cudaError_t sweep_slots(const float* z, const float* w,
                        const float* residual, float* counts, float* zsum,
                        float* delta, float* mind, int* assign, float* pmin,
                        int* pidx, unsigned* tickets, int M, int B, int K,
                        int D, int kchunk, cudaStream_t st) {
  auto* launch = counts == nullptr     ? &sweep_with<kB, kAssignOnly>
                 : residual == nullptr ? &sweep_with<kB, kStats>
                                       : &sweep_with<kB, kStatsDelta>;
  return launch(z, w, residual, counts, zsum, delta, mind, assign, pmin, pidx,
                tickets, M, B, K, D, kchunk, st);
}

// --- the tiled route (B > 8) ------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of rows [0, nrows) and columns [col0, col0 + kTileCols)
// of src (row stride D) into dst [kRows][kTileCols]; rows past nrows and
// columns past D are filled with zeros.  16 bytes a copy with kVec (D a
// multiple of 4, the inputs 16-byte aligned), else 4.
template <int kRows, bool kVec>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int nrows, int col0, int D) {
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  constexpr int kRowCopies = kTileCols / kPer;
  static_assert(kRows * kRowCopies % kThreads == 0, "threads copy alike");
#pragma unroll
  for (int it = 0; it < kRows * kRowCopies / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowCopies;
    const int c = kPer * (i % kRowCopies);
    const bool ok = r < nrows && col0 + c < D;
    const float* from = ok ? src + static_cast<size_t>(r) * D + col0 + c
                           : src;
    if constexpr (kVec)
      cp_async16(dst + r * kTileCols + c, from, ok);
    else
      cp_async4(dst + r * kTileCols + c, from, ok);
  }
}

// One column tile's products for a warp: lane l's fma over k = col0 + l +
// 32j, j < 4 (only k < D unless kFull), slot (p, q) = acc[8q + p] taking
// point slot p and row slot q (the caller's offsets), the rows' norms from
// the same loads.
template <bool kFull>
__device__ __forceinline__ void tile_products(const float* zt,
                                              const float* wt,
                                              const int* zoff,
                                              const int* woff, float* acc,
                                              float* nrm, int kleft) {
#pragma unroll
  for (int j = 0; j < kTileCols / 32; ++j) {
    if (kFull || 32 * j < kleft) {
      float zv[kWarpPoints], wv[kWarpRows];
#pragma unroll
      for (int p = 0; p < kWarpPoints; ++p) zv[p] = zt[zoff[p] + 32 * j];
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) wv[q] = wt[woff[q] + 32 * j];
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) {
        nrm[q] = __fmaf_rn(wv[q], wv[q], nrm[q]);
#pragma unroll
        for (int p = 0; p < kWarpPoints; ++p)
          acc[q * kWarpPoints + p] =
              __fmaf_rn(zv[p], wv[q], acc[q * kWarpPoints + p]);
      }
    }
  }
}

// The B > 8 route (see the header): block (s, t, m) takes points [32t,
// 32t + 32) of worker m against rows [s * kchunk, (s + 1) * kchunk); the
// last of a point tile's S blocks to take its ticket combines the chunks.
// kZOnce: d <= kTileCols, the point tile staged once.  kVec: staged by
// 16-byte copies.  Stages (a row group by a column tile, in that order)
// go through a ring of kStages buffers, kStages - 1 of them in flight
// while one is read.
template <bool kZOnce, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_argmin_kernel(const float* __restrict__ z,
                        const float* __restrict__ w, float* __restrict__ mind,
                        int* __restrict__ assign, float* __restrict__ pmin,
                        int* __restrict__ pidx,
                        unsigned* __restrict__ tickets, int B, int K, int D,
                        int kchunk, int S) {
  constexpr int kP = vq::kTilePoints;
  constexpr int kZTile = kP * kTileCols;
  constexpr int kWTile = kTileRows * kTileCols;
  const int s = blockIdx.x;
  const int t = blockIdx.y;
  const int m = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = t * kP;
  const int np = min(kP, B - p0);
  const int k0 = s * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const int nstages = (k1 - k0 + kTileRows - 1) / kTileRows *
                      ((D + kTileCols - 1) / kTileCols);

  extern __shared__ __align__(16) float smem[];
  // [kStages][kTileRows][kTileCols], then the points: [kP][kTileCols]
  // once, or [kStages][kP][kTileCols] beside the rows
  float* ws = smem;
  float* zs = smem + kStages * kWTile;
  __shared__ float z2s[kP];
  __shared__ float wmin[kTileRows / kWarpRows][kP];
  __shared__ int widx[kTileRows / kWarpRows][kP];

  const float* zm = z + (static_cast<size_t>(m) * B + p0) * D;
  const float* wm = w + static_cast<size_t>(m) * K * D;
  // The next stage to copy: its row group, first column and buffer; each
  // call commits a group, empty past the last stage.
  int ig = 0, icol = 0, ibuf = 0, issued = 0;
  auto stage = [&]() {
    if (issued < nstages) {
      const int r0 = k0 + ig * kTileRows;
      stage_tile<kTileRows, kVec>(ws + ibuf * kWTile,
                                  wm + static_cast<size_t>(r0) * D,
                                  min(kTileRows, k1 - r0), icol, D);
      if constexpr (!kZOnce)
        stage_tile<kP, kVec>(zs + ibuf * kZTile, zm, np, icol, D);
      icol += kTileCols;
      if (icol >= D) {
        icol = 0;
        ++ig;
      }
      ibuf = ibuf + 1 == kStages ? 0 : ibuf + 1;
      ++issued;
    }
    cp_async_commit();
  };
  if constexpr (kZOnce) stage_tile<kP, kVec>(zs, zm, np, 0, D);
  for (int st = 0; st < kStages - 1; ++st) stage();
  if constexpr (!kZOnce) {  // point norms from global memory, as warp_dot
    for (int p = warp; p < np; p += kWarps) {
      const float* zr = zm + static_cast<size_t>(p) * D;
      const float v = vq::warp_dot(zr, zr, D, lane);
      if (lane == 0) z2s[p] = v;
    }
  }

  // Warp (wp, wr) owns points 8wp.. and rows 8wr.. of each stage.  Lane l
  // reads point p ^ pl into point slot p and row q ^ ql into row slot q,
  // which puts lane bits 4-2 on the row slot's bits and 1-0 on the point
  // slot's top two: warp_sum_transposed's layout for slot 8q + p.  Every
  // lane reads its own bank.
  const int wp = warp % (kP / kWarpPoints);
  const int wr = warp / (kP / kWarpPoints);
  const int pl = (lane & 3) << 1;
  const int ql = (lane >> 2) & 7;
  int zoff[kWarpPoints], woff[kWarpRows];
#pragma unroll
  for (int p = 0; p < kWarpPoints; ++p)
    zoff[p] = (wp * kWarpPoints + (p ^ pl)) * kTileCols + lane;
#pragma unroll
  for (int q = 0; q < kWarpRows; ++q)
    woff[q] = (wr * kWarpRows + (q ^ ql)) * kTileCols + lane;

  float acc[kWarpPoints * kWarpRows], nrm[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpPoints * kWarpRows; ++i) acc[i] = 0.f;
#pragma unroll
  for (int q = 0; q < kWarpRows; ++q) nrm[q] = 0.f;
  float best[2] = {VQ_BIG, VQ_BIG};
  int bidx[2] = {INT_MAX, INT_MAX};

  // stage st: row group g, columns from col0, buffer buf
  for (int st = 0, g = 0, col0 = 0, buf = 0; st < nstages; ++st) {
    cp_async_wait<kStages - 2>();  // stage st has landed
    __syncthreads();  // for every thread; and stage st - 1 is read by all
    if (kZOnce && st == 0) {  // point norms from the staged tile
      for (int p = warp; p < np; p += kWarps) {
        const float v = vq::warp_dot(zs + p * kTileCols, zs + p * kTileCols,
                                     D, lane);
        if (lane == 0) z2s[p] = v;
      }
      __syncthreads();
    }
    stage();  // stage st + kStages - 1, into the buffer stage st - 1 left
    const float* zt = zs + (kZOnce ? 0 : buf * kZTile);
    const float* wt = ws + buf * kWTile;
    if (col0 + kTileCols <= D)
      tile_products<true>(zt, wt, zoff, woff, acc, nrm, 0);
    else
      tile_products<false>(zt, wt, zoff, woff, acc, nrm, D - col0 - lane);
    if (col0 + kTileCols >= D) {  // the row group's last column tile
      vq::warp_sum_transposed<kWarpPoints * kWarpRows>(acc);
      vq::warp_sum_transposed<kWarpRows>(nrm);
      // acc[i] is point pl + i's product with row ql, nrm[0] that row's
      // norm
      const int r = k0 + g * kTileRows + wr * kWarpRows + ql;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = wp * kWarpPoints + pl + i;
        if (r < k1 && p < np) {
          const float d2 = vq::sq_dist(z2s[p], acc[i], nrm[0]);
          if (vq::better(d2, r, best[i], bidx[i])) {
            best[i] = d2;
            bidx[i] = r;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kWarpPoints * kWarpRows; ++i) acc[i] = 0.f;
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) nrm[q] = 0.f;
    }
    col0 += kTileCols;
    if (col0 >= D) {
      col0 = 0;
      ++g;
    }
    buf = buf + 1 == kStages ? 0 : buf + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block (the tail's are empty)
  __syncthreads();

  // lanes with the same lane & 3 hold the same two points: fold their rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ov = __shfl_xor_sync(VQ_FULL_MASK, best[i], off);
      const int oi = __shfl_xor_sync(VQ_FULL_MASK, bidx[i], off);
      if (vq::better(ov, oi, best[i], bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = wp * kWarpPoints + pl + i;
      wmin[wr][p] = best[i];
      widx[wr][p] = bidx[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < np) {
    const int p = threadIdx.x;
    float v = VQ_BIG;
    int i = INT_MAX;
    for (int q = 0; q < kTileRows / kWarpRows; ++q) {
      if (vq::better(wmin[q][p], widx[q][p], v, i)) {
        v = wmin[q][p];
        i = widx[q][p];
      }
    }
    const size_t o = (static_cast<size_t>(m) * B + p0 + p) * S + s;
    pmin[o] = v;
    pidx[o] = i;
  }
  unsigned* ticket = tickets + static_cast<size_t>(m) * gridDim.y + t;
  if (!last_to_arrive(ticket, static_cast<unsigned>(S))) return;
  for (int p = warp; p < np; p += kWarps) {
    const size_t o = static_cast<size_t>(m) * B + p0 + p;
    float v;
    int i;
    combine_partials(pmin, pidx, o * S, S, lane, v, i);
    if (lane == 0) {
      mind[o] = v;
      assign[o] = i;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;  // as the launch found it
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

long long vq::argmin_launches = 0;

cudaError_t vq::launch_sweep(const float* z, const float* w,
                             const float* residual, float* counts,
                             float* zsum, float* delta, float* mind,
                             int* assign, float* pmin, int* pidx,
                             unsigned* tickets, int M, int B, int K, int D,
                             int kchunk, cudaStream_t st) {
  if (B > kSmallB || tickets == nullptr ||
      (counts == nullptr) != (zsum == nullptr) ||
      (residual == nullptr) != (delta == nullptr) ||
      (residual != nullptr && counts == nullptr))
    return cudaErrorInvalidValue;
  auto* launch = B == 1 ? &sweep_slots<1> : &sweep_slots<kSmallB>;
  return launch(z, w, residual, counts, zsum, delta, mind, assign, pmin, pidx,
                tickets, M, B, K, D, kchunk, st);
}

cudaError_t vq::launch_tiled(const float* z, const float* w, float* mind,
                             int* assign, float* pmin, int* pidx,
                             unsigned* tickets, int M, int B, int K, int D,
                             int kchunk, cudaStream_t st) {
  if (B <= kSmallB || tickets == nullptr) return cudaErrorInvalidValue;
  const int S = (K + kchunk - 1) / kchunk;
  const dim3 grid(S, (B + kTilePoints - 1) / kTilePoints, M);
  const bool vec = (D & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(z) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  // kernels/vq_assign.py::argmin_plan mirrors these sizes
  const bool once = D <= kTileCols;
  const size_t smem =
      sizeof(float) * (kStages * kTileRows * kTileCols +
                       (once ? 1 : kStages) * kTilePoints * kTileCols);
  auto* kernel = once ? (vec ? &tiled_argmin_kernel<true, true>
                             : &tiled_argmin_kernel<true, false>)
                      : (vec ? &tiled_argmin_kernel<false, true>
                             : &tiled_argmin_kernel<false, false>);
  cudaError_t e = vq::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(z, w, mind, assign, pmin, pidx,
                                       tickets, B, K, D, kchunk, S);
  ++vq::argmin_launches;
  return cudaGetLastError();
}

extern "C" int vq_assign_f32(const float* z, const float* w, float* mind,
                             int* assign, float* pmin, int* pidx,
                             unsigned* tickets, int M, int B, int K, int D,
                             int kchunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      B <= vq::kSmallB
          ? vq::launch_sweep(z, w, nullptr, nullptr, nullptr, nullptr, mind,
                             assign, pmin, pidx, tickets, M, B, K, D, kchunk,
                             st)
          : vq::launch_tiled(z, w, mind, assign, pmin, pidx, tickets, M, B,
                             K, D, kchunk, st));
}

extern "C" int vq_delta_f32(const float* z, const float* w, float* counts,
                            float* zsum, float* mind, int* assign,
                            float* pmin, int* pidx, unsigned* tickets, int M,
                            int B, int K, int D, int kchunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= vq::kSmallB)
    return static_cast<int>(vq::launch_sweep(z, w, nullptr, counts, zsum,
                                             nullptr, mind, assign, pmin,
                                             pidx, tickets, M, B, K, D,
                                             kchunk, st));
  cudaError_t e = vq::launch_tiled(z, w, mind, assign, pmin, pidx, tickets,
                                   M, B, K, D, kchunk, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem4 = sizeof(float) * kOwnRows * D;
  if ((e = vq::allow_smem(accumulate_kernel, smem4)) != cudaSuccess)
    return static_cast<int>(e);
  accumulate_kernel<<<dim3((K + kOwnRows - 1) / kOwnRows, M), kThreads, smem4,
                      st>>>(z, assign, counts, zsum, B, K, D);
  ++vq::argmin_launches;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vq_argmin_launches(long long* out) {
  *out = vq::argmin_launches;
  return 0;
}
