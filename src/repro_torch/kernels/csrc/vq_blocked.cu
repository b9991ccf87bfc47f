// Blocked assign+delta kernel: nearest prototype per point, then the
// per-prototype count and sum of the points assigned to it, and optionally
// the eq.-8 displacement with the sparse transport's error-feedback carry,
// for M stacked workers at any kappa and d.
//
// vq_delta_blocked_f32 replaces the TPU kernel repro/kernels/vq_fused.py::
// _fused_delta_kernel (called through vq_delta_blocked_pallas): a distance
// sweep keeping each point's running (min, argmin) across codebook blocks,
// an accumulate sweep building each codebook block's (counts, zsum) over
// every batch block, and the optional epilogue counts * w - zsum + residual.
//
// Inputs:  z (M, B, d) f32, w (M, kappa, d) f32, residual (M, kappa, d) f32
//          or null.
// Outputs: counts (M, kappa) f32, zsum (M, kappa, d) f32, delta
//          (M, kappa, d) f32 when residual is given, mind (M, B) f32,
//          assign (M, B) int32.
// Scratch: pmin/pidx (M, B, S) with S = ceil(kappa/kchunk); tickets, all 0
//          (M at B <= 8, M * ceil(B / 32) past it), left 0.
//
// Where it is needed.  The delta kernel (vq_delta.cu) accumulates a
// (32, d) tile in shared memory past 8 points, which outgrows a block's 227
// KB past d = 1,807; this kernel's shared memory does not grow with d past
// the argmin engine's staging limits, so the router (kernels/ops.py) sends
// every width past that here.
//
// What bounds it on an H100.  At the eq.-9 tick (B = 1, M = 8, kappa =
// 4096, d = 3072) it must read the codebooks and write zsum, 805 MB, and
// with the epilogue also read the residual and write delta, 1.61 GB:
// bytes.  At batch 1000 the distance product, 2*B*kappa*d flops per
// worker, on the f32 pipes: operations.
//
// What the design does about it.  It runs the argmin engine of the delta
// kernel (vq_delta.cu), so (assign, mind) have the delta kernel's bits:
//   B <= 8: the sweep, one launch, the codebooks read once with the norms
//      folded in; the statistics and the epilogue written by the same
//      launch (the swept rows' zeros and count-0 displacement, then the
//      winners' rows by the last block);
//   B > 8: the tiled argmin, then one owner block per (bk codebook rows x
//      256 columns) tile per worker scans every point's assignment in point
//      order; thread t owns column t of the tile and adds z with __fadd_rn,
//      thread 0 the count.  Each zsum element adds the same points in the
//      same order as the delta kernel's, so the two agree bit for bit, and
//      the tile's shared memory, 4 * (256 * bk + bk + 256) bytes, does not
//      depend on d.  Every column tile counts its rows (the epilogue needs
//      them); the column-0 tiles write counts.
// The epilogue is spelled __fadd_rn(__fsub_rn(__fmul_rn(cnt, w), zs), res),
// the rounding of eager counts * w - zsum + residual, which nvcc then cannot
// contract into an fma.  Neither tile (kchunk, bk) changes a bit: the
// argmin is a strict total order and every sum runs in point order.  They
// are chosen by kernels/autotune.py.
#include "vq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = kThreads;  // codebook columns per owner block
constexpr int kChunk = 256;      // assignments staged in shared memory at once
// kCols and kChunk are mirrored in kernels/vq_fused.py.

__global__ void __launch_bounds__(kThreads)
    blocked_accumulate_kernel(const float* __restrict__ z,
                              const float* __restrict__ w,
                              const float* __restrict__ residual,
                              const int* __restrict__ assign,
                              float* __restrict__ counts,
                              float* __restrict__ zsum,
                              float* __restrict__ delta, int B, int K, int D,
                              int bk) {
  const int k0 = blockIdx.x * bk;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const int m = blockIdx.z;
  const int nown = min(bk, K - k0);
  const bool live = col < D;

  extern __shared__ float smem[];
  float* acc = smem;                                  // [bk][kCols]
  float* cnt = smem + static_cast<size_t>(bk) * kCols;  // [bk]
  int* as = reinterpret_cast<int*>(cnt + bk);         // [kChunk]
  for (int i = 0; i < nown; ++i) acc[i * kCols + threadIdx.x] = 0.f;
  for (int i = threadIdx.x; i < nown; i += kThreads) cnt[i] = 0.f;

  const float* zm = z + static_cast<size_t>(m) * B * D + col;
  const int* am = assign + static_cast<size_t>(m) * B;
  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int n = min(kChunk, B - c0);
    __syncthreads();  // zeroing done, previous chunk no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) as[i] = am[c0 + i];
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const int a = as[b] - k0;
      if (a < 0 || a >= nown) continue;  // uniform across the block
      if (live) {
        float* cell = acc + a * kCols + threadIdx.x;
        *cell = __fadd_rn(*cell, zm[static_cast<size_t>(c0 + b) * D]);
      }
      if (threadIdx.x == 0) cnt[a] = __fadd_rn(cnt[a], 1.f);
    }
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    float* cm = counts + static_cast<size_t>(m) * K + k0;
    for (int i = threadIdx.x; i < nown; i += kThreads) cm[i] = cnt[i];
  }
  if (!live) return;
  const size_t base = (static_cast<size_t>(m) * K + k0) * D + col;
  for (int i = 0; i < nown; ++i) {
    const size_t o = base + static_cast<size_t>(i) * D;
    const float zs = acc[i * kCols + threadIdx.x];
    zsum[o] = zs;
    if (delta != nullptr)
      delta[o] = __fadd_rn(__fsub_rn(__fmul_rn(cnt[i], w[o]), zs),
                           residual[o]);
  }
}

}  // namespace

extern "C" int vq_delta_blocked_f32(const float* z, const float* w,
                                    const float* residual, float* counts,
                                    float* zsum, float* delta, float* mind,
                                    int* assign, float* pmin, int* pidx,
                                    unsigned* tickets, int M, int B, int K,
                                    int D, int kchunk, int bk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((residual == nullptr) != (delta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= vq::kSmallB)
    return static_cast<int>(vq::launch_sweep(z, w, residual, counts, zsum,
                                             delta, mind, assign, pmin, pidx,
                                             tickets, M, B, K, D, kchunk,
                                             st));
  cudaError_t e = vq::launch_tiled(z, w, mind, assign, pmin, pidx, tickets,
                                   M, B, K, D, kchunk, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem4 = sizeof(float) * (static_cast<size_t>(bk) * kCols + bk) +
                       sizeof(int) * kChunk;
  if ((e = vq::allow_smem(blocked_accumulate_kernel, smem4)) != cudaSuccess)
    return static_cast<int>(e);
  blocked_accumulate_kernel<<<dim3((K + bk - 1) / bk, (D + kCols - 1) / kCols,
                                   M),
                              kThreads, smem4, st>>>(
      z, w, residual, assign, counts, zsum, delta, B, K, D, bk);
  ++vq::argmin_launches;
  return static_cast<int>(cudaGetLastError());
}
