// Ring all-reduce hop kernel: one hop of the two-phase ring between
// processes, each process one worker with its payload in its own memory.
//
// Replaces the TPU kernel repro/comm/ring.py::_ring_kernel (called through
// _ring_pallas and ring_all_reduce) in its cross-device form: there each
// device sends its partial to the right neighbour by remote DMA.  Here each
// rank of a process group keeps a staging buffer of the whole padded row,
// M chunks of chunk = ceil(N / M) floats, allocated with cudaMalloc (not by
// PyTorch's caching allocator, whose IPC handle would name the allocator's
// whole segment).  Each rank exports the buffer once
// (cudaIpcGetMemHandle); its right neighbour maps it once
// (cudaIpcOpenMemHandle) and reads it.  The mapping is the same pointer
// whether the neighbour runs on this card or, with peer access, on
// another one.
//
// Hop s of the reduce-scatter on rank r (comm/ring.py's
// ring_all_reduce_group drives the hops): chunk c = (r - s - 1) mod M,
// mine[c] = left[c] + mine[c], the received partial the left operand, in
// __fadd_rn so that nvcc cannot contract a masked multiply into the sum.
// After M - 1 hops rank r holds the finished chunk (r + 1) mod M, folded
// in the order of ring_all_reduce_plain, so the result is its bits.  Hop s
// of the all-gather copies chunk (r - s) mod M from the left.  At hop s
// rank r writes one chunk while its right neighbour reads another ((r - s)
// mod M in the reduce-scatter, (r - s + 1) mod M in the all-gather), so no
// hop reads what the same hop writes; between hops the host synchronises
// the stream and the group (a barrier), so a hop reads what the one before
// it wrote.  The reference's two-slot buffer scheme is not carried over.
//
// vq_ring_stage_f32 loads the payload into the staging buffer before the
// first hop: stage[g] = mask * x[g] (__fmul_rn, as the plain version's
// separate multiply), zeros past N.  The wrapper copies the finished row
// out with vq_ring_copy_f32.
//
// What bounds a hop on an H100: bytes.  A reduce-scatter hop reads two
// chunks and writes one (12 * chunk bytes), an all-gather hop reads one and
// writes one (8 * chunk); chunk * 4 bytes of additions at most.  On one card
// the same HBM serves every rank, so a reduce over M ranks moves M * (M -
// 1) * 20 * chunk bytes there; at M = 8, N = 524,288, 73.4 MB, 0.0219 ms
// at 3.35 TB/s (one hop: 0.79 MB, 0.0002 ms).  What the design does about it: nothing but streaming.  A
// thread owns 4 consecutive floats of the chunk (one 16-byte load of each
// operand and one store) where the chunk and the pointers allow it, else
// one float; no shared memory, no barrier, 64-bit offsets.  The time of a
// reduce is set by the host: a stream sync and a group barrier a hop.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// V = float4 or float; add: the reduce-scatter's fold, else the
// all-gather's copy.  mine/left point at the chunk's first float.
template <typename V, bool kAdd>
__global__ void __launch_bounds__(kThreads)
    vq_ring_hop_kernel(const float* __restrict__ left,
                       float* __restrict__ mine, int64_t count) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kW;
  if (i >= count) return;
  const V l = *reinterpret_cast<const V*>(left + i);
  if constexpr (kAdd) {
    const V m = *reinterpret_cast<const V*>(mine + i);
    if constexpr (kW == 4)
      *reinterpret_cast<V*>(mine + i) = add4(l, m);
    else
      *reinterpret_cast<V*>(mine + i) = __fadd_rn(l, m);
  } else {
    *reinterpret_cast<V*>(mine + i) = l;
  }
}

__global__ void __launch_bounds__(kThreads)
    vq_ring_stage_kernel(const float* __restrict__ x,
                         const float* __restrict__ mask,
                         float* __restrict__ stage, int64_t n,
                         int64_t padded) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= padded) return;
  float v = 0.0f;
  if (i < n) v = mask != nullptr ? __fmul_rn(mask[0], x[i]) : x[i];
  stage[i] = v;
}

int blocks_for(int64_t count, int per_thread, unsigned* out) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * per_thread;
  const int64_t blocks = (count + per_block - 1) / per_block;
  if (blocks <= 0 || blocks > 0x7fffffff) return 1;
  *out = static_cast<unsigned>(blocks);
  return 0;
}

}  // namespace

// A staging buffer of `bytes` bytes, owned by the caller until
// vq_ring_free; *out receives its device pointer.
extern "C" int vq_ring_alloc(long long bytes, void** out) {
  *out = nullptr;
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMalloc(out, static_cast<size_t>(bytes)));
}

extern "C" int vq_ring_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// handle_out: CUDA_IPC_HANDLE_SIZE (64) bytes naming ptr's allocation.
extern "C" int vq_ring_export(void* ptr, void* handle_out) {
  cudaIpcMemHandle_t h;
  const cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) std::memcpy(handle_out, &h, sizeof(h));
  return static_cast<int>(rc);
}

// Maps another process's exported buffer into this one: *out receives a
// pointer this process's kernels can read and write.
extern "C" int vq_ring_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  *out = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int vq_ring_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// stage[0:n] = mask[0] * x[0:n] (x when mask is NULL), stage[n:padded] = 0.
extern "C" int vq_ring_stage_f32(const float* x, const float* mask,
                                 float* stage, long long n, long long padded,
                                 void* stream) {
  if (n <= 0 || padded < n) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid;
  if (blocks_for(padded, 1, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  vq_ring_stage_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, mask, stage,
                                                              n, padded);
  return static_cast<int>(cudaGetLastError());
}

// One hop: mine[c * chunk ...] = left[...] + mine[...] (add != 0) or
// = left[...] (add == 0), for chunk index c.
extern "C" int vq_ring_hop_f32(const float* left, float* mine, int c,
                               long long chunk, int add, void* stream) {
  if (c < 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t off = static_cast<int64_t>(c) * chunk;
  const float* l = left + off;
  float* m = mine + off;
  const bool vec = chunk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0;
  unsigned grid;
  if (blocks_for(chunk, vec ? 4 : 1, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec && add)
    vq_ring_hop_kernel<float4, true><<<grid, kThreads, 0, st>>>(l, m, chunk);
  else if (vec)
    vq_ring_hop_kernel<float4, false><<<grid, kThreads, 0, st>>>(l, m, chunk);
  else if (add)
    vq_ring_hop_kernel<float, true><<<grid, kThreads, 0, st>>>(l, m, chunk);
  else
    vq_ring_hop_kernel<float, false><<<grid, kThreads, 0, st>>>(l, m, chunk);
  return static_cast<int>(cudaGetLastError());
}

// dst[0:n] = src[0:n], device to device, on the stream.
extern "C" int vq_ring_copy_f32(float* dst, const float* src, long long n,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, static_cast<size_t>(n) * sizeof(float),
      cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream)));
}
