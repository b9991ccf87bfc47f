// Ring all-reduce hop kernel: one hop of the two-phase ring between
// processes, each process one worker with its payload in its own memory.
//
// Replaces the TPU kernel repro/comm/ring.py::_ring_kernel (called through
// _ring_pallas and ring_all_reduce) in its cross-device form: there each
// device sends its partial to the right neighbour by remote DMA, and the
// hops wait for each other on DMA and barrier semaphores.  Here each rank
// of a process group keeps a staging buffer of the whole padded row, M
// chunks of chunk = ceil(N / M) floats, allocated with cudaMalloc (not by
// PyTorch's caching allocator, whose IPC handle would name the allocator's
// whole segment).  Each rank exports the buffer once
// (cudaIpcGetMemHandle); both its neighbours map it once
// (cudaIpcOpenMemHandle): the right one reads its row, both read its
// counter.  The mapping is the same pointer whether the neighbour runs on
// this card or, with peer access, on another one.
//
// Each staging allocation starts with a kHeader-byte header that holds the
// rank's progress counter (64 bits, cache-line aligned), then the padded
// row: the neighbours see the counter through the same IPC mapping as the
// row.  Sequence numbers grow without bound: step t of a rank's call k
// (step 0 the stage, steps 1 .. 2 (M - 1) the hops) writes k (2M - 1) + t
// + 1 into its counter after its kernel, with cuStreamWriteValue64's
// default flags, which fence the kernel's stores before the write.  Before
// hop t the rank's stream waits (cuStreamWaitValue64, GEQ) until its left
// neighbour's counter reaches k (2M - 1) + t: the chunk it reads is
// finished.  Those waits chain around the ring, so the right neighbour has
// then finished step t - M + 1, past every read of this row that a hop
// could overwrite.  The stage overwrites the whole row, so it waits until
// the right neighbour's counter reaches k (2M - 1): its last copy of the
// call before is done.  comm/ring.py's hop_schedule spells the steps out
// and ring_all_reduce_group enqueues each with one vq_ring_step (its
// waits, its kernel, its counter write); the host never waits inside a
// call.  The waits hold no SM: the ranks' processes
// share the card as time-sliced contexts, and a kernel spinning on a flag
// would hold its slice while the neighbour it waits for cannot run.  The
// driver's stream memory operations are reached through
// cudaGetDriverEntryPointByVersion, so the library links no libcuda.
//
// Hop s of the reduce-scatter on rank r: chunk c = (r - s - 1) mod M,
// mine[c] = left[c] + mine[c], the received partial the left operand, in
// __fadd_rn so that nvcc cannot contract a masked multiply into the sum.
// After M - 1 hops rank r holds the finished chunk (r + 1) mod M, folded
// in the order of ring_all_reduce_plain, so the result is its bits.  Hop s
// of the all-gather copies chunk (r - s) mod M from the left.  No hop
// reads a chunk that a hop in flight writes
// (tests/test_torch_ring_schedule.py runs the steps under random
// interleavings).  The left operand is loaded past L1 (ld.global.cg):
// another process's kernel wrote it.  The reference's two-slot buffer
// scheme is not carried over.
//
// The stage (a call's first vq_ring_step) loads the payload into the
// staging row before the first hop: stage[g] = mask * x[g] (__fmul_rn, as
// the plain version's separate multiply), zeros past N.  The wrapper copies
// the finished row out with vq_ring_copy_f32.
//
// What bounds a hop on an H100: bytes.  A reduce-scatter hop reads two
// chunks and writes one (12 * chunk bytes), an all-gather hop reads one and
// writes one (8 * chunk); chunk * 4 bytes of additions at most.  On one card
// the same HBM serves every rank, so a reduce over M ranks moves M * (M -
// 1) * 20 * chunk bytes there; at M = 8, N = 524,288, 73.4 MB, 0.0219 ms
// at 3.35 TB/s (one hop: 0.79 MB, 0.0002 ms).  What the design does about
// it: nothing but streaming.  A thread owns 4 consecutive floats of the
// chunk (one 16-byte load of each operand and one store) where the chunk
// and the pointers allow it, else one float; no shared memory, no barrier,
// 64-bit offsets.  What sets a reduce's time is the chain of 2M - 1 steps
// on each of M contexts that take turns on the card.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
// bytes in front of the row: the progress counter, then padding to keep the
// row's float4s 16-byte aligned and the counter alone in its cache line
constexpr int64_t kHeader = 128;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float load_left(const float* p) {
  return __ldcg(p);
}

__device__ __forceinline__ float4 load_left(const float4* p) {
  return __ldcg(p);
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
  const V l = load_left(reinterpret_cast<const V*>(left + i));
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

float* row(void* base) {
  return reinterpret_cast<float*>(static_cast<char*>(base) + kHeader);
}

CUdeviceptr counter(const void* base) {
  return reinterpret_cast<CUdeviceptr>(base);
}

// The driver's entry points this file calls, at their CUDA 12.0 ABI.
using ValueOp = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned);
using DeviceGet = CUresult (*)(CUdevice*, int);
using DeviceAttr = CUresult (*)(int*, CUdevice_attribute, CUdevice);

struct Driver {
  ValueOp wait = nullptr;
  ValueOp write = nullptr;
  DeviceGet device_get = nullptr;
  DeviceAttr attribute = nullptr;
  int rc = 0;
};

template <typename F>
int entry(const char* name, F* out) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &found);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  *out = reinterpret_cast<F>(fn);
  return 0;
}

const Driver& driver() {
  static const Driver d = [] {
    Driver x;
    if (!x.rc) x.rc = entry("cuStreamWaitValue64", &x.wait);
    if (!x.rc) x.rc = entry("cuStreamWriteValue64", &x.write);
    if (!x.rc) x.rc = entry("cuDeviceGet", &x.device_get);
    if (!x.rc) x.rc = entry("cuDeviceGetAttribute", &x.attribute);
    return x;
  }();
  return d;
}

}  // namespace

// caps[0]: CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, caps[1]:
// CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES of the current device.
extern "C" int vq_ring_sync_caps(int* caps) {
  const Driver& d = driver();
  if (d.rc) return d.rc;
  int ordinal = 0;
  const cudaError_t rc = cudaGetDevice(&ordinal);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  CUdevice dev;
  CUresult r = d.device_get(&dev, ordinal);
  if (r == CUDA_SUCCESS)
    r = d.attribute(&caps[0],
                    CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev);
  if (r == CUDA_SUCCESS)
    r = d.attribute(&caps[1], CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES,
                    dev);
  return static_cast<int>(r);
}

// A staging allocation for a row of `bytes` bytes behind the header, owned
// by the caller until vq_ring_free; *out receives its base pointer.  The
// counter is 0 when this returns (the memset is complete).
extern "C" int vq_ring_alloc(long long bytes, void** out) {
  *out = nullptr;
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMalloc(out, static_cast<size_t>(bytes + kHeader));
  if (rc == cudaSuccess) rc = cudaMemset(*out, 0, kHeader);
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  return static_cast<int>(rc);
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

// Maps another process's exported allocation into this one: *out receives
// its base, which this process's kernels and stream waits can use.
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

namespace {

int stage(const float* x, const float* mask, void* mine, long long n,
          long long padded, cudaStream_t st) {
  if (n <= 0 || padded < n) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid;
  if (blocks_for(padded, 1, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  vq_ring_stage_kernel<<<grid, kThreads, 0, st>>>(x, mask, row(mine), n,
                                                  padded);
  return static_cast<int>(cudaGetLastError());
}

int hop(const void* left, void* mine, int c, long long chunk, int add,
        cudaStream_t st) {
  if (c < 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t off = static_cast<int64_t>(c) * chunk;
  const float* l = row(const_cast<void*>(left)) + off;
  float* m = row(mine) + off;
  const bool vec = chunk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0;
  unsigned grid;
  if (blocks_for(chunk, vec ? 4 : 1, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
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

}  // namespace

// One step of a call, on the stream: wait until left's counter >=
// left_value and right's >= right_value (a value of 0 holds at once and is
// not enqueued), then the step's kernel, then mine's counter = value, the
// kernel's stores fenced before it.  c < 0: the stage, row(mine)[0:n] =
// mask[0] * x[0:n] (x when mask is NULL), row(mine)[n:m * chunk] = 0; else
// hop c (below), x and mask unused.
extern "C" int vq_ring_step(const void* left, unsigned long long left_value,
                            const void* right,
                            unsigned long long right_value, int flush,
                            const float* x, const float* mask, long long n,
                            int m, int c, long long chunk, int add,
                            void* mine, unsigned long long value,
                            void* stream) {
  const Driver& d = driver();
  if (d.rc) return d.rc;
  const unsigned flags =
      CU_STREAM_WAIT_VALUE_GEQ | (flush ? CU_STREAM_WAIT_VALUE_FLUSH : 0u);
  const CUstream st = static_cast<CUstream>(stream);
  int rc = CUDA_SUCCESS;
  if (left_value) rc = d.wait(st, counter(left), left_value, flags);
  if (rc == CUDA_SUCCESS && right_value)
    rc = d.wait(st, counter(right), right_value, flags);
  if (rc != CUDA_SUCCESS) return rc;
  const cudaStream_t cst = static_cast<cudaStream_t>(stream);
  rc = c < 0 ? stage(x, mask, mine, n, static_cast<long long>(m) * chunk,
                     cst)
             : hop(left, mine, c, chunk, add, cst);
  if (rc != 0) return rc;
  return static_cast<int>(
      d.write(st, counter(mine), value, CU_STREAM_WRITE_VALUE_DEFAULT));
}

// One hop alone, no wait and no write: row(mine)[c * chunk ...] =
// row(left)[...] + row(mine)[...] (add != 0) or = row(left)[...] (add ==
// 0), for chunk index c.
extern "C" int vq_ring_hop_f32(const void* left, void* mine, int c,
                               long long chunk, int add, void* stream) {
  return hop(left, mine, c, chunk, add, static_cast<cudaStream_t>(stream));
}

// dst[0:n] = row(mine)[0:n], device to device, on the stream.
extern "C" int vq_ring_copy_f32(float* dst, void* mine, long long n,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyAsync(
      dst, row(mine), static_cast<size_t>(n) * sizeof(float),
      cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream)));
}
