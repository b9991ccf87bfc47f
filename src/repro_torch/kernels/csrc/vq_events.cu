// The marks of a timed run's phases (obs/trace.py, PhaseClock).
//
// No kernel.  A timed MeshExecutor run records a CUDA timing event at each
// phase's start, three a sync window.  The events come from a pool that
// lives as long as the process, so a mark is one cudaEventRecord: a
// torch.cuda.Event made and recorded costs an H100 machine's host ~15-22 us,
// a mark through the pool ~5 us, its Python included.  Once the device has
// drained, each mark's time from the mark before it is one
// cudaEventElapsedTime, all in one call: torch.cuda.Event.elapsed_time makes
// two cudaEventQuery calls more a mark, and a Python call each.
//
// vq_events_create: n events made with timing on, into out (n,).
// vq_event_record:  the event recorded on the stream.
// vq_event_elapsed: ms (n,) f32, milliseconds from events[i - 1] to
//                   events[i] (ms[0] = 0); every event recorded and done.

#include <cuda_runtime.h>

extern "C" int vq_events_create(int n, void** out) {
  for (int i = 0; i < n; ++i) {
    cudaEvent_t ev;
    const cudaError_t err = cudaEventCreate(&ev);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i] = ev;
  }
  return 0;
}

extern "C" int vq_event_record(void* event, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int vq_event_elapsed(void* const* events, int n, float* ms) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ms[0] = 0.0f;
  for (int i = 1; i < n; ++i) {
    const cudaError_t err = cudaEventElapsedTime(
        &ms[i], static_cast<cudaEvent_t>(events[i - 1]),
        static_cast<cudaEvent_t>(events[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
