// The clock of the program's timed spans inside CUDA graphs
// (`utils/profiling.py:span`, `core/graph.py:_Capture.stamp`): a
// one-thread kernel that writes the device's global nanosecond timer
// (%globaltimer, 32 ns steps on the H100) into one slot of the graph's
// clock, pinned host memory, so the host reads a replay's stamps with no
// copy once the replay has completed.
//
// A kernel node costs a replay less device time than an event-record
// node: six of them added 1.2% to the 100k MCL step's replay, six timing
// event nodes 3.4% (PERF.md, section 6).
//
// The launcher returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void span_clock_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

// (slot: pinned host memory, stream)
extern "C" int span_clock_launch(void* slot, void* stream) {
  void* dev = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&dev, slot, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  span_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(dev));
  return static_cast<int>(cudaGetLastError());
}
