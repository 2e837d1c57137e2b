// Row gather out[i] = rows[idx[i]] on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   slam_tpu/ops/pano_pallas.py:gather_rows (body `_gather_kernel`).
// Plain PyTorch version: `rows[idx]` (slam_tpu_torch/ops/pano_cuda.py).
//
// On the MCL step the rows are the bins-last beam LUT seen as [H*W, bins]
// (360 bf16 bins = 720 B per row) and idx is each particle's sensor cell.
//
// What bounds it: device memory latency and bandwidth. Each output row is
// one scattered read of a whole table row plus one coalesced write; there
// is no arithmetic. The TPU kernel hides latency with `slots` row DMAs in
// flight per grid step. Here many warps in flight do that: a block of 256
// threads owns kRowsPerBlock output rows, stages their source byte offsets
// in shared memory, and then every thread copies whole vectors of the
// block's contiguous output span, so each warp issues 32 independent
// loads at once. The vector width V is the widest of 16, 8, 4, 1 bytes
// that divides the row pitch and both base addresses (the wrapper picks
// it): bf16/f32 360-bin rows move as 16 B vectors, u8 360-bin rows
// (360 B) as 8 B. One kernel serves every dtype because it only moves
// bytes. Source offsets are int64 (tables past 2 GiB), indices int32
// (as in the Pallas kernel and slam_tpu/ops/lut.py:288).
//
// Precondition (as for the Pallas kernel): every idx lies in [0, R).
// The callers clamp their cells first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;

template <typename V>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const unsigned char* __restrict__ rows, const int* __restrict__ idx,
    unsigned char* __restrict__ out, long long n, long long row_bytes) {
  __shared__ long long src_off[kRowsPerBlock];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long left = n - r0;
  const int nr = left < kRowsPerBlock ? static_cast<int>(left) : kRowsPerBlock;
  for (int k = threadIdx.x; k < nr; k += kThreads) {
    src_off[k] = static_cast<long long>(idx[r0 + k]) * row_bytes;
  }
  __syncthreads();

  const long long vpr = row_bytes / static_cast<long long>(sizeof(V));
  const long long total = nr * vpr;
  V* dst = reinterpret_cast<V*>(out + r0 * row_bytes);
  for (long long k = threadIdx.x; k < total; k += kThreads) {
    const long long r = k / vpr;
    const long long c = k - r * vpr;
    dst[k] = *reinterpret_cast<const V*>(rows + src_off[r] + c * sizeof(V));
  }
}

template <typename V>
void launch(const void* rows, const void* idx, void* out, long long n,
            long long row_bytes, cudaStream_t stream) {
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(rows), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), n, row_bytes);
}

}  // namespace

extern "C" int gather_rows_launch(const void* rows, const void* idx, void* out,
                                  long long n, long long row_bytes,
                                  int vec_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: launch<uint4>(rows, idx, out, n, row_bytes, s); break;
    case 8: launch<uint2>(rows, idx, out, n, row_bytes, s); break;
    case 4: launch<uint32_t>(rows, idx, out, n, row_bytes, s); break;
    case 1: launch<uint8_t>(rows, idx, out, n, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
