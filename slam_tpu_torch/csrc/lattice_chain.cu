// The lattice Hybrid A*'s parent-chain walk on Hopper (sm_90a): one launch
// walks one chunk of the chain, from the goal back towards the start.
//
// Replaces no Pallas kernel: the JAX package walks the chain in a lax.scan
// (slam_tpu/planners/hastar.py). It was added because PyTorch walks it as a
// Python loop of ~16 eager ops a step, run to the next multiple of 64 steps
// between reads of its `done` flag: ~1000 launches and ~19 ms of host time
// for a 57-cell path on an H100, for ~60 dependent loads of one word.
// Plain PyTorch version: planners/hastar.py:_lattice_chain_device and
// _lattice_chain_cost, the CPU route and the reference. Wrapper:
// ops/lattice_chain_cuda.py.
//
// What it computes, from the packed words gp [s] (i32: quantized cost << 3 |
// the parent edge id; 0x7fffffff unset), the inverse steering offsets
// inv_off [k, e] and the edges' quantized costs edge_cost [k, e] (i64), the
// first index idx and the start index (each i32 or i64, read on the device,
// so no host read precedes the walk): for up to max_len steps,
//   safe = clamp(idx, 0, s - 1), word = gp[safe];
//   stop where idx < 0, idx == start or word == unset;
//   else write idx as the next cell, add edge_cost[clamp(nxt, 0, s - 1) % k,
//   edge] with edge = word & 7 and nxt = idx - inv_off[safe % k, edge], and
//   go on from nxt.
// out [4 + max_len] (i64): the cells written n, the sum of their edges'
// costs, done (1 where the walk stopped, 0 where it ran max_len steps), the
// next index (where it stopped, or where the next chunk starts), then the
// cells, -1 past n. Every value equals the eager walk's (its cells, next
// index and done, and its cost sum) bit for bit: the arithmetic is integer.
//
// What bounds it: latency. Each step's load depends on the last one's word,
// so the chain is ~n dependent loads of 4 B from device memory, ~0.5 us each
// on an H100 (0.029 ms for a 57-cell path); the bytes (4 n read, 8 max_len
// written) are nothing. So one thread walks; the block's threads first
// stage the two [k, e] tables in shared memory (padded to 8 edges, so any
// 3-bit edge id reads inside them) and fill the cells with -1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdges = 8;                  // 1 << the packed word's edge bits
constexpr int kEdgeMask = kEdges - 1;
constexpr int kUnset = 0x7fffffff;         // an unset packed word
constexpr int kHeader = 4;                 // n, cost, done, next index
constexpr int kMaxBins = 384;              // k * kEdges * 2 i64 in 48 KB

__device__ __forceinline__ long long load_index(const void* p, int wide) {
  return wide ? *static_cast<const long long*>(p)
              : static_cast<long long>(*static_cast<const int*>(p));
}

__global__ void __launch_bounds__(kThreads) lattice_chain_kernel(
    const int* __restrict__ gp, long long s, const long long* __restrict__ inv_off,
    const long long* __restrict__ edge_cost, int k, int e, const void* idx_p, int idx_wide,
    const void* start_p, int start_wide, long long max_len, long long* __restrict__ out) {
  extern __shared__ long long tables[];  // inv_off [k, 8], then edge_cost [k, 8]
  long long* s_off = tables;
  long long* s_cost = tables + k * kEdges;
  for (int i = threadIdx.x; i < k * kEdges; i += blockDim.x) {
    const int b = i / kEdges, ed = i % kEdges;
    s_off[i] = ed < e ? inv_off[b * e + ed] : 0;
    s_cost[i] = ed < e ? edge_cost[b * e + ed] : 0;
  }
  long long* cells = out + kHeader;
  for (long long i = threadIdx.x; i < max_len; i += blockDim.x) cells[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;

  long long idx = load_index(idx_p, idx_wide);
  const long long start = load_index(start_p, start_wide);
  long long n = 0, cost = 0;
  int done = 0;
  for (; n < max_len; ++n) {
    const long long safe = idx < 0 ? 0 : (idx > s - 1 ? s - 1 : idx);
    const int word = gp[safe];
    if (idx < 0 || idx == start || word == kUnset) {
      done = 1;
      break;
    }
    const int edge = word & kEdgeMask;
    const long long nxt = idx - s_off[(safe % k) * kEdges + edge];
    const long long parent = nxt < 0 ? 0 : (nxt > s - 1 ? s - 1 : nxt);
    cost += s_cost[(parent % k) * kEdges + edge];
    cells[n] = idx;
    idx = nxt;
  }
  out[0] = n;
  out[1] = cost;
  out[2] = done;
  out[3] = idx;
}

}  // namespace

extern "C" int lattice_chain_launch(const void* gp, long long s, const void* inv_off,
                                    const void* edge_cost, int k, int e, const void* idx,
                                    int idx_wide, const void* start, int start_wide,
                                    long long max_len, void* out, void* stream) {
  if (s <= 0 || k <= 0 || k > kMaxBins || e <= 0 || e > kEdges || max_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(k) * kEdges * 2 * sizeof(long long);
  lattice_chain_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gp), s, static_cast<const long long*>(inv_off),
      static_cast<const long long*>(edge_cost), k, e, idx, idx_wide, start, start_wide, max_len,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
