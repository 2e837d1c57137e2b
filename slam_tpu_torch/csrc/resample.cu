// Systematic resampling on Hopper (sm_90a), for one filter or R filters (a
// fleet's robots) in one chain of launches, with the ESS gate read on the
// device.
//
// Replaces no Pallas kernel: the JAX package's `systematic_indices`
// (slam_tpu/ops/resample.py) is plain XLA. It was added because PyTorch
// runs the plain chain (slam_tpu_torch/ops/resample.py: systematic_ends,
// indices_from_ends) with `torch.cummax` in ONE block a row: at 1M
// particles on an H100 the cummax alone took 2.34 ms of the resampler's 3.1.
// Plain PyTorch version: ops/resample.py:systematic_ends +
// indices_from_ends, then gather_pose_packed. Wrapper: ops/resample_cuda.py.
//
// What it computes. For row r, the normalized weights w [n] and the draw
// u0[r]: the f64 prefix P_i of w, c_i = P_i / P_last and
// ends_i = ceil(n * c_i - u0), each operation rounded on its own and in the
// plain path's order (__ddiv_rn, __dmul_rn, __dsub_rn: nvcc contracts
// `n * c - u0` into an FMA by default, which moves the draws that sit on a
// bin edge). Slot k takes the first particle i with ends_i > k, which is
// the plain path's scatter-amax plus cummax: the largest occupied particle
// whose start is at most k. Only the prefix's summation order differs from
// the plain path's (and from the CPU's), so only a draw within ~1e-11 of a
// bin edge can land one slot over.
//
// The chain, for n above one tile (kTile particles):
//   tile sums  a block a tile, 16 B loads: tile_prefix, the tile's last
//              prefix value written (its "sum").
//   ends       a block a tile: the tile's base is the sums of the tiles
//              before it added one at a time in tile order, and P_last the
//              same run to the last tile, the same sequence in every block;
//              so base_{t+1} == base_t + S_t exactly, P never decreases
//              across a tile edge, c_{n-1} == 1 and ends_{n-1} == n, as
//              `c / c[..., -1:]` makes it in the plain path. Then
//              tile_prefix again (the same bits as the tile sums saw) and
//              the ends, int32.
//   select     merge path (Odeh, Green, Mwassi, Shmueli, Birk 2012): the
//              merge of the ends with the slots 0..n-1 takes 2n steps, and
//              a block takes kPath of them. One warp searches the block's
//              diagonal for its first particle and slot (a 32-way search,
//              ~4 rounds of loads at 1M), the block's ends go to shared
//              memory, and each slot's owner is a binary search there. The
//              poses are gathered (nearly coalesced: the owner grows with
//              the slot) and written with log_weight = -log(n); or the
//              indices are written.
// For n of one tile or less one block a row does all three in one launch
// (the RBPF's 1000 particles); it gives what the chain would.
//
// Against a collapsed cloud. A block handles at most kPath slots and
// particles together, so a cloud whose whole mass sits on one particle (it
// owns all n slots) or behind a long run of empty ranges costs what a
// dispersed one does. A block a range of particles, each writing its own
// particles' slots, would leave one block all n slots.
//
// The ESS gate. `gate` (bool [R]; null: every row) is read on the device.
// A row whose gate is false skips the sums and the ends, and its select
// blocks copy its poses and log weights through (indices: slot k keeps
// particle k). So the caller's graph holds no conditional node and no
// select around the chain: a hand-written kernel may not sit in a
// conditional body (core/graph.py:count_launch).
//
// Why the softmax stays outside. The MCL judge forms its weights with
// torch.softmax and then takes an f64 prefix sum (portbench/reference/
// filter.py:systematic). A softmax with another maximum or another order
// of its f32 sum changes the last bits of the weights, and such weights
// (the sharded resampler's) moved 1.71e-4 of the slots, above the judge's
// 1e-4 limit. So the kernel takes torch.softmax's weights bit for bit and
// changes only the f64 prefix's order.
//
// What bounds it: bytes. The weights and the poses read (16 B a particle),
// the poses and log weights written (16 B): 32 n bytes, 0.0096 ms at 1M
// particles on 3.35 TB/s. The chain moves ~44 n (the weights read twice,
// the ends written and read back) and its three launches each ramp up and
// drain; the ends block's serial sum over the tile sums (245 f64 adds at
// 1M) sits on its path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // particles a tile
constexpr int kPath = 2048;                   // merge-path steps a select block
constexpr int kCopy = kPath / 2;              // slots a select block copies for a gated-off row
constexpr int kSumsChunk = 1024;              // tile sums staged in shared memory at once
constexpr int kMaxRows = 65535;               // gridDim.y
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool row_on(const unsigned char* gate, int r) {
  return gate == nullptr || gate[r] != 0;
}

// Scratch of tile_prefix: the warps' totals, their inclusive scan, the
// warps' largest prefix, the tile's sum.
struct ScanScratch {
  double warp_total[kWarps];
  double warp_incl[kWarps];
  double warp_max[kWarps];
  double tile_sum;
};

// The in-tile inclusive prefix p[e] of this thread's kPerThread weights
// (particles t0 + threadIdx.x * kPerThread + e; past n they weigh 0), in
// f64. Each thread adds its own in order; the block scans the thread
// totals (warp shuffles, then the warps' totals); a max-scan then makes the
// prefix non-decreasing, since a shuffle scan's tree can round a thread's
// base one ulp under its left neighbour's last value. Deterministic: the
// tile-sums and ends kernels call it on the same tile and get the same
// bits. Returns the tile's sum, p at its last particle.
__device__ double tile_prefix(const float* __restrict__ w, long long n, long long t0,
                              double (&p)[kPerThread], ScanScratch& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long i0 = t0 + static_cast<long long>(tid) * kPerThread;
  float v[kPerThread];
  if (i0 + kPerThread <= n && (reinterpret_cast<uintptr_t>(w + i0) & 15) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w + i0);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const float4 f = __ldg(w4 + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) v[e] = i0 + e < n ? __ldg(w + i0 + e) : 0.0f;
  }
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    run = __dadd_rn(run, static_cast<double>(v[e]));
    p[e] = run;
  }

  // Exclusive base of this thread: the warp's shuffle scan, then the
  // warps' totals scanned by warp 0.
  double incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = __dadd_rn(o, incl);
  }
  if (lane == 31) s.warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double x = lane < kWarps ? s.warp_total[lane] : 0.0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const double o = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = __dadd_rn(o, x);
    }
    if (lane < kWarps) s.warp_incl[lane] = x;
  }
  __syncthreads();
  double left = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) left = 0.0;
  const double base = __dadd_rn(warp > 0 ? s.warp_incl[warp - 1] : 0.0, left);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) p[e] = __dadd_rn(base, p[e]);

  // Non-decreasing: each value at least the largest before it.
  double m = p[kPerThread - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(kFull, m, d);
    if (lane >= d) m = fmax(o, m);
  }
  if (lane == 31) s.warp_max[warp] = m;
  __syncthreads();
  double before = 0.0;
  for (int q = 0; q < warp; ++q) before = fmax(before, s.warp_max[q]);
  const double prev = __shfl_up_sync(kFull, m, 1);
  if (lane > 0) before = fmax(before, prev);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) p[e] = fmax(p[e], before);
  if (tid == kThreads - 1) s.tile_sum = p[kPerThread - 1];
  __syncthreads();
  return s.tile_sum;
}

// ends_i of this thread's particles from their in-tile prefix p, the
// tile's base and the row's P_last, in the plain path's operation order.
__device__ __forceinline__ void ends_of(const double (&p)[kPerThread], double base,
                                        double last, long long n, float u0,
                                        int (&e)[kPerThread]) {
  const double nd = static_cast<double>(n);
  const double ud = static_cast<double>(u0);
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const double c = __ddiv_rn(__dadd_rn(base, p[q]), last);
    double x = ceil(__dsub_rn(__dmul_rn(c, nd), ud));
    x = fmin(fmax(x, 0.0), nd);  // [0, n] for any finite weights; NaN -> 0
    e[q] = static_cast<int>(x);
  }
}

// Slot k of row `off` takes particle i: its pose and the uniform log
// weight, or its index.
__device__ __forceinline__ void write_slot(long long off, long long k, long long i,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ th, float* ox, float* oy,
                                           float* oth, float* olw, int* oidx, float lw_new) {
  if (oidx != nullptr) {
    oidx[off + k] = static_cast<int>(i);
    return;
  }
  ox[off + k] = __ldg(x + off + i);
  oy[off + k] = __ldg(y + off + i);
  oth[off + k] = __ldg(th + off + i);
  olw[off + k] = lw_new;
}

// A gated-off row: slots [k0, k1) keep their particles.
__device__ __forceinline__ void copy_through(long long off, long long k0, long long k1,
                                             const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             const float* __restrict__ th,
                                             const float* __restrict__ lw, float* ox, float* oy,
                                             float* oth, float* olw, int* oidx) {
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    if (oidx != nullptr) {
      oidx[off + k] = static_cast<int>(k);
      continue;
    }
    ox[off + k] = __ldg(x + off + k);
    oy[off + k] = __ldg(y + off + k);
    oth[off + k] = __ldg(th + off + k);
    olw[off + k] = __ldg(lw + off + k);
  }
}

// First j in [0, m) with ends[j] > k (m - 1 if none: the last slot's owner).
__device__ __forceinline__ int first_above(const int* ends, int m, long long k) {
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > k) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The particles the merge of `ends` [n] with the slots 0..n-1 has taken
// after `diag` steps, a particle taken before slot k when ends_i <= k
// (moderngpu's MergePath with lower bounds). One warp: each round its 32
// lanes test evenly spaced candidates, and the first failing one bounds
// the answer to one stride.
__device__ long long merge_path(const int* __restrict__ ends, long long n, long long diag,
                                int lane) {
  long long lo = diag > n ? diag - n : 0;
  long long hi = diag < n ? diag : n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    const bool taken = m < hi && static_cast<long long>(__ldg(ends + m)) <= diag - 1 - m;
    const long long c = __popc(__ballot_sync(kFull, taken));
    if (c == 0) {
      hi = lo;
    } else {
      const long long next = lo + c * step;
      lo = lo + (c - 1) * step + 1;
      if (next < hi) hi = next;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) resample_tile_sums_kernel(
    const float* __restrict__ w, const unsigned char* __restrict__ gate, double* sums,
    long long n, int n_tiles) {
  const int r = blockIdx.y;
  if (!row_on(gate, r)) return;
  __shared__ ScanScratch s;
  double p[kPerThread];
  const double sum = tile_prefix(w + static_cast<long long>(r) * n, n,
                                 static_cast<long long>(blockIdx.x) * kTile, p, s);
  if (threadIdx.x == 0) sums[static_cast<long long>(r) * n_tiles + blockIdx.x] = sum;
}

__global__ void __launch_bounds__(kThreads) resample_ends_kernel(
    const float* __restrict__ w, const float* __restrict__ u0,
    const unsigned char* __restrict__ gate, const double* __restrict__ sums, int* ends,
    long long n, int n_tiles) {
  const int r = blockIdx.y;
  if (!row_on(gate, r)) return;
  __shared__ ScanScratch s;
  __shared__ double s_sums[kSumsChunk];
  __shared__ double s_acc[2];  // this tile's base, then P_last
  const double* srow = sums + static_cast<long long>(r) * n_tiles;
  const int me = blockIdx.x;
  double acc = 0.0, base = 0.0;  // thread 0's
  for (int c0 = 0; c0 < n_tiles; c0 += kSumsChunk) {
    const int len = n_tiles - c0 < kSumsChunk ? n_tiles - c0 : kSumsChunk;
    for (int j = threadIdx.x; j < len; j += kThreads) s_sums[j] = srow[c0 + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < len; ++j) {
        if (c0 + j == me) base = acc;
        acc = __dadd_rn(acc, s_sums[j]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s_acc[0] = base;
    s_acc[1] = acc;
  }
  double p[kPerThread];
  const long long t0 = static_cast<long long>(me) * kTile;
  tile_prefix(w + static_cast<long long>(r) * n, n, t0, p, s);  // its barriers publish s_acc
  int e[kPerThread];
  ends_of(p, s_acc[0], s_acc[1], n, __ldg(u0 + r), e);
  const long long i0 = t0 + static_cast<long long>(threadIdx.x) * kPerThread;
  int* out = ends + static_cast<long long>(r) * n + i0;
  if (i0 + kPerThread <= n && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      reinterpret_cast<int4*>(out)[q] = make_int4(e[4 * q], e[4 * q + 1], e[4 * q + 2],
                                                  e[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (i0 + q < n) out[q] = e[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads) resample_select_kernel(
    const int* __restrict__ ends, const unsigned char* __restrict__ gate,
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ th,
    const float* __restrict__ lw, float* ox, float* oy, float* oth, float* olw, int* oidx,
    float lw_new, long long n) {
  const int r = blockIdx.y;
  const long long off = static_cast<long long>(r) * n;
  if (!row_on(gate, r)) {
    const long long k0 = static_cast<long long>(blockIdx.x) * kCopy;
    copy_through(off, k0, k0 + kCopy < n ? k0 + kCopy : n, x, y, th, lw, ox, oy, oth, olw,
                 oidx);
    return;
  }
  __shared__ int s_ends[kPath + 1];
  __shared__ long long s_cut[2];
  const int* er = ends + off;
  const long long d0 = static_cast<long long>(blockIdx.x) * kPath;
  const long long d1 = d0 + kPath < 2 * n ? d0 + kPath : 2 * n;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long cut = merge_path(er, n, warp == 0 ? d0 : d1, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) s_cut[warp] = cut;
  }
  __syncthreads();
  const long long i0 = s_cut[0], i1 = s_cut[1];
  const long long k0 = d0 - i0, k1 = d1 - i1;
  // The block's slots are owned by particles i0 .. min(i1, n - 1): particle
  // n - 1 (ends n) is taken only after every slot.
  long long m = (i1 < n - 1 ? i1 : n - 1) - i0 + 1;
  if (m > kPath + 1) m = kPath + 1;
  for (int j = threadIdx.x; j < m; j += kThreads) s_ends[j] = __ldg(er + i0 + j);
  __syncthreads();
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    long long i = i0 + (m > 0 ? first_above(s_ends, static_cast<int>(m), k) : 0);
    if (i > n - 1) i = n - 1;
    write_slot(off, k, i, x, y, th, ox, oy, oth, olw, oidx, lw_new);
  }
}

// n <= kTile: the prefix, the ends and the select in one block a row.
__global__ void __launch_bounds__(kThreads) resample_select_one_tile_kernel(
    const float* __restrict__ w, const float* __restrict__ u0,
    const unsigned char* __restrict__ gate, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ th, const float* __restrict__ lw,
    float* ox, float* oy, float* oth, float* olw, int* oidx, float lw_new, long long n) {
  const int r = blockIdx.y;
  const long long off = static_cast<long long>(r) * n;
  if (!row_on(gate, r)) {
    copy_through(off, 0, n, x, y, th, lw, ox, oy, oth, olw, oidx);
    return;
  }
  __shared__ ScanScratch s;
  __shared__ int s_ends[kTile];
  double p[kPerThread];
  const double last = tile_prefix(w + off, n, 0, p, s);
  int e[kPerThread];
  ends_of(p, 0.0, last, n, __ldg(u0 + r), e);
  const int i0 = threadIdx.x * kPerThread;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    if (i0 + q < n) s_ends[i0 + q] = e[q];
  }
  __syncthreads();
  for (long long k = threadIdx.x; k < n; k += kThreads) {
    write_slot(off, k, first_above(s_ends, static_cast<int>(n), k), x, y, th, ox, oy, oth,
               olw, oidx, lw_new);
  }
}

}  // namespace

// Systematic resampling of R rows of n particles on `stream`.
//   w        f32 [R, n], each row's normalized weights
//   u0       f32 [R], each row's draw in [0, 1)
//   gate     bool [R], or null: resample every row
//   x, y, th, lw   f32 [R, n], the particles (lw: their log weights)
//   ox, oy, oth, olw   f32 [R, n], the resampled particles, or all null
//   oidx     int32 [R, n], the selected indices (then x .. olw may be null)
//   lw_new   the resampled particles' log weight, -log(n) in f32
//   sums     f64 [R, ceil(n / 4096)] and ends int32 [R, n]: scratch for
//            n > 4096 (null otherwise)
// Returns the cudaGetLastError() code after the launches.
extern "C" int resample_launch(const void* w, const void* u0, const void* gate,
                               const void* x, const void* y, const void* th, const void* lw,
                               void* ox, void* oy, void* oth, void* olw, void* oidx,
                               float lw_new, void* sums, void* ends, long long n, int n_rows,
                               void* stream) {
  if (n <= 0 || n_rows <= 0) return 0;
  if (n_rows > kMaxRows || n > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u0);
  const unsigned char* g = static_cast<const unsigned char*>(gate);
  const float *xf = static_cast<const float*>(x), *yf = static_cast<const float*>(y),
              *tf = static_cast<const float*>(th), *lf = static_cast<const float*>(lw);
  float *oxf = static_cast<float*>(ox), *oyf = static_cast<float*>(oy),
        *otf = static_cast<float*>(oth), *olf = static_cast<float*>(olw);
  int* oi = static_cast<int*>(oidx);
  if (n <= kTile) {
    resample_select_one_tile_kernel<<<dim3(1, n_rows), kThreads, 0, s>>>(
        wf, uf, g, xf, yf, tf, lf, oxf, oyf, otf, olf, oi, lw_new, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (sums == nullptr || ends == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const dim3 tiles(n_tiles, n_rows);
  double* sd = static_cast<double*>(sums);
  int* ei = static_cast<int*>(ends);
  resample_tile_sums_kernel<<<tiles, kThreads, 0, s>>>(wf, g, sd, n, n_tiles);
  resample_ends_kernel<<<tiles, kThreads, 0, s>>>(wf, uf, g, sd, ei, n, n_tiles);
  const unsigned select_blocks = static_cast<unsigned>((2 * n + kPath - 1) / kPath);
  resample_select_kernel<<<dim3(select_blocks, n_rows), kThreads, 0, s>>>(
      ei, g, xf, yf, tf, lf, oxf, oyf, otf, olf, oi, lw_new, n);
  return static_cast<int>(cudaGetLastError());
}
