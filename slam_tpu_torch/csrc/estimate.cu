// The particle filter's best and mode poses on Hopper (sm_90a), for one
// filter or R filters (a fleet's robots): one launch at <= 4096 particles a
// row, two above.
//
// Replaces no Pallas kernel: the JAX package's estimate
// (slam_tpu/models/mcl.py) is plain XLA. It was added because PyTorch runs
// the plain estimate's softmax in ONE block a row (cunn_SoftMaxForward), and
// about fifteen more passes over the cloud around it (an argmax, gathers,
// weighted sums with a sin and a cos, an amax and a mean): at 1M particles
// on an H100 the estimate took 0.79 ms of a relocalizing request's 1.33 busy
// ms. Plain PyTorch version: models/mcl.py:plain_estimate. Wrapper:
// ops/estimate_cuda.py.
//
// What it computes, row by row, from the poses x, y, th, the accumulated log
// weights v and the measurement's log weights l [n]:
//   best   the pose of the first maximum of v, by torch.argmax's rule: the
//          lowest index among equal maxima, NaN above every number.
//   mode   with t_i = v_i * tau and e_i = expf(t_i - max t): x = sum e x /
//          sum e, y likewise, theta = atan2(sum e sin th, sum e cos th).
//   share  the share of the particles that tie the top score, those with
//          (max l - l_i) < max(1e-6 |max l|, 1e-6): their count times the
//          factor PyTorch's CUDA mean takes, rows / (rows * n) in f32 (the
//          wrapper forms it). Informative where share < 0.5.
// It writes the best pose (the mode pose where the measurement is not
// informative: the argmax of a majority tie is arbitrary), the mode pose,
// the share and the best index. t, the differences and the tie tolerance
// are each rounded on their own (__fmul_rn, __fsub_rn; nvcc would contract
// v * tau - max t into an FMA) as PyTorch rounds them, and max and argmax do
// not depend on the order of their reduction, so the best index and pose,
// the share and the informative decision equal the plain path's bit for bit
// (the count is exact up to 2^24 particles a row, as PyTorch's f32 sum of
// it is). The mode's sums run in another order than PyTorch's, with
// full-precision expf and sincosf: it differs by ~1e-7 relative.
//
// The chain, above one block's 4096 particles, over B blocks a row (one a
// tile of 1024 particles, at most kMaxBlocks, each block then taking every
// B-th tile; B depends on n alone):
//   maxima  grid (B, R), 16 B loads: each block's maxima of v (with its
//           first index), t and l; block 0 of a row zeroes the row's ticket.
//   pose    grid (B, R): each block loads its particles, then reduces the
//           row's B maxima (max is exact, so every block gets the same
//           bits), then writes its partial sums of e, e x, e y, e sin th,
//           e cos th and its tie count. The last block to take the row's
//           ticket (an integer atomic after a fence) adds the B partials in
//           block order and writes the row's outputs.
// At <= 4096 particles a row one block a row does both passes. No float
// atomics: every launch gives the same bits, so a graph replay equals an
// eager call.
//
// What bounds it: bytes. v, l, x, y and th read once, 20 n bytes: 0.006 ms
// at 1M particles on 3.35 TB/s. The chain reads v and l twice (28 n; the
// second time partly from L2), and each particle's full-precision expf and
// sincosf cost ~70 instructions (~2.5 us at 1M over 132 SMs).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                   // particles a 16 B load
constexpr int kTile = kThreads * kVec;    // particles a tile
constexpr int kOneBlock = 4096;           // particles a row that one block takes alone
constexpr int kMaxBlocks = 512;           // blocks a row
constexpr int kMaxRows = 65535;           // gridDim.y
constexpr int kMaxWords = 4;              // 32-bit words of a block's maxima
constexpr int kSumWords = 6;              // of its sums and tie count
constexpr unsigned kFull = 0xffffffffu;

// One row of the five arrays; `vec` when every one starts 16 B aligned.
struct Row {
  const float* x;
  const float* y;
  const float* th;
  const float* v;
  const float* l;
  long long n;
  bool vec;
};

__device__ __forceinline__ Row row_of(const float* x, const float* y, const float* th,
                                      const float* v, const float* l, long long n, int r) {
  const long long off = static_cast<long long>(r) * n;
  Row row{x + off, y + off, th + off, v + off, l + off, n, false};
  const uintptr_t any = reinterpret_cast<uintptr_t>(row.x) | reinterpret_cast<uintptr_t>(row.y)
                        | reinterpret_cast<uintptr_t>(row.th) | reinterpret_cast<uintptr_t>(row.v)
                        | reinterpret_cast<uintptr_t>(row.l);
  row.vec = (any & 15) == 0;
  return row;
}

// The 4 values of `a` from particle i (a multiple of 4); past n, `pad`.
__device__ __forceinline__ void load4(const float* __restrict__ a, long long i, long long n,
                                      bool vec, float pad, float (&out)[kVec]) {
  if (vec && i + kVec <= n) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(a + i));
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = i + e < n ? __ldg(a + i + e) : pad;
}

// The maxima a block or a row has seen.
struct Maxima {
  float v;  // the largest v, NaN above every number
  int i;    // the first index holding it
  float t;  // the largest t = v * tau
  float l;  // the largest l, NaN if any is
};

__device__ __forceinline__ Maxima no_maxima() {
  return {-INFINITY, INT_MAX, -INFINITY, -INFINITY};
}

// torch.argmax's order: does (a, ia) come before (b, ib)?
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// torch.amax's maximum: NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ Maxima merge(const Maxima& a, const Maxima& b) {
  const bool first = before(a.v, a.i, b.v, b.i);
  return {first ? a.v : b.v, first ? a.i : b.i, fmaxf(a.t, b.t), max_nan(a.l, b.l)};
}

__device__ __forceinline__ Maxima shfl_down(const Maxima& m, int d) {
  return {__shfl_down_sync(kFull, m.v, d), __shfl_down_sync(kFull, m.i, d),
          __shfl_down_sync(kFull, m.t, d), __shfl_down_sync(kFull, m.l, d)};
}

// The block's maxima, returned to every thread.
__device__ Maxima block_maxima(Maxima m, Maxima* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = merge(m, shfl_down(m, d));
  if (lane == 0) s_warp[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? s_warp[lane] : no_maxima();
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1) m = merge(m, shfl_down(m, d));
    if (lane == 0) s_warp[0] = m;
  }
  __syncthreads();
  m = s_warp[0];
  __syncthreads();  // s_warp may be written again
  return m;
}

// This thread's maxima over tiles first, first + stride, ... of the row.
__device__ Maxima thread_maxima(const Row& row, float tau, int first, int stride) {
  Maxima m = no_maxima();
  for (long long t0 = static_cast<long long>(first) * kTile; t0 < row.n;
       t0 += static_cast<long long>(stride) * kTile) {
    const long long i0 = t0 + static_cast<long long>(threadIdx.x) * kVec;
    float v[kVec], l[kVec];
    load4(row.v, i0, row.n, row.vec, -INFINITY, v);
    load4(row.l, i0, row.n, row.vec, -INFINITY, l);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (i0 + e >= row.n) break;
      const int i = static_cast<int>(i0 + e);
      if (before(v[e], i, m.v, m.i)) {
        m.v = v[e];
        m.i = i;
      }
      m.t = fmaxf(m.t, __fmul_rn(v[e], tau));
      m.l = max_nan(m.l, l[e]);
    }
  }
  return m;
}

// Partial sums of e, e x, e y, e sin th, e cos th and the tie count.
struct Sums {
  float s, x, y, sn, cs;
  unsigned ties;
};

__device__ __forceinline__ Sums add(const Sums& a, const Sums& b) {
  return {__fadd_rn(a.s, b.s), __fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
          __fadd_rn(a.sn, b.sn), __fadd_rn(a.cs, b.cs), a.ties + b.ties};
}

__device__ __forceinline__ Sums shfl_down(const Sums& a, int d) {
  return {__shfl_down_sync(kFull, a.s, d), __shfl_down_sync(kFull, a.x, d),
          __shfl_down_sync(kFull, a.y, d), __shfl_down_sync(kFull, a.sn, d),
          __shfl_down_sync(kFull, a.cs, d), __shfl_down_sync(kFull, a.ties, d)};
}

// The block's sums in a fixed tree, returned to thread 0.
__device__ Sums block_sums(Sums a, Sums* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a = add(a, shfl_down(a, d));
  if (lane == 0) s_warp[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s_warp[lane] : Sums{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0u};
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1) a = add(a, shfl_down(a, d));
  }
  __syncthreads();  // s_warp may be written again
  return a;
}

// One tile's particles of this thread, loaded ahead of the sums.
struct Loaded {
  float v[kVec], l[kVec], x[kVec], y[kVec], th[kVec];
};

__device__ __forceinline__ void load_tile(const Row& row, long long i0, Loaded& p) {
  load4(row.v, i0, row.n, row.vec, 0.0f, p.v);
  load4(row.l, i0, row.n, row.vec, 0.0f, p.l);
  load4(row.x, i0, row.n, row.vec, 0.0f, p.x);
  load4(row.y, i0, row.n, row.vec, 0.0f, p.y);
  load4(row.th, i0, row.n, row.vec, 0.0f, p.th);
}

// The row's maxima turned into what the sums need.
struct Scale {
  float tau, t_max, l_max, tol;
};

__device__ __forceinline__ Scale scale_of(const Maxima& m, float tau) {
  // torch.clamp(1e-6 * |max l|, min=1e-6) in f32; NaN stays NaN.
  const float tol = __fmul_rn(1e-6f, fabsf(m.l));
  return {tau, m.t, m.l, isnan(tol) ? tol : fmaxf(tol, 1e-6f)};
}

__device__ __forceinline__ void add_tile(const Loaded& p, long long i0, long long n,
                                         const Scale& k, Sums& a) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (i0 + e >= n) break;
    const float w = expf(__fsub_rn(__fmul_rn(p.v[e], k.tau), k.t_max));
    float sn, cs;
    sincosf(p.th[e], &sn, &cs);
    a.s = __fadd_rn(a.s, w);
    a.x = fmaf(w, p.x[e], a.x);
    a.y = fmaf(w, p.y[e], a.y);
    a.sn = fmaf(w, sn, a.sn);
    a.cs = fmaf(w, cs, a.cs);
    a.ties += __fsub_rn(k.l_max, p.l[e]) < k.tol ? 1u : 0u;
  }
}

// The first maximum's pose, read by thread 0 as soon as the row's maxima
// are known, so the read overlaps the sums.
struct Best {
  float x, y, th;
};

__device__ __forceinline__ Best best_of(const Row& row, const Maxima& m) {
  if (threadIdx.x != 0) return {0.0f, 0.0f, 0.0f};
  return {__ldg(row.x + m.i), __ldg(row.y + m.i), __ldg(row.th + m.i)};
}

// Row r's outputs from its maxima, best pose and sums (thread 0).
__device__ void write_row(const Maxima& m, const Best& best, const Sums& a, float mean_factor,
                          float* out, int* idx, int r, int n_rows) {
  const float share = __fmul_rn(static_cast<float>(a.ties), mean_factor);
  const float mx = __fdiv_rn(a.x, a.s), my = __fdiv_rn(a.y, a.s);
  const float mth = atan2f(a.sn, a.cs);
  const bool informative = share < 0.5f;
  out[0 * n_rows + r] = informative ? best.x : mx;
  out[1 * n_rows + r] = informative ? best.y : my;
  out[2 * n_rows + r] = informative ? best.th : mth;
  out[3 * n_rows + r] = mx;
  out[4 * n_rows + r] = my;
  out[5 * n_rows + r] = mth;
  out[6 * n_rows + r] = share;
  idx[r] = m.i;
}

__global__ void __launch_bounds__(kThreads) estimate_maxima_kernel(
    const float* __restrict__ v, const float* __restrict__ l, float tau, long long n,
    int* maxima, unsigned* tickets) {
  __shared__ Maxima s_warp[kWarps];
  const int r = blockIdx.y, b = blockIdx.x, n_blocks = gridDim.x;
  const Row row = row_of(v, v, v, v, l, n, r);  // the poses are not read here
  const Maxima m = block_maxima(thread_maxima(row, tau, b, n_blocks), s_warp);
  if (threadIdx.x == 0) {
    int* w = maxima + (static_cast<long long>(r) * n_blocks + b) * kMaxWords;
    w[0] = __float_as_int(m.v);
    w[1] = m.i;
    w[2] = __float_as_int(m.t);
    w[3] = __float_as_int(m.l);
    if (b == 0) tickets[r] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads) estimate_pose_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ th,
    const float* __restrict__ v, const float* __restrict__ l, float tau, float mean_factor,
    long long n, const int* __restrict__ maxima, int* sums, unsigned* tickets, float* out,
    int* idx, int n_rows) {
  __shared__ Maxima s_max[kWarps];
  __shared__ Sums s_sum[kWarps];
  __shared__ bool s_last;
  const int r = blockIdx.y, b = blockIdx.x, n_blocks = gridDim.x;
  const Row row = row_of(x, y, th, v, l, n, r);
  long long i0 = static_cast<long long>(b) * kTile + static_cast<long long>(threadIdx.x) * kVec;
  Loaded p;
  load_tile(row, i0, p);  // in flight while the row's maxima are reduced

  Maxima m = no_maxima();
  const int* row_max = maxima + static_cast<long long>(r) * n_blocks * kMaxWords;
  for (int j = threadIdx.x; j < n_blocks; j += kThreads) {
    const int4 w = *reinterpret_cast<const int4*>(row_max + j * kMaxWords);
    m = merge(m, {__int_as_float(w.x), w.y, __int_as_float(w.z), __int_as_float(w.w)});
  }
  m = block_maxima(m, s_max);
  const Scale k = scale_of(m, tau);
  const Best best = best_of(row, m);

  Sums a{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0u};
  const long long step = static_cast<long long>(n_blocks) * kTile;
  while (true) {
    add_tile(p, i0, n, k, a);
    i0 += step;
    if (i0 - static_cast<long long>(threadIdx.x) * kVec >= n) break;
    load_tile(row, i0, p);
  }
  a = block_sums(a, s_sum);

  int* row_sums = sums + static_cast<long long>(r) * n_blocks * kSumWords;
  if (threadIdx.x == 0) {
    int* w = row_sums + b * kSumWords;
    w[0] = __float_as_int(a.s);
    w[1] = __float_as_int(a.x);
    w[2] = __float_as_int(a.y);
    w[3] = __float_as_int(a.sn);
    w[4] = __float_as_int(a.cs);
    w[5] = static_cast<int>(a.ties);
    __threadfence();
    s_last = atomicAdd(tickets + r, 1u) == static_cast<unsigned>(n_blocks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // The last block: the partials in block order, a fixed tree over threads.
  a = Sums{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0u};
  for (int j = threadIdx.x; j < n_blocks; j += kThreads) {
    const int* w = row_sums + j * kSumWords;
    a = add(a, {__int_as_float(__ldcg(w)), __int_as_float(__ldcg(w + 1)),
                __int_as_float(__ldcg(w + 2)), __int_as_float(__ldcg(w + 3)),
                __int_as_float(__ldcg(w + 4)), static_cast<unsigned>(__ldcg(w + 5))});
  }
  a = block_sums(a, s_sum);
  if (threadIdx.x == 0) write_row(m, best, a, mean_factor, out, idx, r, n_rows);
}

// n <= kOneBlock: both passes in one block a row.
__global__ void __launch_bounds__(kThreads) estimate_pose_one_block_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ th,
    const float* __restrict__ v, const float* __restrict__ l, float tau, float mean_factor,
    long long n, float* out, int* idx, int n_rows) {
  __shared__ Maxima s_max[kWarps];
  __shared__ Sums s_sum[kWarps];
  const int r = blockIdx.y;
  const Row row = row_of(x, y, th, v, l, n, r);
  const Maxima m = block_maxima(thread_maxima(row, tau, 0, 1), s_max);
  const Scale k = scale_of(m, tau);
  const Best best = best_of(row, m);
  Sums a{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0u};
  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const long long i0 = t0 + static_cast<long long>(threadIdx.x) * kVec;
    Loaded p;
    load_tile(row, i0, p);
    add_tile(p, i0, n, k, a);
  }
  a = block_sums(a, s_sum);
  if (threadIdx.x == 0) write_row(m, best, a, mean_factor, out, idx, r, n_rows);
}

}  // namespace

// The best and mode poses of R rows of n particles on `stream`.
//   x, y, th, v, l   f32 [R, n]: the poses, the accumulated log weights, the
//                    measurement's log weights
//   tau              the mode's sharpening, f32
//   mean_factor      PyTorch's CUDA mean factor of an [R, n] row mean,
//                    f32(R) / f32(R * n)
//   out              f32 [7, R]: best x, y, theta, mode x, y, theta, share
//   idx              int32 [R]: the first maximum of v
//   scratch          32-bit words, at least R * (10 * B + 1) for n > 4096
//                    (B = min(ceil(n / 1024), 512)); null otherwise
// Returns the cudaGetLastError() code after the launches.
extern "C" int estimate_launch(const void* x, const void* y, const void* th, const void* v,
                               const void* l, float tau, float mean_factor, void* out, void* idx,
                               void* scratch, long long scratch_words, long long n, int n_rows,
                               void* stream) {
  if (n <= 0 || n_rows <= 0) return 0;
  if (n_rows > kMaxRows || n > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *yf = static_cast<const float*>(y),
              *tf = static_cast<const float*>(th), *vf = static_cast<const float*>(v),
              *lf = static_cast<const float*>(l);
  float* of = static_cast<float*>(out);
  int* oi = static_cast<int*>(idx);
  if (n <= kOneBlock) {
    estimate_pose_one_block_kernel<<<dim3(1, n_rows), kThreads, 0, s>>>(
        xf, yf, tf, vf, lf, tau, mean_factor, n, of, oi, n_rows);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const int n_blocks = static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  const long long words = static_cast<long long>(n_rows) * (
      static_cast<long long>(kMaxWords + kSumWords) * n_blocks + 1);
  if (scratch == nullptr || scratch_words < words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* maxima = static_cast<int*>(scratch);
  int* sums = maxima + static_cast<long long>(n_rows) * n_blocks * kMaxWords;
  unsigned* tickets = reinterpret_cast<unsigned*>(
      sums + static_cast<long long>(n_rows) * n_blocks * kSumWords);
  const dim3 grid(n_blocks, n_rows);
  estimate_maxima_kernel<<<grid, kThreads, 0, s>>>(vf, lf, tau, n, maxima, tickets);
  estimate_pose_kernel<<<grid, kThreads, 0, s>>>(xf, yf, tf, vf, lf, tau, mean_factor, n,
                                                  maxima, sums, tickets, of, oi, n_rows);
  return static_cast<int>(cudaGetLastError());
}
