// The RBPF's per-particle-map march and map write on Hopper (sm_90a): two
// launches a chunk of particles, `rbpf_march_kernel` (the predicted hits)
// and `rbpf_write_kernel` (the scan's updates into the new maps).
//
// Replaces no Pallas kernel: the JAX package's fidelity update
// (slam_tpu/ops/mapping.py) is plain XLA. It was added because PyTorch runs
// it as [C, B, K] tensors of every ray step of a chunk (every step of every
// beam, ~60 B a lane), and settles the cells that two beams of one particle
// write through an int64 table with one entry per map cell of the chunk
// (planners/_scatter.py:last_lanes): 26.1 of the 1000-map step's 30.1 ms on
// an H100. Plain PyTorch version: ops/mapping.py:_fidelity_chunk with
// last_lanes, the CPU route and the reference. Wrapper:
// ops/rbpf_fidelity_cuda.py.
//
// The geometry, for particle n of the chunk with sensor (x, y) and beam b
// with f32 c = cos, s = sin (taken in f64 and rounded on the host), at
// 0-based step k of K:
//   px = x + (k + 1) * (c * step), py = y + (k + 1) * (s * step),
//   i = floor(h - py - 1), j = floor(px), cell = i * w + j (i32),
// each product and sum rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: a contracted FMA would move a step onto another cell), so
// every cell equals the plain path's. A step is processed where its cell
// differs from the step before's (the sensor's cell before step 0) and it
// and every step before it lie in the map.
//
// March: one warp a (particle, beam); its lanes take 32 consecutive steps a
// round, the previous step's cell by __shfl_up (lane 0 the last round's
// last). The predicted hit is the first processed step whose cell is not
// the sensor's and reads < 128 in the pre-scan map (__ballot_sync,
// __ffs); the warp stops there, at the first step out of the map, or at K.
// hit_dist = (k + 1) * step (step where nothing is hit), hit_any.
//
// Write: one block a particle, into the new maps (the pre-scan maps'
// copy), every update taken from the pre-scan code. A beam's occupied step
// is the first processed step with d >= z (d = (k + 1) * step), only where
// z < max_dist; its free steps are the processed steps with d * d < z * z
// (occupied wins where both hold). Where lanes of one particle write one
// cell, the plain path keeps the last lane in (beam, step) order. A ray's
// coordinates are monotone in k (each rounding is), so a beam visits a
// cell in one run of steps and writes it once, and the steps in the map
// form one interval: a step k is processed iff step 0 and step k lie in
// the map and its cell is new. So the last writer of a cell is its highest
// beam, and:
//   1. each thread finds a beam's occupied cell: the first step with
//      d >= z from (z / step) back a margin, then forward to the first new
//      cell (a few steps), into shared memory;
//   2. the occupied cells get the occupied update; thread 0 meanwhile
//      hashes (cell -> the highest beam occupying it) in shared memory;
//   3. after a barrier, each warp marches its beams' free steps (32 a
//      round, as the march) and writes the free update, except where the
//      table holds the cell for the beam itself or a later one.
// Two writers of one cell in one phase write one code; the barrier orders
// the free writes after the occupied ones. No atomics, no table in global
// memory.
//
// What bounds it: the dependent rounds of each warp (a map read, a ballot)
// and the bytes of the cells read and written, ~1 B each of a 32 B sector:
// a few 1e7 steps a 1000-map step, well under a millisecond.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMarchThreads = 256;  // 8 (particle, beam) pairs a block
constexpr int kWriteThreads = 512;  // 16 warps share a particle's beams
constexpr int kMaxBeams = 2048;     // the hash table: 2 x 4096 i32 in smem
constexpr int kMaxSteps = 1 << 24;  // (k + 1) exact in f32

struct Ray {
  float x, y;    // the sensor
  float cs, ss;  // c * step, s * step
  float hf;      // f32(h)
  int h, w;
};

__device__ __forceinline__ Ray make_ray(float x, float y, float c, float s, float step, int h,
                                        int w) {
  return Ray{x, y, __fmul_rn(c, step), __fmul_rn(s, step), static_cast<float>(h), h, w};
}

__device__ __forceinline__ int to_cell(const Ray& r, float px, float py, bool* inb) {
  const int i = static_cast<int>(floorf(__fsub_rn(__fsub_rn(r.hf, py), 1.0f)));
  const int j = static_cast<int>(floorf(px));
  *inb = i >= 0 && i < r.h && j >= 0 && j < r.w;
  // i32 with wrap-around, as PyTorch computes it.
  return static_cast<int>(static_cast<unsigned>(i) * static_cast<unsigned>(r.w) +
                          static_cast<unsigned>(j));
}

// The cell of step k (0-based): the sensor's at k = -1.
__device__ __forceinline__ int step_cell(const Ray& r, int k, bool* inb) {
  if (k < 0) return to_cell(r, r.x, r.y, inb);
  const float kf = static_cast<float>(k + 1);
  return to_cell(r, __fadd_rn(r.x, __fmul_rn(kf, r.cs)), __fadd_rn(r.y, __fmul_rn(kf, r.ss)),
                 inb);
}

// One round of a warp's march: steps k0 + lane. `carry` holds the cell of
// step k0 - 1 (all lanes) and becomes the round's last cell. Returns the
// lanes before the first step out of the map or past K (32 where there is
// none); `processed` and `cell` are this lane's.
struct Round {
  int cell;
  int live;  // lanes in the map and before K
  bool processed;
};

__device__ __forceinline__ Round march_round(const Ray& r, int k0, int k_total, int* carry) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = k0 + lane;
  bool inb;
  const int cell = step_cell(r, k, &inb);
  int prev = __shfl_up_sync(kFull, cell, 1);
  if (lane == 0) prev = *carry;
  const unsigned out = __ballot_sync(kFull, !(inb && k < k_total));
  const int live = out ? __ffs(out) - 1 : kWarp;
  *carry = __shfl_sync(kFull, cell, kWarp - 1);
  return Round{cell, live, lane < live && cell != prev};
}

__device__ __forceinline__ uint8_t u8_update(uint8_t v, float scale) {
  const float p = fminf(__fmul_rn(static_cast<float>(v), scale), 1.0f);
  return static_cast<uint8_t>(fmaxf(floorf(__fmul_rn(p, 255.0f)), 1.0f));
}

__global__ void __launch_bounds__(kMarchThreads) rbpf_march_kernel(
    const uint8_t* __restrict__ maps, const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ cs, const float* __restrict__ ss, long long pairs, int n_beams,
    int k_total, int h, int w, float step, float* __restrict__ hit_dist,
    bool* __restrict__ hit_any, int* __restrict__ steps) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * (kMarchThreads / kWarp) + threadIdx.x / kWarp;
  if (pair >= pairs) return;  // the whole warp
  const long long n = pair / n_beams;
  const Ray r = make_ray(xs[n], ys[n], cs[pair], ss[pair], step, h, w);
  const uint8_t* map = maps + n * static_cast<long long>(h) * w;
  bool inb;
  const int cell0 = step_cell(r, -1, &inb);
  int carry = cell0, hit = -1, marched = k_total;
  for (int k0 = 0; k0 < k_total; k0 += kWarp) {
    const Round rd = march_round(r, k0, k_total, &carry);
    const bool occupied = rd.processed && rd.cell != cell0 && __ldg(map + rd.cell) < 128;
    const unsigned hits = __ballot_sync(kFull, occupied);
    if (hits) {
      hit = k0 + __ffs(hits) - 1;
      marched = hit + 1;
      break;
    }
    if (rd.live < kWarp) {
      marched = k0 + rd.live;
      break;
    }
  }
  if ((threadIdx.x & (kWarp - 1)) != 0) return;
  hit_dist[pair] = __fmul_rn(__fadd_rn(static_cast<float>(hit < 0 ? 0 : hit), 1.0f), step);
  hit_any[pair] = hit >= 0;
  if (steps != nullptr) steps[pair] = marched;
}

// The occupied cell of one beam, or -1.
__device__ int occupied_cell(const Ray& r, int cell0, float z, float step, int k_total,
                             float max_dist) {
  if (!(z < max_dist)) return -1;
  // The first step with d >= z: d = (k + 1) * step rises with k, so start
  // a margin below z / step and walk up.
  int k = 0;
  if (!(__fmul_rn(1.0f, step) >= z)) {
    const float g = floorf(__fdiv_rn(z, step)) - 3.0f;
    k = g < 0.0f ? 0 : (g > static_cast<float>(k_total) ? k_total : static_cast<int>(g));
    while (k < k_total && !(__fmul_rn(static_cast<float>(k + 1), step) >= z)) ++k;
  }
  if (k >= k_total) return -1;
  bool inb;
  step_cell(r, 0, &inb);
  if (!inb) return -1;  // no step is processed
  int prev = step_cell(r, k - 1, &inb);
  for (; k < k_total; ++k) {
    const int cell = step_cell(r, k, &inb);
    if (!inb) return -1;
    if (cell != prev) return cell;
    prev = cell;
  }
  return -1;
}

__device__ __forceinline__ unsigned slot_of(int cell, int bits) {
  return (static_cast<unsigned>(cell) * 2654435761u) >> (32 - bits);
}

__global__ void __launch_bounds__(kWriteThreads) rbpf_write_kernel(
    const uint8_t* __restrict__ maps, uint8_t* __restrict__ out, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ cs, const float* __restrict__ ss,
    const float* __restrict__ dists, int n_beams, int k_total, int h, int w, float step,
    float max_dist, float occ_scale, float free_scale, int bits) {
  extern __shared__ int smem[];
  const int slots = 1 << bits;
  int* occ = smem;              // [n_beams]: the beam's occupied cell or -1
  int* keys = occ + n_beams;    // [slots]: a cell or -1
  int* owner = keys + slots;    // [slots]: the highest beam occupying it
  const long long n = blockIdx.x;
  const long long base = n * static_cast<long long>(h) * w;
  const float x = xs[n], y = ys[n];
  const Ray r0 = make_ray(x, y, 1.0f, 0.0f, step, h, w);
  bool inb;
  const int cell0 = step_cell(r0, -1, &inb);

  for (int b = threadIdx.x; b < n_beams; b += blockDim.x) {
    const long long row = n * n_beams + b;
    occ[b] = occupied_cell(make_ray(x, y, cs[row], ss[row], step, h, w), cell0, dists[b], step,
                           k_total, max_dist);
  }
  for (int t = threadIdx.x; t < slots; t += blockDim.x) keys[t] = -1;
  __syncthreads();

  for (int b = threadIdx.x; b < n_beams; b += blockDim.x) {
    const int c = occ[b];
    if (c >= 0) out[base + c] = u8_update(maps[base + c], occ_scale);
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < n_beams; ++b) {
      const int c = occ[b];
      if (c < 0) continue;
      unsigned t = slot_of(c, bits);
      while (keys[t] != -1 && keys[t] != c) t = (t + 1) & (slots - 1);
      keys[t] = c;
      owner[t] = b;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  for (int b = warp; b < n_beams; b += kWriteThreads / kWarp) {
    const long long row = n * n_beams + b;
    const Ray r = make_ray(x, y, cs[row], ss[row], step, h, w);
    const float z = dists[b];
    const float zz = __fmul_rn(z, z);
    int carry = cell0;
    for (int k0 = 0; k0 < k_total; k0 += kWarp) {
      const Round rd = march_round(r, k0, k_total, &carry);
      const float d = __fmul_rn(static_cast<float>(k0 + lane + 1), step);
      const bool free = __fmul_rn(d, d) < zz;
      if (rd.processed && free) {
        unsigned t = slot_of(rd.cell, bits);
        int later = -1;
        for (int key = keys[t]; key != -1; key = keys[t]) {
          if (key == rd.cell) {
            later = owner[t];
            break;
          }
          t = (t + 1) & (slots - 1);
        }
        if (later < b) out[base + rd.cell] = u8_update(maps[base + rd.cell], free_scale);
      }
      // d * d < z * z holds for a prefix of the steps.
      if (rd.live < kWarp || !__all_sync(kFull, free)) break;
    }
  }
}

int table_bits(int n_beams) {
  int bits = 6;
  while ((1 << bits) < 2 * n_beams) ++bits;
  return bits;
}

}  // namespace

extern "C" int rbpf_march_launch(const void* maps, const void* x, const void* y, const void* c,
                                 const void* s, long long n, int n_beams, int k_total, int h,
                                 int w, float step, void* hit_dist, void* hit_any, void* steps,
                                 void* stream) {
  if (n <= 0 || n_beams <= 0 || n_beams > kMaxBeams || k_total <= 0 || k_total > kMaxSteps ||
      h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pairs = n * n_beams;
  const long long per_block = kMarchThreads / kWarp;
  const unsigned grid = static_cast<unsigned>((pairs + per_block - 1) / per_block);
  rbpf_march_kernel<<<grid, kMarchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maps), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(c), static_cast<const float*>(s),
      pairs, n_beams, k_total, h, w, step, static_cast<float*>(hit_dist),
      static_cast<bool*>(hit_any), static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rbpf_write_launch(const void* maps, void* out, const void* x, const void* y,
                                 const void* c, const void* s, const void* dists, long long n,
                                 int n_beams, int k_total, int h, int w, float step,
                                 float max_dist, float occ_scale, float free_scale,
                                 void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || n_beams <= 0 || n_beams > kMaxBeams || k_total <= 0 ||
      k_total > kMaxSteps || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bits = table_bits(n_beams);
  const size_t smem = (static_cast<size_t>(n_beams) + 2 * (static_cast<size_t>(1) << bits)) *
                      sizeof(int);
  rbpf_write_kernel<<<static_cast<unsigned>(n), kWriteThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maps), static_cast<uint8_t*>(out),
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(c),
      static_cast<const float*>(s), static_cast<const float*>(dists), n_beams, k_total, h, w,
      step, max_dist, occ_scale, free_scale, bits);
  return static_cast<int>(cudaGetLastError());
}
