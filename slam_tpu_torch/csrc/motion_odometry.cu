// Odometry motion-model sampling on Hopper (sm_90a), for one filter or a
// fleet of R filters in one launch.
//
// Replaces the TPU Pallas kernel
//   slam_tpu/ops/motion_pallas.py:sample_motion_model_odometry_pallas
//   (body `_kernel`, helpers `_uniform01` and `_normal_pair`).
// Plain PyTorch version: slam_tpu_torch/ops/motion.py:sample_motion_model_odometry.
//
// What it computes: motion_odometry.cuh's sampler for each particle
// (Philox4x32-10 noise, Box-Muller normals, the integrated and wrapped
// pose). The MCL step's fused kernel (lut_weights.cu) runs the same
// sampler in its prologue, so the two give the same poses bit for bit.
//
// A launch samples R rows of n particles: poses [R, n] (R = 1 for a single
// filter), seed int64 [R], odometry f32 [R, 3] (rot1, trans, rot2), both
// read from device memory, as the TPU kernel reads its parameters from a
// ref (motion_pallas.py:88-97), so the caller never syncs with the host
// and a CUDA graph of a step replays with each step's odometry. Row r is
// robot r of a fleet (models/fleet.py): gridDim.y = R, as lut_weights.cu
// lays out its robot axis, and particle i of every row draws Philox
// counter i0 + i, so robot r's poses equal a one-robot launch with its
// seed. `i0` is the global index of the launch's first particle: a rank
// that holds particles [i0, i0 + n) of a sharded filter (slam_tpu_torch/
// parallel/) draws what the unsharded launch draws for them.
//
// What bounds it. Each particle reads 12 B and writes 12 B (0.0072 ms for
// 1M particles at 3.35 TB/s) and issues ~250 instructions at 4 particles
// a thread, ~320 at one (`cuobjdump -sass`): Philox's 10 rounds, two
// logs, two square roots, three sin/cos reductions and the wrap's IEEE
// divide. Issuing them takes about as long as the bytes take to move,
// and the previous design (one particle a thread) left the card idle
// between the dependent steps of each chain.
// tools/motion_ab.py measured each lever against that design in turns
// (PERF.md section 6); what won:
//   - the Box-Muller math without libdevice's branches for arguments the
//     uniforms never give (motion_odometry.cuh, kBranchFree: the same bits
//     on all 2^24 uniforms, motion_odometry_math_check): in straight-line
//     code the compiler interleaves the chains of a thread's particles;
//   - from 2^18 particles a launch, 4 particles a thread, loaded before any
//     arithmetic; where the six fields share their offset from a 16 B
//     boundary (the launcher checks), consecutive particles as one 16 B
//     load or store a field, a row's head and tail (< 4 particles each:
//     a fleet row of 100,003, a shard at i0) on two threads of their own;
//     otherwise a block's tile of 4 x 128 particles strided by 128, each
//     access coalesced. Below 2^18 (one wave at one particle a thread),
//     one particle a thread finishes first;
//   - blocks of 128 threads;
//   - thread 0 derives the stddevs from its row's odometry with
//     slam_motion::odom_params into shared memory while the block draws its
//     normals; a barrier, then every thread applies them. Every thread
//     deriving them itself, with no barrier, issued ~50 more instructions
//     a thread and ran 2-10% slower from 100k particles up.

#include <cuda_runtime.h>
#include <stdint.h>

#include "motion_odometry.cuh"

namespace {

constexpr int kThreads = 128;
// From this many particles a launch, 4 a thread.
constexpr long long kFourFrom = 1LL << 18;

// One row's six fields.
struct Row {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ th;
  float* __restrict__ ox;
  float* __restrict__ oy;
  float* __restrict__ oth;
};

// A thread's kPer particles: their row indices (n for none) and poses.
template <int kPer>
struct Group {
  long long idx[kPer];
  float x[kPer], y[kPer], h[kPer];
};

__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void store4(float* __restrict__ p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Loads this thread's group of the row. kVec (kPer = 4): item t of the row
// is the 4 particles from head + 4 t, one 16 B vector a field (t < body);
// item body is the row's head and item body + 1 its tail. Otherwise the
// block's tile of kPer x kThreads particles, strided by kThreads. A scalar
// group's dead particles load particle n - 1. Returns whether the group is
// a vector.
template <int kPer, bool kVec>
__device__ __forceinline__ bool load_group(const Row& row, long long n, Group<kPer>& g) {
  if constexpr (kVec) {
    static_assert(kPer == 4, "vector groups are 16 B");
    const long long head = min(
        n, static_cast<long long>((0u - (reinterpret_cast<uintptr_t>(row.x) >> 2)) & 3u));
    const long long body = (n - head) / 4;
    const long long tail = head + body * 4;
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (t < body) {
      const long long p = head + t * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) g.idx[j] = p + j;
      load4(row.x + p, g.x);
      load4(row.y + p, g.y);
      load4(row.th + p, g.h);
      return true;
    }
    const long long first = t == body ? 0 : tail;
    const long long end = t == body ? head : t == body + 1 ? n : tail;
#pragma unroll
    for (int j = 0; j < kPer; ++j) g.idx[j] = first + j < end ? first + j : n;
  } else {
    const long long base = static_cast<long long>(blockIdx.x) * kThreads * kPer + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long k = base + j * kThreads;
      g.idx[j] = k < n ? k : n;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long k = g.idx[j] < n ? g.idx[j] : n - 1;
    g.x[j] = row.x[k];
    g.y[j] = row.y[k];
    g.h[j] = row.th[k];
  }
  return false;
}

// Block row r = robot r; each thread samples one group.
template <int kPer, bool kVec>
__global__ void __launch_bounds__(kThreads) motion_odometry_kernel(
    const long long* __restrict__ seed, const float* __restrict__ odo,
    slam_motion::Alphas al, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ th, float* __restrict__ ox, float* __restrict__ oy,
    float* __restrict__ oth, long long n, long long i0) {
  __shared__ slam_motion::OdomParams shared_mp;
  const long long r = blockIdx.y;
  const Row row{x + r * n, y + r * n, th + r * n, ox + r * n, oy + r * n, oth + r * n};
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
  if (threadIdx.x == 0) {
    o0 = odo[3 * r];
    o1 = odo[3 * r + 1];
    o2 = odo[3 * r + 2];
  }
  const unsigned long long s = static_cast<unsigned long long>(seed[r]);
  Group<kPer> g;
  const bool vec = load_group<kPer, kVec>(row, n, g);
  slam_motion::Noise nz[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) nz[j] = slam_motion::odometry_noise<true>(s, i0 + g.idx[j]);
  if (threadIdx.x == 0) shared_mp = slam_motion::odom_params(o0, o1, o2, al);
  __syncthreads();
  const slam_motion::OdomParams mp = shared_mp;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    slam_motion::apply_odometry(mp, nz[j], g.x[j], g.y[j], g.h[j], &g.x[j], &g.y[j], &g.h[j]);
  }
  if constexpr (kVec) {
    if (vec) {
      store4(row.ox + g.idx[0], g.x);
      store4(row.oy + g.idx[0], g.y);
      store4(row.oth + g.idx[0], g.h);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (g.idx[j] < n) {
      row.ox[g.idx[j]] = g.x[j];
      row.oy[g.idx[j]] = g.y[j];
      row.oth[g.idx[j]] = g.h[j];
    }
  }
}

template <int kPer, bool kVec>
cudaError_t launch(const long long* seed, const float* odo, const slam_motion::Alphas& al,
                   const float* x, const float* y, const float* th, float* ox, float* oy,
                   float* oth, long long n, long long i0, int n_robots, cudaStream_t stream) {
  const long long items = kVec ? n / kPer + 2 : (n + kPer - 1) / kPer;
  const dim3 grid(static_cast<unsigned>((items + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_robots));
  motion_odometry_kernel<kPer, kVec><<<grid, kThreads, 0, stream>>>(seed, odo, al, x, y, th, ox,
                                                                     oy, oth, n, i0);
  return cudaGetLastError();
}

// The branch-free forms of motion_odometry.cuh against libdevice's, on
// every uniform u the sampler can draw (the 2^24 values (b + 1) / 2^24):
// mismatches[0] log_normal(u) != logf(u), [1] sqrt_nonneg != sqrtf of
// -2 logf(u), [2] sincos_small != sincosf and [3] cos_small != cosf of
// 2 pi u, each in any bit.
__global__ void noise_math_check_kernel(unsigned long long* mismatches) {
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < (1u << 24);
       b += gridDim.x * blockDim.x) {
    const float u = slam_motion::uniform01(b << 8);
    const float lg = logf(u);
    const float x = __fmul_rn(-2.0f, lg);
    const float a = __fmul_rn(slam_motion::kTwoPi, u);
    float s0, c0, s1, c1;
    sincosf(a, &s0, &c0);
    slam_motion::sincos_small(a, &s1, &c1);
    const bool bad[4] = {
        __float_as_uint(slam_motion::log_normal(u)) != __float_as_uint(lg),
        __float_as_uint(slam_motion::sqrt_nonneg(x)) != __float_as_uint(sqrtf(x)),
        __float_as_uint(s0) != __float_as_uint(s1) || __float_as_uint(c0) != __float_as_uint(c1),
        __float_as_uint(slam_motion::cos_small(a)) != __float_as_uint(cosf(a))};
    for (int k = 0; k < 4; ++k) {
      if (bad[k]) atomicAdd(mismatches + k, 1ull);
    }
  }
}

}  // namespace

// seed: int64 [R]; odo: f32 [R, 3] (rot1, trans, rot2), both on the
// device; a0-a3: the motion model's alphas; poses and outputs f32 [R, n],
// contiguous.
extern "C" int motion_odometry_launch(const void* seed, const void* odo,
                                      float a0, float a1, float a2, float a3,
                                      const void* x, const void* y,
                                      const void* th, void* ox, void* oy,
                                      void* oth, long long n, long long i0,
                                      int n_robots, void* stream) {
  if (n <= 0 || n_robots <= 0) return 0;
  const slam_motion::Alphas al{a0, a1, a2, a3};
  const auto* sd = static_cast<const long long*>(seed);
  const auto* od = static_cast<const float*>(odo);
  const auto* px = static_cast<const float*>(x);
  const auto* py = static_cast<const float*>(y);
  const auto* ph = static_cast<const float*>(th);
  auto* qx = static_cast<float*>(ox);
  auto* qy = static_cast<float*>(oy);
  auto* qh = static_cast<float*>(oth);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * n_robots < kFourFrom) {
    return static_cast<int>(launch<1, false>(sd, od, al, px, py, ph, qx, qy, qh, n, i0,
                                             n_robots, s));
  }
  // 16 B vectors need the six fields at one offset from a 16 B boundary;
  // then every row is too.
  const uintptr_t ux = reinterpret_cast<uintptr_t>(x);
  const uintptr_t apart = (ux ^ reinterpret_cast<uintptr_t>(y)) |
                          (ux ^ reinterpret_cast<uintptr_t>(th)) |
                          (ux ^ reinterpret_cast<uintptr_t>(ox)) |
                          (ux ^ reinterpret_cast<uintptr_t>(oy)) |
                          (ux ^ reinterpret_cast<uintptr_t>(oth));
  return static_cast<int>(
      (apart & 15u) == 0
          ? launch<4, true>(sd, od, al, px, py, ph, qx, qy, qh, n, i0, n_robots, s)
          : launch<4, false>(sd, od, al, px, py, ph, qx, qy, qh, n, i0, n_robots, s));
}

// Counts into mismatches (u64 [4] on the device, zeroed by the caller)
// the uniforms on which a branch-free form differs from libdevice's
// (noise_math_check_kernel).
extern "C" int motion_odometry_math_check(void* mismatches, void* stream) {
  noise_math_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
