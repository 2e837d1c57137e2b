// Fused odometry motion-model sampling on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   slam_tpu/ops/motion_pallas.py:sample_motion_model_odometry_pallas
//   (body `_kernel`, helpers `_uniform01` and `_normal_pair`).
// Plain PyTorch version: slam_tpu_torch/ops/motion.py:sample_motion_model_odometry.
//
// What it computes: motion_odometry.cuh:sample_odometry for each particle
// (Philox4x32-10 noise, Box-Muller normals, the integrated and wrapped
// pose). The MCL step's fused kernel (lut_weights.cu) runs the same
// function in its prologue.
//
// What bounds it: device memory. Each particle reads 12 B and writes 12 B;
// the ~10 transcendentals per particle are far below the card's FP32 rate.
// So the design is one thread per particle, no shared memory, coalesced
// 4 B loads and stores, a bounds check in place of the TPU's padding to
// 256x128 tiles, and the seed read from device memory so the caller never
// syncs with the host to draw it.
//
// `i0` is the global index of the launch's first particle: particle i
// draws Philox counter i0 + i. A rank that holds particles [i0, i0 + n)
// of a sharded filter and the filter's seed so draws exactly what the
// unsharded launch draws for them (slam_tpu_torch/parallel/).

#include <cuda_runtime.h>
#include <stdint.h>

#include "motion_odometry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) motion_odometry_kernel(
    const long long* __restrict__ seed, slam_motion::OdomParams mp,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ th, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oth, long long n, long long i0) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  slam_motion::sample_odometry(static_cast<unsigned long long>(seed[0]), i0 + i,
                               mp, x[i], y[i], th[i], ox + i, oy + i, oth + i);
}

}  // namespace

extern "C" int motion_odometry_launch(const void* seed, float r1, float t,
                                      float r2, float std_r1, float std_t,
                                      float std_r2, const void* x,
                                      const void* y, const void* th, void* ox,
                                      void* oy, void* oth, long long n,
                                      long long i0, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const slam_motion::OdomParams mp{r1, t, r2, std_r1, std_t, std_r2};
  motion_odometry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), mp, static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(th),
      static_cast<float*>(ox), static_cast<float*>(oy),
      static_cast<float*>(oth), n, i0);
  return static_cast<int>(cudaGetLastError());
}
