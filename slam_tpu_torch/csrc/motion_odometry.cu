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
// So the design is one thread per particle, coalesced 4 B loads and
// stores, a bounds check in place of the TPU's padding to 256x128 tiles,
// and the seed and the odometry read from device memory, as the TPU kernel
// reads its parameters from a ref (motion_pallas.py:88-97): the caller
// never syncs with the host to draw the seed, and a CUDA graph of a filter
// step replays with each step's odometry. Thread 0 of each block derives
// the stddevs from the odometry row with slam_motion::odom_params into
// shared memory while the block loads its poses and draws its normals, as
// the fused kernel's prologue derives them (lut_weights.cu), one rounded
// operation at a time, so they equal ops/motion_cuda.py:host_params bit
// for bit.
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
    const long long* __restrict__ seed, const float* __restrict__ odo,
    slam_motion::Alphas al, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ th, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oth, long long n, long long i0) {
  // The stddevs once a block: thread 0 derives them into shared memory
  // while every thread loads its pose and draws its normals, then the
  // block reads them.
  __shared__ slam_motion::OdomParams mp;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
  if (threadIdx.x == 0) {
    o0 = odo[0];
    o1 = odo[1];
    o2 = odo[2];
  }
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;
  slam_motion::Noise nz{};
  float xi = 0.0f, yi = 0.0f, hi = 0.0f;
  if (live) {
    xi = x[i];
    yi = y[i];
    hi = th[i];
    nz = slam_motion::odometry_noise(static_cast<unsigned long long>(seed[0]), i0 + i);
  }
  if (threadIdx.x == 0) mp = slam_motion::odom_params(o0, o1, o2, al);
  __syncthreads();
  if (!live) return;
  slam_motion::apply_odometry(mp, nz, xi, yi, hi, ox + i, oy + i, oth + i);
}

}  // namespace

// seed: int64 [1]; odo: f32 [3] (rot1, trans, rot2), both on the device;
// a0-a3: the motion model's alphas.
extern "C" int motion_odometry_launch(const void* seed, const void* odo,
                                      float a0, float a1, float a2, float a3,
                                      const void* x, const void* y,
                                      const void* th, void* ox, void* oy,
                                      void* oth, long long n, long long i0,
                                      void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const slam_motion::Alphas al{a0, a1, a2, a3};
  motion_odometry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<const float*>(odo), al,
      static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(th),
      static_cast<float*>(ox), static_cast<float*>(oy),
      static_cast<float*>(oth), n, i0);
  return static_cast<int>(cudaGetLastError());
}
