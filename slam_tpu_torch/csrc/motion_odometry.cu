// Fused odometry motion-model sampling on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   slam_tpu/ops/motion_pallas.py:sample_motion_model_odometry_pallas
//   (body `_kernel`, helpers `_uniform01` and `_normal_pair`).
// Plain PyTorch version: slam_tpu_torch/ops/motion.py:sample_motion_model_odometry.
//
// What it computes, per particle i:
//   1. Philox4x32-10 with key = the 64-bit seed and counter = (i, 0, 0, 0)
//      gives 4 x u32.
//   2. Each u32 becomes a (0, 1] uniform from its top 24 bits, (u + 1) / 2^24,
//      so log() never sees 0 (motion_pallas.py:32-39).
//   3. Two Box-Muller pairs; three normals are kept (motion_pallas.py:62-63).
//   4. rot1, trans, rot2 are perturbed with the alpha-mixed stddevs, which
//      the host computes once (motion_pallas.py:88-97), and x, y, theta are
//      integrated. theta is wrapped to [-pi, pi) here with a floored
//      modulo, which the Pallas version leaves to a second pass.
//
// What bounds it: device memory. Each particle reads 12 B and writes 12 B;
// the ~10 transcendentals per particle are far below the card's FP32 rate.
// So the design is one thread per particle, no shared memory, coalesced
// 4 B loads and stores, a bounds check in place of the TPU's padding to
// 256x128 tiles, and the seed read from device memory so the caller never
// syncs with the host to draw it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;

// Philox4x32 with 10 rounds (Salmon et al., SC'11), standard constants.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// (0, 1] uniform from the top 24 bits: exact in float32.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return (static_cast<float>(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads) motion_odometry_kernel(
    const long long* __restrict__ seed, float r1, float t, float r2,
    float std_r1, float std_t, float std_r2, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ th,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oth,
    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  const uint4 bits = philox4x32_10(
      make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, 0u),
      make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)));

  const float rad_a = sqrtf(-2.0f * logf(uniform01(bits.x)));
  const float ang_a = kTwoPi * uniform01(bits.y);
  const float rad_b = sqrtf(-2.0f * logf(uniform01(bits.z)));
  const float ang_b = kTwoPi * uniform01(bits.w);
  float sin_a, cos_a;
  sincosf(ang_a, &sin_a, &cos_a);
  const float n1 = rad_a * cos_a;
  const float n2 = rad_a * sin_a;
  const float n3 = rad_b * cosf(ang_b);

  const float rot1 = r1 - n1 * std_r1;
  const float trans = t - n2 * std_t;
  const float rot2 = r2 - n3 * std_r2;

  const float h = th[i];
  float sin_h, cos_h;
  sincosf(h + rot1, &sin_h, &cos_h);
  ox[i] = x[i] + trans * cos_h;
  oy[i] = y[i] + trans * sin_h;
  // Floored modulo (jnp.mod / torch.remainder semantics), not fmodf.
  const float a = h + rot1 + rot2 + kPi;
  oth[i] = a - kTwoPi * floorf(a / kTwoPi) - kPi;
}

}  // namespace

extern "C" int motion_odometry_launch(const void* seed, float r1, float t,
                                      float r2, float std_r1, float std_t,
                                      float std_r2, const void* x,
                                      const void* y, const void* th, void* ox,
                                      void* oy, void* oth, long long n,
                                      void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  motion_odometry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), r1, t, r2, std_r1, std_t, std_r2,
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(th), static_cast<float*>(ox),
      static_cast<float*>(oy), static_cast<float*>(oth), n);
  return static_cast<int>(cudaGetLastError());
}
