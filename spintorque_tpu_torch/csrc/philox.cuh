// Philox4x32-10 counter-based generator and the thermal-noise sampler of the
// pulse kernel (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC11). Bit for bit the stream of spintorque_tpu_torch/ops/philox.py:
// uniforms by the 23-bit mantissa rule, exact Box-Muller with u1 in (0, 1],
// and (cos, sin) of 2 pi u2 by quadrant fold + Cephes polynomials. Every
// floating constant is written as a double cast to float, the rounding that
// PyTorch applies to a Python float operand of a float32 tensor.
#pragma once

#include <stdint.h>

namespace spintorque {

struct Words4 {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Words4 philox4x32_10(Words4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.w0);
    const uint32_t lo0 = 0xD2511F53u * c.w0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.w2);
    const uint32_t lo1 = 0xCD9E8D57u * c.w2;
    c = Words4{hi1 ^ c.w1 ^ k0, lo1, hi0 ^ c.w3 ^ k1, lo0};
  }
  return c;
}

__device__ __forceinline__ float uniform_from_bits(uint32_t w) {
  return __int_as_float(static_cast<int>((w & 0x7FFFFFu) | 0x3F800000u)) - 1.0f;
}

__device__ __forceinline__ void cos_sin_2pi(float u, float& c, float& s) {
  const float q = u * 4.0f;
  const float k = floorf(q + 0.5f);
  const float x = (q - k) * (float)(0.5 * 3.14159265358979323846);  // |x| <= pi/4
  const float z = x * x;
  const float cp = (((float)2.443315711809948e-5 * z - (float)1.388731625493765e-3) * z +
                    (float)4.166664568298827e-2) * (z * z) - 0.5f * z + 1.0f;
  const float sp = ((((float)-1.9515295891e-4 * z + (float)8.3321608736e-3) * z -
                     (float)1.6666654611e-1) * z) * x + x;
  const int kb = static_cast<int>(k) & 3;
  const bool swap = (kb & 1) == 1;
  c = swap ? sp : cp;
  s = swap ? cp : sp;
  if (kb == 1 || kb == 2) c = -c;
  if (kb == 2 || kb == 3) s = -s;
}

__device__ __forceinline__ void normal_pair(uint32_t w1, uint32_t w2, float& a, float& b) {
  const float u1 = 1.0f - uniform_from_bits(w1);  // (0, 1]: safe for log
  const float u2 = uniform_from_bits(w2);
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  cos_sin_2pi(u2, c, s);
  a = r * c;
  b = r * s;
}

// The four normals of draw `draw` of env `env` at substep `step`:
// counter (env, step, draw, 0), key (seed_lo, seed_hi).
__device__ __forceinline__ void normals4(uint32_t env, uint32_t step, uint32_t draw,
                                         uint32_t seed_lo, uint32_t seed_hi, float out[4]) {
  const Words4 w = philox4x32_10(Words4{env, step, draw, 0u}, seed_lo, seed_hi);
  normal_pair(w.w0, w.w1, out[0], out[1]);
  normal_pair(w.w2, w.w3, out[2], out[3]);
}

}  // namespace spintorque
