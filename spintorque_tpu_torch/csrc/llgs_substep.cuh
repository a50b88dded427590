// Per-substep arithmetic of the LLGS pulse kernel (csrc/pulse_integrator.cu):
// the right-hand side, one Euler / stochastic Heun / RK4 substep with its
// normalize-with-fallback, and the thermal field of one substep. Nothing here
// knows of threads, warps or shared memory: the kernel's scheduling lives
// apart from these functions.
//
// Each function mirrors the op order of the plain version
// (spintorque_tpu_torch/physics/integrator.py and physics/llgs.py), so that
// kernel and plain version agree bit for bit. Four rewrites differ in form
// from the plain version and not in value:
//
//  * The +z right-hand side multiplies by no axis component, so it drops the
//    general form's products by the axis's +0 components. Those are zeros,
//    and they can change only the sign of a result that is a zero; such a
//    sign reaches the new state only through a component that is -0 (+0
//    plus a zero is +0 whatever the zero's sign), and not from the zero row
//    (every form falls back to +z). A block of substeps in which one began
//    from a state where the signs matter runs again in the general form
//    (integrate_block). tests/test_torch_rhs_signs.py compiles the
//    substeps for the host and holds the blocks to the general form bit for
//    bit.
//  * The new state's subnormal flush is one multiply by 1 under
//    flush-to-zero (flush_finite): for the finite values it gets, the
//    plain version's compare and select of a zero of x's sign.
//  * RK4's halving k / 2 is written kHalf * k (0.5 * k): both are the exact
//    scaling of k, rounded once (and torch's CUDA division by a Python scalar
//    multiplies by its reciprocal, here exact, anyway).
//  * RK4's x / 6 is div6(x): q = RN(x * RN(1/6)), the exact remainder
//    r = fma(-6, q, x), then RN(q + r * RN(1/6)) (Markstein's correction for
//    a divisor known in advance). For 0, inf and NaN the product alone is
//    the quotient (the correction would turn -0 into +0 and inf into NaN).
//    That this equals the IEEE quotient x / 6.0f for every one of the 2^32
//    float32 inputs is checked exhaustively on the card by
//    spintorque_check_div6 (chip_smoke.py); the chain loses the division's
//    subroutine and its slow-path branch.
//
// K6's stage ops (T = Bf16) are Hopper's native bf16 instructions, one each:
// add.rn.bf16, sub.rn.bf16 and mul.rn.bf16 for +, - and * (the scalars 0.5
// and 2 enter as the exact bf16 constants kHalf and kTwo), neg.bf16 for
// unary minus. PyTorch
// computes a bf16 op as the float op rounded once to bf16 (bf16_*_f32); the
// native op rounds the exact result once. The two agree: a product of two
// bf16 values is exact in float, and a float sum is exact unless the smaller
// operand lies far below the bf16 rounding boundary, where one rounding and
// two give the same bf16. Subnormals and the sign of zero are where that
// argument could fail, so it is checked on the card over every input:
// spintorque_check_bf16_ops (pulse_integrator.cu, run by chip_smoke.py)
// compares each native op with its float form on all 2^32 ordered pairs
// (add, sub, mul) and all 2^16 inputs (neg, x 0.5, x 2), bit for bit with
// only two NaNs counted equal. Every stage op is native; none failed the
// check on an H100, so none is emulated. Still in float: the rounding of the
// state into T, the widening of the increment, div6 (no bf16 division:
// widen, the float div6, round, as torch divides) and the thermal field's
// rounding. No fused bf16 multiply-add, nor cuda_bf16.h's operators, which
// ptxas may contract into one: it rounds once where PyTorch rounds twice
// (the check's control op, which must differ, shows that on the card).
//
// normalize_with_fallback drops the plain version's second finiteness test
// (ok & isfinite(m / norm)), which can never change the result: when ok
// holds, x, y and z are finite and norm = RN(sqrt(s)) >= 1e-12 with
// s = RN(RN(RN(x^2) + RN(y^2)) + RN(z^2)). Rounding to nearest is monotone, so
// s >= RN(x^2), and sqrt is monotone, so norm >= RN(sqrt(RN(x^2))). Then
//   - if RN(x^2) is inf (|x| > ~1.8e19), s and norm are inf and x / norm = 0;
//   - if RN(x^2) is a normal float, norm >= |x| (1 - 2^-23), so |x / norm|
//     <= 1 + 2^-22;
//   - else |x| < 2^-63 and |x / norm| < 2^-63 / 1e-12 < 1.
// x / norm is never NaN (x finite, norm nonzero), so it is finite, and the
// same holds for y and z.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

namespace spintorque {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// A bf16 value; each operation is a PyTorch bf16 op: the float op, rounded
// once to nearest even.
struct Bf16 {
  __nv_bfloat16 v;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(Bf16 x) { return __bfloat162float(x.v); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ Bf16 from_f32<Bf16>(float x) {
  return Bf16{__float2bfloat16_rn(x)};
}

// PyTorch's bf16 ops as it computes them: widen, the float op, round.
__device__ __forceinline__ Bf16 bf16_add_f32(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) + to_f32(b));
}
__device__ __forceinline__ Bf16 bf16_sub_f32(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) - to_f32(b));
}
__device__ __forceinline__ Bf16 bf16_mul_f32(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) * to_f32(b));
}
__device__ __forceinline__ Bf16 bf16_neg_f32(Bf16 a) { return from_f32<Bf16>(-to_f32(a)); }

__device__ __forceinline__ unsigned short bf16_bits(Bf16 a) { return __bfloat16_as_ushort(a.v); }
__device__ __forceinline__ Bf16 bf16_from_bits(unsigned short b) {
  return Bf16{__ushort_as_bfloat16(b)};
}

// The same ops as one Hopper (sm_90) instruction each: the stage ops of
// T = Bf16. The explicit .rn rounds the exact result once and keeps ptxas
// from contracting a multiply and an add into an FMA.
__device__ __forceinline__ Bf16 bf16_add_rn(Bf16 a, Bf16 b) {
  unsigned short r;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(bf16_bits(a)), "h"(bf16_bits(b)));
  return bf16_from_bits(r);
}
__device__ __forceinline__ Bf16 bf16_sub_rn(Bf16 a, Bf16 b) {
  unsigned short r;
  asm("sub.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(bf16_bits(a)), "h"(bf16_bits(b)));
  return bf16_from_bits(r);
}
__device__ __forceinline__ Bf16 bf16_mul_rn(Bf16 a, Bf16 b) {
  unsigned short r;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(bf16_bits(a)), "h"(bf16_bits(b)));
  return bf16_from_bits(r);
}
__device__ __forceinline__ Bf16 bf16_neg_rn(Bf16 a) {
  unsigned short r;
  asm("neg.bf16 %0, %1;" : "=h"(r) : "h"(bf16_bits(a)));
  return bf16_from_bits(r);
}

__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) { return bf16_add_rn(a, b); }
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) { return bf16_sub_rn(a, b); }
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) { return bf16_mul_rn(a, b); }
__device__ __forceinline__ Bf16 operator-(Bf16 a) { return bf16_neg_rn(a); }

// x / 6.0f, bit for bit (see the note at the top).
__device__ __forceinline__ float div6(float x) {
  const float sixth = (float)(1.0 / 6.0);
  const float q = x * sixth;
  const float r = __fmaf_rn(-6.0f, q, x);
  const float q1 = __fmaf_rn(r, sixth, q);
  // 0, inf or NaN: the product is the quotient.
  const bool special = x == 0.0f || !(fabsf(x) <= 3.40282347e38f);
  // A tie: x / 6 is exactly halfway between two floats 2^-149 apart, which
  // happens only where the quotient's spacing is 2^-149 (|x| < 2^-125) and
  // then the remainder is exactly 3 * 2^-149. RN(1/6) > 1/6, so q rounded
  // away from zero and q1 toward it; ties go to the even one.
  const bool tie_at_q = fabsf(r) == 0x1.8p-148f && (__float_as_uint(q) & 1u) == 0u;
  return special || tie_at_q ? q : q1;
}
__device__ __forceinline__ Bf16 div6(Bf16 x) { return from_f32<Bf16>(div6(to_f32(x))); }

// x * +0 for a finite x, the zero of x's sign: one bit operation.
__device__ __forceinline__ float zero_of(float x) {
  return __uint_as_float(__float_as_uint(x) & 0x80000000u);
}

template <typename T>
struct Coeffs {
  T h_k, ms, neg_gamma_eff, alpha, stt, ex, ey, ez;
};

// dm/dt with the thermal field (tx, ty, tz); the op order of llgs.dmdt_from.
template <typename T, bool THERMAL, bool PLUS_Z>
__device__ __forceinline__ void rhs(T mx, T my, T mz, T tx, T ty, T tz, const Coeffs<T>& c, T& fx,
                                    T& fy, T& fz) {
  T hx, hy, hz, vx, vy, vz;
  if (PLUS_Z) {
    // e = (0, 0, 1): the projections collapse and the axis loads disappear.
    const T anis = c.h_k * mz;
    hx = from_f32<T>(0.0f);
    hy = from_f32<T>(0.0f);
    hz = anis - c.ms * mz;
    // u = m x z = (my, -mx, 0); v = m x u.
    const T ux = my;
    const T uy = -mx;
    vx = -(mz * uy);
    vy = mz * ux;
    vz = mx * uy - my * ux;
  } else {
    const T m_dot_e = mx * c.ex + my * c.ey + mz * c.ez;
    const T anis = c.h_k * m_dot_e;
    hx = anis * c.ex;
    hy = anis * c.ey;
    hz = anis * c.ez - c.ms * mz;
    const T ux = my * c.ez - mz * c.ey;
    const T uy = mz * c.ex - mx * c.ez;
    const T uz = mx * c.ey - my * c.ex;
    vx = my * uz - mz * uy;
    vy = mz * ux - mx * uz;
    vz = mx * uy - my * ux;
  }
  if (THERMAL) {
    hx = hx + tx;
    hy = hy + ty;
    hz = hz + tz;
  }
  const T px = my * hz - mz * hy;  // precession m x H
  const T py = mz * hx - mx * hz;
  const T pz = mx * hy - my * hx;
  const T dx = my * pz - mz * py;  // damping m x (m x H)
  const T dy = mz * px - mx * pz;
  const T dz = mx * py - my * px;
  fx = c.neg_gamma_eff * (px + c.alpha * dx) + c.stt * vx;
  fy = c.neg_gamma_eff * (py + c.alpha * dy) + c.stt * vy;
  fz = c.neg_gamma_eff * (pz + c.alpha * dz) + c.stt * vz;
}

// NaN/Inf or |m| < 1e-12 maps to +z; true division. No second finiteness
// test: with ok, m / norm is finite (the note at the top). The square root
// and the divisions run only where their result is used: a non-finite m
// takes sqrt(1), and a fallback skips the divisions. Their values where
// used are the plain version's, and the IEEE sequences never see the inf
// or NaN that would send them down their slow paths (at the main config's
// float32 freeze nearly every thermal substep's increment is non-finite).
__device__ __forceinline__ void normalize_with_fallback(float& x, float& y, float& z) {
  const float squares = x * x + y * y + z * z;
  const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
  const float norm = sqrtf(finite ? squares : 1.0f);
  const bool ok = finite && (norm >= (float)1e-12);
  if (ok) {
    x = x / norm;
    y = y / norm;
    z = z / norm;
  } else {
    x = 0.0f;
    y = 0.0f;
    z = 1.0f;
  }
}

// x, or a zero of x's sign where x is a float subnormal (|x| below FLT_MIN),
// as XLA's flush-to-zero gives: one compare, and a select of x's sign bit, as
// the plain version's flush_subnormal. XLA flushes subnormals on the CPU and
// a TPU, and the JAX package's pole states with subnormal transverse
// components stay at the pole; IEEE arithmetic would grow them. An explicit
// select, not -ftz=true, which the plain version cannot mirror. Narrower
// than XLA's flush: only the carried state (XLA flushes every intermediate
// too).
__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < 1.17549435e-38f ? zero_of(x) : x;
}

// flush_subnormal of a finite x in one instruction: x * 1 with the
// multiply's flush-to-zero, which gives a subnormal's zero of its sign
// (PTX's .ftz: "flush to sign-preserving zero") and every other finite x
// itself, exactly; nothing else in the kernel flushes (no -ftz=true). A
// NaN would come back canonical, where flush_subnormal keeps its bits: the
// new state, which is always finite, takes this one; the first, given by
// the caller, flush_subnormal.
__device__ __forceinline__ float flush_finite(float x) {
  float y;
  asm("mul.ftz.f32 %0, %1, 0f3F800000;" : "=f"(y) : "f"(x));
  return y;
}

// One substep of the float state (mx, my, mz) with stage fields h (stage s
// reads h[3s..3s+2]; unused when !THERMAL). The stages read a copy of the
// state in T; the increment is widened and added to the float state, which is
// then normalized and flushed of subnormals. Returns whether the new state is
// the all-zero row.
template <typename T, int METHOD, bool THERMAL, bool PLUS_Z>
__device__ __forceinline__ bool substep(float& mx, float& my, float& mz, const T (&h)[12],
                                        const Coeffs<T>& c, const T dt) {
  const T sx = from_f32<T>(mx);
  const T sy = from_f32<T>(my);
  const T sz = from_f32<T>(mz);
  T dx, dy, dz;
  if (METHOD == kEuler) {
    T fx, fy, fz;
    rhs<T, THERMAL, PLUS_Z>(sx, sy, sz, h[0], h[1], h[2], c, fx, fy, fz);
    dx = dt * fx;
    dy = dt * fy;
    dz = dt * fz;
  } else if (METHOD == kHeun) {
    // Stochastic Heun: the corrector reuses the predictor's noise.
    T fx, fy, fz, gx, gy, gz;
    rhs<T, THERMAL, PLUS_Z>(sx, sy, sz, h[0], h[1], h[2], c, fx, fy, fz);
    rhs<T, THERMAL, PLUS_Z>(sx + dt * fx, sy + dt * fy, sz + dt * fz, h[0], h[1], h[2], c, gx, gy,
                            gz);
    const T kHalf = from_f32<T>(0.5f);
    const T half_dt = kHalf * dt;
    dx = half_dt * (fx + gx);
    dy = half_dt * (fy + gy);
    dz = half_dt * (fz + gz);
  } else {
    const T kHalf = from_f32<T>(0.5f);
    const T kTwo = from_f32<T>(2.0f);
    T k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z, k4x, k4y, k4z;
    rhs<T, THERMAL, PLUS_Z>(sx, sy, sz, h[0], h[1], h[2], c, k1x, k1y, k1z);
    k1x = dt * k1x;
    k1y = dt * k1y;
    k1z = dt * k1z;
    rhs<T, THERMAL, PLUS_Z>(sx + kHalf * k1x, sy + kHalf * k1y, sz + kHalf * k1z, h[3], h[4],
                            h[5], c, k2x, k2y, k2z);
    k2x = dt * k2x;
    k2y = dt * k2y;
    k2z = dt * k2z;
    rhs<T, THERMAL, PLUS_Z>(sx + kHalf * k2x, sy + kHalf * k2y, sz + kHalf * k2z, h[6], h[7],
                            h[8], c, k3x, k3y, k3z);
    k3x = dt * k3x;
    k3y = dt * k3y;
    k3z = dt * k3z;
    rhs<T, THERMAL, PLUS_Z>(sx + k3x, sy + k3y, sz + k3z, h[9], h[10], h[11], c, k4x, k4y, k4z);
    k4x = dt * k4x;
    k4y = dt * k4y;
    k4z = dt * k4z;
    dx = div6(k1x + kTwo * k2x + kTwo * k3x + k4x);
    dy = div6(k1y + kTwo * k2y + kTwo * k3y + k4y);
    dz = div6(k1z + kTwo * k2z + kTwo * k3z + k4z);
  }
  float nx = mx + to_f32(dx);
  float ny = my + to_f32(dy);
  float nz = mz + to_f32(dz);
  normalize_with_fallback(nx, ny, nz);
  nx = flush_finite(nx);
  ny = flush_finite(ny);
  nz = flush_finite(nz);
  mx = nx;
  my = ny;
  mz = nz;
  return nx == 0.0f && ny == 0.0f && nz == 0.0f;
}

// Whether the sign of a zero in a substep from (x, y, z) can reach its new
// state: a component is -0, and the state is not the zero row, from which
// every form falls back to +z alike.
__device__ __forceinline__ bool zero_signs_matter(float x, float y, float z) {
  const uint32_t bx = __float_as_uint(x), by = __float_as_uint(y), bz = __float_as_uint(z);
  const bool negative_zero = bx == 0x80000000u || by == 0x80000000u || bz == 0x80000000u;
  return negative_zero && ((bx | by | bz) << 1) != 0u;
}

// `len` substeps of the kernel, each one's zero row ORed into `failed`.
// start(mx, my, mz, failed) puts the block's first state and flag and
// readies its first fields; fields(j, h) loads substep j's into h. The +z
// right-hand side drops the general form's products by the axis's +0
// components, zeros that can change only the sign of a result that is a
// zero. From a state with no -0 component such a sign never reaches the new
// state: every stage and the new state add an increment to a component of
// the state, and a nonzero component plus a zero, or +0 plus a zero, does
// not depend on the zero's sign; from the zero row every form falls back to
// +z. So on +z the block runs the +z form and notes whether a substep began
// from a state where the signs matter (zero_signs_matter: a -0 component,
// not the zero row, which a frozen env's blow-up makes often, x / inf =
// -0). If one did, it starts again and runs the block in the general form
// with e = (+0, +0, 1), whose zeros carry the plain version's signs. Either
// way the block ends in the general form's state, bit for bit. (Testing the
// new state after each substep instead, beside its zero-row test, ran 2–3%
// slower on an H100: PERF.md.)
template <typename T, int METHOD, bool THERMAL, bool PLUS_Z, typename Start, typename Fields>
__device__ __forceinline__ void integrate_block(float& mx, float& my, float& mz, bool& failed,
                                                int len, T (&h)[12], const Coeffs<T>& c,
                                                const T dt, const Start& start,
                                                const Fields& fields) {
  start(mx, my, mz, failed);
  if constexpr (!PLUS_Z) {
    for (int j = 0; j < len; ++j) {
      fields(j, h);
      failed |= substep<T, METHOD, THERMAL, false>(mx, my, mz, h, c, dt);
    }
  } else {
    bool signs_matter = false;
    for (int j = 0; j < len; ++j) {
      fields(j, h);
      signs_matter |= zero_signs_matter(mx, my, mz);
      failed |= substep<T, METHOD, THERMAL, true>(mx, my, mz, h, c, dt);
    }
    if (signs_matter) {
      start(mx, my, mz, failed);
      for (int j = 0; j < len; ++j) {
        fields(j, h);
        failed |= substep<T, METHOD, THERMAL, false>(mx, my, mz, h, c, dt);
      }
    }
  }
}

// Float4 records of one substep's thermal fields: per-stage RK4 stores the
// 12 normals of three Philox calls (stage s reads 3s..3s+2), every other case
// normals 0..2 of one call in one record (the fourth word unused).
template <bool PER_STAGE>
__host__ __device__ constexpr int records_per_substep() {
  return PER_STAGE ? 3 : 1;
}

// sigma * normal in float, rounded to T and widened back, which is exact; the
// consumer's from_f32<T> of the stored value gives the same T.
template <typename T>
__device__ __forceinline__ float field(float sigma, float g) {
  return to_f32(from_f32<T>(sigma * g));
}

// The thermal records of env `env` at substep `step`: draw d of the substep is
// the Philox counter (env, step, d, 0) under the key (seed_lo, seed_hi).
template <typename T, bool PER_STAGE>
__device__ __forceinline__ void thermal_records(uint32_t env, uint32_t step, uint32_t seed_lo,
                                                uint32_t seed_hi, float sigma,
                                                float4 (&rec)[records_per_substep<PER_STAGE>()]) {
#pragma unroll
  for (int d = 0; d < records_per_substep<PER_STAGE>(); ++d) {
    float g[4];
    normals4(env, step, static_cast<uint32_t>(d), seed_lo, seed_hi, g);
    rec[d] = make_float4(field<T>(sigma, g[0]), field<T>(sigma, g[1]), field<T>(sigma, g[2]),
                         PER_STAGE ? field<T>(sigma, g[3]) : 0.0f);
  }
}

// The stage fields h of one substep from its records.
template <typename T, bool PER_STAGE>
__device__ __forceinline__ void stage_fields(const float4 (&rec)[records_per_substep<PER_STAGE>()],
                                             T (&h)[12]) {
  if (PER_STAGE) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      h[4 * d] = from_f32<T>(rec[d].x);
      h[4 * d + 1] = from_f32<T>(rec[d].y);
      h[4 * d + 2] = from_f32<T>(rec[d].z);
      h[4 * d + 3] = from_f32<T>(rec[d].w);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      h[3 * s] = from_f32<T>(rec[0].x);
      h[3 * s + 1] = from_f32<T>(rec[0].y);
      h[3 * s + 2] = from_f32<T>(rec[0].z);
    }
  }
}

}  // namespace spintorque
