// Masked LLGS pulse integrator for NVIDIA Hopper (sm_90a), one thread per env.
//
// Replaces the Pallas TPU kernel spintorque_tpu/ops/pallas_integrator.py::_kernel
// (launched by _pallas_core), both its float32 form (K1) and its bf16_rhs
// branch (K6, pallas_integrator.py:316-356 and substep_delta). Each thread
// integrates one env for its own count of substeps n[env] (Euler, stochastic
// Heun or RK4, each followed by the normalize-with-fallback of
// physics/llgs.py) and flags the env as failed when a substep yields an exact
// zero vector. An env whose n is reached holds its state,
// which is the masked loop's semantics. The operations and their order are those
// of the plain version (spintorque_tpu_torch/physics/integrator.py), so the two
// agree to the last bit or so in the deterministic case. Build without fast math
// and with --fmad=false: true division, sqrtf and unfused products are part of
// that agreement.
//
// What bounds it on an H100: latency. A substep is a serial chain of ~150
// dependent float operations (more with thermal noise: Philox rounds, a log, a
// sqrt and two short polynomials); the state is 3 floats in registers and
// device memory is touched only to load ~14 values and store 4 per env. With
// one thread per env, B=4096 is 128 warps on 132 SMs, so each SM holds about
// one warp and the kernel time is one warp's chain length. The wrapper sorts envs
// by descending n (torch.argsort) and passes the permutation: thread t reads and
// writes env perm[t], so a warp holds envs of similar n and runs to its own
// longest, as a TPU tile ran to its own bound. Thermal counters use the env's
// global index env_offset + perm[t], so the stream depends on neither the sort
// nor the block size.
//
// K5, the sharded pulse of the data-parallel path, is this kernel launched on
// one shard of the batch (replacing _integrate_pulse_pallas_sharded and
// _shard_seed, pallas_integrator.py:689-746, which run K1 per shard under
// shard_map with a per-shard seed offset). Each shard sorts its own envs, and
// env_offset, the shard's first global row, keys the noise: a shard draws
// exactly its rows of the unsharded stream, so a sharded pulse equals the
// unsharded one bit for bit, thermal included. Its bound is K1's.
//
// K6 is the same kernel with the stage value type T = Bf16: the coefficients,
// dt, a bf16 copy of the state and the thermal field (sigma * normal in float,
// then rounded) enter the right-hand side in bf16, and every operation on them
// widens to float, does the one op and rounds back to nearest even, which is
// how PyTorch computes a bf16 tensor op. The increment is widened and added to
// the float state, which is normalized in float. Its plain version runs the
// same ops on bf16 tensors, so the two agree bit for bit. The bf16 operators
// are written out here rather than taken from cuda_bf16.h, whose operators
// and __hfma may be contracted into fma.rn.bf16; with T = float the code is
// K1's, operation for operation. The rounding adds a cvt per operation to
// K1's chain, so K6 is not expected to be faster than K1 on this card: its
// stage arithmetic runs on the float pipes either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace spintorque {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

constexpr int kMaxBlock = 256;

struct PulseArgs {
  const float* mx0;
  const float* my0;
  const float* mz0;
  const int32_t* n;
  const float* dt;
  const float* sigma;
  const float* h_k;
  const float* ms;
  const float* neg_gamma_eff;
  const float* alpha;
  const float* stt;
  const float* ex;  // general axis only
  const float* ey;
  const float* ez;
  const int64_t* perm;
  float* mx;
  float* my;
  float* mz;
  bool* failed;
  int batch;
  uint32_t seed_lo;
  uint32_t seed_hi;
  uint32_t env_offset;  // global index of env 0 of this batch (K5's shard offset)
};

// A bf16 value; each operation is a PyTorch bf16 op: float opmath, one
// rounding to nearest even. A float operand stands for a Python scalar.
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

__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) + to_f32(b));
}
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) - to_f32(b));
}
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) {
  return from_f32<Bf16>(to_f32(a) * to_f32(b));
}
__device__ __forceinline__ Bf16 operator-(Bf16 a) { return from_f32<Bf16>(-to_f32(a)); }
__device__ __forceinline__ Bf16 operator*(float a, Bf16 b) {
  return from_f32<Bf16>(a * to_f32(b));
}
__device__ __forceinline__ Bf16 operator/(Bf16 a, float b) {
  return from_f32<Bf16>(to_f32(a) / b);
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

// NaN/Inf or |m| < 1e-12 maps to +z; true division.
__device__ __forceinline__ void normalize_with_fallback(float& x, float& y, float& z) {
  const float norm = sqrtf(x * x + y * y + z * z);
  bool ok = isfinite(x) && isfinite(y) && isfinite(z) && (norm >= (float)1e-12);
  const float safe = ok ? norm : 1.0f;
  const float nx = x / safe;
  const float ny = y / safe;
  const float nz = z / safe;
  ok = ok && isfinite(nx) && isfinite(ny) && isfinite(nz);
  x = ok ? nx : 0.0f;
  y = ok ? ny : 0.0f;
  z = ok ? nz : 1.0f;
}

template <typename T, int METHOD, bool THERMAL, bool PER_STAGE, bool PLUS_Z>
__global__ void __launch_bounds__(kMaxBlock) pulse_kernel(const PulseArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.batch) return;
  const int64_t env = a.perm[t];
  // The Philox counter's env word: the wrapper checks env_offset + batch <= 2^32.
  const uint32_t key_env = a.env_offset + static_cast<uint32_t>(env);

  Coeffs<T> c;
  c.h_k = from_f32<T>(a.h_k[env]);
  c.ms = from_f32<T>(a.ms[env]);
  c.neg_gamma_eff = from_f32<T>(a.neg_gamma_eff[env]);
  c.alpha = from_f32<T>(a.alpha[env]);
  c.stt = from_f32<T>(a.stt[env]);
  if (!PLUS_Z) {
    c.ex = from_f32<T>(a.ex[env]);
    c.ey = from_f32<T>(a.ey[env]);
    c.ez = from_f32<T>(a.ez[env]);
  }
  const int n = a.n[env];
  const T dt = from_f32<T>(a.dt[env]);
  const float sigma = THERMAL ? a.sigma[env] : 0.0f;
  float mx = a.mx0[env];
  float my = a.my0[env];
  float mz = a.mz0[env];
  bool failed = false;

  for (int i = 0; i < n; ++i) {
    // Thermal field of each RK stage: per-stage RK4 takes normals 3s..3s+2 of
    // three Philox calls, every other case normals 0..2 of one call.
    T h[12];
    if (THERMAL) {
      float g[12];
      normals4(key_env, static_cast<uint32_t>(i), 0u, a.seed_lo, a.seed_hi, g);
      if (PER_STAGE) {
        normals4(key_env, static_cast<uint32_t>(i), 1u, a.seed_lo, a.seed_hi, g + 4);
        normals4(key_env, static_cast<uint32_t>(i), 2u, a.seed_lo, a.seed_hi, g + 8);
#pragma unroll
        for (int k = 0; k < 12; ++k) h[k] = from_f32<T>(sigma * g[k]);
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          h[3 * s] = from_f32<T>(sigma * g[0]);
          h[3 * s + 1] = from_f32<T>(sigma * g[1]);
          h[3 * s + 2] = from_f32<T>(sigma * g[2]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) h[k] = from_f32<T>(0.0f);
    }

    // The stages read a copy of the state in T; the increment (dx, dy, dz)
    // is widened and added to the float state.
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
      rhs<T, THERMAL, PLUS_Z>(sx + dt * fx, sy + dt * fy, sz + dt * fz, h[0], h[1], h[2], c, gx,
                              gy, gz);
      const T half_dt = 0.5f * dt;
      dx = half_dt * (fx + gx);
      dy = half_dt * (fy + gy);
      dz = half_dt * (fz + gz);
    } else {
      T k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z, k4x, k4y, k4z;
      rhs<T, THERMAL, PLUS_Z>(sx, sy, sz, h[0], h[1], h[2], c, k1x, k1y, k1z);
      k1x = dt * k1x;
      k1y = dt * k1y;
      k1z = dt * k1z;
      rhs<T, THERMAL, PLUS_Z>(sx + k1x / 2.0f, sy + k1y / 2.0f, sz + k1z / 2.0f, h[3], h[4], h[5],
                              c, k2x, k2y, k2z);
      k2x = dt * k2x;
      k2y = dt * k2y;
      k2z = dt * k2z;
      rhs<T, THERMAL, PLUS_Z>(sx + k2x / 2.0f, sy + k2y / 2.0f, sz + k2z / 2.0f, h[6], h[7], h[8],
                              c, k3x, k3y, k3z);
      k3x = dt * k3x;
      k3y = dt * k3y;
      k3z = dt * k3z;
      rhs<T, THERMAL, PLUS_Z>(sx + k3x, sy + k3y, sz + k3z, h[9], h[10], h[11], c, k4x, k4y, k4z);
      k4x = dt * k4x;
      k4y = dt * k4y;
      k4z = dt * k4z;
      dx = (k1x + 2.0f * k2x + 2.0f * k3x + k4x) / 6.0f;
      dy = (k1y + 2.0f * k2y + 2.0f * k3y + k4y) / 6.0f;
      dz = (k1z + 2.0f * k2z + 2.0f * k3z + k4z) / 6.0f;
    }
    float nx = mx + to_f32(dx);
    float ny = my + to_f32(dy);
    float nz = mz + to_f32(dz);
    normalize_with_fallback(nx, ny, nz);
    failed = failed || (nx == 0.0f && ny == 0.0f && nz == 0.0f);
    mx = nx;
    my = ny;
    mz = nz;
  }
  a.mx[env] = mx;
  a.my[env] = my;
  a.mz[env] = mz;
  a.failed[env] = failed;
}

template <typename T, int METHOD, bool THERMAL, bool PER_STAGE>
cudaError_t launch(const PulseArgs& a, bool plus_z, int block, cudaStream_t stream) {
  const int grid = (a.batch + block - 1) / block;
  if (plus_z) {
    pulse_kernel<T, METHOD, THERMAL, PER_STAGE, true><<<grid, block, 0, stream>>>(a);
  } else {
    pulse_kernel<T, METHOD, THERMAL, PER_STAGE, false><<<grid, block, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int METHOD>
cudaError_t launch_method(const PulseArgs& a, bool thermal, bool per_stage, bool plus_z, int block,
                          cudaStream_t stream) {
  if (!thermal) return launch<T, METHOD, false, false>(a, plus_z, block, stream);
  if constexpr (METHOD == kRk4) {
    if (per_stage) return launch<T, METHOD, true, true>(a, plus_z, block, stream);
  }
  return launch<T, METHOD, true, false>(a, plus_z, block, stream);
}

template <typename T>
cudaError_t launch_type(const PulseArgs& a, int method, bool thermal, bool per_stage, bool plus_z,
                        int block, cudaStream_t stream) {
  switch (method) {
    case kEuler:
      return launch_method<T, kEuler>(a, thermal, per_stage, plus_z, block, stream);
    case kHeun:
      return launch_method<T, kHeun>(a, thermal, per_stage, plus_z, block, stream);
    case kRk4:
      return launch_method<T, kRk4>(a, thermal, per_stage, plus_z, block, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

__global__ void probe_add_one_kernel(const float* x, float* y, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = x[i] + 1.0f;
}

}  // namespace spintorque

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched). bf16 != 0 selects K6; env_offset
// is the global index of env 0 (nonzero on every shard of K5 but the first).
extern "C" int spintorque_pulse_integrate(
    const float* mx0, const float* my0, const float* mz0, const int32_t* n, const float* dt,
    const float* sigma, const float* h_k, const float* ms, const float* neg_gamma_eff,
    const float* alpha, const float* stt, const float* ex, const float* ey, const float* ez,
    const int64_t* perm, float* mx, float* my, float* mz, bool* failed, int batch, int method,
    int thermal, int per_stage, int plus_z, int bf16, unsigned int seed_lo, unsigned int seed_hi,
    unsigned int env_offset, int block, void* stream) {
  using namespace spintorque;
  if (batch <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PulseArgs a{mx0, my0, mz0, n, dt, sigma, h_k, ms, neg_gamma_eff, alpha, stt, ex, ey,
                    ez, perm, mx, my, mz, failed, batch, seed_lo, seed_hi, env_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(launch_type<Bf16>(a, method, thermal, per_stage, plus_z, block, s));
  }
  return static_cast<int>(launch_type<float>(a, method, thermal, per_stage, plus_z, block, s));
}

// The fast-path probe: y = x + 1 over `count` floats.
extern "C" int spintorque_probe_add_one(const float* x, float* y, int count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 128;
  spintorque::probe_add_one_kernel<<<(count + block - 1) / block, block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(x, y, count);
  return static_cast<int>(cudaGetLastError());
}
