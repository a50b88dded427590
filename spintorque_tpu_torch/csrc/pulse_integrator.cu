// Masked LLGS pulse integrator for NVIDIA Hopper (sm_90a), one thread per env.
//
// Replaces the Pallas TPU kernel spintorque_tpu/ops/pallas_integrator.py::_kernel
// (launched by _pallas_core). Each thread integrates one env for its own count
// of substeps n[env] (Euler, stochastic Heun or RK4, each followed by the
// normalize-with-fallback of physics/llgs.py) and flags the env as failed when a
// substep yields an exact zero vector. An env whose n is reached holds its state,
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
// original index, so the stream depends on neither the sort nor the block size.

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
};

struct Coeffs {
  float h_k, ms, neg_gamma_eff, alpha, stt, ex, ey, ez;
};

// dm/dt with the thermal field (tx, ty, tz); the op order of llgs.dmdt_from.
template <bool THERMAL, bool PLUS_Z>
__device__ __forceinline__ void rhs(float mx, float my, float mz, float tx, float ty, float tz,
                                    const Coeffs& c, float& fx, float& fy, float& fz) {
  float hx, hy, hz, vx, vy, vz;
  if (PLUS_Z) {
    // e = (0, 0, 1): the projections collapse and the axis loads disappear.
    const float anis = c.h_k * mz;
    hx = 0.0f;
    hy = 0.0f;
    hz = anis - c.ms * mz;
    // u = m x z = (my, -mx, 0); v = m x u.
    const float ux = my;
    const float uy = -mx;
    vx = -(mz * uy);
    vy = mz * ux;
    vz = mx * uy - my * ux;
  } else {
    const float m_dot_e = mx * c.ex + my * c.ey + mz * c.ez;
    const float anis = c.h_k * m_dot_e;
    hx = anis * c.ex;
    hy = anis * c.ey;
    hz = anis * c.ez - c.ms * mz;
    const float ux = my * c.ez - mz * c.ey;
    const float uy = mz * c.ex - mx * c.ez;
    const float uz = mx * c.ey - my * c.ex;
    vx = my * uz - mz * uy;
    vy = mz * ux - mx * uz;
    vz = mx * uy - my * ux;
  }
  if (THERMAL) {
    hx = hx + tx;
    hy = hy + ty;
    hz = hz + tz;
  }
  const float px = my * hz - mz * hy;  // precession m x H
  const float py = mz * hx - mx * hz;
  const float pz = mx * hy - my * hx;
  const float dx = my * pz - mz * py;  // damping m x (m x H)
  const float dy = mz * px - mx * pz;
  const float dz = mx * py - my * px;
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

template <int METHOD, bool THERMAL, bool PER_STAGE, bool PLUS_Z>
__global__ void __launch_bounds__(kMaxBlock) pulse_kernel(const PulseArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.batch) return;
  const int64_t env = a.perm[t];

  Coeffs c;
  c.h_k = a.h_k[env];
  c.ms = a.ms[env];
  c.neg_gamma_eff = a.neg_gamma_eff[env];
  c.alpha = a.alpha[env];
  c.stt = a.stt[env];
  if (!PLUS_Z) {
    c.ex = a.ex[env];
    c.ey = a.ey[env];
    c.ez = a.ez[env];
  }
  const int n = a.n[env];
  const float dt = a.dt[env];
  const float sigma = THERMAL ? a.sigma[env] : 0.0f;
  float mx = a.mx0[env];
  float my = a.my0[env];
  float mz = a.mz0[env];
  bool failed = false;

  for (int i = 0; i < n; ++i) {
    // Thermal field of each RK stage: per-stage RK4 takes normals 3s..3s+2 of
    // three Philox calls, every other case normals 0..2 of one call.
    float h[12];
    if (THERMAL) {
      float g[12];
      normals4(static_cast<uint32_t>(env), static_cast<uint32_t>(i), 0u, a.seed_lo, a.seed_hi, g);
      if (PER_STAGE) {
        normals4(static_cast<uint32_t>(env), static_cast<uint32_t>(i), 1u, a.seed_lo, a.seed_hi,
                 g + 4);
        normals4(static_cast<uint32_t>(env), static_cast<uint32_t>(i), 2u, a.seed_lo, a.seed_hi,
                 g + 8);
#pragma unroll
        for (int k = 0; k < 12; ++k) h[k] = sigma * g[k];
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          h[3 * s] = sigma * g[0];
          h[3 * s + 1] = sigma * g[1];
          h[3 * s + 2] = sigma * g[2];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) h[k] = 0.0f;
    }

    float nx, ny, nz;
    if (METHOD == kEuler) {
      float fx, fy, fz;
      rhs<THERMAL, PLUS_Z>(mx, my, mz, h[0], h[1], h[2], c, fx, fy, fz);
      nx = mx + dt * fx;
      ny = my + dt * fy;
      nz = mz + dt * fz;
    } else if (METHOD == kHeun) {
      // Stochastic Heun: the corrector reuses the predictor's noise.
      float fx, fy, fz, gx, gy, gz;
      rhs<THERMAL, PLUS_Z>(mx, my, mz, h[0], h[1], h[2], c, fx, fy, fz);
      rhs<THERMAL, PLUS_Z>(mx + dt * fx, my + dt * fy, mz + dt * fz, h[0], h[1], h[2], c, gx, gy,
                           gz);
      const float half_dt = 0.5f * dt;
      nx = mx + half_dt * (fx + gx);
      ny = my + half_dt * (fy + gy);
      nz = mz + half_dt * (fz + gz);
    } else {
      float k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z, k4x, k4y, k4z;
      rhs<THERMAL, PLUS_Z>(mx, my, mz, h[0], h[1], h[2], c, k1x, k1y, k1z);
      k1x = dt * k1x;
      k1y = dt * k1y;
      k1z = dt * k1z;
      rhs<THERMAL, PLUS_Z>(mx + k1x / 2.0f, my + k1y / 2.0f, mz + k1z / 2.0f, h[3], h[4], h[5], c,
                           k2x, k2y, k2z);
      k2x = dt * k2x;
      k2y = dt * k2y;
      k2z = dt * k2z;
      rhs<THERMAL, PLUS_Z>(mx + k2x / 2.0f, my + k2y / 2.0f, mz + k2z / 2.0f, h[6], h[7], h[8], c,
                           k3x, k3y, k3z);
      k3x = dt * k3x;
      k3y = dt * k3y;
      k3z = dt * k3z;
      rhs<THERMAL, PLUS_Z>(mx + k3x, my + k3y, mz + k3z, h[9], h[10], h[11], c, k4x, k4y, k4z);
      k4x = dt * k4x;
      k4y = dt * k4y;
      k4z = dt * k4z;
      nx = mx + (k1x + 2.0f * k2x + 2.0f * k3x + k4x) / 6.0f;
      ny = my + (k1y + 2.0f * k2y + 2.0f * k3y + k4y) / 6.0f;
      nz = mz + (k1z + 2.0f * k2z + 2.0f * k3z + k4z) / 6.0f;
    }
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

template <int METHOD, bool THERMAL, bool PER_STAGE>
cudaError_t launch(const PulseArgs& a, bool plus_z, int block, cudaStream_t stream) {
  const int grid = (a.batch + block - 1) / block;
  if (plus_z) {
    pulse_kernel<METHOD, THERMAL, PER_STAGE, true><<<grid, block, 0, stream>>>(a);
  } else {
    pulse_kernel<METHOD, THERMAL, PER_STAGE, false><<<grid, block, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int METHOD>
cudaError_t launch_method(const PulseArgs& a, bool thermal, bool per_stage, bool plus_z, int block,
                          cudaStream_t stream) {
  if (!thermal) return launch<METHOD, false, false>(a, plus_z, block, stream);
  if constexpr (METHOD == kRk4) {
    if (per_stage) return launch<METHOD, true, true>(a, plus_z, block, stream);
  }
  return launch<METHOD, true, false>(a, plus_z, block, stream);
}

__global__ void probe_add_one_kernel(const float* x, float* y, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = x[i] + 1.0f;
}

}  // namespace spintorque

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int spintorque_pulse_integrate(
    const float* mx0, const float* my0, const float* mz0, const int32_t* n, const float* dt,
    const float* sigma, const float* h_k, const float* ms, const float* neg_gamma_eff,
    const float* alpha, const float* stt, const float* ex, const float* ey, const float* ez,
    const int64_t* perm, float* mx, float* my, float* mz, bool* failed, int batch, int method,
    int thermal, int per_stage, int plus_z, unsigned int seed_lo, unsigned int seed_hi, int block,
    void* stream) {
  using namespace spintorque;
  if (batch <= 0 || block <= 0 || block > kMaxBlock || block % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PulseArgs a{mx0, my0, mz0, n, dt, sigma, h_k, ms, neg_gamma_eff, alpha,
                    stt, ex, ey, ez, perm, mx, my, mz, failed, batch, seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kEuler:
      return static_cast<int>(launch_method<kEuler>(a, thermal, per_stage, plus_z, block, s));
    case kHeun:
      return static_cast<int>(launch_method<kHeun>(a, thermal, per_stage, plus_z, block, s));
    case kRk4:
      return static_cast<int>(launch_method<kRk4>(a, thermal, per_stage, plus_z, block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fast-path probe: y = x + 1 over `count` floats.
extern "C" int spintorque_probe_add_one(const float* x, float* y, int count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 128;
  spintorque::probe_add_one_kernel<<<(count + block - 1) / block, block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(x, y, count);
  return static_cast<int>(cudaGetLastError());
}
