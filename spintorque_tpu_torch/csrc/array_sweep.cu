// The array env's sequential sweep (SpinTorqueArray-v0, coupling_update
// 'sequential') in one launch on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's sweep is a masked lax.scan over
// the device index (spintorque_tpu/envs/array.py, _sequential_sweep), which
// XLA compiles whole. The port's plain version (ops/array_sweep.py,
// sequential_sweep_plain) runs it eagerly: ~120 tiny launches a device over
// every array, ~1,900 a step of a 4x4 array, each a few us of device work
// behind ~13 us of host. This kernel runs the same sweep of every array in
// one launch.
//
// What it computes, per array b of the batch (the plain version's steps):
//  * the pattern, flushed of subnormals to a zero of their sign
//    (flush_subnormal, a compare and a bit operation, as K1 flushes its
//    first state);
//  * the step energy: the per-device energies e[b, d] (computed before the
//    launch from the flushed pattern's resistance) summed in device order as
//    energy + (active ? e : 0);
//  * for each device d in mask order, when |J| > 1e-12: the field
//    H_k (m_d . e) e + sum_n C[d, n] m_n over the pattern as updated so far,
//    then the 10-substep constant-slope Euler of the reference
//    (tau = 0.1 J m x (m x z), dmdt = -gamma m x H, dmdt += alpha m x dmdt,
//    dmdt += tau, dt = duration / 10, renormalized after every substep);
//  * the output: each moved device's result, every other device's unflushed
//    input (the plain version's final where(moved, pattern, held)).
// A device that is not in the mask, or one driven by |J| <= 1e-12, keeps
// its flushed value through the sweep in the plain version too, whose
// update of it is discarded by torch.where; so the kernel skips its field
// and substeps and every output stays the same.
//
// Op order: the plain version's on the card, op for op, with true division,
// sqrtf and products fused only where PyTorch's kernels fuse them (the
// library builds with --fmad=false, no fast math, no ftz). PyTorch's scalar
// operands enter as the float their Python value rounds to, and its
// division by the Python scalar 10 is a multiply by the float 1 / 10. The
// orders PyTorch leaves unspecified (torch.linalg.cross's contraction, the
// dot with the easy axis, the coupling einsum, the 3-term sum of |m|^2) are
// the ones PyTorch 2.11 (CUDA 12.8) was found to take on an H100, each
// matched bit for bit on 4096 random rows (cross, dot3, coupling_sum,
// sum_sq3 below; the einsum for N from 2 to 64). Another PyTorch or cuBLAS
// may take others: the card tests hold the kernel to the plain version at
// 1e-6 and report its bits.
//
// What bounds it on this card: one thread an array, so at B = 4096 it is 4096
// threads, about one warp an SM. The sweep reads and writes ~2 MB (the
// B x N x 3 float pattern twice, the mask, currents, durations and
// energies): ~0.6 us at 3.35 TB/s. Its time is the dependent chain of one
// array, a few hundred float operations a moved device (10 substeps, each a
// sqrt and three divisions), a few us to a few tens of us. The loop over
// moved devices walks each thread's own active devices in order, so that the
// threads of a warp that pulse different devices (the 'individual' action
// mode) update them together and not one device after another. Each thread
// sweeps its array in its rows of the output buffer (3N floats, in L1 after
// the flush writes them), so every rows x cols runs on the one path.
//
// The launch allocates nothing, reads nothing back and synchronizes nothing,
// so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "llgs_substep.cuh"

namespace spintorque {

constexpr int kSweepBlock = 64;      // arrays (threads) a block
constexpr int kSubsteps = 10;
constexpr float kAlpha = 0.01f;      // the reference's hardcoded damping
constexpr float kTorque = 0.1f;      // tau = 0.1 J m x (m x z)
constexpr float kInvSubsteps = 0.1f; // 1 / 10 in float: PyTorch's duration / 10.0
constexpr float kMinCurrent = 1e-12f;

struct SweepArgs {
  const float* pattern;     // (B, N, 3) raw input
  const uint8_t* mask;      // (B, N) bool
  const float* current;     // (B,)
  const float* duration;    // (B,)
  const float* energies;    // (B, N) per-device pulse energies
  const float* coupling;    // (N, N)
  const float* easy_axis;   // (3,) normalized
  const float* anisotropy;  // () K_u
  const float* saturation;  // () M_s
  float* out;               // (B, N, 3)
  float* energy;            // (B,)
  int batch, n;
  float neg_gamma, mu0;
};

struct Vec3 {
  float x, y, z;
};

// a x b as torch.linalg.cross computes each component on the card: the
// first product fused into the difference, a_i b_j - RN(a_j b_i).
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// m . e in the order the plain version's (B, 3) @ (3,) (a cuBLAS gemv)
// takes on the card.
__device__ __forceinline__ float dot3(Vec3 m, Vec3 e) {
  return __fmaf_rn(m.y, e.y, m.x * e.x) + m.z * e.z;
}

// C[d, k] m_k summed over k in [lo, hi) for component c, fused from +0.
__device__ __forceinline__ float coupling_chain(const float* row, const float* w, int lo, int hi, int c) {
  float s = 0.0f;
  for (int k = lo; k < hi; ++k) s = __fmaf_rn(__ldg(row + k), w[3 * k + c], s);
  return s;
}

// sum_n C[d, n] m_n for component c in the order the plain version's einsum
// (a cuBLAS product) takes on the card: two fused chains, over the first
// ceil(n / 2) devices and over the rest, added; for one device, the product.
__device__ __forceinline__ float coupling_sum(const float* row, const float* w, int n, int c) {
  if (n == 1) return __ldg(row) * w[c];
  const int half = (n + 1) / 2;
  return coupling_chain(row, w, 0, half, c) + coupling_chain(row, w, half, n, c);
}

// |o|^2 in the order the plain version's (o * o).sum(-1) takes on the card.
__device__ __forceinline__ float sum_sq3(Vec3 o) {
  return (o.x * o.x + o.z * o.z) + o.y * o.y;
}

// The first device at or after d that the mask selects, or n.
__device__ __forceinline__ int next_active(const uint8_t* mask, int d, int n) {
  while (d < n && !mask[d]) ++d;
  return d;
}

// Device d's update: its field over the pattern as swept so far, then the
// 10-substep Euler; the plain version's _device_field and _device_update.
__device__ __forceinline__ Vec3 device_update(const float* w, int d, int n, const float* coupling,
                                              Vec3 e, float h_k, float neg_gamma, float j,
                                              float dt) {
  const Vec3 m = {w[3 * d], w[3 * d + 1], w[3 * d + 2]};
  const float hk_cos = h_k * dot3(m, e);
  const float* row = coupling + static_cast<size_t>(d) * n;
  const Vec3 h = {hk_cos * e.x + coupling_sum(row, w, n, 0),
                  hk_cos * e.y + coupling_sum(row, w, n, 1),
                  hk_cos * e.z + coupling_sum(row, w, n, 2)};
  const float tj = kTorque * j;
  const Vec3 c2 = cross(m, cross(m, Vec3{0.0f, 0.0f, 1.0f}));
  const Vec3 tau = {tj * c2.x, tj * c2.y, tj * c2.z};
  const Vec3 p = cross(m, h);
  Vec3 dmdt = {neg_gamma * p.x, neg_gamma * p.y, neg_gamma * p.z};
  const Vec3 q = cross(m, dmdt);
  dmdt = {dmdt.x + kAlpha * q.x, dmdt.y + kAlpha * q.y, dmdt.z + kAlpha * q.z};
  dmdt = {dmdt.x + tau.x, dmdt.y + tau.y, dmdt.z + tau.z};
  Vec3 o = m;
#pragma unroll 1
  for (int s = 0; s < kSubsteps; ++s) {
    o = {o.x + dmdt.x * dt, o.y + dmdt.y * dt, o.z + dmdt.z * dt};
    const float norm = sqrtf(sum_sq3(o));
    o = {o.x / norm, o.y / norm, o.z / norm};
  }
  return o;
}

__global__ void __launch_bounds__(kSweepBlock) array_sweep_kernel(SweepArgs a) {
  const int b = blockIdx.x * kSweepBlock + threadIdx.x;
  if (b >= a.batch) return;
  const int n = a.n;
  const size_t row = static_cast<size_t>(b) * n;
  const float* held = a.pattern + 3 * row;
  const uint8_t* mask = a.mask + row;
  float* w = a.out + 3 * row;  // the pattern being swept

  float energy = 0.0f;
  for (int d = 0; d < n; ++d) energy = energy + (mask[d] ? a.energies[row + d] : 0.0f);
  a.energy[b] = energy;

  const float j = a.current[b];
  if (!(fabsf(j) > kMinCurrent)) {  // nothing moves: every device keeps its input
    for (int k = 0; k < 3 * n; ++k) w[k] = held[k];
    return;
  }
  for (int k = 0; k < 3 * n; ++k) w[k] = flush_subnormal(held[k]);
  const float dt = a.duration[b] * kInvSubsteps;
  const float h_k = (2.0f * *a.anisotropy) / (a.mu0 * *a.saturation);
  const Vec3 e = {a.easy_axis[0], a.easy_axis[1], a.easy_axis[2]};
  for (int d = next_active(mask, 0, n); d < n; d = next_active(mask, d + 1, n)) {
    const Vec3 o = device_update(w, d, n, a.coupling, e, h_k, a.neg_gamma, j, dt);
    w[3 * d] = o.x;
    w[3 * d + 1] = o.y;
    w[3 * d + 2] = o.z;
  }
  for (int d = 0; d < n; ++d) {  // the devices not moved keep their unflushed input
    if (!mask[d]) {
      for (int c = 0; c < 3; ++c) w[3 * d + c] = held[3 * d + c];
    }
  }
}

}  // namespace spintorque

// Plain C entry point, bound with ctypes: the sequential sweep of `batch`
// arrays of `n` devices each, on `stream`. Every pointer is to contiguous
// float32 (the mask bool, one byte an element) CUDA memory; `out` must not
// overlap `pattern`. Returns cudaGetLastError() (0 = launched).
extern "C" int spintorque_array_sweep(const float* pattern, const uint8_t* mask,
                                      const float* current, const float* duration,
                                      const float* energies, const float* coupling,
                                      const float* easy_axis, const float* anisotropy,
                                      const float* saturation, float* out, float* energy,
                                      int batch, int n, float neg_gamma, float mu0,
                                      void* stream) {
  using namespace spintorque;
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs a{pattern, mask,  current, duration, energies, coupling, easy_axis, anisotropy,
                    saturation, out, energy, batch, n, neg_gamma, mu0};
  const int grid = (batch + kSweepBlock - 1) / kSweepBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  array_sweep_kernel<<<grid, kSweepBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
