// Serial dependent chains of one float (or bf16) operation, for per-op prices on NVIDIA
// Hopper (sm_90a) (K7).
//
// Replaces the Pallas TPU kernel scripts/bench_vpu_op_costs.py::_chain_kernel
// (pallas_call at :87-91): each lane runs `steps` dependent steps of one op,
// x <- op(x), and writes the result (the Pallas kernel runs trips x 100 steps
// from x = 1). Every op holds x at a
// float32 fixed point near 1 and is nonlinear in x, so the chain cannot be
// folded and its output stays finite at any length (the forms of OPS,
// bench_vpu_op_costs.py:58-67). Each step depends on the one before, so a
// thread exposes the op's full latency; the time's slope between two step
// counts, taken by the caller, is the price of one step without the launch.
//
// What bounds it: by design, the chain's latency (one block of 1024 threads,
// the TPU vreg's 1024 lanes) or the SM's issue rate for the op (enough blocks
// to fill every SM, the throughput shape); device memory is touched once per
// lane. The build flags are K1's (--fmad=false, no fast math), so logf, expf,
// cosf, sqrtf and the division are the accurate forms K1's chain runs, and the
// prices are K1's prices. base2_bf16 runs base2's Newton step in K6's native
// bf16 ops (llgs_substep.cuh's Bf16), on a bf16 value from the float input
// to the float output, so its price is K6's stage op's.

#include <cuda_runtime.h>

#include "llgs_substep.cuh"

namespace spintorque {

enum ChainOp { kBase2 = 0, kSqrt, kRsqrt, kLog, kExp, kCos, kDiv, kSelect, kBase2Bf16, kNumOps };

// The chain's value type: float, or bf16 for base2_bf16.
template <int OP>
struct ChainValue {
  using type = float;
};
template <>
struct ChainValue<kBase2Bf16> {
  using type = Bf16;
};

template <int OP>
__device__ __forceinline__ typename ChainValue<OP>::type chain_step(
    typename ChainValue<OP>::type x);
// Newton reciprocal step: 2 simple ops.
template <>
__device__ __forceinline__ float chain_step<kBase2>(float x) {
  return x * (2.0f - x);
}
template <>
__device__ __forceinline__ float chain_step<kSqrt>(float x) {
  return sqrtf(x);
}
template <>
__device__ __forceinline__ float chain_step<kRsqrt>(float x) {
  return rsqrtf(x);
}
template <>
__device__ __forceinline__ float chain_step<kLog>(float x) {
  return logf(x) + 1.0f;
}
template <>
__device__ __forceinline__ float chain_step<kExp>(float x) {
  return expf(x) * static_cast<float>(1.0 / 2.718281828459045);
}
template <>
__device__ __forceinline__ float chain_step<kCos>(float x) {
  return cosf(x) + 0.4596976941f;
}
template <>
__device__ __forceinline__ float chain_step<kDiv>(float x) {
  return 2.0f / (x + 1.0f);
}
template <>
__device__ __forceinline__ float chain_step<kSelect>(float x) {
  return x > 0.5f ? x : x + 1e-7f;
}

// The same Newton step in native bf16 ops: x * (2 - x) holds x = 1 in bf16.
template <>
__device__ __forceinline__ Bf16 chain_step<kBase2Bf16>(Bf16 x) {
  const Bf16 two = bf16_from_bits(0x4000);
  return x * (two - x);
}

template <int OP>
__global__ void op_chain_kernel(const float* x, float* y, int count, int steps) {
  using T = typename ChainValue<OP>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  T v = from_f32<T>(x[i]);
  // Partly unrolled: the loop counter's few instructions do not depend on v
  // and issue under the chain's latency.
#pragma unroll 25
  for (int k = 0; k < steps; ++k) v = chain_step<OP>(v);
  y[i] = to_f32(v);
}

template <int OP>
cudaError_t launch_chain(const float* x, float* y, int count, int steps, int block,
                         cudaStream_t stream) {
  const int grid = (count + block - 1) / block;
  op_chain_kernel<OP><<<grid, block, 0, stream>>>(x, y, count, steps);
  return cudaGetLastError();
}

}  // namespace spintorque

// Plain C entry point, bound with ctypes: y = op^steps(x) over `count`
// floats, `block` threads per block, on `stream`. `op` indexes ChainOp (the
// order of OPS in ops/op_chain.py). Returns cudaGetLastError() (0 = launched).
extern "C" int spintorque_op_chain(const float* x, float* y, int count, int op, int steps,
                                   int block, void* stream) {
  using namespace spintorque;
  if (count <= 0 || steps < 0 || block <= 0 || block > 1024 || block % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kBase2:
      return static_cast<int>(launch_chain<kBase2>(x, y, count, steps, block, s));
    case kSqrt:
      return static_cast<int>(launch_chain<kSqrt>(x, y, count, steps, block, s));
    case kRsqrt:
      return static_cast<int>(launch_chain<kRsqrt>(x, y, count, steps, block, s));
    case kLog:
      return static_cast<int>(launch_chain<kLog>(x, y, count, steps, block, s));
    case kExp:
      return static_cast<int>(launch_chain<kExp>(x, y, count, steps, block, s));
    case kCos:
      return static_cast<int>(launch_chain<kCos>(x, y, count, steps, block, s));
    case kDiv:
      return static_cast<int>(launch_chain<kDiv>(x, y, count, steps, block, s));
    case kSelect:
      return static_cast<int>(launch_chain<kSelect>(x, y, count, steps, block, s));
    case kBase2Bf16:
      return static_cast<int>(launch_chain<kBase2Bf16>(x, y, count, steps, block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
