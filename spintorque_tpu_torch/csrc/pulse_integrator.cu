// Masked LLGS pulse integrator for NVIDIA Hopper (sm_90a): one thread per env
// integrates, and in thermal runs producer warps draw its noise ahead of it.
//
// Replaces the Pallas TPU kernel spintorque_tpu/ops/pallas_integrator.py::_kernel
// (launched by _pallas_core), both its float32 form (K1) and its bf16_rhs
// branch (K6, pallas_integrator.py:316-356 and substep_delta). Each env runs
// its own count of substeps n[env] (Euler, stochastic Heun or RK4, each
// followed by the normalize-with-fallback of physics/llgs.py) and is flagged
// failed when a substep yields an exact zero vector. An env whose n is reached
// holds its state, which is the masked loop's semantics. The arithmetic is in
// llgs_substep.cuh, in the op order of the plain version
// (spintorque_tpu_torch/physics/integrator.py), so the two agree bit for bit;
// build without fast math and with --fmad=false.
//
// What bounds it on an H100: latency. One env's substeps form a serial chain
// of dependent float operations (ops.cuda_integrator.pulse_chain_depth counts
// them by class: ~60 adds and multiplies, a square root, a division and a few
// selects per RK4 substep); the state is 3 floats in registers, and device
// memory is touched only to load ~14 values and store 4 per env. The kernel
// ends with its longest env, so its floor is that env's substeps times the
// chain's latency, whatever the batch. The design keeps everything else off
// that chain:
//
//  * Warp roles. A block holds one consumer warp, whose 32 lanes integrate 32
//    envs, one each, with the state in registers. B=4096 is 128 blocks, one
//    consumer warp per SM on 128 of the 132 SMs. Deterministic launches are
//    the consumer warp alone.
//  * The thermal sampler on producer warps. The thermal field of a substep
//    depends on (env, substep, seed) only, never on m, so in thermal launches
//    the block adds kProducers producer warps (beside the consumer on the
//    SM's other sub-partitions). Producer lane l draws the
//    fields of the consumer's lane l (Philox4x32-10, Box-Muller's log and
//    sqrt, the folded cos/sin; sigma * normal rounded to the stage type) up to
//    that env's own n and writes them to a ring in shared memory. The Philox
//    counters are those the plain version draws, (env_offset + env, i, draw,
//    0), so K5 equals the unsharded launch bit for bit.
//  * The ring. Substeps go in chunks of kChunk (kChunk / 2 for per-stage
//    RK4, whose records are three times as large); each producer owns
//    kSlotsPerProducer slots, and chunk k is producer k % kProducers's. Every
//    slot has an mbarrier pair: `full` (32 producer arrivals, release) and
//    `empty` (32 consumer arrivals). The consumer waits once per chunk, then
//    reads each substep's record (one 16-byte ld.shared per lane; three for
//    per-stage RK4, whose four stages take fresh fields) one substep ahead of
//    use. Consecutive lanes read consecutive records, so no bank conflicts.
//  * The sort. The wrapper sorts envs by descending n (torch.argsort) and
//    passes the permutation: consumer lane t reads and writes env perm[t], so
//    a warp holds envs of similar n and runs to its own longest, as a TPU
//    tile ran to its own bound. Thermal counters use the env's global index,
//    so the stream depends on neither the sort nor the block shape.
//
// K5, the sharded pulse of the data-parallel path, is this kernel launched on
// one shard of the batch (replacing _integrate_pulse_pallas_sharded and
// _shard_seed, pallas_integrator.py:689-746, which run K1 per shard under
// shard_map with a per-shard seed offset). Each shard sorts its own envs, and
// env_offset, the shard's first global row, keys the noise: a shard draws
// exactly its rows of the unsharded stream. Its bound is K1's.
//
// K6 is the same kernel with the stage value type T = Bf16: the coefficients,
// dt, a bf16 copy of the state and the thermal field enter the right-hand side
// in bf16, and each stage op is one native Hopper bf16 instruction
// (add.rn.bf16, sub.rn.bf16, mul.rn.bf16, neg.bf16; llgs_substep.cuh), which
// rounds the exact result once to nearest even. PyTorch computes a bf16 op
// in float and rounds once; spintorque_check_bf16_ops below shows the two
// equal on every input, so K6 stays bit for bit with its plain version. Its
// chain is then K1's stage ops, one instruction each, plus the rounding of
// the state into bf16, the widening of the increment and div6's widening and
// rounding (ops.cuda_integrator.pulse_chain_depth). No fused bf16
// multiply-add: fma.rn.bf16, and cuda_bf16.h's __hfma or its __hmul and
// __hadd, which ptxas may contract into one, round once where PyTorch
// rounds twice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "llgs_substep.cuh"

namespace spintorque {

// Producer warps of a thermal block: one, two and three tie at B=4096, three
// is fastest at B=65536, where blocks share SMs (PERF.md, the design timings).
constexpr int kProducers = 3;
constexpr int kThermalBlock = 32 * (1 + kProducers);
constexpr int kChunk = 8;  // substeps per ring slot; half that for per-stage RK4
constexpr int kSlotsPerProducer = 2;
constexpr int kSlots = kProducers * kSlotsPerProducer;

template <bool PER_STAGE>
__host__ __device__ constexpr int chunk_substeps() {
  return PER_STAGE ? kChunk / 2 : kChunk;
}

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
  // The 64-bit Philox key (low word, high word), read from device memory by
  // the producers of a thermal launch (null in a deterministic one), so that
  // a launch captured in a CUDA graph draws the key its replay was given.
  const uint64_t* key;
  int batch;
  uint32_t env_offset;  // global index of env 0 of this batch (K5's shard offset)
};

// Dynamic shared memory of a thermal launch: the ring. At most 36 KB
// (per-stage RK4), so with the barriers it stays under the 48 KB a block gets
// without opting in.
template <bool PER_STAGE>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kSlots) * chunk_substeps<PER_STAGE>() *
         records_per_substep<PER_STAGE>() * 32 * sizeof(float4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive with release semantics: this thread's shared-memory writes (or
// reads) are ordered before the phase completes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait, with acquire semantics, for the completion of the phase of parity
// `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T, bool PLUS_Z>
__device__ __forceinline__ Coeffs<T> load_coeffs(const PulseArgs& a, int64_t env) {
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
  } else {
    // The general form's axis, for the blocks that run it (integrate_block).
    c.ex = from_f32<T>(0.0f);
    c.ey = from_f32<T>(0.0f);
    c.ez = from_f32<T>(1.0f);
  }
  return c;
}

// The consumer lane of env `env` (live: a real env of the batch, else n = 0):
// integrates n substeps, reading thermal fields from the ring when THERMAL.
template <typename T, int METHOD, bool THERMAL, bool PER_STAGE, bool PLUS_Z>
__device__ __forceinline__ void consume(const PulseArgs& a, bool live, int64_t env, int n,
                                        int chunks, const float4* ring, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int R = records_per_substep<PER_STAGE>();
  constexpr int C = chunk_substeps<PER_STAGE>();
  const Coeffs<T> c = load_coeffs<T, PLUS_Z>(a, env);
  const T dt = from_f32<T>(a.dt[env]);
  // The first state, m0 flushed (integrate_block's start, or a rerun's).
  const auto first_state = [&](float& x, float& y, float& z, bool& f) {
    x = flush_subnormal(a.mx0[env]);
    y = flush_subnormal(a.my0[env]);
    z = flush_subnormal(a.mz0[env]);
    f = false;
  };
  float mx, my, mz;
  bool failed;
  T h[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) h[k] = from_f32<T>(0.0f);

  if constexpr (!THERMAL) {
    // One block, the whole pulse: a rerun starts again from m0.
    const auto no_fields = [](int, T(&)[12]) {};
    integrate_block<T, METHOD, false, PLUS_Z>(mx, my, mz, failed, n, h, c, dt, first_state,
                                              no_fields);
  } else {
    first_state(mx, my, mz, failed);
    const int lane = threadIdx.x & 31;
    int p = 0;  // chunk k is producer p's u-th
    int u = 0;
    for (int k = 0; k < chunks; ++k) {
      const int s = p * kSlotsPerProducer + (u % kSlotsPerProducer);
      mbar_wait(&full[s], (u / kSlotsPerProducer) & 1);
      const float4* slot = ring + s * (C * R * 32) + lane;
      const int len = min(C, n - k * C);
      float4 rec[R];
      // The chunk's first state and substep 0's records; substep j's records
      // with substep j + 1's read ahead (a rerun of the block reads them
      // again from the slot, which it still holds).
      const float x0 = mx, y0 = my, z0 = mz;
      const bool failed0 = failed;
      const auto start = [&](float& x, float& y, float& z, bool& f) {
        x = x0;
        y = y0;
        z = z0;
        f = failed0;
        if (len > 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) rec[r] = slot[r * 32];
        }
      };
      const auto fields = [&](int j, T(&hh)[12]) {
        stage_fields<T, PER_STAGE>(rec, hh);
        if (j + 1 < len) {
#pragma unroll
          for (int r = 0; r < R; ++r) rec[r] = slot[((j + 1) * R + r) * 32];
        }
      };
      integrate_block<T, METHOD, true, PLUS_Z>(mx, my, mz, failed, len, h, c, dt, start, fields);
      mbar_arrive(&empty[s]);
      if (++p == kProducers) {
        p = 0;
        ++u;
      }
    }
  }
  if (live) {
    a.mx[env] = mx;
    a.my[env] = my;
    a.mz[env] = mz;
    a.failed[env] = failed;
  }
}

// Producer warp q: fills the ring slots of chunks q, q + kProducers, ...
// with the thermal records of its lane's env, up to that env's n.
template <typename T, bool PER_STAGE>
__device__ __forceinline__ void produce(const PulseArgs& a, bool live, int64_t env, int n,
                                        int chunks, int q, float4* ring, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int R = records_per_substep<PER_STAGE>();
  constexpr int C = chunk_substeps<PER_STAGE>();
  const int lane = threadIdx.x & 31;
  // The Philox counter's env word: the wrapper checks env_offset + batch <= 2^32.
  const uint32_t key_env = a.env_offset + static_cast<uint32_t>(env);
  const float sigma = live ? a.sigma[env] : 0.0f;
  const uint64_t key = *a.key;
  const uint32_t seed_lo = static_cast<uint32_t>(key);
  const uint32_t seed_hi = static_cast<uint32_t>(key >> 32);
  for (int k = q, u = 0; k < chunks; k += kProducers, ++u) {
    const int s = q * kSlotsPerProducer + (u % kSlotsPerProducer);
    // The first use of each slot passes at once (parity 1 of a fresh barrier).
    mbar_wait(&empty[s], ((u / kSlotsPerProducer) & 1) ^ 1);
    float4* slot = ring + s * (C * R * 32) + lane;
    const int i0 = k * C;
    const int len = min(C, n - i0);
    for (int j = 0; j < len; ++j) {
      float4 rec[R];
      thermal_records<T, PER_STAGE>(key_env, static_cast<uint32_t>(i0 + j), seed_lo, seed_hi,
                                    sigma, rec);
#pragma unroll
      for (int r = 0; r < R; ++r) slot[(j * R + r) * 32] = rec[r];
    }
    mbar_arrive(&full[s]);
  }
}

// Block b: consumer warp 0 integrates sorted envs 32b..32b+31; in thermal
// launches warps 1..kProducers feed it through the ring.
template <typename T, int METHOD, bool THERMAL, bool PER_STAGE, bool PLUS_Z>
__global__ void __launch_bounds__(kThermalBlock) pulse_kernel(const PulseArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const bool live = t < a.batch;
  const int64_t env = live ? a.perm[t] : 0;
  const int n = live ? a.n[env] : 0;
  if constexpr (!THERMAL) {
    consume<T, METHOD, false, PER_STAGE, PLUS_Z>(a, live, env, n, 0, nullptr, nullptr, nullptr);
  } else {
    extern __shared__ float4 ring[];
    __shared__ __align__(8) uint64_t full[kSlots];
    __shared__ __align__(8) uint64_t empty[kSlots];
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(&full[s], 32);
        mbar_init(&empty[s], 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // Every warp of the block holds the same 32 envs, so all agree on the
    // number of chunks: the longest env's.
    constexpr int C = chunk_substeps<PER_STAGE>();
    const int chunks = (__reduce_max_sync(0xffffffffu, n) + C - 1) / C;
    if (warp == 0) {
      consume<T, METHOD, true, PER_STAGE, PLUS_Z>(a, live, env, n, chunks, ring, full, empty);
    } else {
      produce<T, PER_STAGE>(a, live, env, n, chunks, warp - 1, ring, full, empty);
    }
  }
}

template <typename T, int METHOD, bool THERMAL, bool PER_STAGE, bool PLUS_Z>
cudaError_t launch_instance(const PulseArgs& a, cudaStream_t stream) {
  const int grid = (a.batch + 31) / 32;
  const int block = THERMAL ? kThermalBlock : 32;
  const size_t smem = THERMAL ? ring_bytes<PER_STAGE>() : 0;
  pulse_kernel<T, METHOD, THERMAL, PER_STAGE, PLUS_Z><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int METHOD, bool THERMAL, bool PER_STAGE>
cudaError_t launch(const PulseArgs& a, bool plus_z, cudaStream_t stream) {
  return plus_z ? launch_instance<T, METHOD, THERMAL, PER_STAGE, true>(a, stream)
                : launch_instance<T, METHOD, THERMAL, PER_STAGE, false>(a, stream);
}

template <typename T, int METHOD>
cudaError_t launch_method(const PulseArgs& a, bool thermal, bool per_stage, bool plus_z,
                          cudaStream_t stream) {
  if (!thermal) return launch<T, METHOD, false, false>(a, plus_z, stream);
  if constexpr (METHOD == kRk4) {
    if (per_stage) return launch<T, METHOD, true, true>(a, plus_z, stream);
  }
  return launch<T, METHOD, true, false>(a, plus_z, stream);
}

template <typename T>
cudaError_t launch_type(const PulseArgs& a, int method, bool thermal, bool per_stage, bool plus_z,
                        cudaStream_t stream) {
  switch (method) {
    case kEuler:
      return launch_method<T, kEuler>(a, thermal, per_stage, plus_z, stream);
    case kHeun:
      return launch_method<T, kHeun>(a, thermal, per_stage, plus_z, stream);
    case kRk4:
      return launch_method<T, kRk4>(a, thermal, per_stage, plus_z, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

__global__ void probe_add_one_kernel(const float* x, float* y, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = x[i] + 1.0f;
}

// Over all 2^32 float32 bit patterns x, counts where div6(x) and the IEEE
// quotient x / 6.0f differ: counts[0] in value (any bit, unless both are
// NaN), counts[1] in a NaN's payload only.
__global__ void check_div6_kernel(unsigned long long* counts) {
  const uint32_t stride = gridDim.x * blockDim.x;
  unsigned long long bad = 0;
  unsigned long long payload = 0;
  for (uint64_t b = blockIdx.x * blockDim.x + threadIdx.x; b < (1ull << 32); b += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(b));
    const float got = div6(x);
    const float want = x / 6.0f;
    if (__float_as_uint(got) != __float_as_uint(want)) {
      if (isnan(got) && isnan(want)) {
        ++payload;
      } else {
        ++bad;
      }
    }
  }
  atomicAdd(&counts[0], bad);
  atomicAdd(&counts[1], payload);
}

// The bf16 ops the kernel computes natively, in the order of
// spintorque_check_bf16_ops's records: x + y, x - y, x * y over every
// ordered pair, then -x, 0.5 x and 2 x over every x; last the control,
// x * y + x over every pair.
enum Bf16CheckOp { kCheckAdd = 0, kCheckSub, kCheckMul, kCheckNeg, kCheckHalf, kCheckTwo,
                   kCheckFmaControl, kNumCheckOps };

// The check's control: x * y + z fused, rounded once, where PyTorch rounds
// the product and then the sum. The kernel never uses it. The check must
// find it different from PyTorch's form on some pairs; one that found it
// equal everywhere would be comparing an op with itself.
__device__ __forceinline__ Bf16 bf16_fma_rn(Bf16 x, Bf16 y, Bf16 z) {
  unsigned short r;
  asm("fma.rn.bf16 %0, %1, %2, %3;"
      : "=h"(r)
      : "h"(bf16_bits(x)), "h"(bf16_bits(y)), "h"(bf16_bits(z)));
  return bf16_from_bits(r);
}

// Equal bits, or both NaN.
__device__ __forceinline__ bool same_bf16(Bf16 a, Bf16 b) {
  const unsigned short x = bf16_bits(a);
  const unsigned short y = bf16_bits(b);
  return x == y || ((x & 0x7fffu) > 0x7f80u && (y & 0x7fffu) > 0x7f80u);
}

// Over every ordered pair (x, y) of bf16 bit patterns (the pair's index is
// x << 16 | y), each native op of the kernel against PyTorch's form of it
// (the float op rounded to bf16), and the control; the unary ops over every
// x (index x), the scalars 0.5 and 2 as the kernel has them (bf16
// constants, a native multiply).
// Adds each op's mismatches to counts[op] and lowers first[op] to its
// first mismatching index.
__global__ void check_bf16_ops_kernel(unsigned long long* counts, unsigned long long* first) {
  const uint32_t stride = gridDim.x * blockDim.x;
  unsigned long long bad[kNumCheckOps] = {};
  unsigned long long low[kNumCheckOps];
#pragma unroll
  for (int k = 0; k < kNumCheckOps; ++k) low[k] = ~0ull;
  const auto note = [&](int op, bool ok, uint64_t index) {
    if (!ok) {
      ++bad[op];
      low[op] = min(low[op], static_cast<unsigned long long>(index));
    }
  };
  for (uint64_t p = blockIdx.x * blockDim.x + threadIdx.x; p < (1ull << 32); p += stride) {
    const Bf16 x = bf16_from_bits(static_cast<unsigned short>(p >> 16));
    const Bf16 y = bf16_from_bits(static_cast<unsigned short>(p & 0xffffu));
    note(kCheckAdd, same_bf16(bf16_add_rn(x, y), bf16_add_f32(x, y)), p);
    note(kCheckSub, same_bf16(bf16_sub_rn(x, y), bf16_sub_f32(x, y)), p);
    note(kCheckMul, same_bf16(bf16_mul_rn(x, y), bf16_mul_f32(x, y)), p);
    note(kCheckFmaControl,
         same_bf16(bf16_fma_rn(x, y, x), bf16_add_f32(bf16_mul_f32(x, y), x)), p);
    if (p < (1ull << 16)) {
      note(kCheckNeg, same_bf16(-y, bf16_neg_f32(y)), p);
      note(kCheckHalf, same_bf16(from_f32<Bf16>(0.5f) * y, from_f32<Bf16>(0.5f * to_f32(y))), p);
      note(kCheckTwo, same_bf16(from_f32<Bf16>(2.0f) * y, from_f32<Bf16>(2.0f * to_f32(y))), p);
    }
  }
#pragma unroll
  for (int k = 0; k < kNumCheckOps; ++k) {
    if (bad[k]) {
      atomicAdd(&counts[k], bad[k]);
      atomicMin(&first[k], low[k]);
    }
  }
}

}  // namespace spintorque

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched). bf16 != 0 selects K6; key points
// to the thermal stream's 64-bit Philox key on the device (read only by a
// thermal launch); env_offset is the global index of env 0 (nonzero on every
// shard of K5 but the first).
extern "C" int spintorque_pulse_integrate(
    const float* mx0, const float* my0, const float* mz0, const int32_t* n, const float* dt,
    const float* sigma, const float* h_k, const float* ms, const float* neg_gamma_eff,
    const float* alpha, const float* stt, const float* ex, const float* ey, const float* ez,
    const int64_t* perm, float* mx, float* my, float* mz, bool* failed,
    const unsigned long long* key, int batch, int method, int thermal, int per_stage, int plus_z,
    int bf16, unsigned int env_offset, void* stream) {
  using namespace spintorque;
  if (batch <= 0 || (thermal && key == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const PulseArgs a{mx0, my0, mz0, n, dt, sigma, h_k, ms, neg_gamma_eff, alpha, stt, ex, ey,
                    ez, perm, mx, my, mz, failed, reinterpret_cast<const uint64_t*>(key), batch,
                    env_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(launch_type<Bf16>(a, method, thermal, per_stage, plus_z, s));
  }
  return static_cast<int>(launch_type<float>(a, method, thermal, per_stage, plus_z, s));
}

// The fast-path probe: y = x + 1 over `count` floats.
extern "C" int spintorque_probe_add_one(const float* x, float* y, int count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 128;
  spintorque::probe_add_one_kernel<<<(count + block - 1) / block, block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(x, y, count);
  return static_cast<int>(cudaGetLastError());
}

// The exhaustive check of div6: adds to counts[0] (of two zeroed device
// counters) the float32 inputs where div6(x) and x / 6.0f differ in value,
// and to counts[1] those where both are NaN with other payloads.
extern "C" int spintorque_check_div6(unsigned long long* counts, void* stream) {
  spintorque::check_div6_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(counts);
  return static_cast<int>(cudaGetLastError());
}

// The exhaustive check of K6's native bf16 ops against PyTorch's: adds to
// counts[op] (of kNumCheckOps zeroed counters) the inputs where the native
// op and the float op rounded to bf16 differ (two NaNs count as equal), and
// lowers first[op] (of kNumCheckOps set to all ones) to the first such
// input's index, for the ops of Bf16CheckOp (the last, the control, must
// differ).
extern "C" int spintorque_check_bf16_ops(unsigned long long* counts, unsigned long long* first,
                                         void* stream) {
  spintorque::check_bf16_ops_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, first);
  return static_cast<int>(cudaGetLastError());
}
