"""The pulse kernel's +z substeps against the general form, bit for bit,
compiled for the host.

``csrc/llgs_substep.cuh``'s ``rhs`` specializes the easy axis e = (+0, +0,
1): it loads no axis and multiplies by none of its components. That drops
the general form's products by +0, zeros that can change only the sign of
a result that is a zero, and such a sign reaches the new state only through
a state component that is -0, and not from the zero row (every form falls
back to +z). So the kernel's ``integrate_block`` runs a block of substeps in
the +z form and, when one of them began from a state with a -0 component
that is not the zero row (``zero_signs_matter``), runs the block again in
the general form. The plain
version, like the JAX package's XLA path, runs the general form; the kernel
must give its bits, signed zeros included.

There is no nvcc here, but the substeps' float arithmetic is plain C++:
``div6``, ``zero_of``, ``Coeffs``, ``rhs``, the normalization, the flush,
``substep`` and ``integrate_block`` are cut from the header and compiled
with the host's C++ compiler (``-ffp-contract=off``, as the kernel builds
with ``--fmad=false``), the device qualifiers defined away and the
intrinsics given host forms. From every state whose components are zeros
of either sign, normals near FLT_MIN or of order one, the harness runs
Euler, Heun and RK4, thermal and deterministic: a block of eight substeps
with ``integrate_block`` on +z from the flushed state, as the kernel
begins, against the general form's eight (new bits and zero-row flag;
some blocks must meet a -0 that their first state lacks, made by a flush,
as a step of 1e-18 s turns a component near FLT_MIN into another's
subnormal), and one substep in the +z form alone against the general
form's. The +z substep alone must differ somewhere (the control: a harness
that finds nothing there compares nothing), and nowhere that
``zero_signs_matter`` clears.
"""

import pathlib
import re
import shutil
import subprocess

import pytest

CSRC = pathlib.Path(__file__).resolve().parents[1] / "spintorque_tpu_torch" / "csrc"

PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>
#define __device__
#define __forceinline__ inline
static inline float __uint_as_float(uint32_t b) { float f; std::memcpy(&f, &b, 4); return f; }
static inline uint32_t __float_as_uint(float f) { uint32_t b; std::memcpy(&b, &f, 4); return b; }
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
using std::isfinite;
namespace spintorque {
enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };
inline float to_f32(float x) { return x; }
template <typename T> T from_f32(float x);
template <> inline float from_f32<float>(float x) { return x; }
"""

MAIN = r"""
}  // namespace spintorque
using namespace spintorque;

static bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (std::isnan(a) && std::isnan(b));
}

struct Counts { long long states = 0, block = 0, control = 0, cleared = 0, later = 0; };

template <int METHOD, bool THERMAL>
void run(Counts& n) {
  const std::vector<float> v = {0.0f, -0.0f, 1.2e-38f, -1.2e-38f, 3e-38f, -3e-38f,
                                0.3f, -0.3f, 0.8f, -0.8f, 1.0f, -1.0f,
                                1.5e-38f, -1.5e-38f, 1e-37f, -1e-37f, 1e-30f, -1e-30f};
  const float fields[3][12] = {
      {0.0f, -0.0f, 0.0f, -0.0f, 0.0f, -0.0f, 0.0f, -0.0f, 0.0f, -0.0f, 0.0f, -0.0f},
      {-0.0f, 0.0f, -0.0f, -0.0f, -0.0f, 0.0f, 0.0f, 0.0f, -0.0f, 0.0f, -0.0f, -0.0f},
      {1e3f, -2e3f, 0.0f, -5e2f, 0.0f, 7e2f, -0.0f, 1e3f, -1e3f, 3e2f, 0.0f, -0.0f}};
  for (float hk : {1.6e6f, -4e5f}) for (float stt : {0.0f, -0.0f, 3e9f})
  for (float dt : {1e-12f, 1e-13f, 1e-18f}) for (int f = 0; f < (THERMAL ? 3 : 1); ++f)
  for (float x : v) for (float y : v) for (float z : v) {
    const Coeffs<float> c{hk, 8e5f, -1.7598e11f, 0.01f, stt, 0.0f, 0.0f, 1.0f};
    // Substep j's fields: the pattern rotated by j, so the block's fields differ.
    const auto load = [&](int j, float (&h)[12]) {
      for (int r = 0; r < 12; ++r) h[r] = fields[f][(r + 5 * j) % 12];
    };
    float h[12];
    // The kernel's first state: m0 flushed.
    float g[3] = {flush_subnormal(x), flush_subnormal(y), flush_subnormal(z)};
    const float first_state[3] = {g[0], g[1], g[2]};
    float b[3];
    const bool first = zero_signs_matter(g[0], g[1], g[2]);
    bool gf = false, bf = false, later = false;
    for (int j = 0; j < 8; ++j) {
      load(j, h);
      gf |= substep<float, METHOD, THERMAL, false>(g[0], g[1], g[2], h, c, dt);
      later |= j < 7 && !first && zero_signs_matter(g[0], g[1], g[2]);
    }
    const auto start = [&](float& sx, float& sy, float& sz, bool& sf) {
      sx = first_state[0];
      sy = first_state[1];
      sz = first_state[2];
      sf = false;
    };
    integrate_block<float, METHOD, THERMAL, true>(b[0], b[1], b[2], bf, 8, h, c, dt, start, load);
    n.block += !(same(b[0], g[0]) && same(b[1], g[1]) && same(b[2], g[2]) && bf == gf);
    n.later += later;
    float s[3] = {x, y, z}, k[3] = {x, y, z};
    load(0, h);
    const bool sz = substep<float, METHOD, THERMAL, false>(s[0], s[1], s[2], h, c, dt);
    const bool kz = substep<float, METHOD, THERMAL, true>(k[0], k[1], k[2], h, c, dt);
    const bool kd = !(same(k[0], s[0]) && same(k[1], s[1]) && same(k[2], s[2]) && kz == sz);
    ++n.states;
    n.control += kd;
    n.cleared += kd && !zero_signs_matter(x, y, z);
  }
}

int main() {
  Counts n;
  run<kEuler, false>(n); run<kEuler, true>(n);
  run<kHeun, false>(n); run<kHeun, true>(n);
  run<kRk4, false>(n); run<kRk4, true>(n);
  std::printf("%lld %lld %lld %lld %lld\n", n.states, n.block, n.control, n.cleared, n.later);
  return 0;
}
"""


def _cut(text, start, end):
    i = text.index(start)
    return text[i:text.index(end, i)]


# flush_finite's one PTX instruction, and its host form: a subnormal's zero
# of its sign, every other finite x itself (the card's tests hold the
# instruction to the plain flush).
FTZ_ASM = 'asm("mul.ftz.f32 %0, %1, 0f3F800000;" : "=f"(y) : "f"(x));'
FTZ_HOST = "y = std::fabs(x) < 1.17549435e-38f ? std::copysign(0.0f, x) : x;"


def _harness_source():
    text = (CSRC / "llgs_substep.cuh").read_text()
    assert FTZ_ASM in text
    text = text.replace(FTZ_ASM, FTZ_HOST)
    div6 = _cut(text, "__device__ __forceinline__ float div6(float x) {",
                "__device__ __forceinline__ Bf16 div6")
    zero_of = _cut(text, "__device__ __forceinline__ float zero_of(float x) {",
                   "template <typename T>\nstruct Coeffs {")
    substep = _cut(text, "template <typename T>\nstruct Coeffs {", "// Float4 records")
    return PRELUDE + div6 + zero_of + substep + MAIN


def test_plus_z_blocks_have_the_general_forms_bits(tmp_path):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler")
    src = tmp_path / "plus_z_signs.cpp"
    src.write_text(_harness_source())
    exe = tmp_path / "plus_z_signs"
    subprocess.run([compiler, "-std=c++17", "-O1", "-ffp-contract=off", str(src), "-o", str(exe)],
                   check=True, capture_output=True, text=True, timeout=180)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=180)
    states, block, control, cleared, later = map(int, out.stdout.split())
    assert states == 18 ** 3 * 2 * 3 * 3 * (1 + 3) * 3
    assert block == 0, f"{block} of {states} blocks differ from the general form's bits"
    assert control > 0, "the +z substep matched the general form on every state"
    assert later > 0, "no block met a -0 component after its first state"
    assert cleared == 0, (
        f"the +z substep differs on {cleared} states that zero_signs_matter clears")
