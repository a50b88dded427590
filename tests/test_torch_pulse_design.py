"""The pulse kernel's design figures, on the CPU: the dependent depth of one
substep (``pulse_chain_depth``) and the chain floor priced from it, the
ring of every configuration within a block's shared memory (from the
constants of ``csrc/pulse_integrator.cu``), the parse of ptxas's register
and spill report, and the wrappers' refusal of CPU tensors (no fallback).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.ops import _build
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.ops import op_chain as oc
from spintorque_tpu_torch.physics import IntegratorConfig
from spintorque_tpu_torch.physics.integrator import noise_draws

CSRC = Path(ci.__file__).resolve().parent.parent / "csrc"

CONFIGS = {
    "euler": IntegratorConfig(method="euler"),
    "heun": IntegratorConfig(method="heun"),
    "rk4": IntegratorConfig(method="rk4"),
    "euler_thermal": IntegratorConfig(method="euler", thermal=True),
    "heun_physical": IntegratorConfig(method="heun", thermal=True, noise_mode="physical"),
    "rk4_per_substep": IntegratorConfig(method="rk4", thermal=True, rk4_noise="per_substep"),
    "rk4_per_stage": IntegratorConfig(method="rk4", thermal=True, rk4_noise="per_stage"),
}
RHS_EVALUATIONS = {"euler": 1, "heun": 2, "rk4": 4}

# (method, plus_z, bf16) -> simple ops on the chain, deterministic; counted
# by hand from csrc/llgs_substep.cuh (rhs +z 10, general 14; the subnormal
# flush's compare one). With bf16 the stage ops are native bf16 ops
# (BF16_DEPTH), and the simple ones are the state's rounding, the
# increment's widening, div6 with its widening and rounding (RK4), the
# state's add, the squared norm, the compare and the flush's compare.
SIMPLE_DEPTH = {
    ("euler", True, False): 17, ("euler", False, False): 21,
    ("heun", True, False): 30, ("heun", False, False): 38,
    ("rk4", True, False): 59, ("rk4", False, False): 75,
    ("euler", True, True): 8, ("euler", False, True): 8,
    ("heun", True, True): 8, ("heun", False, True): 8,
    ("rk4", True, True): 13, ("rk4", False, True): 13,
}
# (method, plus_z) -> native bf16 ops on K6's chain: the float32 chain's
# stage ops, one instruction each.
BF16_DEPTH = {
    ("euler", True): 11, ("euler", False): 15,
    ("heun", True): 24, ("heun", False): 32,
    ("rk4", True): 50, ("rk4", False): 66,
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("plus_z", [True, False], ids=["plus_z", "general"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_chain_depth_counts(method, plus_z, bf16):
    cfg = IntegratorConfig(method=method, bf16_rhs=bf16)
    depth = ci.pulse_chain_depth(cfg, plus_z)
    assert depth == {
        "simple": SIMPLE_DEPTH[(method, plus_z, bf16)],
        "bf16": BF16_DEPTH[(method, plus_z)] if bf16 else 0,
        # div6's; normalize's, before sqrt; the subnormal flush's
        "select": 3 if method == "rk4" else 2,
        "div": 1,  # normalize's division by the norm; RK4's / 6 is div6
        "sqrt": 1,
        "log": 0,
        "cos": 0,
    }
    # A non-finite increment's fallback to +z skips the division, nothing else.
    assert ci.pulse_chain_depth(cfg, plus_z, fallback=True) == {**depth, "div": 0}


@pytest.mark.parametrize("plus_z", [True, False], ids=["plus_z", "general"])
@pytest.mark.parametrize("name", [k for k, c in CONFIGS.items() if c.thermal])
def test_thermal_adds_no_sampler_depth(name, plus_z):
    """The sampler (Philox, log, sqrt, cos/sin) runs on producer warps: a
    thermal substep's chain is the deterministic one plus the field's one add
    onto H per right-hand side evaluation, in the stage type's class (one
    native bf16 add with bf16)."""
    hot = CONFIGS[name]
    cold = hot._replace(thermal=False)
    for bf16 in (False, True):
        d_hot = ci.pulse_chain_depth(hot._replace(bf16_rhs=bf16), plus_z)
        d_cold = ci.pulse_chain_depth(cold._replace(bf16_rhs=bf16), plus_z)
        cls = "bf16" if bf16 else "simple"
        assert d_hot[cls] - d_cold[cls] == RHS_EVALUATIONS[hot.method]
        assert {k: v for k, v in d_hot.items() if k != cls} == {
            k: v for k, v in d_cold.items() if k != cls}
        assert d_hot["log"] == d_hot["cos"] == 0


PRICES_NS = {"simple": 4.0, "bf16": 5.0, "select": 6.0, "div": 65.0, "sqrt": 46.0, "log": 103.0,
             "cos": 116.0}


def test_chain_floor_of_the_main_config():
    depth = ci.pulse_chain_depth(CONFIGS["rk4_per_substep"], True)
    per_substep_ns = sum(v * PRICES_NS[k] for k, v in depth.items())
    assert per_substep_ns == pytest.approx(63 * 4.0 + 3 * 6.0 + 65.0 + 46.0)


def test_bf16_chain_floor_prices_native_ops():
    """K6's floor of the main config prices its 54 native bf16 ops (50
    stage ops and 4 thermal adds) at the bf16 latency and its 13
    conversions and float ops at the float one: RK4 per substep, +z,
    thermal, on the fallback path."""
    cfg = CONFIGS["rk4_per_substep"]._replace(bf16_rhs=True)
    depth = ci.pulse_chain_depth(cfg, True, fallback=True)
    assert depth == {"simple": 13, "bf16": 54, "select": 3, "div": 0, "sqrt": 1, "log": 0,
                     "cos": 0}
    n = torch.tensor([5001, 17], dtype=torch.int32)
    want = 5001 * (13 * 4.0 + 54 * 5.0 + 3 * 6.0 + 46.0) * 1e-6
    assert ci.pulse_chain_floor_ms(n, cfg, True, PRICES_NS, fallback=True) == pytest.approx(want)
    # K1's floor needs no bf16 price.
    no_bf16 = {k: v for k, v in PRICES_NS.items() if k != "bf16"}
    assert ci.pulse_chain_floor_ms(n, CONFIGS["rk4_per_substep"], True, no_bf16) > 0


def test_bf16_operators_are_native_rounded_ptx():
    """The device forms of Bf16's +, -, * and unary - are one PTX
    instruction each with an explicit round to nearest (neg is exact), so
    ptxas contracts none into an FMA; the header names no fused bf16
    multiply-add and none of cuda_bf16.h's operators, which may be
    contracted. The scalars 0.5 and 2 are bf16 constants."""
    text = (CSRC / "llgs_substep.cuh").read_text()
    for op in ("add", "sub", "mul"):
        assert re.search(rf'asm\("{op}\.rn\.bf16 %0, %1, %2;"', text), op
    assert re.search(r'asm\("neg\.bf16 %0, %1;"', text)
    assert not re.search(r"\b(add|sub|mul)\.bf16\b", text)  # no op without .rn
    for name in ("fma.rn.bf16", "__hfma", "__hmul", "__hadd"):
        assert name not in text, name
    for op, sym in (("add", "+"), ("sub", "-"), ("mul", "*")):
        assert f"Bf16 operator{sym}(Bf16 a, Bf16 b) {{ return bf16_{op}_rn(a, b); }}" in text
        body = re.search(rf"Bf16 bf16_{op}_rn\(Bf16 a, Bf16 b\) \{{(.*?)\n\}}", text, re.S)
        assert body and f"{op}.rn.bf16" in body.group(1), op
    assert "Bf16 operator-(Bf16 a) { return bf16_neg_rn(a); }" in text
    # The scalars enter as exact bf16 constants: no float * Bf16 operator.
    assert "operator*(float" not in text
    assert "const T kHalf = from_f32<T>(0.5f);" in text
    assert "const T kTwo = from_f32<T>(2.0f);" in text


@pytest.mark.parametrize("plus_z", [True, False])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_bf16_ops_are_the_stage_ops(method, plus_z):
    """K6's share of a substep's operations that runs as native bf16
    instructions: every stage op but RK4's divisions by 6 and the state's
    add, which are float (the rest, normalization, flush, the failed flag
    and the sampler, is float too); none in K1."""
    f32 = IntegratorConfig(method=method)
    bf16 = f32._replace(bf16_rhs=True)
    assert ci.pulse_bf16_ops_per_substep(f32, plus_z) == 0
    assert ci.pulse_ops_per_substep(bf16, plus_z) == ci.pulse_ops_per_substep(f32, plus_z)
    float_ops = ci._NORMALIZE_OPS + ci._FLUSH_OPS + 4 + 3 + (3 if method == "rk4" else 0)
    float_ops += ci._NEGATIVE_ZERO_OPS if plus_z else 0
    assert ci.pulse_bf16_ops_per_substep(bf16, plus_z) == (
        ci.pulse_ops_per_substep(bf16, plus_z) - float_ops)
    for thermal in (False, True):
        hot = bf16._replace(thermal=thermal)
        assert ci.pulse_bf16_ops_per_substep(hot, plus_z) == ci.pulse_bf16_ops_per_substep(
            bf16, plus_z)
    if method == "rk4" and plus_z:
        assert ci.pulse_bf16_ops_per_substep(bf16, plus_z) == 226  # of 258


@pytest.mark.parametrize("batch", [1, 31, 100, 4096, 65536])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_floor_prices_the_longest_env(name, batch):
    """The floor is the longest env's substeps at one substep's priced
    depth, whatever the batch and its other envs' counts (0 included); the
    fallback path's floor is one division's price less a substep."""
    cfg = CONFIGS[name]
    rng = np.random.default_rng(batch)
    n = torch.from_numpy(rng.integers(0, 5002, size=batch).astype(np.int32))
    n[rng.integers(0, batch)] = 0
    for plus_z in (True, False):
        depth = ci.pulse_chain_depth(cfg, plus_z)
        per_substep_ns = sum(v * PRICES_NS[k] for k, v in depth.items())
        floor = ci.pulse_chain_floor_ms(n, cfg, plus_z, PRICES_NS)
        assert floor == pytest.approx(int(n.max()) * per_substep_ns * 1e-6)
        fallback = ci.pulse_chain_floor_ms(n, cfg, plus_z, PRICES_NS, fallback=True)
        assert fallback == pytest.approx(int(n.max()) * (per_substep_ns - 65.0) * 1e-6)
        assert ci.pulse_chain_floor_ms(n[:0], cfg, plus_z, PRICES_NS) == 0.0


def _source_constant(name):
    text = (CSRC / "pulse_integrator.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrapper_constants_are_the_kernels():
    assert ci.PULSE_CHUNK == _source_constant("kChunk")
    # One consumer warp and at most three producers: four warps, one per
    # sub-partition of an SM.
    assert 1 <= _source_constant("kProducers") <= 3


DEFAULT_SHARED_MEMORY = 49_152  # a block's shared memory without opting in to more


@pytest.mark.parametrize("name", list(CONFIGS))
def test_launch_shape_fits_the_card(name):
    """A thermal block (the consumer warp and kProducers producer warps)
    with its ring of kProducers * kSlotsPerProducer slots of kChunk
    substeps (kChunk / 2 for per-stage RK4, whose 16-byte records are three
    a substep) and two 8-byte mbarriers a slot fits the shared memory a
    block gets without opting in to more."""
    cfg = CONFIGS[name]
    producers = _source_constant("kProducers")
    slots = producers * _source_constant("kSlotsPerProducer")
    records = noise_draws(cfg) if cfg.thermal else 0
    chunk = _source_constant("kChunk") // (2 if records == 3 else 1)
    assert records in (0, 1, 3)
    ring = slots * chunk * records * 32 * 16
    assert 0 <= ring + 2 * 8 * slots <= DEFAULT_SHARED_MEMORY
    assert 32 * (1 + producers) <= 128  # whole warps, one per sub-partition


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN10spintorque12pulse_kernelIfLi2ELb1ELb0ELb1EEEvNS_9PulseArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN10spintorque12pulse_kernelIfLi2ELb1ELb0ELb1EEEvNS_9PulseArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 96 bytes smem, 536 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10spintorque12pulse_kernelI4Bf16Li2ELb1ELb1ELb0EEEvNS_9PulseArgsE' for 'sm_90a'
ptxas info    : Function properties for __internal_accurate_fdividef
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN10spintorque12pulse_kernelI4Bf16Li2ELb1ELb1ELb0EEEvNS_9PulseArgsE
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 536 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = _build.ptxas_report(PTXAS_LOG)
    f32 = "_ZN10spintorque12pulse_kernelIfLi2ELb1ELb0ELb1EEEvNS_9PulseArgsE"
    b16 = "_ZN10spintorque12pulse_kernelI4Bf16Li2ELb1ELb1ELb0EEEvNS_9PulseArgsE"
    assert set(rep) == {f32, b16}  # a subroutine's properties are not a kernel
    assert rep[f32] == dict(registers=64, stack=0, spill_stores=0, spill_loads=0)
    assert rep[b16] == dict(registers=255, stack=16, spill_stores=12, spill_loads=8)


def test_wrappers_refuse_cpu_tensors():
    """No fallback: a CPU tensor given to a kernel wrapper raises, and only
    ``integrate_pulse`` dispatches it to the plain version."""
    x = torch.ones(8)
    with pytest.raises(ValueError):
        ci.probe_add_one(x)
    with pytest.raises(ValueError):
        oc.op_chain(x, "base2", 3)
    m0 = (x, x, x)
    with pytest.raises(ValueError):
        ci.launch_pulse(m0, x, torch.ones(8, dtype=torch.int32), x, None, IntegratorConfig())
