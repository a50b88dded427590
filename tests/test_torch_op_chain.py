"""The op-chain micro-benchmark (K7): plain chains, slope arithmetic, and
the kernel against its plain version on the card.

Counterpart of scripts/bench_vpu_op_costs.py, which has no tests of its
own: every chain step must hold x = 1 at its float32 fixed point (so a
chain's output can feed another and stays finite at any length), the
per-op price is the slope between two step counts with the companion
simple ops priced at base2/2, and the kernel's output equals the plain
chain's at 1e-6 on inputs where a wrong chain would not.
"""

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.ops import op_chain as oc

torch.set_num_threads(1)


@pytest.mark.parametrize("op", list(oc.OPS))
def test_plain_chains_stay_at_their_fixed_points(op):
    x = torch.ones(64)
    y = oc.op_chain_plain(x, op, steps=10_000)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), 1.0, atol=1e-6, rtol=0)
    # A nudged start returns to the fixed point or stays within 1e-6 of
    # the nudge, so no chain diverges.
    z = oc.op_chain_plain(torch.full((4,), 1.0 + 1e-6), op, steps=1000)
    assert float((z - 1.0).abs().max()) <= 2e-6


@pytest.mark.parametrize("op", list(oc.OPS))
def test_check_inputs_tell_a_wrong_chain_apart(op):
    """On ``check_input`` the plain chain of ``CHECK_STEPS`` steps is finite
    and differs, by far more than ``CHECK_RTOL``, from its input (a copy),
    from one step fewer or more, and from every other op's chain: a kernel
    that skipped the loop, miscounted or ran another op would fail the
    comparison with it."""
    x = oc.check_input(op, 4096, seed=1)
    lo, hi = oc.CHECK_DOMAIN[op]
    assert float(x.min()) >= lo and float(x.max()) <= hi
    want = oc.op_chain_plain(x, op, oc.CHECK_STEPS)
    assert torch.isfinite(want).all()
    wrong = {"copy": x, "one step fewer": oc.op_chain_plain(x, op, oc.CHECK_STEPS - 1),
             "one step more": oc.op_chain_plain(x, op, oc.CHECK_STEPS + 1)}
    wrong.update({other: oc.op_chain_plain(x, other, oc.CHECK_STEPS)
                  for other in oc.OPS if other != op})
    for name, got in wrong.items():
        assert not torch.allclose(got, want, rtol=100 * oc.CHECK_RTOL, atol=0.0), name


def test_slope_and_isolation_on_synthetic_times():
    lo, hi, intercept = 200_000, 600_000, 0.013  # ms of launch and loop set-up
    true = {"base2": 4.2, "sqrt": 9.0, "log": 20.0, "div": 15.0}
    step_ns = {}
    for op, ns in true.items():
        def t(steps):
            return intercept + ns * steps * 1e-6

        step_ns[op] = oc.slope_ns_per_step(t(lo), t(hi), lo, hi)
        assert step_ns[op] == pytest.approx(ns, rel=1e-9)
    iso = oc.isolate(step_ns)
    assert iso["simple"] == pytest.approx(2.1)
    assert iso["sqrt"] == pytest.approx(9.0)  # no companion
    assert iso["log"] == pytest.approx(20.0 - 2.1)
    assert iso["div"] == pytest.approx(15.0 - 2.1)
    assert "base2" not in iso


def test_bf16_step_prices_the_bf16_class():
    """base2_bf16's step is two native bf16 ops: half of it prices the
    ``bf16`` class of K6's chain, as half of base2 prices ``simple``."""
    iso = oc.isolate({"base2": 8.4, "base2_bf16": 9.0, "sqrt": 9.0})
    assert iso == pytest.approx({"simple": 4.2, "bf16": 4.5, "sqrt": 9.0})
    assert "base2_bf16" not in iso


def test_bf16_chain_rounds_every_step_to_bf16():
    """The plain base2_bf16 chain is torch's bf16 ops: every value it gives
    is a bf16 value, and one step equals x * (2 - x) in bf16."""
    x = oc.check_input("base2_bf16", 4096, seed=2)
    b = x.to(torch.bfloat16)
    assert torch.equal(oc.op_chain_plain(x, "base2_bf16", 1), (b * (2.0 - b)).float())
    y = oc.op_chain_plain(x, "base2_bf16", oc.CHECK_STEPS)
    assert torch.equal(y, y.to(torch.bfloat16).float())
    assert not torch.equal(y, oc.op_chain_plain(x, "base2", oc.CHECK_STEPS))


def test_kernel_wrapper_raises_off_the_card():
    with pytest.raises(ValueError):
        oc.op_chain(torch.ones(1024), "base2", 1)
    with pytest.raises(RuntimeError):
        oc.measure_op_costs(device="cpu")
    assert list(oc.OPS) == ["base2", "sqrt", "rsqrt", "log", "exp", "cos", "div", "select",
                            "base2_bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1024, 256])
def test_kernel_matches_plain_chain_on_the_card(block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for op in oc.OPS:
        x = oc.check_input(op, 2048, device="cuda")
        before = oc.OP_CHAIN_LAUNCHES.count
        y = oc.op_chain(x, op, oc.CHECK_STEPS, block)
        torch.cuda.synchronize()
        assert oc.OP_CHAIN_LAUNCHES.count - before == 1
        torch.testing.assert_close(y, oc.op_chain_plain(x, op, oc.CHECK_STEPS),
                                   rtol=oc.CHECK_RTOL, atol=0.0)
    with pytest.raises(ValueError):
        oc.op_chain(x, "tan", 1)
