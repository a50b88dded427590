"""The CUDA pulse kernels (K1 in float32, K6 with bf16 stage arithmetic,
K5 on a shard) against their plain versions, the PPO trainer, the
quantum tier's integer products, devices and matmul precision, the
adaptive loop's subnormal pole states and the sign of flushed subnormals,
on the card.

Every test here carries the ``cuda`` marker and skips where torch sees no
CUDA device. This file imports no JAX, so it also runs where the JAX
package is not installed; run it on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Deterministic results must agree at rtol/atol 2e-6 with n_substeps and
failed identical (the kernel is built with --fmad=false and mirrors the
plain version op for op, so they usually agree to the bit). K6 rounds every
stage op to bf16 as a torch bf16 op does, and is held to the same bounds.
"""

import itertools
import types

import pytest
import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu_torch.physics import integrate_pulse_plain
from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
from spintorque_tpu_torch.utils import measure_env_throughput, measure_train_throughput

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ci.cuda_kernel_available()
    return torch.device("cuda")


def _params(device, axis=(0.0, 0.0, 1.0), **over):
    vals = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                volume=1e-23, polarization=0.7)
    vals.update(over)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in vals.items()}
    return LLGSParams(**p, easy_axis=torch.tensor(axis, dtype=torch.float32, device=device))


def _setup(B, device, seed=0, cur=200.0):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(B, 3, generator=g, dtype=torch.float64)
    m = m / m.norm(dim=-1, keepdim=True)
    spans = 5e-11 + 2.5e-10 * torch.rand(B, generator=g, dtype=torch.float64)
    current = cur * (2 * torch.rand(B, generator=g, dtype=torch.float64) - 1)

    def f(x):
        return x.float().to(device).contiguous()

    return (f(m[:, 0]), f(m[:, 1]), f(m[:, 2])), f(spans), f(current)


def _assert_close(a, b, tol=2e-6):
    for x, y in zip(a.m, b.m):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)
    assert torch.equal(a.n_substeps, b.n_substeps)
    assert torch.equal(a.failed, b.failed)


@pytest.mark.parametrize("axis", [(0.0, 0.0, 1.0), (0.6, 0.0, 0.8)], ids=["plus_z", "tilted"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_kernel_matches_plain_deterministic(cuda, method, axis):
    m0, spans, cur = _setup(200, cuda)
    p = _params(cuda, axis)
    cfg = IntegratorConfig(method=method, max_substeps=256)
    _assert_close(integrate_pulse(m0, spans, cur, p, cfg),
                  integrate_pulse_plain(m0, spans, cur, p, cfg))


@pytest.mark.parametrize(
    "cfg",
    [
        IntegratorConfig(method="rk4", max_substeps=256, thermal=True, rk4_noise="per_substep"),
        IntegratorConfig(method="rk4", max_substeps=256, thermal=True, rk4_noise="per_stage"),
        IntegratorConfig(method="heun", max_substeps=256, thermal=True, noise_mode="physical"),
    ],
    ids=["rk4_per_substep", "rk4_per_stage", "heun_physical"],
)
def test_kernel_matches_plain_thermal(cuda, cfg):
    """Same Philox stream: only the card's logf and the plain version's log
    may differ in the last bit, so 1e-5 bounds the difference."""
    m0, spans, cur = _setup(512, cuda, seed=3)
    p = _params(cuda)
    _assert_close(integrate_pulse(m0, spans, cur, p, cfg, seed=77),
                  integrate_pulse_plain(m0, spans, cur, p, cfg, seed=77), tol=1e-5)


def _bitwise(got, m, n, failed):
    assert all(torch.equal(x, y) for x, y in zip(got.m, m))
    assert torch.equal(got.n_substeps, n)
    assert torch.equal(got.failed, failed)


@pytest.mark.parametrize(
    "case", ["batch_100", "n_0_1_max_in_a_warp", "every_n_0", "chunk_plus_one", "k5_offset"])
@pytest.mark.parametrize("noise", ["per_substep", "per_stage"])
def test_thermal_ring_ragged_cases_bitwise(cuda, noise, case):
    """The producer warps' ring at its edges, bit for bit with the plain
    version: a batch that is no multiple of 32; n = 0 and n = 1 in the warp
    of n = 300 (counts the dt law cannot give, so ``launch_pulse`` takes them
    and the reference is the plain version per group of rows, each env's
    draws and integration being its own); every n = 0; n one past a multiple
    of the ring's chunk; a K5 shard at a nonzero env_offset."""
    cfg = IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise=noise)
    p = _params(cuda)
    if case == "batch_100":
        m0, spans, cur = _setup(100, cuda, seed=8)
        want = integrate_pulse_plain(m0, spans, cur, p, cfg, seed=5)
        _bitwise(integrate_pulse(m0, spans, cur, p, cfg, seed=5), *want[:2], want.failed)
    elif case == "n_0_1_max_in_a_warp":
        m0, _, cur = _setup(32, cuda, seed=8)
        spans = torch.linspace(3e-10, 4e-10, 32, device=cuda)
        groups = ((0, 30, 300), (30, 31, 1), (31, 32, 0))
        n = torch.tensor([c for lo, hi, c in groups for _ in range(lo, hi)], dtype=torch.int32,
                         device=cuda)
        got = ci.launch_pulse(m0, spans / n.float(), n, cur, p, cfg, seed=5)
        parts = [integrate_pulse_plain(tuple(x[lo:hi] for x in m0), spans[lo:hi], cur[lo:hi], p,
                                       cfg._replace(max_substeps=cap), seed=5, env_offset=lo)
                 for lo, hi, cap in groups]
        _bitwise(got, [torch.cat([r.m[k] for r in parts]) for k in range(3)],
                 torch.cat([r.n_substeps for r in parts]), torch.cat([r.failed for r in parts]))
    elif case == "every_n_0":
        m0, spans, cur = _setup(64, cuda, seed=8)
        zero = torch.zeros(64, dtype=torch.int32, device=cuda)
        got = ci.launch_pulse(m0, spans / zero.float(), zero, cur, p, cfg, seed=5)
        _bitwise(got, m0, zero, torch.zeros(64, dtype=torch.bool, device=cuda))
    elif case == "chunk_plus_one":
        m0, _, cur = _setup(96, cuda, seed=8)
        n_odd = ci.PULSE_CHUNK * 13 + 1
        spans = torch.full((96,), (n_odd + 0.5) * 1e-12, device=cuda)
        want = integrate_pulse_plain(m0, spans, cur, p, cfg, seed=5)
        assert int(want.n_substeps.min()) == int(want.n_substeps.max()) == n_odd
        _bitwise(integrate_pulse(m0, spans, cur, p, cfg, seed=5), *want[:2], want.failed)
    else:
        m0, spans, cur = _setup(256, cuda, seed=8)
        want = integrate_pulse_plain(m0, spans, cur, p, cfg, seed=5, env_offset=4096)
        got = ci.integrate_pulse_cuda(m0, spans, cur, p, cfg, seed=5, env_offset=4096)
        _bitwise(got, *want[:2], want.failed)


@pytest.mark.parametrize("axis", [(0.0, 0.0, 1.0), (0.6, 0.0, 0.8)], ids=["plus_z", "tilted"])
@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_bf16_kernel_matches_plain(cuda, method, axis):
    """K6 against the plain bf16 version: deterministic at 2e-6, and thermal
    (rk4 per stage, the same Philox stream) at 1e-5."""
    m0, spans, cur = _setup(200, cuda, seed=4)
    p = _params(cuda, axis)
    cfg = IntegratorConfig(method=method, max_substeps=256, bf16_rhs=True)
    before = ci.PULSE_BF16_LAUNCHES.count
    _assert_close(integrate_pulse(m0, spans, cur, p, cfg),
                  integrate_pulse_plain(m0, spans, cur, p, cfg))
    assert ci.PULSE_BF16_LAUNCHES.count - before == 1
    hot = cfg._replace(thermal=True, rk4_noise="per_stage")
    _assert_close(integrate_pulse(m0, spans, cur, p, hot, seed=5),
                  integrate_pulse_plain(m0, spans, cur, p, hot, seed=5), tol=1e-5)


def test_native_bf16_ops_equal_torch_bf16_ops(cuda):
    """Every bf16 op K6 computes natively (add, sub, mul over all 2^32
    ordered pairs; neg, x 0.5, x 2 over all 2^16 values) equals torch's
    bf16 op, the float op rounded once, bit for bit (two NaNs equal). The
    control, a fused multiply-add against torch's two roundings, differs:
    the check can fail."""
    out = ci.check_bf16_ops(cuda)
    assert {op: out[op] for op in ci.BF16_OPS} == {op: (0, None) for op in ci.BF16_OPS}
    bad, first = out[ci.BF16_CONTROL]
    assert bad > 0 and len(first) == 2


def test_bf16_op_chain_equals_its_plain_version(cuda):
    """K7's base2_bf16 chain, in K6's native bf16 ops, equals torch's bf16
    chain on the card bit for bit, and holds x = 1."""
    from spintorque_tpu_torch.ops import op_chain as oc

    for block in (1024, 256):
        x = oc.check_input("base2_bf16", 2048, device=cuda)
        before = oc.OP_CHAIN_LAUNCHES.count
        y = oc.op_chain(x, "base2_bf16", oc.CHECK_STEPS, block)
        torch.cuda.synchronize()
        assert oc.OP_CHAIN_LAUNCHES.count - before == 1
        assert torch.equal(y, oc.op_chain_plain(x, "base2_bf16", oc.CHECK_STEPS))
    ones = torch.ones(1024, device=cuda)
    assert torch.equal(oc.op_chain(ones, "base2_bf16", 10_000), ones)


def _trainer(cuda, **env_kw):
    env = SpinTorqueEnv(batch_size=64, device=cuda, max_duration=1e-10, max_steps=4, **env_kw)
    return PPOTrainer(env, PPOConfig(rollout_steps=4, num_epochs=2, num_minibatches=2,
                                     hidden_sizes=(32, 32)))


@pytest.mark.parametrize("bf16_rhs", [False, True], ids=["k1", "k6"])
def test_train_step_launches_the_pulse_kernel_without_host_sync(cuda, bf16_rhs):
    trainer = _trainer(cuda, bf16_rhs=bf16_rhs)
    ts = trainer.init(0)
    k1, k6 = ci.PULSE_LAUNCHES.count, ci.PULSE_BF16_LAUNCHES.count
    ts, metrics = trainer.train_step(ts)
    launched = (ci.PULSE_LAUNCHES.count - k1, ci.PULSE_BF16_LAUNCHES.count - k6)
    assert launched == ((0, 4) if bf16_rhs else (4, 0))
    assert torch.isfinite(metrics["loss"]).item()
    out = measure_train_throughput(trainer, warmup=0, steps=1, sync_debug_mode="error")
    assert out["rollout_ms"][0] > 0 and out["update_ms"][0] > 0


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_kernel_flushes_subnormal_pole_states_as_the_plain_loop(cuda, method):
    """Pole states whose transverse components are float32 subnormals, under
    currents that destabilize their pole: the kernel flushes the state's
    subnormals on entry and after every substep, as the plain loop does (and
    XLA, which the JAX package runs on), so both hold every such state at its
    pole exactly, and agree bit for bit on the rest of the batch."""
    B = 256
    m0, spans, _ = _setup(B, cuda, seed=9)
    tiny = torch.tensor([1e-38, -5e-39, 1e-45, 3e-40], dtype=torch.float32, device=cuda)
    mx, my, mz = (x.clone() for x in m0)
    poles = torch.arange(128, device=cuda)
    mx[poles] = tiny[poles % 4]
    my[poles] = -tiny[(poles + 1) % 4]
    mz[poles] = torch.where(poles < 64, -1.0, 1.0)
    spans[:] = 2.5e-10
    cur = torch.where(torch.arange(B, device=cuda) % 2 == 0, -2.7e-7, 2.7e-7).float()
    p = _params(cuda, volume=1e-24, uniaxial_anisotropy=8e5)
    cfg = IntegratorConfig(method=method, max_substeps=512)
    got = integrate_pulse((mx, my, mz), spans, cur, p, cfg)
    want = integrate_pulse_plain((mx, my, mz), spans, cur, p, cfg)
    for a, b in zip(got.m, want.m):
        assert torch.equal(a, b)
    assert torch.equal(got.n_substeps, want.n_substeps)
    assert torch.equal(got.failed, want.failed)
    assert (got.m[0][:128] == 0).all() and (got.m[1][:128] == 0).all()
    assert torch.equal(got.m[2][:128], mz[:128])


def _bits(x):
    """The int32 bit patterns of a float32 tensor: -0 and +0 differ."""
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("kernel", ["k1", "k5", "k6"])
def test_kernels_keep_the_sign_of_flushed_subnormals(cuda, kernel, method):
    """States that reach +-subnormal: every sign of (+-1e-40, +-1e-40, +-1),
    flushed on entry, and of (+-3e-38, +-3e-38, +-1), decaying through the
    subnormal range under 2e-12 A/m^2 over 1 ns. K1, K5 (rank 1 of 2) and K6
    flush to a zero of the subnormal's sign, as XLA and the plain version
    do, and hold the plain version bit for bit, compared as int32 bits so
    that -0 differs from +0; some components end at -0."""
    signs = torch.tensor(list(itertools.product((1.0, -1.0), repeat=3)))
    m = torch.cat([signs * torch.tensor([mag, mag, 1.0]) for mag in (1e-40, 3e-38)])
    m = m.float().repeat(16, 1).to(cuda)  # 256 rows
    B = m.shape[0]
    m0 = tuple(m[:, k].contiguous() for k in range(3))
    spans = torch.full((B,), 1e-9, device=cuda)
    cur = torch.full((B,), 2e-12, device=cuda)
    p = _params(cuda, volume=1e-24, uniaxial_anisotropy=8e5)
    cfg = IntegratorConfig(method=method, max_substeps=1000, bf16_rhs=kernel == "k6")
    counter = {"k1": ci.PULSE_LAUNCHES, "k5": ci.PULSE_SHARDED_LAUNCHES,
               "k6": ci.PULSE_BF16_LAUNCHES}[kernel]
    before = counter.count
    mesh = types.SimpleNamespace(data_rank=1) if kernel == "k5" else None
    got = integrate_pulse(m0, spans, cur, p, cfg, mesh=mesh)
    want = integrate_pulse_plain(m0, spans, cur, p, cfg, env_offset=B if mesh else 0)
    assert counter.count - before == 1
    for a, b in zip(got.m, want.m):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got.n_substeps, want.n_substeps)
    assert torch.equal(got.failed, want.failed)
    xy = torch.stack(got.m[:2])
    assert ((xy == 0) & torch.signbit(xy)).any()


def test_indivisible_mesh_batch_launches_k1(cuda):
    """A global batch that does not divide the mesh's data axis runs
    unsharded, as the JAX package's ``integrate_pulse_pallas`` falls back:
    one K1 launch at env offset 0, no K5, bit for bit with the launch
    without a mesh, thermal draws included."""
    from spintorque_tpu_torch.parallel import Mesh, split_mesh

    B = 4097
    m0, spans, cur = _setup(B, cuda, seed=11)
    p = _params(cuda)
    cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True,
                           rk4_noise="per_substep")
    mesh = Mesh({"data": 2, "model": 1}, cuda)
    k1, k5 = ci.PULSE_LAUNCHES.count, ci.PULSE_SHARDED_LAUNCHES.count
    got = integrate_pulse(m0, spans, cur, p, cfg, seed=3, mesh=split_mesh(B, mesh))
    assert (ci.PULSE_LAUNCHES.count - k1, ci.PULSE_SHARDED_LAUNCHES.count - k5) == (1, 0)
    want = integrate_pulse(m0, spans, cur, p, cfg, seed=3)
    for a, b in zip(got.m, want.m):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got.n_substeps, want.n_substeps)


def test_surface_code_logical_failure_on_the_card(cuda):
    """The surface code's integer products on the card (CUDA torch has no
    integer matmul: syndromes are float32 products, the logical overlap a
    product and a sum) equal the CPU's over all 512 error patterns; the
    Monte-Carlo rate runs on the card's generator."""
    from spintorque_tpu_torch.quantum import SurfaceCodeErrorCorrection

    errors = (torch.arange(512)[:, None] >> torch.arange(9)) & 1
    card, cpu = SurfaceCodeErrorCorrection(cuda), SurfaceCodeErrorCorrection("cpu")
    for kind in ("x", "z"):
        for dtype in (torch.int32, torch.int64):
            e = errors.to(dtype)
            assert torch.equal(card.measure_syndrome(e.to(cuda), kind).cpu(),
                               cpu.measure_syndrome(e, kind))
            assert torch.equal(card.logical_failure(e.to(cuda), kind).cpu(),
                               cpu.logical_failure(e, kind))
    rate = card.logical_error_rate(0.01, n_trials=100_000)
    assert 0.0 < rate["logical_x_rate"] < 0.01 and 0.0 < rate["logical_z_rate"] < 0.01


def test_quantum_entry_points_default_to_the_card(cuda):
    """A circuit built without a device runs on the card whatever it is
    given: CPU angles, a ``from_complex`` state, and its unitary, and
    agrees with the same circuit on the CPU."""
    import numpy as np

    from spintorque_tpu_torch.quantum import QuantumCircuit
    from spintorque_tpu_torch.quantum import statevector as sv

    circ = QuantumCircuit(3).h(0).ry(1, 0).cnot(0, 2).rz(2, 1)
    cpu_circ = QuantumCircuit(3, circ.gates, device="cpu")
    angles = torch.tensor([[0.3, -1.1], [2.0, 0.7]])
    psi = sv.from_complex(np.full(8, 8 ** -0.5))
    assert psi.is_cuda and sv.gate_pair(sv.GATES["H"]).is_cuda
    for got, want in ((circ.run(angles), cpu_circ.run(angles)),
                      (circ.run(angles, state=psi), cpu_circ.run(angles, state=psi.cpu())),
                      (circ.run(angles.cuda(), state=psi.cpu()),
                       cpu_circ.run(angles, state=psi.cpu()))):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(circ.unitary(np.zeros(2)), cpu_circ.unitary(np.zeros(2)),
                               atol=1e-6)


def test_gate_products_refuse_reduced_precision_matmuls(cuda):
    """The gate products must be full float32 (the JAX package asks for
    ``Precision.HIGHEST``): with TF32 matmuls turned on, a gate on a card
    state raises, and it runs again once they are off."""
    from spintorque_tpu_torch.quantum import statevector as sv

    state = sv.zero_state(4, device=cuda)
    h = sv.gate_pair(sv.GATES["H"], cuda)
    before = torch.get_float32_matmul_precision()
    try:
        for precision in ("high", "medium"):
            torch.set_float32_matmul_precision(precision)
            with pytest.raises(RuntimeError, match="full float32"):
                sv.apply_gate(state, h, (0,))
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.isclose(sv.probabilities(sv.apply_gate(state, h, (0,))).sum(),
                         torch.tensor(1.0, device=cuda))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m0, spans, cur = _setup(8, cuda)
    p = _params(cuda)
    cfg = IntegratorConfig(max_substeps=64)
    with pytest.raises(TypeError):
        integrate_pulse(tuple(x.double() for x in m0), spans.double(), cur.double(),
                        p.to(dtype=torch.float64), cfg)
    bf16 = integrate_pulse(m0, spans, cur, p, cfg._replace(bf16_rhs=True))  # launches K6
    assert all(torch.isfinite(x).all() for x in bf16.m)
    with pytest.raises(ValueError):
        integrate_pulse(m0, spans, cur, p, cfg._replace(method="dop853"))
    strided = torch.stack(m0, -1)
    with pytest.raises(ValueError):
        integrate_pulse((strided[:, 0], strided[:, 1], strided[:, 2]), spans, cur, p, cfg)
    with pytest.raises(ValueError):
        integrate_pulse(m0, spans.cpu(), cur, p, cfg)


def test_integrate_pulse_with_gradients_raises_on_the_card(cuda):
    """K1 has no backward: a current that requires grad raises, launches
    nothing, and the plain loop on the same card tensors differentiates.
    The currents are ~1e-6 A/m^2, the smooth regime where the gradient is
    finite (at larger ones the simplified STT term is stiff and the
    gradient NaN, in the JAX package too)."""
    m0, spans, cur = _setup(8, cuda)
    p = _params(cuda)
    cfg = IntegratorConfig(max_substeps=64)
    ci.PULSE_LAUNCHES.reset()
    current = (cur * 5e-9).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        integrate_pulse(m0, spans, current, p, cfg)
    assert ci.PULSE_LAUNCHES.count == 0
    res = integrate_pulse_plain(m0, spans, current, p, cfg)
    res.m[2].sum().backward()
    assert current.grad is not None and torch.isfinite(current.grad).all()


def test_env_step_launches_the_kernel_without_host_sync(cuda):
    env = SpinTorqueEnv(batch_size=256, device=cuda, max_duration=1e-10)
    before = ci.PULSE_LAUNCHES.count
    measure_env_throughput(env, n_inner=4, warmup=1, blocks=1, iters_per_block=1,
                           sync_debug_mode="error")
    assert ci.PULSE_LAUNCHES.count - before == 8
    with pytest.raises(ValueError):
        SpinTorqueEnv(batch_size=4, device=cuda, dtype="float64")


@pytest.mark.parametrize("bf16_rhs", [False, True], ids=["k1", "k6"])
def test_sharded_kernel_equals_unsharded(cuda, bf16_rhs):
    """K5: four shards, each keyed by its global rows, equal the unsharded
    launch bit for bit, thermal noise included, and hold to the sharded
    plain version at the thermal tolerance."""
    B, W = 512, 4
    n = B // W
    m0, spans, cur = _setup(B, cuda, seed=6)
    p = _params(cuda)
    cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True,
                           rk4_noise="per_substep", bf16_rhs=bf16_rhs)
    ref = integrate_pulse(m0, spans, cur, p, cfg, seed=3)
    before = ci.PULSE_SHARDED_LAUNCHES.count
    for r in range(W):
        rows = slice(r * n, (r + 1) * n)
        shard = [x[rows].contiguous() for x in (*m0, spans, cur)]
        out = integrate_pulse(tuple(shard[:3]), shard[3], shard[4], p, cfg, seed=3,
                              mesh=types.SimpleNamespace(data_rank=r))
        for got, want in zip(out.m, ref.m):
            assert torch.equal(got, want[rows])
        assert torch.equal(out.n_substeps, ref.n_substeps[rows])
        assert torch.equal(out.failed, ref.failed[rows])
        _assert_close(out, integrate_pulse_plain(tuple(shard[:3]), shard[3], shard[4], p, cfg,
                                                 seed=3, env_offset=r * n), tol=1e-5)
    assert ci.PULSE_SHARDED_LAUNCHES.count - before == W


DEVICE_PARAMS = dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
                     uniaxial_anisotropy=1.2e6, polarization=0.7, easy_axis=[0.6, 0.0, 0.8])


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("thermal", [False, True], ids=["deterministic", "thermal"])
def test_solver_runs_k1_and_matches_plain(cuda, method, thermal):
    """LLGSSolver.solve on the card launches K1 once and agrees with the
    plain version on the card, which the trajectory's loop runs (the CPU's
    float32 ops differ from the card's in the last bit, which these
    currents amplify): 2e-6 deterministic, 1e-5 thermal (the same Philox
    stream), n_steps and failed identical."""
    from spintorque_tpu_torch.physics import LLGSSolver

    g = torch.Generator().manual_seed(9)
    m = torch.randn(300, 3, generator=g)
    solver = LLGSSolver(method=method, max_substeps=512, device=cuda)
    kw = dict(current=50.0, thermal_noise=thermal, seed=5)
    before = ci.PULSE_LAUNCHES.count
    card = solver.solve(m, (0.0, 2e-10), DEVICE_PARAMS, **kw)
    assert ci.PULSE_LAUNCHES.count - before == 1
    plain = solver.solve(m, (0.0, 2e-10), DEVICE_PARAMS, return_trajectory=True, **kw)
    assert ci.PULSE_LAUNCHES.count - before == 1
    tol = 1e-5 if thermal else 2e-6
    torch.testing.assert_close(card["m"], plain["m"][:, -1], rtol=tol, atol=tol)
    assert torch.equal(card["n_steps"], plain["n_steps"])
    assert torch.equal(card["failed"], plain["failed"])


def test_solver_float64_on_the_card_raises(cuda):
    from spintorque_tpu_torch.physics import LLGSSolver

    solver = LLGSSolver(dtype=torch.float64, device=cuda)
    before = ci.PULSE_LAUNCHES.count
    with pytest.raises(ValueError, match="does not cover"):
        solver.solve([0.0, 0.1, 0.99], (0.0, 1e-10), DEVICE_PARAMS)
    assert ci.PULSE_LAUNCHES.count == before
    traj = solver.solve([0.0, 0.1, 0.99], (0.0, 1e-11), DEVICE_PARAMS, return_trajectory=True)
    assert traj["m"].dtype == torch.float64 and traj["m"].device.type == "cuda"


def test_adaptive_on_the_card_matches_the_cpu(cuda):
    from spintorque_tpu_torch.physics import AdaptiveLLGSSolver

    m = torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    for method in ("RK45", "midpoint", "Radau"):
        card = AdaptiveLLGSSolver(method=method, rtol=1e-5, atol=1e-8, device=cuda).solve(
            m, (0.0, 2e-11), DEVICE_PARAMS)
        cpu = AdaptiveLLGSSolver(method=method, rtol=1e-5, atol=1e-8, dtype=torch.float64,
                                 device="cpu").solve(m.double(), (0.0, 2e-11), DEVICE_PARAMS)
        assert card["success"] and cpu["success"]
        torch.testing.assert_close(card["m"].cpu().double(), cpu["m"], rtol=0, atol=1e-4)


def test_adaptive_rk45_holds_subnormal_pole_states_on_the_card(cuda):
    """The -z pole with float32 subnormal transverse parts under a current
    that destabilizes it: the adaptive loop flushes the state's subnormals
    on entry and after each accepted update, so RK45 ends at the pole on
    the card with the CPU port's step counts (and XLA's: 28 steps)."""
    from spintorque_tpu_torch.physics import integrate_adaptive
    from spintorque_tpu_torch.physics.solver import params_from_dict

    dp = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
              uniaxial_anisotropy=8e5, polarization=0.7)
    tiny = torch.tensor([1e-38, -5e-39, 1e-45, 3e-40])
    m0 = (tiny, -tiny.roll(1), torch.full((4,), -1.0))
    span, cur = torch.full((4,), 2.5e-10), torch.full((4,), -2.7e-7)
    card = integrate_adaptive(tuple(x.to(cuda) for x in m0), span.to(cuda), cur.to(cuda),
                              params_from_dict(dp, device=cuda), max_steps=4000)
    cpu = integrate_adaptive(m0, span, cur, params_from_dict(dp, device="cpu"), max_steps=4000)
    for res in (card, cpu):
        assert res.success.all()
        assert [x.abs().cpu().tolist() for x in res.m] == [[0.0] * 4, [0.0] * 4, [1.0] * 4]
    assert torch.equal(card.n_steps.cpu(), cpu.n_steps)
    assert torch.equal(card.n_rejected.cpu(), cpu.n_rejected)
    assert cpu.n_steps.tolist() == [28] * 4


def test_env_states_are_pure_and_resume_on_the_card(cuda, tmp_path):
    from spintorque_tpu_torch.utils import load_env_state, save_env_state

    env = SpinTorqueEnv(batch_size=256, device=cuda, max_steps=2, max_duration=2e-10)
    action = torch.stack([torch.linspace(-2e6, 2e6, 256), torch.full((256,), 1e-10)], -1).to(cuda)
    state, _ = env.reset(seed=3)
    state, _ = env.step(state, action)
    save_env_state(tmp_path / "s.pt", state)
    a, ta = env.step(state, action)
    b, tb = env.step(state, action)
    c, tc = env.step(load_env_state(tmp_path / "s.pt", cuda), action)
    for x in (b, c):
        assert torch.equal(a.m, x.m) and torch.equal(a.target, x.target)
    for x in (tb, tc):
        assert torch.equal(ta.obs, x.obs) and torch.equal(ta.reward, x.reward)


def test_first_probe_from_threads_probes_once(cuda):
    """Threads that reach the first launch together (a serving refresh
    thread and the main thread) probe once, under the build lock, and all
    see True."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    ci.forget_probe()
    ci.PROBE_LAUNCHES.reset()
    barrier = threading.Barrier(8)

    def probe(_):
        barrier.wait()
        return ci.cuda_kernel_available()

    with ThreadPoolExecutor(8) as ex:
        assert list(ex.map(probe, range(8))) == [True] * 8
    assert ci.PROBE_LAUNCHES.count == 1


def test_worker_pool_coalesces_on_the_card(cuda):
    """Solves submitted from 8 threads run as K1 launches on the pool's
    drainer thread; each result equals its row of one solve_batch bit for
    bit."""
    import numpy as np

    from spintorque_tpu_torch.physics.solver import params_from_dict
    from spintorque_tpu_torch.utils import PhysicsWorkerPool, parallel_map

    rng = np.random.default_rng(0)
    m0 = rng.normal(size=(512, 3)).astype(np.float32)
    spans = rng.uniform(1e-11, 1e-10, 512).astype(np.float32)
    currents = rng.uniform(-1e11, 1e11, 512).astype(np.float32)
    params = params_from_dict(dict(volume=1e-24), device=cuda)
    with PhysicsWorkerPool(params, device=cuda) as ref:
        whole = ref.solve_batch(m0, spans, currents)
    ci.PULSE_LAUNCHES.reset()
    with PhysicsWorkerPool(params, max_wait_ms=5.0, device=cuda) as pool:
        futs = parallel_map(lambda i: pool.submit(m0[i], (0.0, float(spans[i])), currents[i]),
                            range(512))
        rows = np.stack([f.result(timeout=120) for f in futs])
        stats = pool.get_statistics()
    np.testing.assert_array_equal(rows, whole)
    assert ci.PULSE_LAUNCHES.count == stats["batches"] >= 1


def test_serving_endpoint_checks_run_k1_from_the_refresh_thread(cuda):
    import time

    from spintorque_tpu_torch.deployment import ServingEndpoint

    ep = ServingEndpoint(host="127.0.0.1", port=0, refresh_interval=0.2, device=cuda)
    ep.start()
    try:
        assert ep.state.health["status"] == "HEALTHY"
        ci.PULSE_LAUNCHES.reset()
        # Two refreshes end after the reset: the second one began after it.
        deadline = time.monotonic() + 120
        for _ in range(2):
            last = ep.state.metric("spintorque_last_refresh_unixtime")
            while ep.state.metric("spintorque_last_refresh_unixtime") == last:
                assert time.monotonic() < deadline
                time.sleep(0.05)
    finally:
        ep.stop()
    assert ci.PULSE_LAUNCHES.count >= 2  # the physics check and the env step
    assert ep.state.readiness["checks"]["subsystem_health"]["passed"]


def _steps_per_s(env, action, n):
    """Steps of ``env`` (B=1) per second with one host read a step, as a
    Gymnasium adapter reads its step, resetting on termination or
    truncation; one warm step first."""
    import time

    from spintorque_tpu_torch.utils.host import to_host

    state, _ = env.reset(0)
    action = torch.as_tensor(action, dtype=torch.float32, device=env.device)[None]
    state, ts = env.step(state, action)
    to_host(ts)
    t0 = time.perf_counter()
    for _ in range(n):
        state, ts = env.step(state, action)
        host = to_host(ts)
        if host.terminated[0] or host.truncated[0]:
            state, _ = env.reset(0)
    return n / (time.perf_counter() - t0)


def test_single_env_faster_than_reference_gate(cuda):
    """tests/integration/test_perf_gates.py's single-env gate (>10 steps/s)
    on the functional env with the configuration GymSpinTorqueEnv(
    include_thermal_fluctuations=False, max_duration=1e-9, dtype="float32")
    builds (the card's machine has no gymnasium)."""
    from spintorque_tpu_torch.envs import SpinTorqueEnvConfig

    cfg = SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-9, autoreset=False)
    env = SpinTorqueEnv(batch_size=1, config=cfg, device=cuda)
    rate = _steps_per_s(env, [1e5, 1e-9], 50)
    assert rate > 10, f"single-env rate {rate:.1f} steps/s under reference gate"


def test_array_env_faster_than_reference_gate(cuda):
    """The 4x4 array gate (>1 step/s) on the configuration
    GymSpinTorqueArrayEnv(array_size=(4, 4), action_mode="global",
    dtype="float32") builds."""
    from spintorque_tpu_torch.envs import ArrayEnvConfig, SpinTorqueArrayEnv

    cfg = ArrayEnvConfig(rows=4, cols=4, action_mode="global", autoreset=False)
    env = SpinTorqueArrayEnv(batch_size=1, config=cfg, device=cuda)
    rate = _steps_per_s(env, [0.0, 1e5], 20)
    assert rate > 1, f"array-env rate {rate:.1f} steps/s under reference gate"


def test_soak_is_healthy_on_the_card(cuda):
    """utils.soak at B=4096 with the default env configuration for a few
    seconds: no bad block, a mean failed-solve fraction under 5%, one K1
    launch a step."""
    from spintorque_tpu_torch.utils.soak import N_INNER, soak

    env = SpinTorqueEnv(batch_size=4096, device=cuda)
    ci.PULSE_LAUNCHES.reset()
    rec = soak(env, seconds=5.0, warmup_blocks=1)
    assert rec["healthy"] and rec["bad_blocks"] == 0 and rec["blocks"] >= 1, rec
    assert ci.PULSE_LAUNCHES.count == (1 + rec["blocks"]) * N_INNER
    assert rec["card"] and rec["backend"] == "cuda"
