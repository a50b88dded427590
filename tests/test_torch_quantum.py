"""The quantum tier of the port (``spintorque_tpu_torch.quantum``) against
the JAX package's (``spintorque_tpu.quantum``), on the CPU.

The 26 tests of tests/unit/test_quantum.py, ported (``device="cpu"``; the
seeded draws are torch's, so seeded results are held by the JAX tests'
thresholds), then the parts held to JAX on seeded numpy inputs:

  * ``apply_gate`` for every gate kind and wire layout, batched gates
    against JAX's vmap, and whole circuits at 6 qubits: atol 1e-5;
  * ``QuantumCircuit.unitary``: atol 1e-5;
  * the QAOA cost vector and its grid of expectation values: rtol 1e-5
    (the values relative to the grid's largest magnitude: JAX under the
    tests' x64 promotes the cost layer to float64, the port is float32);
  * the surface code's syndromes, decoder tables and ``logical_failure``
    over all 512 error patterns: equal;
  * the VQE energy and its gradient at the same parameters: rtol 1e-5;
  * the surrogate MLP at converted parameters: rtol 1e-5;
  * the stochastic paths (surface-code and repetition-code rates, the noisy
    simulator) against JAX's within binomial bounds: their random streams
    differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spintorque_tpu.quantum as jq
from spintorque_tpu.quantum import circuits as jcircuits
from spintorque_tpu.quantum import energy_landscape as jlandscape
from spintorque_tpu.quantum import optimization as joptimization
from spintorque_tpu.quantum import statevector as jsv
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.quantum import (
    AdaptiveResourceOptimizer,
    AdaptiveScheduler,
    CircuitOptimizer,
    HardwareCompiler,
    HybridMultiDeviceSimulator,
    IterationFreeQAOA,
    LogicalQubitOperations,
    ProgrammableQuantumSimulator,
    QuantumAdvantageVerifier,
    QuantumCircuit,
    QuantumEnhancedEnergyLandscape,
    QuantumMLDeviceOptimizer,
    SimulationTask,
    SkyrmionErrorCorrection,
    SurfaceCodeErrorCorrection,
    SymmetryEnhancedVQE,
    TopologicalProtection,
)
from spintorque_tpu_torch.quantum import energy_landscape as landscape
from spintorque_tpu_torch.quantum import optimization
from spintorque_tpu_torch.quantum import statevector as sv

torch.set_num_threads(1)
CPU = "cpu"


def _circuit(n, gates=None):
    return QuantumCircuit(n, gates, device=CPU)


# ---------------------------------------------------------------------------
# state vector core


def test_bell_state():
    psi = _circuit(2).h(0).cnot(0, 1).run()
    np.testing.assert_allclose(sv.probabilities(psi), [0.5, 0, 0, 0.5], atol=1e-6)


def test_ghz_stabilizers():
    psi = _circuit(3).h(0).cnot(0, 1).cnot(1, 2).run()
    assert abs(float(sv.expectation_pauli(psi, "ZZI")) - 1.0) < 1e-6
    assert abs(float(sv.expectation_pauli(psi, "IZZ")) - 1.0) < 1e-6
    assert abs(float(sv.expectation_pauli(psi, "XXX")) - 1.0) < 1e-6


def test_rotation_gradient_matches_analytic():
    circ = _circuit(1).rx(0, 0)
    p = torch.tensor([0.7], requires_grad=True)
    (grad,) = torch.autograd.grad(sv.expectation_z(circ.run(p), 0), p)
    assert abs(float(grad[0]) + np.sin(0.7)) < 1e-5


def test_expectation_z_wire_order():
    # |01> (wire 0 = 1, wire 1 = 0): <Z0> = -1, <Z1> = +1
    psi = sv.basis_state(2, 1, device=CPU)
    assert float(sv.expectation_z(psi, 0)) == pytest.approx(-1.0)
    assert float(sv.expectation_z(psi, 1)) == pytest.approx(1.0)


def test_sample_counts_distribution():
    psi = _circuit(1).h(0).run()
    samples = sv.sample_counts(psi, torch.Generator().manual_seed(0), 2000)
    frac = float((samples == 1).float().mean())
    assert 0.4 < frac < 0.6


# ---------------------------------------------------------------------------
# circuit optimizer / compiler


def _unitaries_equal(c1, c2, atol=1e-4):
    U1, U2 = np.asarray(c1.unitary()), np.asarray(c2.unitary())
    ov = U1.conj().ravel() @ U2.ravel()
    if abs(ov) < 1e-9:
        return False
    phase = ov / abs(ov)
    return np.allclose(U1 * phase, U2, atol=atol)


def test_optimizer_cancels_self_inverse():
    circ = _circuit(2).h(0).h(0).x(1).x(1)
    opt = CircuitOptimizer().optimize(circ)
    assert len(opt.gates) == 0


def test_optimizer_preserves_unitary():
    rng = np.random.default_rng(3)
    circ = _circuit(3)
    for _ in range(12):
        circ.add(rng.choice(["H", "X", "Y", "S", "T"]), int(rng.integers(3)))
    circ.cnot(0, 2)
    assert _unitaries_equal(circ, CircuitOptimizer().optimize(circ))


def _random_compiler_circuit(rng, n=4, gates=10):
    circ = _circuit(n)
    for _ in range(gates):
        kind = rng.integers(3)
        if kind == 0:
            circ.add(rng.choice(["H", "X", "S", "T"]), int(rng.integers(n)))
        elif kind == 1:
            a, b = rng.choice(n, 2, replace=False)
            circ.add(rng.choice(["CNOT", "CZ", "SWAP"]), (int(a), int(b)))
        else:
            a, b = rng.choice(n, 2, replace=False)
            circ.add("CRZ", (int(a), int(b)), float(rng.uniform(0, 2 * np.pi)))
    return circ


def test_compiler_random_equivalence():
    rng = np.random.default_rng(7)
    hc = HardwareCompiler()
    for _ in range(3):
        circ = _random_compiler_circuit(rng)
        compiled = hc.compile(circ)
        assert _unitaries_equal(circ, compiled)
        # native set only
        for g in compiled.gates:
            assert g.name in ("RZ", "RX", "CZ", "FUSED")


def test_compiler_adjacency():
    compiled = HardwareCompiler().compile(_circuit(4).cnot(0, 3))
    for g in compiled.gates:
        if len(g.wires) == 2:
            assert abs(g.wires[0] - g.wires[1]) == 1


# ---------------------------------------------------------------------------
# QAOA / surrogate optimizers


def test_qaoa_finds_small_qubo_optimum():
    Q = np.array([[-1.0, 2.0, 0.0], [0.0, -1.0, 2.0], [0.0, 0.0, -1.0]])
    qaoa = IterationFreeQAOA(grid_points=16, device=CPU)
    res = qaoa.optimize(Q)
    cost = qaoa.qubo_cost_vector(Q, CPU).numpy()
    assert res.best_value == pytest.approx(float(cost.min()))
    assert qaoa.approximation_ratio(Q, res) == pytest.approx(1.0)


def test_qaoa_cost_vector():
    Q = np.array([[1.0, 0.0], [0.0, 2.0]])
    cost = IterationFreeQAOA.qubo_cost_vector(Q, CPU).numpy()
    np.testing.assert_allclose(cost, [0.0, 1.0, 2.0, 3.0])


def test_surrogate_optimizer_converges():
    def objective(d):
        return (d["a"] - 0.3) ** 2 + (d["b"] + 0.5) ** 2

    opt = QuantumMLDeviceOptimizer(
        n_train=256, train_steps=150, refine_starts=32, refine_steps=40, device=CPU
    )
    res = opt.optimize(objective, {"a": (-1, 1), "b": (-1, 1)}, seed=0)
    assert res.best_value < 0.05


# ---------------------------------------------------------------------------
# error correction


def test_surface_code_structure():
    code = SurfaceCodeErrorCorrection(CPU)
    SZ, SX = code.Z_STABILIZERS, code.X_STABILIZERS
    assert ((SZ @ SX.T) % 2 == 0).all()  # CSS commutation
    assert ((SZ @ code.LOGICAL_X) % 2 == 0).all()
    assert ((SX @ code.LOGICAL_Z) % 2 == 0).all()
    assert (code.LOGICAL_X @ code.LOGICAL_Z) % 2 == 1


def test_surface_code_corrects_all_single_errors():
    code = SurfaceCodeErrorCorrection(CPU)
    errors = torch.eye(9, dtype=torch.int32)
    assert not bool(code.logical_failure(errors, "x").any())
    assert not bool(code.logical_failure(errors, "z").any())


def test_surface_code_suppression():
    code = SurfaceCodeErrorCorrection(CPU)
    res = code.logical_error_rate(0.01, n_trials=100_000)
    assert res["logical_x_rate"] < 0.01
    assert res["logical_z_rate"] < 0.01


def test_topological_protection_arrhenius():
    tp = TopologicalProtection()
    kT = 1.380649e-23 * 300
    low = tp.error_rate(60 * kT, 300.0)
    high = tp.error_rate(20 * kT, 300.0)
    assert low < high
    assert tp.stability_ratio(40 * kT, 300.0) == pytest.approx(40.0)


def test_skyrmion_majority_vote():
    sk = SkyrmionErrorCorrection(3, device=CPU)
    kT = 1.380649e-23 * 300
    out = sk.logical_error_rate(10 * kT, 300.0, op_time=1e-6, n_trials=50_000)
    assert out["logical_rate"] <= out["physical_rate"]


def test_logical_qubit_cnot():
    lq = LogicalQubitOperations(device=CPU)
    control = lq.logical_x(lq.init_frames(2))
    control, target = lq.logical_cnot(control, lq.init_frames(2))
    assert (target[:, 0].numpy() == 1).all()


# ---------------------------------------------------------------------------
# VQE / energy landscape


def test_vqe_finds_diagonal_minimum():
    diag = torch.tensor([3.0, 1.0, -2.0, 0.5, 2.0, 1.5, 0.0, 4.0])
    vqe = SymmetryEnhancedVQE(n_qubits=3, n_layers=2, iterations=200, device=CPU)
    res = vqe.minimize_diagonal(diag)
    assert res["ground_state_index"] == 2
    assert res["final_energy"] < 0.0


def test_quantum_energy_landscape_ground_state():
    from spintorque_tpu_torch.physics.solver import params_from_dict

    params = params_from_dict(
        dict(
            volume=1e-24,
            saturation_magnetization=800e3,
            damping=0.01,
            uniaxial_anisotropy=1e6,
            easy_axis=np.array([0.0, 0.0, 1.0]),
        ),
        device=CPU,
    )
    # without demag the minimum is along +-z (theta 0 or pi)
    qel = QuantumEnhancedEnergyLandscape(params, n_theta_qubits=4, include_demag=False)
    adv = qel.symmetry_advantage()
    assert adv["reduction_factor"] == 2**4
    res = qel.find_ground_state("uniaxial")
    assert abs(np.sin(res["theta"])) < 0.25  # near a pole


# ---------------------------------------------------------------------------
# hybrid scheduling


def test_scheduler_routes_both_paths():
    from spintorque_tpu_torch.physics.solver import params_from_dict

    params = params_from_dict(dict(volume=1e-24), device=CPU)
    tasks = [
        SimulationTask("quantum_circuit", {"circuit": _circuit(2).h(0).cnot(0, 1)}),
        SimulationTask(
            "classical_llgs",
            {"m0": np.tile([0.1, 0.0, 0.995], (4, 1)), "params": params,
             "span": 1e-10, "max_substeps": 128},
        ),
    ]
    sched = AdaptiveScheduler(device=CPU)
    done = sched.submit(tasks)
    stats = sched.get_statistics()
    assert stats["quantum_tasks"] == 1 and stats["classical_tasks"] == 1
    for t in done:
        assert t.result is not None and t.cost_estimate > 0


def test_noisy_simulator_decoheres():
    circ = _circuit(2).h(0).cnot(0, 1)
    clean = ProgrammableQuantumSimulator(0.0, device=CPU).expectation(circ, "XX")
    noisy = ProgrammableQuantumSimulator(0.3, seed=1, device=CPU).expectation(
        circ, "XX", batch=64
    )
    assert clean == pytest.approx(1.0, abs=1e-5)
    assert noisy < clean - 0.05


def test_hybrid_multidevice_step():
    from spintorque_tpu_torch.physics.solver import params_from_dict

    params = params_from_dict(dict(volume=1e-24), device=CPU)
    sim = HybridMultiDeviceSimulator(params, n_devices=4)
    m0 = np.tile([0.1, 0.0, 0.995], (4, 1)).astype(np.float32)
    out = sim.run(m0, currents=[1e6, -1e6], span=1e-10)
    assert out["trajectory"].shape == (3, 4, 3)
    norms = np.linalg.norm(out["final"], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_resource_optimizer_caps_batch():
    ro = AdaptiveResourceOptimizer(hbm_bytes=1e9)
    rec = ro.recommend(
        SimulationTask("quantum_circuit", {"circuit": _circuit(16), "batch": 10**9})
    )
    assert rec["batch"] < 10**9
    rec2 = ro.recommend(SimulationTask("classical_llgs", {"m0": np.zeros((100, 3))}))
    assert rec2["padded_batch"] == 128


# ---------------------------------------------------------------------------
# advantage verification


def test_verifier_detects_real_advantage():
    def better(inst):
        return inst * 0.5  # lower cost, instant

    def worse(inst):
        return inst

    v = QuantumAdvantageVerifier(n_instances=10)
    report = v.verify("halves the cost", better, worse, lambda i: float(i + 1))
    assert report.verified
    assert report.quality_delta > 0


def test_verifier_rejects_no_advantage():
    def same_slow(inst):
        import time as _t

        _t.sleep(0.002)
        return inst

    def same_fast(inst):
        return inst

    v = QuantumAdvantageVerifier(n_instances=8)
    report = v.verify("slower, same quality", same_slow, same_fast, lambda i: float(i))
    assert not report.verified


# ---------------------------------------------------------------------------
# parity with the JAX package


def _random_state(rng, n, batch=()):
    z = rng.normal(size=batch + (2**n,)) + 1j * rng.normal(size=batch + (2**n,))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


GATE_CASES = [
    ("H", (0,)), ("X", (5,)), ("Y", (2,)), ("Z", (3,)), ("S", (1,)), ("T", (4,)),
    ("SDG", (0,)), ("CNOT", (0, 1)), ("CNOT", (4, 1)), ("CZ", (2, 5)), ("SWAP", (5, 0)),
    ("RX", (1,)), ("RY", (3,)), ("RZ", (5,)), ("PHASE", (2,)), ("U3", (4,)),
    ("CRZ", (3, 0)), ("CRZ", (0, 3)),
]


def _pair_both(name, angles):
    """(port gate, JAX gate) real pairs of one gate kind."""
    if name in sv.GATES:
        return sv.gate_pair(sv.GATES[name], CPU), jsv.gate_pair(jsv.GATES[name])
    fn = {"RX": "rx", "RY": "ry", "RZ": "rz", "PHASE": "phase", "U3": "u3", "CRZ": "crz"}[name]
    args = angles[:3] if name == "U3" else angles[:1]
    return (getattr(sv, fn)(*(torch.tensor(a) for a in args)),
            getattr(jsv, fn)(*(jnp.asarray(a, jnp.float32) for a in args)))


@pytest.mark.parametrize("name,wires", GATE_CASES, ids=[f"{n}{w}" for n, w in GATE_CASES])
def test_apply_gate_equals_jax(name, wires):
    rng = np.random.default_rng(len(name) * 7 + sum(wires))
    psi = _random_state(rng, 6)
    angles = rng.uniform(-np.pi, np.pi, size=3)
    gate, jgate = _pair_both(name, angles)
    np.testing.assert_allclose(np.asarray(gate), np.asarray(jgate), atol=1e-7)
    got = sv.apply_gate(sv.from_complex(psi, CPU), gate, wires)
    want = jsv.apply_gate(jsv.from_complex(psi), jgate, wires)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a batch of states, and a batch of gates (one angle per state): JAX's vmap
    states = _random_state(rng, 6, (5,))
    got = sv.apply_gate(sv.from_complex(states, CPU), gate, wires)
    want = jsv.apply_gate_batched(jsv.from_complex(states), jgate, wires)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if name in ("RX", "RY", "RZ", "PHASE", "CRZ"):
        thetas = rng.uniform(-np.pi, np.pi, size=5)
        fn = getattr(sv, name.lower())
        got = sv.apply_gate(sv.from_complex(states, CPU), fn(torch.tensor(thetas)), wires)
        jfn = getattr(jsv, name.lower())
        want = jax.vmap(lambda s, t: jsv.apply_gate(s, jfn(t), wires))(
            jsv.from_complex(states), jnp.asarray(thetas, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _random_circuit(rng, n, depth, circuit_cls, **kw):
    circ = circuit_cls(n, **kw)
    for _ in range(depth):
        kind = rng.integers(5)
        w = int(rng.integers(n))
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        if kind == 0:
            circ.add(str(rng.choice(["H", "X", "Y", "Z", "S", "T", "SDG"])), w)
        elif kind == 1:
            circ.add(str(rng.choice(["CNOT", "CZ", "SWAP"])), (a, b))
        elif kind == 2:
            circ.add(str(rng.choice(["RX", "RY", "RZ", "PHASE"])), w, float(rng.uniform(0, 6)))
        elif kind == 3:
            circ.add("CRZ", (a, b), float(rng.uniform(0, 6)))
        else:
            circ.add("U3", w, tuple(float(x) for x in rng.uniform(0, 6, size=3)))
    return circ


def test_circuits_and_unitary_equal_jax():
    rng = np.random.default_rng(11)
    circ = _random_circuit(rng, 6, 60, QuantumCircuit, device=CPU)
    jcirc = jcircuits.QuantumCircuit(6, circ.gates)
    psi = _random_state(rng, 6)
    np.testing.assert_allclose(
        circ.run(state=sv.from_complex(psi, CPU)).numpy(),
        np.asarray(jax.jit(lambda s: jcirc.run(state=s))(jsv.from_complex(psi))), atol=1e-5)
    np.testing.assert_allclose(circ.run().numpy(), np.asarray(jax.jit(jcirc.run)()), atol=1e-5)
    assert circ.depth() == jcirc.depth() and circ.gate_counts() == jcirc.gate_counts()
    small = _random_circuit(rng, 4, 30, QuantumCircuit, device=CPU)
    np.testing.assert_allclose(small.unitary(),
                               jcircuits.QuantumCircuit(4, small.gates).unitary(), atol=1e-5)
    # the optimizer and the compiler are host algebra: the same gate lists
    for port, jax_ in ((CircuitOptimizer().optimize(small),
                        jcircuits.CircuitOptimizer().optimize(jcircuits.QuantumCircuit(
                            4, small.gates))),
                       (HardwareCompiler().compile(small),
                        jcircuits.HardwareCompiler().compile(jcircuits.QuantumCircuit(
                            4, small.gates)))):
        assert [(g.name, g.wires, g.param) for g in port.gates] == [
            (g.name, g.wires, g.param) for g in jax_.gates]
        np.testing.assert_allclose(port.unitary(), jax_.unitary(), atol=1e-5)


def test_parameterized_circuit_and_gradient_equal_jax():
    """A circuit over a parameter vector, batched over parameter vectors
    where JAX vmaps, and its gradient."""
    circ = _circuit(3).ry(0, 0).rx(1, 1).cnot(0, 2).rz(2, 2).add("CRZ", (2, 0), 3)
    circ.add("PHASE", 1, 1)
    jcirc = jcircuits.QuantumCircuit(3, circ.gates)
    thetas = np.random.default_rng(5).uniform(-3, 3, size=(4, 4))
    got = circ.run(torch.tensor(thetas))
    want = jax.jit(jax.vmap(lambda p: jcirc.run(p)))(jnp.asarray(thetas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    p = torch.tensor(thetas[0], requires_grad=True)
    (grad,) = torch.autograd.grad(sv.expectation_z(circ.run(p), 1), p)
    jgrad = jax.jit(jax.grad(lambda q: jsv.expectation_z(jcirc.run(q), 1)))(
        jnp.asarray(thetas[0]))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_measurements_equal_jax():
    rng = np.random.default_rng(2)
    a, b = _random_state(rng, 5), _random_state(rng, 5)
    sa, sb = sv.from_complex(a, CPU), sv.from_complex(b, CPU)
    ja, jb = jsv.from_complex(a), jsv.from_complex(b)
    np.testing.assert_allclose(sv.probabilities(sa).numpy(), np.asarray(jsv.probabilities(ja)),
                               atol=1e-6)
    np.testing.assert_allclose(float(sv.fidelity(sa, sb)), float(jsv.fidelity(ja, jb)),
                               atol=1e-6)
    for w in range(5):
        np.testing.assert_allclose(float(sv.expectation_z(sa, w)),
                                   float(jsv.expectation_z(ja, w)), atol=1e-6)
    for pauli in ("XYZIX", "ZZIII", "IYYXZ"):
        np.testing.assert_allclose(float(sv.expectation_pauli(sa, pauli, 0.5)),
                                   float(jsv.expectation_pauli(ja, pauli, 0.5)), atol=1e-6)
    np.testing.assert_allclose(sv.to_complex(sa), jsv.to_complex(ja), atol=1e-7)


def test_qaoa_cost_vector_and_grid_equal_jax():
    rng = np.random.default_rng(4)
    Q = np.triu(rng.normal(size=(6, 6)))
    cost = IterationFreeQAOA.qubo_cost_vector(Q, CPU)
    jcost = jq.IterationFreeQAOA.qubo_cost_vector(Q)
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-5, atol=1e-6)
    for p in (1, 2):
        qaoa = IterationFreeQAOA(n_layers=p, grid_points=8, device=CPU)
        jqaoa = jq.IterationFreeQAOA(n_layers=p, grid_points=8)
        angles = qaoa.angle_grid()
        values = qaoa.grid_values(cost, angles)
        want = jax.jit(jax.vmap(
            lambda a: jnp.sum(jsv.probabilities(jqaoa._evolve(a, jcost, 6)) * jcost)))(
            jnp.asarray(angles.numpy()))
        want = np.asarray(want)
        np.testing.assert_allclose(values.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    res, jres = (IterationFreeQAOA(grid_points=12, device=CPU).optimize(Q),
                 jq.IterationFreeQAOA(grid_points=12).optimize(Q))
    assert res.best_value == pytest.approx(jres.best_value)
    assert {k: v for k, v in res.best_params.items() if k.startswith("x")} == {
        k: v for k, v in jres.best_params.items() if k.startswith("x")}
    np.testing.assert_allclose([res.best_params["gamma0"], res.best_params["beta0"]],
                               [jres.best_params["gamma0"], jres.best_params["beta0"]],
                               rtol=1e-6)


def test_surface_code_equals_jax_exactly():
    code, jcode = SurfaceCodeErrorCorrection(CPU), jq.SurfaceCodeErrorCorrection()
    np.testing.assert_array_equal(code._decode_x, jcode._decode_x)
    np.testing.assert_array_equal(code._decode_z, jcode._decode_z)
    errors = ((np.arange(512)[:, None] >> np.arange(9)) & 1).astype(np.int32)
    for kind in ("x", "z"):
        syn = code.measure_syndrome(torch.from_numpy(errors), kind)
        np.testing.assert_array_equal(syn.numpy(), np.asarray(jcode.measure_syndrome(
            jnp.asarray(errors), kind)))
        np.testing.assert_array_equal(code.decode(syn, kind).numpy(),
                                      np.asarray(jcode.decode(jnp.asarray(syn.numpy()), kind)))
        np.testing.assert_array_equal(
            code.logical_failure(torch.from_numpy(errors), kind).numpy(),
            np.asarray(jcode.logical_failure(jnp.asarray(errors), kind)))
    frames = np.random.default_rng(0).integers(0, 2, size=(16, 2)).astype(np.int32)
    lq, jlq = LogicalQubitOperations(code), jq.LogicalQubitOperations(jcode)
    t = torch.from_numpy(frames)
    for ours, theirs in ((lq.logical_x(t), jlq.logical_x(jnp.asarray(frames))),
                         (lq.logical_z(t), jlq.logical_z(jnp.asarray(frames))),
                         (lq.measure_logical_z(t, torch.from_numpy(errors[:16])),
                          jlq.measure_logical_z(jnp.asarray(frames), jnp.asarray(errors[:16])))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    c, t2 = lq.logical_cnot(t, t.flip(0))
    jc, jt = jlq.logical_cnot(jnp.asarray(frames), jnp.asarray(frames[::-1]))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt))


def _binomial_close(a, b, n, sigmas=5.0):
    """Two rates from n trials each agree within ``sigmas`` standard errors."""
    p = (a + b) / 2
    return abs(a - b) <= sigmas * np.sqrt(2 * max(p * (1 - p), 1.0 / n) / n)


def test_stochastic_rates_agree_with_jax_in_distribution():
    n = 100_000
    ours = SurfaceCodeErrorCorrection(CPU).logical_error_rate(0.05, n_trials=n)
    theirs = jq.SurfaceCodeErrorCorrection().logical_error_rate(0.05, n_trials=n)
    for k in ("logical_x_rate", "logical_z_rate"):
        assert _binomial_close(ours[k], theirs[k], n), (k, ours[k], theirs[k])
    kT = 1.380649e-23 * 300
    sk = SkyrmionErrorCorrection(5, device=CPU).logical_error_rate(
        3 * kT, 300.0, op_time=1e-6, n_trials=n)
    jsk = jq.SkyrmionErrorCorrection(5).logical_error_rate(3 * kT, 300.0, op_time=1e-6,
                                                             n_trials=n)
    assert sk["physical_rate"] == pytest.approx(jsk["physical_rate"], rel=1e-12)
    assert _binomial_close(sk["logical_rate"], jsk["logical_rate"], n)
    # the noisy simulator: <XX> of a Bell pair over 512 Monte-Carlo branches
    circ = _circuit(2).h(0).cnot(0, 1)
    noisy = ProgrammableQuantumSimulator(0.2, seed=3, device=CPU).expectation(
        circ, "XX", batch=512)
    jnoisy = jq.ProgrammableQuantumSimulator(0.2, seed=3).expectation(
        jcircuits.QuantumCircuit(2, circ.gates), "XX", batch=512)
    assert abs(noisy - jnoisy) < 5 * np.sqrt(2 / 512), (noisy, jnoisy)


def test_vqe_energy_and_gradient_equal_jax():
    rng = np.random.default_rng(6)
    n, layers = 4, 3
    params = rng.normal(scale=0.8, size=(layers + 1, n))
    diag = rng.normal(size=2**n).astype(np.float32)
    p = torch.tensor(params, dtype=torch.float32, requires_grad=True)
    energy = landscape.ansatz_energy(p, torch.from_numpy(diag), layers)
    (grad,) = torch.autograd.grad(energy, p)

    def jenergy(q):
        psi = jlandscape._hardware_efficient_ansatz(q, n, layers)
        return jnp.sum(jsv.probabilities(psi) * jnp.asarray(diag))

    want, want_grad = jax.jit(jax.value_and_grad(jenergy))(jnp.asarray(params, jnp.float32))
    np.testing.assert_allclose(float(energy.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


def test_landscape_hamiltonian_equals_jax():
    from spintorque_tpu.physics.solver import params_from_dict as jparams
    from spintorque_tpu_torch.physics.solver import params_from_dict

    d = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
             uniaxial_anisotropy=1e6, easy_axis=np.array([0.0, 0.6, 0.8]))
    ours = QuantumEnhancedEnergyLandscape(params_from_dict(d, device=CPU),
                                          n_theta_qubits=3, n_phi_qubits=2,
                                          applied_field=(1e4, 0.0, -2e4))
    theirs = jq.QuantumEnhancedEnergyLandscape(jparams(d), n_theta_qubits=3, n_phi_qubits=2,
                                               applied_field=(1e4, 0.0, -2e4))
    for symmetry in ("uniaxial", "none"):
        np.testing.assert_allclose(ours.diagonal_hamiltonian(symmetry).numpy(),
                                   np.asarray(theirs.diagonal_hamiltonian(symmetry)),
                                   rtol=1e-12)
    assert ours.symmetry_advantage() == theirs.symmetry_advantage()


def test_surrogate_mlp_at_converted_params_equals_jax():
    rng = np.random.default_rng(8)
    layers = joptimization._mlp_init(jax.random.PRNGKey(3), (2, 16, 16, 1))
    host = [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in layers]
    x = rng.uniform(size=(64, 2)).astype(np.float32)
    ours = optimization._mlp_apply(convert.mlp_params_from_numpy(host, device=CPU),
                                   torch.from_numpy(x))
    want = joptimization._mlp_apply([(jnp.asarray(w), jnp.asarray(b)) for w, b in host],
                                    jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    back = convert.mlp_params_to_numpy(convert.mlp_params_from_numpy(host, device=CPU))
    for (w, b), (w2, b2) in zip(host, back):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(b, b2)


def test_entry_points_default_to_the_card():
    """Without ``device`` every entry point asks for the card, which this
    machine lacks: each raises, and none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: QuantumCircuit(2).run(), lambda: IterationFreeQAOA(),
                 lambda: SurfaceCodeErrorCorrection(), lambda: SymmetryEnhancedVQE(2),
                 lambda: AdaptiveScheduler(), lambda: ProgrammableQuantumSimulator(),
                 lambda: QuantumMLDeviceOptimizer(), lambda: sv.zero_state(2),
                 lambda: AdaptiveResourceOptimizer(), lambda: sv.gate_pair(sv.GATES["H"]),
                 lambda: sv.from_complex(np.ones(4)), lambda: QuantumCircuit(2).unitary(),
                 lambda: QuantumCircuit(2).run(state=sv.zero_state(2, device=CPU))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
