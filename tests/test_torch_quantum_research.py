"""The quantum half of the port's research tier
(``research.quantum_machine_learning``, ``research.quantum_spintronics``,
``research.validation_framework.QuantumValidationFramework``) against the
JAX package's, on the CPU.

The six quantum tests of tests/unit/test_research_tier.py, ported
(``device="cpu"``; the seeded draws are torch's, so seeded results are held
by the JAX tests' thresholds; ``sample_obs`` draws a batch from a
``torch.Generator`` where JAX's maps over keys), then the parts held to JAX:

  * the QNN and QRL forward passes (and the QNN's gradient) at the JAX
    models' parameters carried across by ``convert``: atol 1e-5;
  * the Ising cost vector: rtol 1e-6; ``estimate_qubo`` of a
    non-quadratic objective: atol 1e-6;
  * ``QuantumSpintronicBenchmark`` on the same instances: the same
    exhaustive and greedy values, and the QAOA's;
  * ``QuantumValidationFramework``: every check passes, as in JAX, with
    the measured quantities within float32's rounding of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spintorque_tpu.research as jresearch
from spintorque_tpu.research import quantum_machine_learning as jqml
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.research import (
    QuantumNeuralNetwork,
    QuantumReinforcementLearning,
    QuantumSpinOptimizer,
    QuantumSpintronicBenchmark,
    QuantumSpintronicOptimizer,
    QuantumValidationFramework,
)

torch.set_num_threads(1)
CPU = "cpu"


# ---------------------------------------------------------------------------
# quantum spintronics / QML


def test_qubo_estimation_exact_for_quadratics():
    rng = np.random.default_rng(0)
    Q_true = np.triu(rng.normal(size=(5, 5)))

    def objective(X):
        return np.einsum("ki,ij,kj->k", X, Q_true, X)

    Q_est = QuantumSpintronicOptimizer.estimate_qubo(objective, 5)
    # symmetric part determines the objective on 0/1 vectors
    np.testing.assert_allclose(
        Q_est + Q_est.T - np.diag(np.diag(Q_est)),
        Q_true + Q_true.T - np.diag(np.diag(Q_true)),
        atol=1e-6,
    )


def test_quantum_spintronic_optimizer_end_to_end():
    Q = np.array([[-2.0, 3.0], [0.0, -1.0]])

    def discrete_obj(X):
        return np.einsum("ki,ij,kj->k", X, Q, X)

    def cont_obj(design, params):
        return (params["scale"] - float(design.sum())) ** 2

    out = QuantumSpintronicOptimizer(grid_points=12, device=CPU).optimize(
        discrete_obj, 2, cont_obj, {"scale": (0.0, 3.0)},
        cem_kwargs={"population": 128, "iterations": 6},
    )
    assert out["discrete"].best_value == pytest.approx(-2.0)  # x=(1,0)
    assert out["best_value"] < 0.05


def test_ising_ground_state():
    # ferromagnetic pair + field: ground state both spins down
    J = np.array([[0.0, -1.0], [0.0, 0.0]])
    h = np.array([0.5, 0.5])
    opt = QuantumSpinOptimizer(iterations=200, device=CPU)
    res = opt.optimize(J, h)
    assert res["spin_energy"] == pytest.approx(-2.0)  # -1*1 + (-1-1)*0.5
    assert tuple(res["spins"]) == (-1, -1)


def test_qnn_learns_separable_labels():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(48, 2)).astype(np.float32)
    y = np.sign(X[:, 0]).astype(np.float32)
    qnn = QuantumNeuralNetwork(n_qubits=3, n_blocks=2, learning_rate=0.1, device=CPU)
    out = qnn.fit(X, y, epochs=120)
    assert out["final_loss"] < out["loss_history"][0]
    assert qnn.accuracy(X, y) > 0.8


def test_quantum_rl_improves_reward():
    # bandit: action 1 always pays when obs[0] > 0, action 0 otherwise
    def sample_obs(generator, batch):
        return 2.0 * torch.rand((batch, 2), generator=generator) - 1.0

    def reward_fn(obs, action):
        want = 1 if obs[0] > 0 else 0
        return 1.0 if action == want else 0.0

    agent = QuantumReinforcementLearning(n_obs_features=2, n_actions=2,
                                         n_qubits=2, learning_rate=0.2, device=CPU)
    out = agent.train(sample_obs, reward_fn, episodes=60, batch=16)
    assert out["final_mean_reward"] > np.mean(out["reward_history"][:5])


def test_quantum_validation_passes():
    report = QuantumValidationFramework(device=CPU).run_all()
    failing = [c for c in report["checks"] if not c["passed"]]
    assert report["passed"], f"failing checks: {failing}"


# ---------------------------------------------------------------------------
# parity with the JAX package


def test_qnn_forward_and_gradient_at_converted_params_equal_jax():
    jqnn = jqml.QuantumNeuralNetwork(n_qubits=3, n_blocks=2, seed=4)
    jqnn.params = jqnn.params + 0.7 * jax.random.normal(jax.random.PRNGKey(9), jqnn.params.shape)
    qnn = convert.variational_params_from_numpy(
        np.asarray(jqnn.params), QuantumNeuralNetwork(n_qubits=3, n_blocks=2, device=CPU))
    np.testing.assert_array_equal(convert.variational_params_to_numpy(qnn),
                                  np.asarray(jqnn.params, np.float32))
    X = np.random.default_rng(1).uniform(-1, 1, size=(16, 2)).astype(np.float32)
    np.testing.assert_allclose(qnn.predict(X).numpy(), np.asarray(jqnn.predict(X)), atol=1e-5)
    y = np.sign(X[:, 0])
    p = qnn.params.detach().clone().requires_grad_(True)
    loss = torch.mean((qnn(p, torch.from_numpy(X)) - torch.from_numpy(y)) ** 2)
    (grad,) = torch.autograd.grad(loss, p)
    jgrad = jax.jit(jax.grad(lambda q: jnp.mean(
        (jax.vmap(lambda x: jqnn.forward(q, x))(jnp.asarray(X)) - jnp.asarray(y)) ** 2)))(
        jnp.asarray(jqnn.params, jnp.float32))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_qrl_logits_at_converted_params_equal_jax():
    jagent = jqml.QuantumReinforcementLearning(n_obs_features=3, n_actions=3, seed=2)
    agent = convert.variational_params_from_numpy(
        np.asarray(jagent.params),
        QuantumReinforcementLearning(n_obs_features=3, n_actions=3, device=CPU))
    obs = np.random.default_rng(3).uniform(-1, 1, size=(8, 3)).astype(np.float32)
    want = jax.vmap(lambda o: jagent.logits(jagent.params, o))(jnp.asarray(obs))
    with torch.no_grad():
        np.testing.assert_allclose(agent.logits(agent.params, torch.from_numpy(obs)).numpy(),
                                   np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(agent.logits(agent.params, torch.from_numpy(obs[0])).numpy(),
                                   np.asarray(want[0]), atol=1e-5)
    assert agent.act(obs[0], torch.Generator().manual_seed(0)) in range(3)


def test_ising_cost_and_qubo_estimate_equal_jax():
    rng = np.random.default_rng(5)
    J, h = rng.normal(size=(5, 5)), rng.normal(size=5)
    np.testing.assert_allclose(QuantumSpinOptimizer.ising_cost_vector(J, h, CPU).numpy(),
                               np.asarray(jqml.QuantumSpinOptimizer.ising_cost_vector(J, h)),
                               rtol=1e-6, atol=1e-6)

    def objective(X):  # not quadratic: Q is a second-order surrogate
        return np.sin(X @ np.arange(1.0, 5.0)) + (X[:, 0] * X[:, 1] * X[:, 2])

    np.testing.assert_allclose(
        QuantumSpintronicOptimizer.estimate_qubo(objective, 4),
        jresearch.QuantumSpintronicOptimizer.estimate_qubo(objective, 4), atol=1e-6)
    # a tensor-valued objective is read back to the host
    torch_objective = lambda X: torch.as_tensor(objective(X))  # noqa: E731
    np.testing.assert_allclose(QuantumSpintronicOptimizer.estimate_qubo(torch_objective, 4),
                               QuantumSpintronicOptimizer.estimate_qubo(objective, 4))


def test_spintronic_benchmark_baselines_equal_jax():
    ours = QuantumSpintronicBenchmark(n_vars=5, n_instances=3, device=CPU)
    theirs = jresearch.QuantumSpintronicBenchmark(n_vars=5, n_instances=3)
    for i in range(3):
        Q = ours._instance(i)
        np.testing.assert_array_equal(Q, theirs._instance(i))
        assert ours._greedy(Q) == theirs._greedy(Q)
        assert ours._exhaustive(Q) == pytest.approx(theirs._exhaustive(Q), rel=1e-6)
        assert ours._qaoa_method(Q) == pytest.approx(theirs._qaoa_method(Q), rel=1e-6)
    report = ours.run()
    assert set(report) == {"qaoa_vs_greedy", "qaoa_vs_exhaustive", "n_vars", "n_instances"}
    assert report["qaoa_vs_exhaustive"].quality_delta <= 1e-6  # never beats the optimum


def test_quantum_validation_measures_as_jax():
    ours = {c["name"]: c for c in QuantumValidationFramework(device=CPU).run_all()["checks"]}
    theirs = {c["name"]: c for c in jresearch.QuantumValidationFramework().run_all()["checks"]}
    assert list(ours) == list(theirs)
    for name, c in theirs.items():
        assert ours[name]["passed"] == c["passed"], name
    assert ours["norm_preservation"]["norm"] == pytest.approx(
        theirs["norm_preservation"]["norm"], abs=1e-5)
    assert ours["compiled_circuit_equivalence"]["overlap"] == pytest.approx(
        theirs["compiled_circuit_equivalence"]["overlap"], abs=1e-5)
