"""spintorque_tpu_torch.physics.solver and the pulse trajectory against the
JAX package's.

The same seeded numpy inputs go through both packages. Tolerances:
  * ``params_from_dict``: the same values (float64, exact);
  * ``integrate_pulse_trajectory`` against JAX op by op
    (``jax.disable_jit``): float64 rtol 1e-12, float32 rtol/atol 2e-6
    (the integrator tests' contract), n_substeps and failed identical;
  * ``LLGSSolver.solve`` against the jitted JAX solver, float64, on inputs
    where the dynamics are not chaotic (XLA's fused multiply-adds move the
    last bits): rtol 1e-9, n_steps and failed identical; against the plain
    pulse on the normalized state: bit for bit;
  * the zero-span, zero/NaN-magnetization and unknown-method probes: the
    JAX package's results exactly;
  * ``AdaptiveLLGSSolver``: the JAX package's facade tests, with their
    tolerances (explicit and implicit answers within rtol 1e-4, atol 1e-5).
Thermal solves draw from the port's Philox stream: the trajectory's last
row equals the pulse's result on the same seed bit for bit.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics import AdaptiveLLGSSolver as JAdaptive
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import LLGSSolver as JSolver
from spintorque_tpu.physics import integrate_pulse_trajectory as jax_trajectory
from spintorque_tpu.physics import params_from_dict as jax_params_from_dict
from spintorque_tpu_torch.physics import (
    AdaptiveLLGSSolver,
    IntegratorConfig,
    LLGSParams,
    LLGSSolver,
    RobustLLGSSolver,
    ScalableLLGSSolver,
    SimpleLLGSSolver,
    integrate_pulse_plain,
    integrate_pulse_trajectory,
    normalize_with_fallback,
    params_from_dict,
)

torch.set_num_threads(1)

DP = dict(damping=0.01, saturation_magnetization=800e3, uniaxial_anisotropy=1.2e6,
          volume=1e-23, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]))


def _starts(B, seed):
    m = np.random.default_rng(seed).normal(size=(B, 3))
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


@pytest.mark.parametrize("dp", [DP, {}, dict(DP, easy_axis=np.array([0.6, 0.0, 0.8]))],
                         ids=["full", "defaults", "tilted"])
def test_params_from_dict_matches_jax(dp):
    want = jax_params_from_dict(dp, jnp.float64)
    got = params_from_dict(dp, torch.float64, device="cpu")
    for name in ("saturation_magnetization", "damping", "uniaxial_anisotropy", "volume",
                 "polarization", "easy_axis"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        assert getattr(got, name).dtype == torch.float64
    assert got.plus_z == (dp.get("easy_axis", np.array([0.0, 0.0, 1.0]))[0] == 0.0)


def _traj_pair(dtype, method, thermal=False, B=4, max_substeps=48):
    m = _starts(B, 3).astype(dtype)
    spans = np.array([1e-11, 2e-11, 3.4e-11, 4.5e-11][:B], dtype)
    cur = np.full(B, 1e3, dtype)
    p = {k: np.asarray(v, dtype) for k, v in DP.items()}
    jp = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = LLGSParams(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    kw = dict(method=method, max_substeps=max_substeps, thermal=thermal)
    return m, spans, cur, jp, tp, JConfig(**kw), IntegratorConfig(**kw)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trajectory_matches_jax_op_by_op(method, dtype):
    m, spans, cur, jp, tp, jcfg, tcfg = _traj_pair(dtype, method)
    with jax.disable_jit():
        jres, jtraj = jax_trajectory(tuple(jnp.asarray(m[:, c]) for c in range(3)),
                                     jnp.asarray(spans), jnp.asarray(cur), jp, jcfg)
    tres, ttraj = integrate_pulse_trajectory(
        tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)), torch.from_numpy(spans),
        torch.from_numpy(cur), tp, tcfg)
    assert ttraj.shape == (tcfg.max_substeps + 1, 3, 4) == jtraj.shape
    assert ttraj.dtype == getattr(torch, np.dtype(dtype).name)
    tol = dict(rtol=1e-12, atol=1e-14) if dtype == np.float64 else dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), **tol)
    np.testing.assert_array_equal(tres.n_substeps.numpy(), np.asarray(jres.n_substeps))
    np.testing.assert_array_equal(tres.failed.numpy(), np.asarray(jres.failed))
    # Rows past an env's n hold its state; the last row is the pulse's result.
    n = tres.n_substeps.numpy()
    for b in range(4):
        assert (ttraj[n[b]:, :, b] == ttraj[n[b], :, b]).all()
    plain = integrate_pulse_plain(tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)),
                                  torch.from_numpy(spans), torch.from_numpy(cur), tp, tcfg)
    assert torch.equal(ttraj[-1], torch.stack(plain.m))


def test_thermal_trajectory_draws_the_pulses_stream():
    m, spans, cur, _, tp, _, tcfg = _traj_pair(np.float32, "rk4", thermal=True)
    args = (tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)), torch.from_numpy(spans),
            torch.from_numpy(cur), tp, tcfg)
    _, traj = integrate_pulse_trajectory(*args, seed=7)
    plain = integrate_pulse_plain(*args, seed=7)
    assert torch.equal(traj[-1], torch.stack(plain.m))
    _, other = integrate_pulse_trajectory(*args, seed=8)
    assert not torch.equal(traj[-1], other[-1])
    with pytest.raises(ValueError, match="seed"):
        integrate_pulse_trajectory(*args)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_solve_matches_jitted_jax(method):
    """Small currents, spans of 50-200 ps: not chaotic, so the jitted JAX
    solver agrees to rtol 1e-9 in float64."""
    m = _starts(6, 4)
    jres = JSolver(method=method, dtype=jnp.float64).solve(m, (0.0, 1.5e-10), DP, current=1e2)
    solver = LLGSSolver(method=method, dtype=torch.float64, device="cpu")
    tres = solver.solve(m, (0.0, 1.5e-10), DP, current=1e2)
    np.testing.assert_allclose(tres["m"].numpy(), np.asarray(jres["m"]), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tres["n_steps"].numpy(), np.asarray(jres["n_steps"]))
    np.testing.assert_array_equal(tres["failed"].numpy(), np.asarray(jres["failed"]))
    assert tres["success"] == jres["success"]  # RK4 freezes some rows at 1e2 A/m^2
    # The facade adds nothing to the pulse: the plain version on the same
    # normalized state gives the same bits.
    p = params_from_dict(DP, torch.float64, device="cpu")
    cfg = IntegratorConfig(method=method, max_substeps=5120)
    mt = torch.from_numpy(m)
    plain = integrate_pulse_plain(normalize_with_fallback(*mt.unbind(-1)),
                                  torch.full((6,), 1.5e-10, dtype=torch.float64),
                                  torch.full((6,), 1e2, dtype=torch.float64), p, cfg)
    assert torch.equal(tres["m"], torch.stack(plain.m, -1))
    assert solver.get_solver_info() == dict(method=method, solve_count=1, max_step=1e-12,
                                            max_substeps=5120, backend="cpu")


def test_solve_trajectory_shape_and_thermal_seed():
    solver = LLGSSolver(method="heun", max_substeps=64, device="cpu")
    one = solver.solve(np.array([0.0, 0.1, 0.995]), (0.0, 3e-11), DP, return_trajectory=True)
    assert one["m"].shape == (65, 3) and one["m"].dtype == torch.float32
    batch = solver.solve(np.tile([0.0, 0.1, 0.995], (3, 1)), (0.0, 3e-11), DP,
                         return_trajectory=True, thermal_noise=True, seed=4)
    assert batch["m"].shape == (3, 65, 3)
    again = solver.solve(np.tile([0.0, 0.1, 0.995], (3, 1)), (0.0, 3e-11), DP,
                         return_trajectory=True, thermal_noise=True, seed=4)
    assert torch.equal(batch["m"], again["m"])
    final = solver.solve(np.tile([0.0, 0.1, 0.995], (3, 1)), (0.0, 3e-11), DP,
                         thermal_noise=True, seed=4)
    assert torch.equal(final["m"], batch["m"][:, -1])


def test_solver_facade_single_and_batch():
    """The JAX package's facade test (tests/unit/test_llgs.py)."""
    solver = LLGSSolver(method="rk4", dtype=torch.float64, device="cpu")
    res = solver.solve(np.array([0.0, 0.1, 0.995]), (0.0, 1e-10), DP, current=1e2)
    assert res["success"]
    assert res["m"].shape == (3,)
    resb = solver.solve(np.tile([0.0, 0.1, 0.995], (4, 1)), (0.0, 1e-10), DP, current=1e2)
    assert resb["m"].shape == (4, 3)
    np.testing.assert_allclose(resb["m"][0].numpy(), res["m"].numpy(), rtol=1e-12)
    triv = solver.solve(np.array([0.0, 0.0, 1.0]), (0.0, 0.0), DP)
    assert triv["success"] and triv["n_steps"] == 1
    # A large current overflows RK4's norm: the reference's freeze, reported
    # as success=False.
    frozen = solver.solve(np.array([0.0, 0.1, 0.995]), (0.0, 1e-10), DP, current=1e6)
    assert not frozen["success"]
    jfrozen = JSolver(method="rk4", dtype=jnp.float64).solve(
        np.array([0.0, 0.1, 0.995]), (0.0, 1e-10), DP, current=1e6)
    assert bool(frozen["failed"]) == bool(jfrozen["failed"])


@pytest.mark.parametrize("m0,want", [
    ([0.0, 0.0, 2.0], [0.0, 0.0, 1.0]),
    ([3.0, 0.0, 4.0], [0.6, 0.0, 0.8]),
    ([0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
    ([np.nan, 0.0, 0.5], [0.0, 0.0, 1.0]),
    ([np.inf, 0.0, 0.0], [0.0, 0.0, 1.0]),
])
@pytest.mark.parametrize("facade", ["fixed", "adaptive"])
def test_zero_span_and_fallback_probes(m0, want, facade):
    """A zero span gives the normalized initial state; a zero, NaN or
    infinite magnetization falls back to [0, 0, 1]; as the JAX package."""
    if facade == "fixed":
        ours, theirs = (LLGSSolver(dtype=torch.float64, device="cpu"),
                        JSolver(dtype=jnp.float64))
    else:
        ours, theirs = (AdaptiveLLGSSolver(dtype=torch.float64, device="cpu"),
                        JAdaptive(dtype=jnp.float64))
    got = ours.solve(np.array(m0), (1e-9, 1e-9), DP)
    ref = theirs.solve(np.array(m0), (1e-9, 1e-9), DP)
    np.testing.assert_allclose(got["m"].numpy(), want, atol=1e-15)
    np.testing.assert_array_equal(got["m"].numpy(), np.asarray(ref["m"]))
    assert got["success"] and got["n_steps"] == ref["n_steps"]
    assert got["message"] == ref["message"]


def test_fallback_magnetization_in_a_solve():
    """A zero or NaN row enters the pulse as +z (normalize_with_fallback),
    which the easy axis keeps; the other rows integrate."""
    solver = LLGSSolver(method="rk4", dtype=torch.float64, device="cpu")
    m = np.array([[0.0, 0.0, 0.0], [np.nan, 1.0, 0.0], [0.0, 0.1, 0.995]])
    res = solver.solve(m, (0.0, 5e-11), DP)
    np.testing.assert_allclose(res["m"][:2].numpy(), [[0.0, 0.0, 1.0]] * 2, atol=1e-12)
    assert res["success"] and torch.isfinite(res["m"]).all()
    jres = JSolver(method="rk4", dtype=jnp.float64).solve(m, (0.0, 5e-11), DP)
    np.testing.assert_allclose(res["m"].numpy(), np.asarray(jres["m"]), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["euler", "RK4", "Heun", "rk45", "dop853", "bogus"])
def test_unknown_fixed_step_method_becomes_euler(name):
    ours = LLGSSolver(method=name, device="cpu")
    assert ours.method == JSolver(method=name).method
    assert ours.method == (name.lower() if name.lower() in ("euler", "rk4", "heun") else "euler")


def test_aliases_and_default_device():
    assert SimpleLLGSSolver is RobustLLGSSolver is ScalableLLGSSolver is LLGSSolver
    for cls in (LLGSSolver, AdaptiveLLGSSolver):
        assert inspect.signature(cls).parameters["device"].default is None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls()
    assert "seed" in inspect.signature(LLGSSolver.solve).parameters
    assert LLGSSolver(device="cpu").method == "euler"  # the reference's default


def test_adaptive_solver_facade():
    """The JAX package's facade test (tests/unit/test_adaptive.py), and the
    port's result against the JAX facade's at rtol 1e-9 (float64, jitted
    JAX)."""
    dp = dict(DP, damping=0.05)
    results = {}
    for meth in ("RK45", "Radau"):
        s = AdaptiveLLGSSolver(method=meth, rtol=1e-7, atol=1e-10, dtype=torch.float64,
                               device="cpu")
        out = s.solve(np.array([0.4, 0.1, 0.911]), (0.0, 3e-10), dp, current=1e-11)
        assert out["success"], out["message"]
        assert out["m"].shape == (3,)
        np.testing.assert_allclose(float(torch.linalg.vector_norm(out["m"])), 1.0, atol=1e-6)
        assert int(out["n_steps"]) > 0
        results[meth] = out["m"].numpy()
        assert s.get_solver_info()["method"] == meth
        assert s.get_solver_info()["backend"] == "cpu"
        ref = JAdaptive(method=meth, rtol=1e-7, atol=1e-10, dtype=jnp.float64).solve(
            np.array([0.4, 0.1, 0.911]), (0.0, 3e-10), dp, current=1e-11)
        np.testing.assert_allclose(results[meth], np.asarray(ref["m"]), rtol=1e-9, atol=1e-12)
        assert int(out["n_steps"]) == int(ref["n_steps"])
    np.testing.assert_allclose(results["RK45"], results["Radau"], rtol=1e-4, atol=1e-5)

    s = AdaptiveLLGSSolver(method="BDF", dtype=torch.float64, device="cpu")
    batch = np.tile(np.array([[0.3, 0.0, 0.954]]), (4, 1))
    out = s.solve(batch, (0.0, 1e-10), dp)
    assert out["m"].shape == (4, 3)
    assert out["success"]
    out = s.solve(np.array([0.0, 0.0, 2.0]), (0.0, 0.0), dp)
    np.testing.assert_allclose(out["m"].numpy(), [0.0, 0.0, 1.0])
    with pytest.raises(ValueError, match="unknown method"):
        AdaptiveLLGSSolver(method="rk23", device="cpu")


# The optimal-control scale of the research tier's device (tests/unit/
# test_research_tier.py's _params(); OptimalControlBaseline's default
# max_current there is ~4.0e-7 A/m^2): smooth dynamics whose gradient JAX
# computes finite.
OC_DP = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.05,
             uniaxial_anisotropy=4e5, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]))


def test_trajectory_gradient_matches_jax_grad():
    """d/dJ of a scalar of the final state (its alignment with -z, summed
    over envs) through the trajectory, float64, against ``jax.grad``
    through the jitted JAX trajectory: rtol 1e-9 (jitted XLA fuses
    multiply-adds; the dynamics at this scale are not chaotic). The result
    keeps its (max_substeps + 1, 3, B) shape and the forward bits of the
    plain pulse."""
    m = _starts(3, 9)
    spans = np.array([2e-10, 1.5e-10, 2e-10])
    cur = np.array([2e-7, -1.5e-7, 3e-7])
    cfg = dict(method="rk4", max_substeps=256)
    jp = jax_params_from_dict(OC_DP, jnp.float64)

    def jloss(j):
        res, _ = jax_trajectory(tuple(jnp.asarray(m[:, c]) for c in range(3)),
                                jnp.asarray(spans), j, jp, JConfig(**cfg))
        return -jnp.sum(res.m[2])

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(cur)))
    tp = params_from_dict(OC_DP, torch.float64, device="cpu")
    current = torch.tensor(cur, requires_grad=True)
    m0 = tuple(torch.from_numpy(m[:, c].copy()) for c in range(3))
    res, traj = integrate_pulse_trajectory(m0, torch.from_numpy(spans), current, tp,
                                           IntegratorConfig(**cfg))
    assert traj.shape == (257, 3, 3) and traj.requires_grad
    (-res.m[2].sum()).backward()
    assert np.all(np.isfinite(want)) and np.any(want != 0.0)
    np.testing.assert_allclose(current.grad.numpy(), want, rtol=1e-9, atol=0.0)
    plain = integrate_pulse_plain(m0, torch.from_numpy(spans), torch.from_numpy(cur), tp,
                                  IntegratorConfig(**cfg))
    assert torch.equal(traj[-1].detach(), torch.stack(plain.m))


def test_cuda_pulse_refuses_gradients():
    """The kernel has no backward: inputs that require a gradient raise
    before any build or launch (so the check runs here, without a card),
    and name the plain loop that differentiates."""
    from spintorque_tpu_torch.ops import cuda_integrator as ci

    m0 = tuple(torch.zeros(4) for _ in range(3))
    span, cur = torch.full((4,), 1e-10), torch.zeros(4)
    tp = params_from_dict(DP, torch.float32, device="cpu")
    cfg = IntegratorConfig()
    for which in ("m0", "span", "current"):
        args = [tuple(x.clone() for x in m0), span.clone(), cur.clone()]
        if which == "m0":
            args[0][2].requires_grad_(True)
        else:
            args[("span", "current").index(which) + 1].requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"no gradient \\({which} requires grad\\).*plain"):
            ci.integrate_pulse_cuda(*args, tp, cfg)
    with pytest.raises(RuntimeError, match="no gradient"):
        ci.launch_pulse(m0, span, torch.full((4,), 10, dtype=torch.int32),
                        cur.clone().requires_grad_(True), tp, cfg)
