"""spintorque_tpu_torch.physics.adaptive against spintorque_tpu.physics.adaptive.

The same seeded numpy inputs go through both packages. Tolerances:
  * the adaptive RHS, JAX op by op (``jax.disable_jit``), float64: rtol
    1e-13 (the same ops in the same order);
  * the written-out Jacobian against forward-mode autodiff of the same RHS
    (torch.func and jax.jacfwd), float64: 1e-12 of its largest entry;
  * RK45 against JAX op by op: equal accepted and rejected step counts, m
    within rtol 1e-12 in float64 and 2e-6 in float32;
  * the implicit midpoint and Radau against jitted JAX, float64 (op by op
    they take minutes; XLA's fused multiply-adds move the last bits, and
    these inputs are not chaotic): equal step counts, m within atol 1e-10;
  * the trajectory diagnostics against JAX at rtol 1e-12;
  * ``find_stable_states`` draws its seeds from a torch.Generator, the JAX
    package from jax.random: the two are held to the same set of states.
The chunked termination test (``CHECK_EVERY``) holds every chunk size to
the bits of a host read every iteration. The JAX package's own tests of
the module are ported in test_torch_adaptive_stiff.py and
test_torch_adaptive_order.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import find_stable_states as jax_find_stable_states
from spintorque_tpu.physics import integrate_adaptive as jax_integrate_adaptive
from spintorque_tpu.physics import llgs_solver_rhs as jax_rhs
from spintorque_tpu_torch.physics import (
    LLGSParams,
    find_stable_states,
    integrate_adaptive,
    llgs_solver_rhs,
    trajectory_energy,
    trajectory_torques,
)
from spintorque_tpu_torch.physics import adaptive
from spintorque_tpu_torch.physics.adaptive import _fvec, _rhs_and_jacobian, _rhs_invariants

torch.set_num_threads(1)

BASE = dict(saturation_magnetization=800e3, damping=0.05, uniaxial_anisotropy=1.2e6,
            volume=1e-23, polarization=0.7)
SMALL_CURRENT = 1e-11  # where the adaptive RHS is not absurdly stiff (the JAX tests')


def _pair(dtype=np.float64, axis=(0.0, 0.0, 1.0), **over):
    """(JAX params, port params) from the same numpy values."""
    vals = dict(BASE, **over)
    vals = {k: np.asarray(v, dtype) for k, v in vals.items()}
    axis = np.asarray(axis, dtype)
    return (JParams(**{k: jnp.asarray(v) for k, v in vals.items()}, easy_axis=jnp.asarray(axis)),
            LLGSParams(**{k: torch.from_numpy(np.array(v)) for k, v in vals.items()},
                       easy_axis=torch.from_numpy(axis)))


JP, TP = _pair()


def _starts(B, seed):
    m = np.random.default_rng(seed).normal(size=(B, 3))
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def _run_both(m, span, cur, jp, tp, jit=True, **kw):
    B = m.shape[0]
    args = (np.full(B, span), np.broadcast_to(np.asarray(cur, float), (B,)))
    if jit:
        j = jax_integrate_adaptive(tuple(jnp.asarray(m[:, c]) for c in range(3)),
                                   *map(jnp.asarray, args), jp, **kw)
    else:
        with jax.disable_jit():
            j = jax_integrate_adaptive(tuple(jnp.asarray(m[:, c]) for c in range(3)),
                                       *map(jnp.asarray, args), jp, **kw)
    t = integrate_adaptive(tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)),
                           *map(torch.from_numpy, args), tp, **kw)
    return j, t


def _m(res):
    return np.stack([np.asarray(c) for c in res.m], axis=-1)


# ---------------------------------------------------------------- the RHS


@pytest.mark.parametrize("case", ["default", "demag_field_current"])
def test_rhs_matches_jax_op_by_op(case):
    rng = np.random.default_rng(1)
    B = 16
    m = rng.normal(size=(B, 3))
    axis = rng.normal(size=(B, 3))
    jp, tp = _pair(axis=axis, damping=rng.uniform(0.01, 0.5, B),
                   uniaxial_anisotropy=rng.uniform(3e5, 2e6, B))
    cur = rng.uniform(-2e-11, 2e-11, B)
    cur[:3] = 0.0
    kw = {} if case == "default" else dict(demag_factors=(0.1, 0.3, 0.6),
                                           exchange_constant=1.5e-11,
                                           h_applied=(1e3, -4e2, 2e4))
    with jax.disable_jit():
        want = jax_rhs(*(jnp.asarray(m[:, c]) for c in range(3)), jnp.asarray(cur), jp, **kw)
    got = llgs_solver_rhs(*(torch.from_numpy(m[:, c].copy()) for c in range(3)),
                          torch.from_numpy(cur), tp, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=0)


def test_jacobian_is_exact():
    """The written-out chain rule against forward-mode autodiff of the same
    renormalized RHS, in torch and in JAX, at 1e-12 of its largest entry;
    a zero state (constant RHS) has a zero Jacobian."""
    rng = np.random.default_rng(2)
    B = 12
    y = rng.normal(size=(B, 3)) * 1.4
    y[0] = 0.0
    axis = rng.normal(size=(B, 3))
    jp, tp = _pair(axis=axis, damping=rng.uniform(0.01, 0.5, B))
    cur = rng.uniform(-2e-11, 2e-11, B)
    kw = dict(demag_factors=(0.2, 0.2, 0.6), h_applied=(5e3, 0.0, -1e3))
    c = _rhs_invariants(torch.from_numpy(cur), tp, **kw)
    F, J = _rhs_and_jacobian(torch.from_numpy(y), c)
    eye = torch.eye(3, dtype=torch.float64)

    def along(t):
        return torch.func.jvp(lambda v: _fvec(v, c), (torch.from_numpy(y),),
                              (t.expand(B, 3),))

    F_ad, J_ad = torch.func.vmap(along, out_dims=(None, -1))(eye)
    assert torch.equal(F, F_ad)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-12 * float(J_ad.abs().max()))
    assert not J[0].any()

    def f_single(v, cur_b, alpha, axis_b):
        p = jp.replace(damping=alpha, easy_axis=axis_b)
        n = jnp.sqrt(jnp.sum(v * v))
        v = v / n
        return jnp.stack(jax_rhs(v[0], v[1], v[2], cur_b, p, **kw))

    J_jax = jax.vmap(jax.jacfwd(f_single))(jnp.asarray(y[1:]), jnp.asarray(cur[1:]),
                                           jp.damping[1:], jnp.asarray(axis[1:]))
    np.testing.assert_allclose(J.numpy()[1:], np.asarray(J_jax),
                               atol=1e-12 * float(np.abs(J_jax).max()))


# ------------------------------------------------------ parity with JAX


def test_rk45_matches_jax_op_by_op():
    m = _starts(4, 0)
    j, t = _run_both(m, 2e-11, SMALL_CURRENT, JP, TP, jit=False, rtol=1e-7, atol=1e-10)
    np.testing.assert_array_equal(t.n_steps.numpy(), np.asarray(j.n_steps))
    np.testing.assert_array_equal(t.n_rejected.numpy(), np.asarray(j.n_rejected))
    assert t.success.all() and bool(j.success.all())
    np.testing.assert_allclose(_m(t), _m(j), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("method,span", [("midpoint", 2e-11), ("radau", 5e-11)])
def test_implicit_methods_match_jitted_jax(method, span):
    m = _starts(4, 1)
    j, t = _run_both(m, span, SMALL_CURRENT, JP, TP, rtol=1e-7, atol=1e-10, method=method)
    np.testing.assert_array_equal(t.n_steps.numpy(), np.asarray(j.n_steps))
    np.testing.assert_array_equal(t.n_rejected.numpy(), np.asarray(j.n_rejected))
    assert t.success.all() and bool(j.success.all())
    np.testing.assert_allclose(_m(t), _m(j), atol=1e-10)


def test_rk45_float32_matches_jax_op_by_op():
    jp, tp = _pair(np.float32)
    m = _starts(4, 3).astype(np.float32)
    B = 4
    args = (np.full(B, 2e-11, np.float32), np.full(B, SMALL_CURRENT, np.float32))
    with jax.disable_jit():
        j = jax_integrate_adaptive(tuple(jnp.asarray(m[:, c]) for c in range(3)),
                                   *map(jnp.asarray, args), jp, rtol=1e-5, atol=1e-8)
    t = integrate_adaptive(tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)),
                           *map(torch.from_numpy, args), tp, rtol=1e-5, atol=1e-8)
    assert t.m[0].dtype == torch.float32
    np.testing.assert_array_equal(t.n_steps.numpy(), np.asarray(j.n_steps))
    np.testing.assert_allclose(_m(t), _m(j), rtol=2e-6, atol=2e-6)


# ------------------------------------------------- the loop and the batch


@pytest.mark.parametrize("method", ["rk45", "midpoint", "radau"])
def test_chunked_termination_gives_the_bits_of_a_read_every_iteration(method, monkeypatch):
    """Envs of different spans finish at different iterations; a chunk
    that runs past the last one (or past max_steps' cap) changes no bit."""
    m = _starts(5, 4)
    spans = torch.tensor([1e-12, 3e-12, 6e-12, 1e-11, 0.0], dtype=torch.float64)
    m0 = tuple(torch.from_numpy(m[:, c].copy()) for c in range(3))
    kw = dict(rtol=1e-7, atol=1e-10, method=method)

    def run(every, **more):
        monkeypatch.setattr(adaptive, "CHECK_EVERY", every)
        return integrate_adaptive(m0, spans, SMALL_CURRENT, TP, **kw, **more)

    one = run(1)
    assert one.host_reads == one.iterations + 1
    for k in (3, adaptive.CHECK_EVERY, 1000):
        other = run(k)
        for a, b in zip(one.m, other.m):
            assert torch.equal(a, b)
        assert torch.equal(one.n_steps, other.n_steps)
        assert torch.equal(one.n_rejected, other.n_rejected)
        assert torch.equal(one.success, other.success)
        assert other.iterations >= one.iterations and other.host_reads <= one.host_reads
    assert bool(one.success.all()) and int(one.n_steps[-1]) == 0
    # A budget that ends mid-integration: the last chunk is capped.
    capped = [run(k, max_steps=13) for k in (1, 5)]
    assert capped[0].iterations == capped[1].iterations == 13
    assert not bool(capped[0].success.all())
    for a, b in zip(capped[0].m, capped[1].m):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["rk45", "radau"])
def test_batch_shapes_are_flattened_and_restored(method):
    """Scalar and 2-d batches, with per-env parameters of the batch's
    shape, give the flat batch's results (the JAX Radau path takes 1-d
    batches only)."""
    rng = np.random.default_rng(6)
    m = _starts(6, 6)
    damping = rng.uniform(0.02, 0.3, 6)
    _, tp = _pair(damping=damping)
    kw = dict(rtol=1e-7, atol=1e-10, method=method)
    flat = integrate_adaptive(tuple(torch.from_numpy(m[:, c].copy()) for c in range(3)),
                              1e-11, SMALL_CURRENT, tp, **kw)
    _, tp2 = _pair(damping=damping.reshape(2, 3))
    grid = integrate_adaptive(tuple(torch.from_numpy(m[:, c].reshape(2, 3).copy())
                                    for c in range(3)), 1e-11, SMALL_CURRENT, tp2, **kw)
    assert grid.m[0].shape == (2, 3) and grid.n_steps.shape == (2, 3)
    for a, b in zip(flat.m, grid.m):
        np.testing.assert_allclose(a.numpy(), b.reshape(-1).numpy(), rtol=1e-13, atol=1e-15)
    _, tp1 = _pair(damping=damping[0])
    one = integrate_adaptive(tuple(torch.tensor(m[0, c]) for c in range(3)), 1e-11,
                             SMALL_CURRENT, tp1, **kw)
    assert one.m[0].shape == () and one.n_steps.shape == ()
    np.testing.assert_allclose(torch.stack(one.m).numpy(), _m(flat)[0], rtol=1e-13, atol=1e-15)


# ------------------------------------ diagnostics and the stable states


def test_trajectory_diagnostics_match_jax():
    from spintorque_tpu.physics import trajectory_energy as jax_energy
    from spintorque_tpu.physics import trajectory_torques as jax_torques

    m_traj = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.6, 0.0, 0.8]])
    e = trajectory_energy(torch.from_numpy(m_traj), TP)
    assert float(e[0]) < float(e[1])  # the easy axis lies lower than the hard axis
    np.testing.assert_allclose(e.numpy(), np.asarray(jax_energy(jnp.asarray(m_traj), JP)),
                               rtol=1e-13)
    tq = trajectory_torques(torch.from_numpy(m_traj), 0.0, TP)
    assert float(tq[0]) < 1e-3  # no torque at the pole
    for cur in (0.0, 1e6):
        np.testing.assert_allclose(trajectory_torques(torch.from_numpy(m_traj), cur, TP).numpy(),
                                   np.asarray(jax_torques(jnp.asarray(m_traj), cur, JP)),
                                   rtol=1e-12, atol=1e-3)


def test_stable_states_relaxation_finds_the_jax_states():
    tp32 = TP.to(dtype=torch.float32)
    states = find_stable_states(tp32, n_seeds=32, relax_time=3e-9)
    assert 1 <= len(states) <= 3
    assert np.all(np.abs(np.abs(states[:, 2]) - 1.0) < 0.05)
    jax_states = np.asarray(jax_find_stable_states(JP.astype(jnp.float32), n_seeds=32,
                                                   relax_time=3e-9))
    for a, b in ((states, jax_states), (jax_states, states)):
        for s in a:
            assert np.max(b @ s) > 1.0 - 1e-3, (states, jax_states)
