"""The sharded pulse (K5's plain version) against the unsharded one and the
JAX package's shard_map path.

Counterpart of tests/unit/test_pallas_sharding.py. A batch cut into 8
shards, each integrated with ``env_offset`` = its first global row, must
equal the unsharded call bit for bit (m, n_substeps, dt, failed), thermal
noise included: the Philox counter holds the global env index, so each
shard draws exactly its rows of the unsharded stream (the JAX package's
``_shard_seed`` can give that only for its deterministic path). Against
JAX's ``integrate_pulse_pallas(..., mesh=make_mesh())`` in interpret mode
on the 8 fake devices the tolerance is tests/test_torch_integrator.py's
for the Pallas path: float32 rtol = atol = 2e-6, n and failed identical.

Shards hold 32 envs (a multiple of the CPU's widest float32 vector loop),
so the plain version's vectorized transcendentals see the same lanes
whether a row runs in a shard or in the whole batch.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spintorque_tpu.ops.pallas_integrator import integrate_pulse_pallas
from spintorque_tpu.parallel import make_mesh as jax_make_mesh
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu_torch.ops.cuda_integrator import integrate_pulse_cuda, shard_env_offset
from spintorque_tpu_torch.parallel import Mesh, local_batch_size, shard_batch
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse
from spintorque_tpu_torch.physics import integrate_pulse_plain

torch.set_num_threads(1)

W = 8
PARAMS = dict(
    saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
    volume=1e-23, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]),
)


def _setup(B, seed=0, hi=1.5e-10):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, 3))
    m = m / np.linalg.norm(m, axis=-1, keepdims=True)
    spans = rng.uniform(5e-11, hi, B)
    cur = rng.uniform(-200.0, 200.0, B)
    return m.T.astype(np.float32), spans.astype(np.float32), cur.astype(np.float32)


def _params(case, B):
    p = dict(PARAMS)
    if case == "tilted":
        p["easy_axis"] = np.array([0.6, 0.0, 0.8])
    if case == "per_env":
        rng = np.random.default_rng(7)
        axes = rng.normal(size=(B, 3))
        p.update(uniaxial_anisotropy=np.linspace(8e5, 1.6e6, B),
                 damping=np.linspace(0.008, 0.02, B),
                 easy_axis=axes / np.linalg.norm(axes, axis=-1, keepdims=True))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _torch_params(p, rows=slice(None)):
    def cut(k, v):
        per_env = v.ndim == (2 if k == "easy_axis" else 1)
        return torch.tensor(v[rows] if per_env else v)

    return LLGSParams(**{k: cut(k, v) for k, v in p.items()})


CASES = {
    "plus_z": IntegratorConfig(method="rk4", max_substeps=512),
    "tilted": IntegratorConfig(method="rk4", max_substeps=512),
    "per_env": IntegratorConfig(method="rk4", max_substeps=512),
    "thermal": IntegratorConfig(method="rk4", max_substeps=512, thermal=True,
                                rk4_noise="per_stage"),
    "thermal_heun_physical": IntegratorConfig(method="heun", max_substeps=512, thermal=True,
                                              noise_mode="physical"),
}


def _sharded_plain(m, spans, cur, p, cfg, seed):
    n = spans.shape[0] // W
    parts = []
    for r in range(W):
        rows = slice(r * n, (r + 1) * n)
        parts.append(integrate_pulse_plain(
            tuple(torch.tensor(c[rows]) for c in m), torch.tensor(spans[rows]),
            torch.tensor(cur[rows]), _torch_params(p, rows), cfg, seed=seed,
            env_offset=shard_env_offset(r, n)))
    return (tuple(torch.cat([x.m[c] for x in parts]) for c in range(3)),
            torch.cat([x.n_substeps for x in parts]), torch.cat([x.dt for x in parts]),
            torch.cat([x.failed for x in parts]))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_plain_equals_unsharded_bit_for_bit(case):
    B = 256
    m, spans, cur = _setup(B, seed=1)
    p = _params(case, B)
    cfg = CASES[case]
    ref = integrate_pulse_plain(tuple(torch.tensor(c) for c in m), torch.tensor(spans),
                                torch.tensor(cur), _torch_params(p), cfg, seed=42)
    (mx, my, mz), n, dt, failed = _sharded_plain(m, spans, cur, p, cfg, seed=42)
    for got, want in zip((mx, my, mz), ref.m):
        assert torch.equal(got, want)
    assert torch.equal(n, ref.n_substeps)
    assert torch.equal(dt, ref.dt)
    assert torch.equal(failed, ref.failed)


@pytest.mark.parametrize("case", ["plus_z", "tilted", "per_env"])
def test_sharded_plain_matches_jax_shard_map(case):
    B = 256
    m, spans, cur = _setup(B, seed=2)
    p = _params(case, B)
    jp = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with pltpu.force_tpu_interpret_mode():
        (px, py, pz), jn, _, jfailed = integrate_pulse_pallas(
            tuple(jnp.asarray(c) for c in m), jnp.asarray(spans), jnp.asarray(cur), jp,
            JConfig(method="rk4", max_substeps=512), mesh=jax_make_mesh(),
        )
    (mx, my, mz), n, _, failed = _sharded_plain(m, spans, cur, p, CASES[case], seed=None)
    for got, want in zip((mx, my, mz), (px, py, pz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(failed.numpy(), np.asarray(jfailed))


def test_thermal_shards_draw_distinct_fields():
    """Without the offset every shard would draw the thermal fields of rows
    0..B/W-1; with it, shards that start from the same state diverge."""
    n = 32
    m, spans, cur = _setup(n, seed=3)
    args = (tuple(torch.tensor(c) for c in m), torch.tensor(spans), torch.tensor(cur),
            _torch_params(_params("plus_z", n)), CASES["thermal"])
    a = integrate_pulse_plain(*args, seed=5, env_offset=shard_env_offset(0, n))
    b = integrate_pulse_plain(*args, seed=5, env_offset=shard_env_offset(1, n))
    assert not torch.equal(a.m[0], b.m[0])
    assert torch.equal(a.n_substeps, b.n_substeps)


def test_shard_offsets_are_distinct_and_disjoint():
    for world, n in ((8, 32), (4, 1024), (64, 1024)):
        offsets = [shard_env_offset(r, n) for r in range(world)]
        assert len(set(offsets)) == world
        covered = np.concatenate([np.arange(o, o + n) for o in offsets])
        np.testing.assert_array_equal(np.sort(covered), np.arange(world * n))


def test_mesh_sets_the_offset_and_indivisible_batches_raise():
    """``integrate_pulse(mesh=...)`` keys its rows by the mesh's data rank;
    a batch that does not divide the data axis raises (the JAX package
    replicates it instead)."""
    n = 32
    m, spans, cur = _setup(n, seed=4)
    args = (tuple(torch.tensor(c) for c in m), torch.tensor(spans), torch.tensor(cur),
            _torch_params(_params("plus_z", n)), CASES["thermal"])
    rank3 = types.SimpleNamespace(data_rank=3)
    a = integrate_pulse(*args, seed=9, mesh=rank3)
    b = integrate_pulse_plain(*args, seed=9, env_offset=3 * n)
    assert torch.equal(a.m[2], b.m[2])
    mesh = Mesh({"data": 8, "model": 1}, torch.device("cpu"))
    assert local_batch_size(256, mesh) == 32
    with pytest.raises(ValueError):
        local_batch_size(100, mesh)
    with pytest.raises(ValueError):
        shard_batch(torch.zeros(100, 3), mesh)
    # The global index must fit the counter's 32-bit env word.
    with pytest.raises(ValueError):
        integrate_pulse_plain(*args, seed=9, env_offset=2**32 - n + 1)
    integrate_pulse_plain(*args[:3], args[3], CASES["plus_z"], env_offset=2**32 - n)
    with pytest.raises(ValueError):
        integrate_pulse_cuda(*args, seed=9, env_offset=n)  # CPU tensors: the kernel raises
