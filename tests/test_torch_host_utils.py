"""The port's host utilities against the JAX package's.

Counterpart of tests/unit/test_utils_scaling.py, test_security_wrappers.py
(the security utilities; the Gymnasium wrappers are in test_torch_gym.py),
the safe-math and validation parts of test_utils_config.py, and
test_visualization.py, on the CPU. Parity:

  * validators and safe math equal the JAX package's exactly on numpy
    inputs, and at float64 rtol = atol = 1e-15 on torch tensors;
  * ``AutoScaler`` makes the same sequence of batch decisions as JAX's on
    the same rate sequence, and ``LoadBalancer.partition`` is equal for the
    same rates;
  * ``PhysicsWorkerPool.solve_batch`` equals JAX's on the same float32
    deterministic inputs (short spans) at the float32 tolerance of
    tests/test_torch_integrator.py (rtol = atol = 2e-6), and coalesced
    futures equal ``solve_batch`` bit for bit.

Also: the first kernel build runs once when 8 threads reach it together
(a fake compiler stands in for nvcc), another source tree's library builds
beside it and can take its place, and the launch counters count every
increment from many threads.
"""

import json
import logging
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import spintorque_tpu.utils as J
from spintorque_tpu.physics.solver import params_from_dict as jax_params_from_dict
from spintorque_tpu_torch import utils as U
from spintorque_tpu_torch.ops import _build
from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.physics.solver import params_from_dict
from spintorque_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _params():
    return params_from_dict(dict(volume=1e-24), device="cpu")


# ---------------------------------------------------------------------------
# the first build under threads


def test_first_build_runs_once_under_threads(monkeypatch, tmp_path):
    calls = []
    lock = threading.Lock()

    def fake_run(cmd):
        with lock:
            calls.append(cmd)
        time.sleep(0.2)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return "ptxas info    : Used 32 registers\n"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    monkeypatch.setattr(_build, "_bind", lambda lib, optional=(): None)
    barrier = threading.Barrier(8)

    def first_use(_):
        barrier.wait()
        return _build.load_library()

    with ThreadPoolExecutor(8) as ex:
        libs = list(ex.map(first_use, range(8)))
    sources = [p for p in _build._sources() if p.suffix == ".cu"]
    # One build: one nvcc per source and one link, into one library.
    assert len(calls) == len(sources) + 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].path.is_file() and libs[0].path.parent == tmp_path
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [libs[0].path.name, libs[0].path.with_suffix(".log").name])


def test_library_of_other_sources_builds_beside_and_takes_its_place(monkeypatch, tmp_path):
    """``build_library`` of another source tree (a parent commit's) builds
    beside the checkout's library under its own digest, and
    ``use_library`` makes the wrappers bind their entry points from it."""
    built = []

    def fake_run(cmd):
        built.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "_KERNEL_FNS", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(path=path, entry=path))
    monkeypatch.setattr(_build, "_bind", lambda lib, optional=(): None)
    other = tmp_path / "csrc"
    other.mkdir()
    for src in _build._sources():
        (other / src.name).write_bytes(src.read_bytes())
    (other / "llgs_substep.cuh").write_text("// another version\n")
    own = _build.load_library()
    theirs = _build.build_library(other)
    assert theirs.path.parent == own.path.parent and theirs.path != own.path
    assert any(str(other) in " ".join(cmd) for cmd in built)
    assert _build.kernel_fn("entry") == str(own.path)
    _build.use_library(theirs)
    assert _build.load_library() is theirs and _build.kernel_fn("entry") == str(theirs.path)
    _build.use_library(own)
    assert _build.kernel_fn("entry") == str(own.path)


# The entry points of a library built from sources older than the bf16 op check.
OLDER_ENTRY_POINTS = ["spintorque_pulse_integrate", "spintorque_probe_add_one",
                      "spintorque_check_div6", "spintorque_op_chain"]


def test_bind_leaves_out_entry_points_an_older_library_lacks(monkeypatch):
    """A parent commit's library may lack a newer entry point (the bf16 op
    check): bound with it optional, the entry points it has get their
    types, and ``kernel_fn`` raises for the missing one at its first
    call."""
    older = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in OLDER_ENTRY_POINTS})
    _build._bind(older, optional={"spintorque_check_bf16_ops"})
    for n in OLDER_ENTRY_POINTS:
        fn = getattr(older, n)
        assert fn.restype is _build.ctypes.c_int and fn.argtypes[-1] is _build.ctypes.c_void_p
    assert len(older.spintorque_pulse_integrate.argtypes) == 29
    monkeypatch.setattr(_build, "_KERNEL_FNS", {})
    monkeypatch.setattr(_build, "_LIBRARY", _build.KernelLibrary(older, Path("old.so"), 0.0, ""))
    assert _build.kernel_fn("spintorque_check_div6") is older.spintorque_check_div6
    with pytest.raises(AttributeError):
        _build.kernel_fn("spintorque_check_bf16_ops")
    newer = types.SimpleNamespace(
        **{n: types.SimpleNamespace() for n in OLDER_ENTRY_POINTS + ["spintorque_check_bf16_ops"]})
    _build._bind(newer, optional={"spintorque_check_bf16_ops"})
    assert len(newer.spintorque_check_bf16_ops.argtypes) == 3  # counts, first, stream


def test_bind_requires_every_entry_point_of_its_own_sources():
    """The checkout's own library binds with nothing optional: one that
    lacks an entry point fails when it loads, not at the first launch."""
    older = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in OLDER_ENTRY_POINTS})
    with pytest.raises(AttributeError, match="spintorque_check_bf16_ops"):
        _build._bind(older)
    del older.spintorque_check_div6  # not optional, missing: raises though others are optional
    with pytest.raises(AttributeError, match="spintorque_check_div6"):
        _build._bind(older, optional={"spintorque_check_bf16_ops", "spintorque_op_chain"})
    from spintorque_tpu_torch.utils import compare_kernel_sources as cks

    assert cks.BASE_MAY_LACK == {"spintorque_check_bf16_ops"}


def test_compare_kernel_sources_arguments():
    from spintorque_tpu_torch.utils import compare_kernel_sources as cks

    args = cks.parse_args(["--base", "build/parent"])
    assert vars(args) == {"base": "build/parent", "out": None}
    args = cks.parse_args(["--base", "p", "--out", "build/compare.json"])
    assert vars(args) == {"base": "p", "out": "build/compare.json"}
    for bad in ([], ["--out", "o"], ["--base", "p", "--kernels", "K6"]):
        with pytest.raises(SystemExit):
            cks.parse_args(bad)
    assert cks.KERNELS == {"K1": False, "K6": True}  # K6 is the bf16_rhs pulse


def test_compare_kernel_sources_summary_keys():
    """Every call of K1 and K6, thermal and deterministic, at each batch
    has its medians, base spread, wins and ratio in the JSON line."""
    from spintorque_tpu_torch.utils import compare_kernel_sources as cks

    keys = [f"{k}_{m}_B{b}" for b in (4096, 65536) for k in cks.KERNELS for m in cks.MODES]
    assert keys[:4] == ["K1_thermal_B4096", "K1_deterministic_B4096", "K6_thermal_B4096",
                        "K6_deterministic_B4096"]
    turns = 2 * cks.ROUNDS
    times = {"base": {k: [2.0 + 0.01 * i for i in range(turns)] for k in keys},
             "this": {k: [1.0 + 0.01 * i for i in range(turns)] for k in keys}}
    out = cks.summarize(times, {k: True for k in keys})
    assert set(out) == {"bitwise_equal", "median_ms", "base_iqr_ms", "pairs",
                        "pairs_this_faster", "this_over_base", "ms_in_turns"}
    for field in ("base_iqr_ms", "pairs_this_faster", "this_over_base", "bitwise_equal"):
        assert list(out[field]) == keys, field
    assert out["pairs"] == turns
    assert out["pairs_this_faster"] == {k: turns for k in keys}
    mid = 0.01 * (turns - 1) / 2
    assert out["median_ms"]["base"][keys[0]] == pytest.approx(2.0 + mid)
    assert out["this_over_base"][keys[-1]] == pytest.approx((1.0 + mid) / (2.0 + mid))
    assert out["base_iqr_ms"][keys[0]] == pytest.approx(0.01 * (turns - 1) / 2)
    json.loads(json.dumps(out))
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Used {regs} registers\n"
        for name, regs in (
            ("_ZN10spintorque12pulse_kernelIfLi2ELb1ELb0ELb1EEEvNS_9PulseArgsE", 64),
            ("_ZN10spintorque12pulse_kernelINS_4Bf16ELi2ELb1ELb0ELb1EEEvNS_9PulseArgsE", 72),
            ("_ZN10spintorque21check_bf16_ops_kernelEPyS0_", 30)))
    rep = cks.pulse_ptxas(log)
    assert {k: [r["registers"] for r in v.values()] for k, v in rep.items()} == {
        "K1": [64], "K6": [72]}


def test_compare_kernel_sources_needs_the_card(tmp_path):
    from spintorque_tpu_torch.utils import compare_kernel_sources as cks

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cks.main(["--base", str(tmp_path)])


def test_launch_counter_counts_every_thread():
    counter = profiling.LaunchCounter()

    def add(_):
        for _ in range(1000):
            counter.add()

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(add, range(8)))
    assert counter.count == 8000
    counter.reset()
    assert counter.count == 0


# ---------------------------------------------------------------------------
# safe math and validation against JAX


SAFE_INPUTS = {
    "division": ([1.0, -2.0, 3.0, 0.0, 5.5], [0.0, 4.0, -1e-300, 0.0, 3.0]),
    "sqrt": ([4.0, -1.0, 0.0, 2.0, np.nan, np.inf],),
    "log": ([1.0, 0.0, -3.0, 2.5, np.nan, 1e-300],),
    "normalize": ([[3.0, 0.0, 4.0], [0.0, 0.0, 0.0], [np.nan, 1.0, 0.0], [1e-13, 0.0, 0.0],
                   [1.0, 2.0, 2.0]],),
}


@pytest.mark.parametrize("name", sorted(SAFE_INPUTS))
def test_safe_math_matches_jax(name):
    args = [np.asarray(a, float) for a in SAFE_INPUTS[name]]
    fn, jfn = getattr(U, f"safe_{name}"), getattr(J, f"safe_{name}")
    np.testing.assert_array_equal(fn(*args), jfn(*args))
    out = fn(*[torch.as_tensor(a, dtype=torch.float64) for a in args])
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), jfn(*args), rtol=1e-15, atol=1e-15)


def test_safe_math_scalars_and_defaults():
    assert U.safe_division(1.0, 0.0) == J.safe_division(1.0, 0.0) == 0.0
    assert U.safe_division(1.0, 0.0, default=7.0) == 7.0
    assert float(U.safe_division(torch.tensor(1.0), torch.tensor(0.0), default=7.0)) == 7.0
    np.testing.assert_allclose(U.safe_normalize([0.0, 0.0, 0.0]), [0, 0, 1])
    assert float(U.safe_sqrt(torch.tensor(-4), default=-1.0)) == -1.0


VALID = [
    ("validate_magnetization", ([3.0, 0.0, 4.0],)),
    ("validate_magnetization", ([[1.0, 2.0, 2.0], [0.0, -5.0, 0.0]],)),
    ("validate_magnetization", ([0.0, 0.0, 0.0],)),
    ("validate_magnetization", ([np.nan, 0.0, 1.0],)),
    ("validate_magnetization", ([1.0, 2.0],)),
    ("validate_action", ([1e6, 1e-9],)),
    ("validate_action", ([np.inf, 1e-9],)),
    ("validate_observation", ([0.1, 0.2, 0.3],)),
    ("validate_observation", ([0.1, np.nan],)),
]


def _outcome(fn, *args):
    try:
        return "ok", np.asarray(fn(*args))
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name,args", VALID, ids=[f"{n}-{i}" for i, (n, _) in enumerate(VALID)])
def test_validators_match_jax(name, args):
    want = _outcome(getattr(J, name), *[np.asarray(a, float) for a in args])
    got = _outcome(getattr(U, name), *[np.asarray(a, float) for a in args])
    assert got[0] == want[0]
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
        tensor = _outcome(getattr(U, name), *[torch.tensor(a, dtype=torch.float64) for a in args])
        np.testing.assert_allclose(tensor[1], want[1], rtol=1e-15, atol=1e-15)
    else:
        assert got[1] == want[1]


def test_validator_classes_match_jax():
    params = {"volume": 1e-24, "damping": 0.02, "polarization": 0.7, "temperature": 300.0}
    assert U.validate_parameters(params) == J.validate_parameters(params)
    for bad in ({"damping": 2.0}, {"volume": -1.0}, {"temperature": -1.0}):
        with pytest.raises(U.ValidationError):
            U.validate_parameters(bad)
        with pytest.raises(J.ValidationError):
            J.validate_parameters(bad)
    a = np.array([[5e6, 1e-8], [-5e6, 0.0]])
    np.testing.assert_array_equal(U.ActionValidator().clip(a), J.ActionValidator().clip(a))
    np.testing.assert_array_equal(U.ActionValidator().clip(torch.tensor(a)),
                                  J.ActionValidator().clip(a))
    with pytest.raises(U.ValidationError):
        U.NumericalValidator.check_range(torch.tensor([0.5, 2.0]), 0.0, 1.0)
    cfg = {"max_steps": 10, "max_current": 1e6, "success_threshold": 0.9}
    assert U.validate_environment_config(cfg) == J.validate_environment_config(cfg)


def test_error_recovery_and_retry():
    rec = U.ErrorRecoveryManager(max_failures=2)
    rec.record_failure("pulse")
    assert not rec.should_abort("pulse")
    rec.record_failure("pulse")
    assert rec.should_abort("pulse")
    rec.reset("pulse")
    assert not rec.should_abort("pulse")
    tries = {"n": 0}

    @U.robust_computation(max_retries=2, backoff=0.0, fallback=lambda: "fallback")
    def flaky():
        tries["n"] += 1
        raise U.PhysicsError("no")

    assert flaky() == "fallback" and tries["n"] == 3
    assert U.safe_execute(lambda: 1 / 0, default=-1) == -1
    assert issubclass(U.NumericalError, U.SpinTorqueError)


# ---------------------------------------------------------------------------
# security (tests/unit/test_security_wrappers.py)


def test_sanitize_string():
    assert U.InputSanitizer.sanitize_string("hello") == "hello"
    assert U.InputSanitizer.sanitize_string("a\x00b") == "ab"
    with pytest.raises(U.SecurityError):
        U.InputSanitizer.sanitize_string("x" * 10000)
    with pytest.raises(U.SecurityError):
        U.InputSanitizer.sanitize_string(123)


def test_sanitize_key_and_number():
    assert U.InputSanitizer.sanitize_key("max_current") == "max_current"
    with pytest.raises(U.SecurityError):
        U.InputSanitizer.sanitize_key("rm -rf /")
    assert U.InputSanitizer.sanitize_number("2e6") == 2e6
    with pytest.raises(U.SecurityError):
        U.InputSanitizer.sanitize_number(float("nan"))


def test_sanitize_dict_nested_matches_jax():
    data = {"a": {"b": 1.5}, "c": "ok", "d": [1, "x\x01", True], "e": False}
    out = U.InputSanitizer.sanitize_dict(data)
    assert out == J.InputSanitizer.sanitize_dict(data)
    assert out["a"] == {"b": 1.5} and out["c"] == "ok"
    deep = {"k": {}}
    d = deep["k"]
    for _ in range(10):
        d["k"] = {}
        d = d["k"]
    with pytest.raises(U.SecurityError):
        U.InputSanitizer.sanitize_dict(deep)


def test_rate_limiter():
    rl = U.RateLimiter(rate_per_s=1000.0, burst=2)
    assert rl.allow() and rl.allow()
    assert not rl.allow()


def test_secure_hasher_roundtrip_matches_jax():
    h1 = U.SecureHasher.hash_dict({"a": 1, "b": 2})
    assert h1 == U.SecureHasher.hash_dict({"b": 2, "a": 1}) == J.SecureHasher.hash_dict({"a": 1,
                                                                                        "b": 2})
    sig = U.SecureHasher.hmac_sign(b"data", b"key")
    assert sig == J.SecureHasher.hmac_sign(b"data", b"key")
    assert U.SecureHasher.verify(b"data", b"key", sig)
    assert not U.SecureHasher.verify(b"data2", b"key", sig)
    auditor = U.SecurityAuditor(max_events=4)
    for i in range(6):
        auditor.record("denied" if i % 2 else "allowed", str(i))
    assert auditor.report()["total_events"] <= 4


# ---------------------------------------------------------------------------
# cache


def test_lru_cache_eviction_and_stats():
    c = U.LRUCache(max_size=2, ttl_s=None)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # refreshes 'a' to MRU
    c.put("c", 3)  # evicts 'b' (LRU)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.stats.evictions == 1
    assert c.stats.hit_rate > 0.5


def test_lru_cache_ttl_expiry():
    c = U.LRUCache(max_size=8, ttl_s=0.05)
    c.put("k", 42)
    assert c.get("k") == 42
    time.sleep(0.08)
    assert c.get("k") is None
    assert c.stats.expirations == 1


def test_cache_key_distinguishes_arrays_and_tensors():
    k1 = U.LRUCache.make_key(np.array([1.0, 2.0]), current=1e6)
    k2 = U.LRUCache.make_key(np.array([1.0, 2.0]), current=2e6)
    k3 = U.LRUCache.make_key(np.array([1.0, 2.000001]), current=1e6)
    assert k1 != k2 and k1 != k3  # no current-blind or rounded-key collisions
    # the JAX package's keys of numpy structures, unchanged
    assert k1 == J.LRUCache.make_key(np.array([1.0, 2.0]), current=1e6)
    t = torch.tensor([1.0, 2.0], dtype=torch.float64)
    kt = U.LRUCache.make_key(t, current=1e6)
    assert kt == U.LRUCache.make_key(t.clone(), current=1e6)
    keys = {kt, U.LRUCache.make_key(t.float(), current=1e6),
            U.LRUCache.make_key(t.reshape(2, 1), current=1e6),
            U.LRUCache.make_key(torch.tensor([1.0, 2.000001], dtype=torch.float64), current=1e6),
            U.LRUCache.make_key(t.to(torch.bfloat16), current=1e6), k1}
    assert len(keys) == 6  # dtype, shape, bytes and kind each tell keys apart


def test_adaptive_cache_grows_on_hits():
    c = U.AdaptiveCache(max_size=64, ttl_s=None, adapt_interval=50)
    c.put("x", 1)
    for _ in range(200):
        c.get("x")
    assert c.max_size > 64


def test_cached_decorator_and_manager():
    calls = {"n": 0}

    @U.cached(cache_name="test_dec", max_size=16)
    def slow(a, b):
        calls["n"] += 1
        return a + b

    assert slow(1, 2) == 3 and slow(1, 2) == 3
    assert calls["n"] == 1
    assert slow(1, 3) == 4 and calls["n"] == 2
    assert "test_dec" in U.get_cache_manager().stats()


# ---------------------------------------------------------------------------
# logging


def test_structured_log_records_the_rank(capsys):
    logger = U.setup_logging("INFO", structured=True)
    try:
        with U.LoggingContext(run="t1"):
            U.PerformanceLogger("perf").log_metrics("steps", env_steps_per_s=12.5)
        rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    finally:
        logger.handlers.clear()
        logger.setLevel(logging.WARNING)
    assert rec["process"] == 0  # no process group: rank 0
    assert rec["logger"] == "spintorque_tpu_torch.perf" and rec["run"] == "t1"
    assert rec["metrics"] == {"env_steps_per_s": 12.5}


# ---------------------------------------------------------------------------
# concurrency


def test_resource_pool_reuses_instances():
    created = []

    def factory():
        created.append(object())
        return created[-1]

    pool = U.ResourcePool(factory, max_size=2)
    a = pool.acquire()
    pool.release(a)
    b = pool.acquire()
    assert a is b  # LIFO reuse
    assert pool.size == 1


def test_physics_worker_pool_coalesces():
    with U.PhysicsWorkerPool(_params(), max_substeps=64, max_batch=64,
                             max_wait_ms=20.0, device="cpu") as pool:
        futs = [
            pool.submit(np.array([0.1, 0.0, 0.995]), (0.0, 1e-11), 0.0)
            for _ in range(16)
        ]
        results = [f.result(timeout=60) for f in futs]
    for r in results:
        assert r.shape == (3,)
        assert abs(np.linalg.norm(r) - 1.0) < 1e-4
    stats = pool.get_statistics()
    assert stats["submitted"] == 16
    assert stats["mean_batch_size"] > 1.0  # coalescing actually happened


def _pool_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    m0 = rng.normal(size=(n, 3)).astype(np.float32)
    m0 /= np.linalg.norm(m0, axis=-1, keepdims=True)
    spans = rng.uniform(2e-12, 2e-11, n).astype(np.float32)
    currents = rng.uniform(-3e10, 3e10, n).astype(np.float32)
    return m0, spans, currents


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_physics_worker_pool_solve_batch_matches_jax(method):
    m0, spans, currents = _pool_inputs(64)
    jpool = J.PhysicsWorkerPool(jax_params_from_dict(dict(volume=1e-24)), method=method,
                                max_substeps=64)
    try:
        want = jpool.solve_batch(m0, spans, currents)
    finally:
        jpool.shutdown()
    with U.PhysicsWorkerPool(_params(), method=method, max_substeps=64, device="cpu") as pool:
        got = pool.solve_batch(m0, spans, currents)
    assert got.dtype == np.float32 and got.shape == (64, 3)
    assert np.abs(got - m0).max() > 1e-3  # the pulses moved m
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_coalesced_futures_equal_solve_batch_bitwise():
    n = 256
    m0, spans, currents = _pool_inputs(n, seed=1)
    with U.PhysicsWorkerPool(_params(), max_substeps=64, max_batch=64, max_wait_ms=5.0,
                             device="cpu") as pool:
        whole = pool.solve_batch(m0, spans, currents)
        futs = U.parallel_map(lambda i: pool.submit(m0[i], (0.0, float(spans[i])), currents[i]),
                              range(n), max_workers=8)
        rows = np.stack([f.result(timeout=60) for f in futs])
        stats = pool.get_statistics()
    np.testing.assert_array_equal(rows, whole)
    assert stats["submitted"] == n and stats["batches"] >= n // 64
    assert stats["solved"] == 2 * n


def test_parallel_map():
    assert U.parallel_map(lambda x: x * x, [1, 2, 3], max_workers=2) == [1, 4, 9]


def test_parallel_benchmark_runs():
    out = U.ParallelBenchmark(_params(), n_solves=32, max_substeps=16, device="cpu").run()
    assert out["n_solves"] == 32
    assert out["batched_s"] > 0 and out["serial_estimate_s"] > 0
    # solved over batches, the direct calls' rows included (the JAX package's count)
    assert out["mean_batch_size"] > 1.0


def test_async_environment_manager_runs_episodes():
    from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from spintorque_tpu_torch.parallel import random_policy

    def factory():
        return SpinTorqueEnv(batch_size=4, device="cpu",
                             config=SpinTorqueEnvConfig(max_duration=1e-11, max_substeps=32))

    mgr = U.AsyncEnvironmentManager(factory, n_runners=2)
    try:
        first = mgr.run_episodes(random_policy(factory()), n_episodes=2, steps_per_episode=2)
        again = mgr.run_episodes(random_policy(factory()), n_episodes=2, steps_per_episode=2)
    finally:
        mgr.shutdown()
    assert [e["episode"] for e in first] == [0, 1]
    assert first == again  # seeded: reproducible
    assert all(np.isfinite(e["mean_reward"]) for e in first)


# ---------------------------------------------------------------------------
# scaling


RATE_SEQUENCES = {
    "grow": [(256, 10, 1.0), (512, 10, 0.5), (1024, 10, 0.5), (2048, 10, 0.4)],
    "regress": [(512, 10, 1.0), (1024, 10, 4.0), (512, 10, 1.1)],
    "plateau": [(128, 10, 1.0), (256, 10, 2.0), (128, 10, 1.0), (64, 10, 0.2)],
    "cap": [(1 << 19, 1, 1.0), (1 << 20, 1, 1.0), (1 << 20, 1, 3.0)],
}


@pytest.mark.parametrize("name", sorted(RATE_SEQUENCES))
def test_autoscaler_decisions_match_jax(name):
    seq = RATE_SEQUENCES[name]
    ours = U.AutoScaler(initial_batch=seq[0][0], cooldown_s=0.0)
    ref = J.AutoScaler(initial_batch=seq[0][0], cooldown_s=0.0)
    decisions = []
    for batch, steps, elapsed in seq:
        for sc in (ours, ref):
            sc.record(batch, steps, elapsed)
        decisions.append((ours.recommend(), ref.recommend()))
    assert [a for a, _ in decisions] == [b for _, b in decisions]
    assert [(e.old_batch, e.new_batch, e.reason) for e in ours.events] == [
        (e.old_batch, e.new_batch, e.reason) for e in ref.events]
    assert ours.get_statistics() == ref.get_statistics()


def test_autoscaler_explores_and_grows():
    sc = U.AutoScaler(initial_batch=256, cooldown_s=0.0)
    sc.record(256, 10, 1.0)  # 2560 steps/s
    assert sc.recommend() == 512  # moves to 512 to explore
    sc.record(512, 10, 0.5)  # 10240 steps/s - better; keeps exploring up
    assert sc.recommend() == 1024
    sc.record(1024, 10, 0.5)  # 20480/s - best so far
    assert sc.get_statistics()["throughput_by_batch"][1024] > 10000


def test_autoscaler_backs_off_on_regression():
    sc = U.AutoScaler(initial_batch=512, cooldown_s=0.0)
    sc.record(512, 10, 1.0)    # 5120/s
    assert sc.recommend() == 1024  # explore up
    sc.record(1024, 10, 4.0)   # 2560/s - worse
    sc.recommend()
    assert sc.batch == 512  # reverted to the best-known size


@pytest.mark.parametrize("strategy", ["round_robin", "least_loaded", "fastest_response"])
def test_load_balancer_matches_jax(strategy):
    ours = U.LoadBalancer(devices=["d0", "d1", "d2"], strategy=strategy)
    ref = J.LoadBalancer(devices=["d0", "d1", "d2"], strategy=strategy)
    for items, elapsed in ((300, 1.0), (100, 1.0), (50, 0.5), (400, 2.0), (10, 0.1)):
        i, j = ours.select_device(), ref.select_device()
        assert i == j
        ours.record_completion(i, items, elapsed)
        ref.record_completion(j, items, elapsed)
        for total in (7, 400, 1001):
            assert ours.partition(total) == ref.partition(total)
    assert ours.get_statistics() == ref.get_statistics()


def test_load_balancer_defaults_to_the_cards():
    lb = U.LoadBalancer()
    assert lb.devices == [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def test_load_balancer_partitions_by_rate():
    lb = U.LoadBalancer(devices=["d0", "d1"], strategy="fastest_response")
    i0 = lb.select_device()
    lb.record_completion(i0, items=300, elapsed_s=1.0)
    i1 = lb.select_device()
    lb.record_completion(i1, items=100, elapsed_s=1.0)
    shares = lb.partition(400)
    assert sum(shares) == 400
    assert shares[i0] > shares[i1]


def test_adaptive_resource_manager_lifecycle():
    with U.AdaptiveResourceManager(U.AutoScaler(initial_batch=128), interval_s=0.01) as mgr:
        mgr.observe(128, 10, 0.1)
        time.sleep(0.05)
    assert mgr.current_batch >= 128


def test_scalable_environment_manager_runs_and_measures():
    from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig

    def factory(batch):
        return SpinTorqueEnv(
            batch_size=batch, device="cpu",
            config=SpinTorqueEnvConfig(max_duration=1e-11, max_substeps=32),
        )

    mgr = U.ScalableEnvironmentManager(
        factory, initial_batch=8, min_batch=8, max_batch=16, autoscale=False
    )
    chunk = mgr.run_batch_steps(n_steps=3)
    assert chunk["env_steps_per_s"] > 0
    assert np.isfinite(chunk["mean_reward"])
    assert mgr.get_statistics()["chunks_run"] == 1
    assert mgr.run_batch_steps(n_steps=3)["mean_reward"] == chunk["mean_reward"]  # seeded
    best = U.ScalableEnvironmentManager(factory, initial_batch=8, min_batch=8,
                                        max_batch=16).run_until_stable(chunks=2, n_steps=2)
    assert best["best_batch"] in (8, 16)


# ---------------------------------------------------------------------------
# health


def test_full_health_monitor_healthy():
    report = U.build_full_health_monitor(device="cpu").run()
    assert report["status"] == "HEALTHY", report
    assert set(report["checks"]) == {"physics", "devices", "environment", "system"}
    assert report["checks"]["system"]["detail"].startswith("cpu")
    assert U.get_health_monitor("cpu") is U.get_health_monitor("cpu")


@pytest.mark.parametrize("name", ["PhysicsHealthCheck", "DeviceHealthCheck",
                                  "EnvironmentHealthCheck", "SystemHealthCheck"])
def test_health_checks_default_to_the_card(name):
    check = getattr(U, name)()
    if torch.cuda.is_available():
        assert check()[0]
    else:  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check()


# ---------------------------------------------------------------------------
# performance optimizer


def test_computation_optimizer_memoizes():
    opt = U.ComputationOptimizer()
    calls = {"n": 0}

    def expensive(x):
        calls["n"] += 1
        return x * 2

    assert opt.cached_computation("exp", expensive, 21) == 42
    assert opt.cached_computation("exp", expensive, 21) == 42
    assert calls["n"] == 1
    assert opt.get_statistics()["cache"]["hits"] == 1
    assert opt.memoized(expensive)(4) == opt.memoized(expensive)(4) == 8


def test_optimizer_registry_counts_eager_calls():
    opt = U.ComputationOptimizer()
    f = opt.jit("double", lambda x: x * 2)
    g = opt.jit("double", lambda x: x * 3)  # same name -> same function
    assert f is g
    assert float(f(torch.tensor(2.0))) == 4.0
    assert f(3) == 6
    stats = opt.get_statistics()["jitted_functions"]["double"]
    assert stats["calls"] == 2 and stats["first_call_s"] >= 0.0


@pytest.mark.parametrize("n", [1, 31, 32, 100])
def test_pad_batch_to_the_kernels_block(n):
    for x in (np.arange(n * 3.0).reshape(n, 3), torch.arange(n * 3.0).reshape(n, 3)):
        padded, size = U.pad_batch(x)
        assert size == n and padded.shape[0] == -(-n // 32) * 32
        assert type(padded) is type(x)
        assert (np.asarray(padded[n:]) == np.asarray(x[-1])).all()
        assert U.unpad_batch(padded, size).shape[0] == n
    padded, _ = U.pad_batch(np.ones((100, 3)), multiple=128)
    assert padded.shape[0] == 128  # the JAX package's lane multiple, when asked


def test_optimize_batch_size_uses_the_devices_memory():
    from spintorque_tpu_torch.utils.performance import device_memory_bytes

    opt = U.ComputationOptimizer()
    host = device_memory_bytes("cpu")
    assert host > 0
    b = opt.optimize_batch_size(1 << 20, device="cpu")
    assert b % 32 == 0 and b == (int(host * 0.75 / (1 << 20)) // 32) * 32
    assert opt.optimize_batch_size(1000, hbm_bytes=64e3) == 32


def test_global_optimizer_singleton():
    assert U.get_optimizer() is U.get_optimizer()


# ---------------------------------------------------------------------------
# visualization (tests/unit/test_visualization.py)


def test_plot_trajectory_takes_tensors():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from spintorque_tpu_torch.visualization import plot_trajectory

    t = np.linspace(0, 4 * np.pi, 50)
    traj = np.stack([np.sin(t) * 0.3, np.cos(t) * 0.3, np.full_like(t, np.sqrt(1 - 0.09))], -1)
    for x in (traj, torch.as_tensor(traj)):
        fig = plot_trajectory(x)
        assert fig is not None
        plt.close(fig)


def test_energy_surface_and_visualizer(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from spintorque_tpu_torch.physics import EnergyLandscape, LLGSParams
    from spintorque_tpu_torch.visualization import SpintronicVisualizer, plot_energy_surface

    params = LLGSParams(*(torch.tensor(v, dtype=torch.float64) for v in
                          (800e3, 0.01, 1.2e6, 1e-23, 0.7)),
                        easy_axis=torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    el = EnergyLandscape(params)
    surface = el.energy_surface(n_theta=24, n_phi=48)
    fig = plot_energy_surface(surface)
    assert fig is not None
    plt.close(fig)

    viz = SpintronicVisualizer(output_dir=tmp_path)
    assert viz.energy_surface(surface).exists()
    assert viz.training_curves({"reward": torch.tensor([0.1, 0.3, 0.5])}).exists()
    diagram = el.switching_phase_diagram((0.0, 5e6), n_fields=8, n_angles=8)
    assert viz.switching_phase_diagram(diagram).exists()


def test_plot_switching_diagram_of_a_sweep():
    pytest.importorskip("matplotlib")
    from spintorque_tpu_torch.research import switching_probability_diagram
    from spintorque_tpu_torch.visualization import plot_switching_diagram

    params = params_from_dict(dict(volume=1e-22, damping=0.05), device="cpu")
    diagram = switching_probability_diagram(params, [-2e7, 0.0], [1e-10, 2e-10], n_ensemble=4,
                                            temperature=0.0, max_substeps=256, device="cpu")
    fig = plot_switching_diagram(diagram)
    assert fig.get_axes()[0].get_title() == "Switching probability"


def test_research_figures_save(tmp_path):
    pytest.importorskip("matplotlib")
    from spintorque_tpu_torch.visualization import QuantumSpintronicVisualizer

    viz = QuantumSpintronicVisualizer(output_dir=tmp_path)
    p = torch.logspace(-4, -1, 5)
    assert Path(viz.plot_error_correction(p, {"d=3": p**2 * 10})).exists()
    assert Path(viz.plot_vqe_convergence({"vqe": torch.linspace(1.0, -1.0, 10)},
                                         exact_minimum=-1.0)).exists()
    traj = torch.randn(6, 2, 3, generator=torch.Generator().manual_seed(0))
    assert Path(viz.plot_hybrid_trajectory(traj, z_expectations=traj[:, :, 2])).exists()
    g = torch.linspace(0, 1, 4)
    assert Path(viz.plot_qaoa_angle_landscape(g, g, torch.rand(16), best=(0.5, 0.5))).exists()
    assert len(list(tmp_path.iterdir())) == 4

