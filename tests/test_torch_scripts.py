"""The port's programs beside the package (``scripts/torch/``) on the CPU at
a small size, each through its ``main(argv)``:

* the directory holds exactly the nine programs (bench.py's counterpart,
  the seven device-neutral scripts' and their shared helper), none of
  which writes into ``docs/``; each program raises without a card unless
  ``--device cpu`` is given;
* bench: the JSON line has bench.py's keys (``use_cuda_kernel`` where
  bench.py has ``use_pallas``), its ``metric`` string verbatim, and
  ``vs_baseline == value * 1.802`` to float rounding (rel 1e-12);
* bench_roofline: the fit equals ``numpy.polyfit`` on the recorded
  (substeps, ms) points, and the operation and byte counts equal
  ``pulse_work``'s at the reference point;
* bench_ppo at B=32, rollout 2: the additive split's identity holds to
  1e-9 relative, the ablated step leaves the parameters and the optimizer
  equal and the full step changes them;
* verify_thermal exits 0 at 300 K, and 1 at 0 K (the two-sided checks
  fail there): the checks have teeth;
* bench_bf16 and bench_integrator: their angle and difference statistics
  equal the ones computed directly from ``integrate_pulse_plain`` on the
  same inputs (exactly: the same ops on the same CPU);
* bench_sort_overhead: its substep statistics equal the dt law's.

The stiff-solver ladder's parity with JAX is in
``tests/test_torch_scripts_stiff.py``.
"""

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.ops import cuda_integrator as ci
from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse, integrate_pulse_plain
from spintorque_tpu_torch.physics.integrator import clamped_substep_counts

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts" / "torch"
PROGRAMS = ("bench", "bench_integrator", "bench_roofline", "bench_sort_overhead", "bench_bf16",
            "bench_ppo", "bench_stiff_solvers", "verify_thermal")
CPU = ["--device", "cpu"]


def _program(name):
    spec = importlib.util.spec_from_file_location(f"torch_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def test_the_nine_programs_are_there():
    assert sorted(p.stem for p in SCRIPTS.glob("*.py")) == sorted(PROGRAMS + ("_bench_util",))


@pytest.mark.parametrize("name", PROGRAMS + ("_bench_util",))
def test_no_program_writes_into_docs(name):
    """No string of the program names the docs directory (the JAX programs'
    records there stay untouched): a program writes only where --out says."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if s == "docs" or "docs/" in s or "docs\\" in s]


@pytest.mark.parametrize("name", PROGRAMS)
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _program(name).main([])


# The JAX programs' workloads: each program's defaults (every option but
# --device) that a run without options takes.
JAX_DEFAULTS = {
    "bench": dict(batch=4096, max_duration=5e-9, warmup=12, blocks=3, iters_per_block=8),
    "bench_integrator": dict(batch=4096, span=1e-9, large_batches=[16384, 65536], iters=30,
                             plain_iters=30),
    "bench_roofline": dict(batch=4096, spans_ps=[10, 1000, 5000], warmup=12, iters=None,
                           out=None),
    "bench_sort_overhead": dict(batch=4096, max_span=5e-9, warmup=12, iters=20),
    "bench_bf16": dict(batch=4096, span=1e-9, warmup=12, iters=20, out=None),
    "bench_ppo": dict(batch=4096, rollout=16, epochs=4, minibatches=4, compute_dtype="float32",
                      shared_trunk=False, max_duration=5e-9, warmup=10, iters=8, out=None),
    "bench_stiff_solvers": dict(rtols=[1e-6, 1e-8, 1e-10], ref_rtol=1e-12, out=None),
    "verify_thermal": dict(batch=4096, temperature=300.0),
}


@pytest.mark.parametrize("name", PROGRAMS)
def test_defaults_are_the_jax_programs(name):
    args = vars(_program(name).parse_args([]))
    assert args.pop("device") == "cuda"
    assert args == JAX_DEFAULTS[name]


def _jax_headline_keys():
    """The keys and the metric of bench.py's JSON line, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            keys = [k.value for k in node.keys]
            return keys, node.values[keys.index("metric")].value
    raise AssertionError("bench.py prints no metric")


def test_bench_line(capsys):
    out = _program("bench").main(CPU + ["--batch", "32", "--max-duration", "1e-11", "--warmup",
                                        "0", "--blocks", "1", "--iters-per-block", "1"])
    line = _last_json(capsys.readouterr().out)
    jax_keys, metric = _jax_headline_keys()
    want = {"use_cuda_kernel" if k == "use_pallas" else k for k in jax_keys}
    assert want <= set(line) and "use_pallas" not in line
    assert line["metric"] == metric == "env_steps_per_s_per_chip_4096envs_SpinTorque-v0"
    assert line["value"] > 0 and line["unit"] == "env-steps/s/chip"
    assert line["vs_baseline"] == pytest.approx(line["value"] * 1.802, rel=1e-12)
    assert line["use_cuda_kernel"] is False and line["backend"] == "cpu"
    assert len(line["per_compile_medians"]) == 3
    assert line["value"] == sorted(line["per_compile_medians"])[1]
    assert out["ok"] and {k: out[k] for k in line} == line


def test_bench_roofline_fit_and_counts(tmp_path):
    path = tmp_path / "roofline.json"
    out = _program("bench_roofline").main(
        CPU + ["--batch", "32", "--spans-ps", "100", "130", "150", "--warmup", "0", "--iters",
               "1", "--out", str(path)])
    assert out["ok"] and out["substeps"] == 130
    assert json.loads(path.read_text()) == {k: v for k, v in out.items() if k != "ok"}
    assert out["op_latency_ns"] is None
    for label, thermal in (("deterministic", False), ("thermal_per_substep", True)):
        r = out["results"][label]
        ns = [r["substeps_run"][str(n)] for n in (100, 130, 150)]
        assert ns == [100, 130, 150]
        ms = [r[f"ms_per_pulse_batch_{n}"] for n in (100, 130, 150)]
        slope, intercept = np.polyfit(np.asarray(ns, float), np.asarray(ms, float) / 1e3, 1)
        assert r["us_per_substep_batch_marginal"] == pytest.approx(slope * 1e6, rel=1e-12)
        assert r["fixed_call_overhead_ms"] == pytest.approx(intercept * 1e3, rel=1e-12)
        cfg = IntegratorConfig(method="rk4", max_substeps=5120, thermal=thermal,
                               noise_mode="reference", rk4_noise="per_substep")
        _, n = clamped_substep_counts(torch.full((32,), 130e-12), cfg)
        assert (r["ops_per_call"], r["hbm_bytes_per_call"]) == ci.pulse_work(n, cfg, True)
        assert r["substep_flop_per_env_counted"] == ci.pulse_ops_per_substep(cfg, True)
        assert r["chain_depth"] == ci.pulse_chain_depth(cfg, True, thermal)
        # No share of the card's peaks from CPU times.
        assert r["fp32_utilization_vs_instr_ceiling"] is None and r["hbm_utilization"] is None
        assert r["chain_floor_us_per_substep"] is None and r["kernel_fixed_ms"] is None
        assert r["kernel_profiled_calls"] == 0


def test_bench_ppo_split():
    out = _program("bench_ppo").main(CPU + ["--batch", "32", "--rollout", "2", "--max-duration",
                                            "1e-11", "--warmup", "1", "--iters", "1"])
    phases = out["phases_in_situ_ms"]
    assert sum(phases.values()) == pytest.approx(out["train_step_ms"], rel=1e-9)
    assert out["identity_rel_err"] <= 1e-9
    assert phases["update_marginal"] == out["train_step_ms"] - out["train_step_update_ablated_ms"]
    assert out["ablated_step_leaves_network_and_optimizer"] is True
    assert out["full_step_moves_parameters"] is True
    assert out["ok"] and out["use_cuda_kernel"] is False
    turns = out["turns_ms"]  # two blocks each, in turns
    assert all(len(v) == 2 for v in turns.values())
    assert out["train_step_ms"] == pytest.approx(sum(turns["train_step"]) / 2, rel=1e-12)


def test_verify_thermal_passes_at_300_kelvin():
    out = _program("verify_thermal").main(CPU)
    assert out["ok"] and all(out["checks"].values())
    assert out["batch"] == 4096 and out["substeps"] == 100


def test_verify_thermal_fails_without_noise():
    """At 0 K every state stays at the pole: the two-sided checks and the
    pole check fail, and the program exits 1."""
    proc = subprocess.run([sys.executable, str(SCRIPTS / "verify_thermal.py"), "--device", "cpu",
                           "--temperature", "0", "--batch", "256"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    out = _last_json(proc.stdout)
    checks = out["checks"]
    assert not checks["two-sided x"] and not checks["two-sided y"]
    assert not checks["no silent pole resets"] and checks["finite"]


def _inputs(B):
    util = _program("_bench_util")
    return util, util.setup_pulse_inputs(B, 0, device="cpu")


def test_bench_bf16_angles_equal_the_plain_versions():
    B, span = 32, 5e-12
    out = _program("bench_bf16").main(CPU + ["--batch", str(B), "--span", str(span), "--warmup",
                                             "0", "--iters", "1"])
    util, (m0, _, _) = _inputs(B)
    p = util.bench_params("cpu")
    spans = torch.full((B,), span)
    zero = torch.zeros(B)
    cfg = IntegratorConfig(method="rk4", max_substeps=1024, noise_mode="reference",
                           rk4_noise="per_substep")
    a = torch.stack(integrate_pulse_plain(m0, spans, zero, p, cfg).m, -1).numpy()
    b = torch.stack(integrate_pulse_plain(m0, spans, zero, p, cfg._replace(bf16_rhs=True)).m,
                    -1).numpy()
    cos = np.clip(np.sum(a.astype(np.float64) * b.astype(np.float64), -1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    acc = out["accuracy_det_bf16_vs_f32"]
    assert ang.max() > 0
    assert acc["mean_angular_error_deg"] == float(ang.mean())
    assert acc["p99_angular_error_deg"] == float(np.percentile(ang, 99))
    assert acc["max_angular_error_deg"] == float(ang.max())
    assert all(len(v["ms_per_pulse_batch_trials"]) == 3 for v in out["results"].values())
    assert sorted(out["results"]) == ["det_bf16", "det_f32", "thermal_bf16", "thermal_f32"]


def test_bench_integrator_difference_equals_the_plain_versions():
    B, span = 32, 5e-12
    out = _program("bench_integrator").main(
        CPU + ["--batch", str(B), "--span", str(span), "--large-batches", "64", "--iters", "1",
               "--plain-iters", "1"])
    util, (m0, _, _) = _inputs(B)
    p = util.bench_params("cpu")
    spans, cur = torch.full((B,), span), torch.full((B,), 1e2)
    cfg = IntegratorConfig(method="rk4", max_substeps=1024)
    plain = integrate_pulse_plain(m0, spans, cur, p, cfg)
    other = integrate_pulse(m0, spans, cur, p, cfg)
    d = max(float((x - y).abs().max()) for x, y in zip(plain.m, other.m))
    assert out["max_abs_diff_deterministic"] == d == 0.0 and out["ok"]
    assert out["substeps"] == 100 and sorted(out["kernel_thermal_large"]) == ["64"]
    assert sorted(out["results"]) == ["kernel_det_rk4", "kernel_thermal_rk4", "plain_det_rk4",
                                      "plain_thermal_rk4"]


def test_bench_sort_overhead_substeps():
    B, span = 32, 2e-10
    out = _program("bench_sort_overhead").main(
        CPU + ["--batch", str(B), "--max-span", str(span), "--warmup", "0", "--iters", "1"])
    util = _program("_bench_util")
    _, spans, _ = util.setup_pulse_inputs(B, 0, span_lo=1e-12, span_hi=span, device="cpu")
    cfg = IntegratorConfig(method="rk4", max_substeps=5101)
    _, n = clamped_substep_counts(spans, cfg)
    assert out["mean_substeps_random"] == float(n.double().mean())
    assert out["max_substeps_random"] == int(n.max())
    assert out["mean_substeps_uniform"] == 100.0
    assert out["sort_overhead_ms"] == out["sorted_random_ms"] - out["uniform_ms"]
    assert out["ok"]
