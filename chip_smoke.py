#!/usr/bin/env python3
"""Smoke run of spintorque_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the port's CUDA kernels from the
checkout's sources, holds each kernel against its plain PyTorch version on
the card, drives the port's paths and checks that each launched its
kernels: the env at B=4096 with the default config (K1), the same env with
bf16_rhs=True (K6), and the PPO trainer at full width (B=4096, the default
PPOConfig) over both, plus the JAX package's PPO learning gate. Each path's
launch counts are set to 0 just before it and read just after. Any failed
check raises and exits non-zero. The
last two lines of standard output are the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}; the line before
those lists each kernel with its launches, error and times. A longer record
goes to build/chip_smoke.json.

Tolerances:
  * deterministic pulses, kernel vs plain (K1 and K6 alike): rtol = atol =
    2e-6 on m, with n_substeps and failed identical (the JAX package's
    Pallas contract); both usually agree to the bit;
  * thermal pulses with the same Philox stream: rtol = atol = 1e-5. Both
    sides draw the same bits; only the transcendentals (logf and the
    plain version's log) may differ by an ulp, and the field such a
    difference perturbs is tiny against the anisotropy field;
  * one env step on the card vs the CPU plain path, float32, thermal off:
    1e-4 on obs and reward, for the ulps by which the card's and the CPU's
    eager float32 ops may differ;
  * K6 against K1 on zero-current precession (<= 300 substeps, B=256):
    mean angle < 6 deg and max < 25 deg, the JAX package's bounds for its
    bf16 kernel at the batch of its test.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RECORD = {}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    # ---------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    import numpy as np
    from scipy import integrate as sp_integrate
    from scipy import stats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spintorque_tpu_torch import convert
    from spintorque_tpu_torch.constants import KB_SOLVER, MU0
    from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from spintorque_tpu_torch.ops import _build
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.parallel import random_policy
    from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams
    from spintorque_tpu_torch.physics import integrate_pulse_plain
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
    from spintorque_tpu_torch.utils import measure_env_throughput, measure_train_throughput

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    RECORD["card"] = smi
    RECORD["torch"] = torch.__version__
    dev = torch.device("cuda")

    # ------------------------------------------------ 2. build and probe
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s)")
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    print(f"ptxas: {len(regs)} kernels, registers per thread "
          f"{sorted({int(r.split('Used ')[1].split()[0]) for r in regs})}")
    check(ci.cuda_kernel_available(), "probe failed")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev)
    probe_err = (ci.probe_add_one(x) - ci.probe_add_one_plain(x)).abs().max().item()
    check(probe_err == 0.0, f"probe disagrees with x + 1 by {probe_err}")
    probe_ms = cuda_ms(lambda: ci.probe_add_one(x), 100)
    probe_plain_ms = cuda_ms(lambda: ci.probe_add_one_plain(x), 100)
    print(f"probe: ok, max_abs_err {probe_err}, {probe_ms:.4f} ms vs plain {probe_plain_ms:.4f} ms")

    gen = torch.Generator().manual_seed(1234)

    def setup(B, lo=5e-11, hi=3e-10, cur=200.0, g=gen):
        m = torch.randn(B, 3, generator=g, dtype=torch.float64)
        m = m / m.norm(dim=-1, keepdim=True)
        spans = lo + (hi - lo) * torch.rand(B, generator=g, dtype=torch.float64)
        current = cur * (2.0 * torch.rand(B, generator=g, dtype=torch.float64) - 1.0)

        def f(t):
            return t.float().to(dev).contiguous()

        return (f(m[:, 0]), f(m[:, 1]), f(m[:, 2])), f(spans), f(current)

    def params(axis=(0.0, 0.0, 1.0), **over):
        vals = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                    volume=1e-23, polarization=0.7)
        vals.update(over)
        p = {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in vals.items()}
        return LLGSParams(**p, easy_axis=torch.as_tensor(axis, dtype=torch.float32).to(dev))

    def per_env_params(B):
        def u(lo, hi):
            return lo + (hi - lo) * torch.rand(B, generator=gen, dtype=torch.float64)

        axes = torch.randn(B, 3, generator=gen, dtype=torch.float64)
        return params(
            axes / axes.norm(dim=-1, keepdim=True),
            saturation_magnetization=u(4e5, 1.2e6), damping=u(0.005, 0.05),
            uniaxial_anisotropy=u(3e5, 2e6), volume=u(5e-24, 5e-23), polarization=u(0.3, 0.9),
        )

    def compare(a, b, tol):
        err = max((x - y).abs().max().item() for x, y in zip(a.m, b.m)) if a.m[0].numel() else 0.0
        for x, y in zip(a.m, b.m):
            torch.testing.assert_close(x, y, rtol=tol, atol=tol)
        check(torch.equal(a.n_substeps, b.n_substeps), "n_substeps differ")
        check(torch.equal(a.failed, b.failed), "failed flags differ")
        return err

    # ---------------------------- 3. K1 vs its plain version, deterministic
    det_err = 0.0
    cases = []
    for method in ("euler", "heun", "rk4"):
        for B in (1, 5, 200, 4096):
            axes = {"plus_z": params(), "tilted": params((0.6, 0.0, 0.8)),
                    "per_env": per_env_params(B)}
            for name, p in axes.items():
                m0, spans, cur = setup(B)
                cfg = IntegratorConfig(method=method, max_substeps=512)
                err = compare(ci.integrate_pulse_cuda(m0, spans, cur, p, cfg),
                              integrate_pulse_plain(m0, spans, cur, p, cfg), 2e-6)
                det_err = max(det_err, err)
                cases.append(dict(method=method, axis=name, B=B, max_abs_err=err))
                print(f"K1 deterministic {method:5s} {name:7s} B={B:5d}: max_abs_err {err:.3e}")
    B = 128
    m0, _, _ = setup(B)
    spans = torch.full((B,), 1e-10, device=dev)
    # Half at 1e6 A/m^2 (the JAX package's freeze test); half spread over
    # 1e-4..1e3 A/m^2, where float32 RK4 substeps overflow to zero rows.
    cur = torch.where(torch.arange(B) % 2 == 0, 1e6, torch.logspace(-4, 3, B)).float().to(dev)
    cfg = IntegratorConfig(method="rk4", max_substeps=128)
    a = ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg)
    err = compare(a, integrate_pulse_plain(m0, spans, cur, params(), cfg), 2e-6)
    det_err = max(det_err, err)
    frozen = int(a.failed.sum())
    check(frozen > 0, "the freeze case froze no env")
    print(f"K1 freeze case B={B}: {frozen} envs failed on both sides, max_abs_err {err:.3e}")
    RECORD["deterministic"] = cases

    # ------------------------------- 4. K1 thermal, the same Philox stream
    thermal_err = 0.0
    for cfg in (
        IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise="per_substep"),
        IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise="per_stage"),
        IntegratorConfig(method="heun", max_substeps=512, thermal=True, noise_mode="physical"),
    ):
        m0, spans, cur = setup(4096)
        err = compare(ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg, seed=99),
                      integrate_pulse_plain(m0, spans, cur, params(), cfg, seed=99), 1e-5)
        thermal_err = max(thermal_err, err)
        print(f"K1 thermal {cfg.method} {cfg.rk4_noise} {cfg.noise_mode}: max_abs_err {err:.3e}")
    RECORD["thermal_max_abs_err"] = thermal_err

    # Boltzmann equilibrium through the kernel: the setup of the JAX
    # package's fast physical-noise gate (heun, physical, B=1024, alpha 0.3,
    # a macrospin with an effective barrier of 1.5 kT, so p(m_z) ~
    # exp(1.5 m_z^2)) at the dt and span of its full-size gate, whose
    # bounds these are: KS p > 1e-3 and <m_z^2> within 0.02.
    ms, vol, temp = 800e3, 1e-25, 300.0
    delta, alpha, dt, span, B = 1.5, 0.3, 1e-13, 2.5e-9, 1024
    k_u = delta * KB_SOLVER * temp / vol + 0.5 * MU0 * ms**2
    g = torch.Generator().manual_seed(11)
    m = torch.randn(B, 3, generator=g, dtype=torch.float64)
    m0 = tuple((m / m.norm(dim=-1, keepdim=True)).t().float().to(dev).contiguous())
    res = ci.integrate_pulse_cuda(
        m0, torch.full((B,), span, device=dev), torch.zeros(B, device=dev),
        params(saturation_magnetization=ms, damping=alpha, uniaxial_anisotropy=k_u, volume=vol),
        IntegratorConfig(method="heun", max_step=dt, max_substeps=int(span / dt) + 10,
                         thermal=True, noise_mode="physical"),
        seed=11, temperature=temp,
    )
    check(not bool(res.failed.any()), "Boltzmann run failed")
    mz = res.m[2].double().cpu().numpy()
    xs = np.linspace(-1.0, 1.0, 2001)
    pdf = np.exp(delta * xs**2)
    cdf = sp_integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    ks = stats.kstest(mz, lambda v: np.interp(v, xs, cdf))
    m2_theory = np.trapezoid(xs**2 * pdf, xs) / np.trapezoid(pdf, xs)
    m2 = float((mz**2).mean())
    print(f"K1 Boltzmann gate: KS p {ks.pvalue:.4f} (> 1e-3), <m_z^2> {m2:.4f} vs {m2_theory:.4f}")
    check(ks.pvalue > 1e-3, f"m_z distribution rejects Boltzmann: {ks}")
    check(abs(m2 - m2_theory) < 0.02, "<m_z^2> off the Boltzmann value")
    RECORD["boltzmann"] = dict(ks_p=float(ks.pvalue), m2=m2, m2_theory=float(m2_theory))

    # -------------------- 5. K6 vs its plain bf16 version, and against K1
    bf16_err = 0.0
    bf16_cases = []
    for method in ("euler", "heun", "rk4"):
        for B in (1, 5, 200, 4096):
            axes = {"plus_z": params(), "tilted": params((0.6, 0.0, 0.8)),
                    "per_env": per_env_params(B)}
            for name, p in axes.items():
                m0, spans, cur = setup(B)
                cfg = IntegratorConfig(method=method, max_substeps=512, bf16_rhs=True)
                err = compare(ci.integrate_pulse_cuda(m0, spans, cur, p, cfg),
                              integrate_pulse_plain(m0, spans, cur, p, cfg), 2e-6)
                bf16_err = max(bf16_err, err)
                bf16_cases.append(dict(method=method, axis=name, B=B, max_abs_err=err))
                print(f"K6 deterministic {method:5s} {name:7s} B={B:5d}: max_abs_err {err:.3e}")
    RECORD["bf16_deterministic"] = bf16_cases
    bf16_thermal_err = 0.0
    for cfg in (
        IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise="per_substep"),
        IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise="per_stage"),
        IntegratorConfig(method="heun", max_substeps=512, thermal=True, noise_mode="physical"),
    ):
        cfg = cfg._replace(bf16_rhs=True)
        m0, spans, cur = setup(4096)
        err = compare(ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg, seed=99),
                      integrate_pulse_plain(m0, spans, cur, params(), cfg, seed=99), 1e-5)
        bf16_thermal_err = max(bf16_thermal_err, err)
        print(f"K6 thermal {cfg.method} {cfg.rk4_noise} {cfg.noise_mode}: max_abs_err {err:.3e}")
    RECORD["bf16_thermal_max_abs_err"] = bf16_thermal_err

    # K6 against K1 where bf16 rounding shows: zero current (precession and
    # damping), RK4, +z, spans up to 290 ps (<= 290 substeps). The bounds
    # are the JAX package's for B=256 (its test's batch), on inputs from a
    # generator of their own (seed 3, as the JAX test's key): the maximum is
    # a tail statistic, 13-24 deg over seeds 0-7. The B=4096 figures, a
    # further tail, are printed beside them.
    drift = {}
    for B in (256, 4096):
        m0, spans, _ = setup(B, lo=5e-11, hi=2.9e-10, g=torch.Generator().manual_seed(3))
        zero = torch.zeros_like(spans)
        cfg = IntegratorConfig(method="rk4", max_substeps=512)
        a = ci.integrate_pulse_cuda(m0, spans, zero, params(), cfg)
        b = ci.integrate_pulse_cuda(m0, spans, zero, params(), cfg._replace(bf16_rhs=True))
        check(torch.equal(a.n_substeps, b.n_substeps) and int(a.n_substeps.max()) <= 300,
              "K6 and K1 took different substeps")
        check(not bool(b.failed.any()), "K6 froze an env on the precession setup")
        cos = sum(x.double() * y.double() for x, y in zip(a.m, b.m)).clamp(-1.0, 1.0)
        ang = torch.rad2deg(torch.arccos(cos))
        drift[B] = dict(mean=ang.mean().item(), max=ang.max().item())
        print(f"K6 vs K1, zero-current precession B={B}: mean {drift[B]['mean']:.3f} deg, "
              f"max {drift[B]['max']:.3f} deg")
    check(drift[256]["mean"] < 6.0 and drift[256]["max"] < 25.0,
          "K6 drifts from K1 past the JAX bounds (B=256: mean < 6, max < 25 deg)")
    check(drift[256]["max"] > 1e-3, "K6 computed float32 results")
    RECORD["k6_vs_k1_deg"] = drift

    # K1 and K6 at the main path's shapes: default env config, random
    # actions. plus_z is resolved, as the env resolves it at construction;
    # left unresolved, the wrapper reads the axis back, a host sync per call.
    main_cfg = SpinTorqueEnvConfig().integrator()
    timing = {}
    for B in (4096, 65536):
        m0, spans, cur = setup(B, lo=1e-12, hi=5e-9, cur=2e6)
        p = dataclasses.replace(params(), plus_z=True)
        for label, cfg in (("thermal", main_cfg), ("deterministic", main_cfg._replace(thermal=False))):
            def k1():
                return ci.integrate_pulse_cuda(m0, spans, cur, p, cfg, seed=5)

            def k6():
                return ci.integrate_pulse_cuda(m0, spans, cur, p, cfg._replace(bf16_rhs=True), seed=5)

            k1()
            k6()
            # In turns, K1, K6, K6, K1, so that both see the same card state.
            k1_ms = cuda_ms(k1, 3)
            k6_ms = cuda_ms(k6, 6)
            k1_ms = (k1_ms + cuda_ms(k1, 3)) / 2
            plain_ms = cuda_ms(lambda: integrate_pulse_plain(m0, spans, cur, p, cfg, seed=5), 1)
            row = dict(ms=k1_ms, plain_ms=plain_ms, bf16_ms=k6_ms)
            line = (f"K1 {label} B={B} max_substeps={cfg.max_substeps}: "
                    f"kernel {k1_ms:.3f} ms, plain {plain_ms:.1f} ms; K6 {k6_ms:.3f} ms")
            if B == 4096 and label == "thermal":
                row["bf16_plain_ms"] = cuda_ms(lambda: integrate_pulse_plain(
                    m0, spans, cur, p, cfg._replace(bf16_rhs=True), seed=5), 1)
                line += f", plain bf16 {row['bf16_plain_ms']:.1f} ms"
            timing[f"{label}_B{B}"] = row
            print(f"{line}  [{smi}]")
    RECORD["k1_timing"] = timing

    # ------------------------------------- 6. the main path: the env step
    ci.PULSE_LAUNCHES.reset()
    ci.PULSE_BF16_LAUNCHES.reset()
    ci.PROBE_LAUNCHES.reset()
    ci.forget_probe()  # the env probes at construction, as in a fresh process
    env = SpinTorqueEnv(batch_size=4096, device="cuda")
    warmup, blocks, iters, n_inner = 2, 3, 2, 16
    rates, _, obs = measure_env_throughput(
        env, n_inner=n_inner, warmup=warmup, blocks=blocks, iters_per_block=iters,
        return_final=True,
    )
    launches = {"llgs_pulse": ci.PULSE_LAUNCHES.count, "probe_add_one": ci.PROBE_LAUNCHES.count}
    steps = (warmup + blocks * iters) * n_inner
    check(launches["llgs_pulse"] == steps,
          f"K1 launched {launches['llgs_pulse']} times in {steps} env steps")
    check(launches["probe_add_one"] == 1, "the env did not probe the kernel library")
    check(ci.PULSE_BF16_LAUNCHES.count == 0, "the float32 env launched K6")
    check(bool(torch.isfinite(obs).all()), "non-finite observations")
    norm = torch.linalg.vector_norm(obs[:, :3], dim=-1)
    check(bool(((norm - 1.0).abs() < 1e-5).all()), "|m| != 1 in the observations")
    rates.sort()
    print(f"main path B=4096: {steps} steps, K1 launched {launches['llgs_pulse']} times, "
          f"probe {launches['probe_add_one']}; median {rates[len(rates) // 2]:.0f} env-steps/s "
          f"(blocks {[round(r) for r in rates]})  [{smi}]")
    RECORD["env_steps_per_s_B4096"] = rates

    measure_env_throughput(env, n_inner=n_inner, warmup=0, blocks=1, iters_per_block=1,
                           sync_debug_mode="error")
    print("main path: one timed block of 16 steps ran under sync debug mode 'error'")

    env_big = SpinTorqueEnv(batch_size=65536, device="cuda")
    big_rates, _ = measure_env_throughput(env_big, n_inner=n_inner, warmup=1, blocks=3,
                                          iters_per_block=1)
    big_rates.sort()
    print(f"main path B=65536: median {big_rates[1]:.0f} env-steps/s "
          f"(blocks {[round(r) for r in big_rates]})  [{smi}]")
    RECORD["env_steps_per_s_B65536"] = big_rates

    # ------------------------------------ 7. the env with bf16_rhs (K6)
    ci.PULSE_LAUNCHES.reset()
    ci.PULSE_BF16_LAUNCHES.reset()
    env16 = SpinTorqueEnv(batch_size=4096, device="cuda", bf16_rhs=True)
    rates16, _, obs16 = measure_env_throughput(env16, n_inner=n_inner, warmup=1, blocks=3,
                                               iters_per_block=1, return_final=True)
    measure_env_throughput(env16, n_inner=n_inner, warmup=0, blocks=1, iters_per_block=1,
                           sync_debug_mode="error")
    steps16 = (1 + 3 + 1) * n_inner
    launches["llgs_pulse_bf16"] = ci.PULSE_BF16_LAUNCHES.count
    check(launches["llgs_pulse_bf16"] == steps16,
          f"K6 launched {launches['llgs_pulse_bf16']} times in {steps16} bf16 env steps")
    check(ci.PULSE_LAUNCHES.count == 0, "the bf16 env launched K1")
    check(bool(torch.isfinite(obs16).all()), "non-finite bf16 observations")
    norm = torch.linalg.vector_norm(obs16[:, :3], dim=-1)
    check(bool(((norm - 1.0).abs() < 1e-5).all()), "|m| != 1 in the bf16 observations")
    rates16.sort()
    print(f"bf16 env B=4096: {steps16} steps, K6 launched {launches['llgs_pulse_bf16']} times, "
          f"K1 0; median {rates16[1]:.0f} env-steps/s (blocks {[round(r) for r in rates16]}); "
          f"one block of 16 steps under sync debug mode 'error'  [{smi}]")
    RECORD["bf16_env_steps_per_s_B4096"] = rates16

    # ---------------------- 8. the PPO trainer at full width, over K1 and K6
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    train = {}
    for label, env_kw, counter, other in (
        ("float32", {}, ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES),
        ("bf16_rhs", {"bf16_rhs": True}, ci.PULSE_BF16_LAUNCHES, ci.PULSE_LAUNCHES),
    ):
        trainer = PPOTrainer(SpinTorqueEnv(batch_size=4096, device="cuda", **env_kw), PPOConfig())
        warmup_steps, timed_steps = (1, 3) if label == "float32" else (0, 1)
        ci.PULSE_LAUNCHES.reset()
        ci.PULSE_BF16_LAUNCHES.reset()
        out = measure_train_throughput(trainer, warmup=warmup_steps, steps=timed_steps)
        n_steps = warmup_steps + timed_steps
        want = n_steps * trainer.config.rollout_steps
        check(counter.count == want and other.count == 0,
              f"trainer ({label}) launched {counter.count} / {other.count} pulses, want {want} / 0")
        check(all(np.isfinite(v) for v in out["metrics"].values()), f"non-finite metrics: {out}")
        check(out["state"].update_count == n_steps, "the trainer lost an update")
        rate = sorted(out["rates"])[len(out["rates"]) // 2]
        print(f"PPO train {label} B=4096, PPOConfig(): {n_steps} train steps, pulse kernel "
              f"launched {counter.count} times; {rate:.0f} train env-steps/s, rollout "
              f"{[round(x, 2) for x in out['rollout_ms']]} ms, update "
              f"{[round(x, 2) for x in out['update_ms']]} ms, loss {out['metrics']['loss']:.4g}"
              f"  [{smi}]")
        train[label] = dict(rates=out["rates"], rollout_ms=out["rollout_ms"],
                            update_ms=out["update_ms"], metrics=out["metrics"],
                            pulse_launches=counter.count)
        if label == "float32":
            # One more train step under sync debug mode "error": it reads
            # nothing back to the host.
            measure_train_throughput(trainer, warmup=0, steps=1, sync_debug_mode="error")
            print("PPO train step: one step ran under sync debug mode 'error'")
    check(not torch.backends.cuda.matmul.allow_tf32, "the trainer turned TF32 on")
    RECORD["train_B4096"] = train

    # -------------- 9. the learning gate (tests/unit/test_rollout_rl.py:55)
    t0 = time.perf_counter()
    env_gate = SpinTorqueEnv(
        batch_size=64, device="cuda", include_thermal=False, max_duration=1e-10, max_steps=4,
        device_params={"polarization": 1e-12, "damping": 0.1},
    )
    trainer = PPOTrainer(env_gate, PPOConfig(rollout_steps=8, num_epochs=4, num_minibatches=4,
                                             hidden_sizes=(64, 64), learning_rate=1e-3,
                                             ent_coef=0.01))
    ts = trainer.init(0)
    success = []
    for _ in range(30):
        ts, metrics = trainer.train_step(ts)
        success.append(float(metrics["success_rate"]))
    baseline, trained = float(np.mean(success[:3])), float(np.mean(success[-5:]))
    print(f"learning gate B=64, 30 updates: success {baseline:.3f} -> {trained:.3f} "
          f"(>= 0.9 and +0.3) in {time.perf_counter() - t0:.1f} s")
    check(trained >= 0.9 and trained - baseline >= 0.3, "PPO did not learn to switch")
    RECORD["learning_gate"] = dict(success=success, baseline=baseline, trained=trained)

    # Where an env step's time goes: torch.profiler over 16 steps at B=4096.
    # Kernel self times are device times; the wall clock runs with the
    # profiler on, so the busy share it gives is a lower bound. It runs after
    # the trainer phases, so that their host-bound timings are taken before
    # any profiler session in the process.
    policy = random_policy(env)
    action_gen = torch.Generator(device=dev).manual_seed(3)
    state, obs = env.reset(seed=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_inner):
            state, ts = env.step(state, policy(None, obs, action_gen))
            obs = ts.obs
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_inner
    kernel_us = {
        e.key: e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }
    busy_ms = sum(kernel_us.values()) / 1e3 / n_inner
    k1_ms = sum(v for k, v in kernel_us.items() if "pulse_kernel" in k) / 1e3 / n_inner
    check(k1_ms > 0, "the profiler saw no K1 time")
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile B=4096: {wall_ms:.3f} ms/step wall (profiler on), device busy "
          f"{busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%}), K1 {k1_ms:.3f} ms/step, "
          f"{len(kernel_us)} kernel names  [{smi}]")
    RECORD["profile_B4096"] = dict(
        wall_ms_per_step=wall_ms, busy_ms_per_step=busy_ms, k1_ms_per_step=k1_ms,
        top_kernels_us_per_16_steps=top,
    )

    # One float32 step, thermal off, on the card and on the CPU plain path.
    # Without auto-reset: the card's and the CPU's reset generators draw
    # different streams.
    cfg = SpinTorqueEnvConfig(include_thermal=False, autoreset=False)
    B = 1024
    env_gpu = SpinTorqueEnv(batch_size=B, config=cfg, device="cuda")
    env_cpu = SpinTorqueEnv(batch_size=B, config=cfg, device="cpu")
    state, _ = env_gpu.reset(seed=21)
    snapshot = convert.env_state_to_numpy(state)
    action = torch.stack([2e6 * (2 * torch.rand(B, generator=gen) - 1),
                          1e-12 + 5e-9 * torch.rand(B, generator=gen)], -1)
    _, ts_gpu = env_gpu.step(convert.env_state_from_numpy(snapshot, device="cuda"), action.to(dev))
    _, ts_cpu = env_cpu.step(convert.env_state_from_numpy(snapshot, device="cpu"), action)
    obs_diff = (ts_gpu.obs.cpu() - ts_cpu.obs).abs().max().item()
    rew_diff = (ts_gpu.reward.cpu() - ts_cpu.reward).abs().max().item()
    print(f"one step card vs CPU plain path (B={B}, f32, thermal off): "
          f"obs max diff {obs_diff:.3e}, reward max diff {rew_diff:.3e}")
    check(obs_diff < 1e-4 and rew_diff < 1e-4, "card and CPU steps disagree")
    RECORD["card_vs_cpu_step"] = dict(obs=obs_diff, reward=rew_diff)

    kernels = [
        dict(name="llgs_pulse", route="cuda",
             source="spintorque_tpu_torch/csrc/pulse_integrator.cu",
             replaces="spintorque_tpu/ops/pallas_integrator.py:283",
             launches=launches["llgs_pulse"], max_abs_err=det_err,
             ms=timing["thermal_B4096"]["ms"], plain_ms=timing["thermal_B4096"]["plain_ms"]),
        dict(name="llgs_pulse_bf16", route="cuda",
             source="spintorque_tpu_torch/csrc/pulse_integrator.cu",
             replaces="spintorque_tpu/ops/pallas_integrator.py:316",
             launches=launches["llgs_pulse_bf16"], max_abs_err=bf16_err,
             ms=timing["thermal_B4096"]["bf16_ms"], plain_ms=timing["thermal_B4096"]["bf16_plain_ms"]),
        dict(name="probe_add_one", route="cuda",
             source="spintorque_tpu_torch/csrc/pulse_integrator.cu",
             replaces="spintorque_tpu/ops/pallas_integrator.py:118",
             launches=launches["probe_add_one"], max_abs_err=probe_err,
             ms=probe_ms, plain_ms=probe_plain_ms),
    ]
    RECORD["kernels"] = kernels
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    # One device driven, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))


if __name__ == "__main__":
    main()
