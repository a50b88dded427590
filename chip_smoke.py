#!/usr/bin/env python3
"""Smoke run of spintorque_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. It builds the port's CUDA kernels from the
checkout's sources (one nvcc per source, in parallel, then one link), holds each kernel
against its plain PyTorch version on the card, drives the port's paths and
checks that each launched its kernels: the env at B=4096 with the default
config (K1), the same env with bf16_rhs=True (K6), the PPO trainer at full
width (B=4096, the default PPOConfig) over both, the JAX package's PPO
learning gate, the data-parallel path (K5: the main config cut into four
shards in one process; two gloo ranks sharing the card for an env block
and a train step, held bit for bit to one process; one NCCL rank through
the same calls), the switching and Neel-Brown sweeps at full width, and
the op-chain micro-benchmark (K7), the device factory and its analytics,
and the functional env of each Gymnasium id with the configuration its
adapter builds: SpinTorque-v0 at B=1 for a 100-step episode (K1 once a
step), its VectorSpinTorqueEnv configuration at B=4096 with the adapter's
numpy round trip, the crossbar array env (4 x 4 sequential and
simultaneous, 16 x 16 simultaneous) and the skyrmion racetrack at B=4096.
The adapters themselves need gymnasium, which the card's machine may lack,
and are tested on the CPU (tests/test_torch_gym.py). Last, the analysis
physics (``analysis_phase``): the solver facade LLGSSolver at B=65536 over
a 5 ns pulse (K1) for euler, heun and rk4, thermal and deterministic, with
an easy axis taken from a dict; the trajectory at B=4096 over 2 ns; the
adaptive RK45 (B=4096), implicit midpoint and Radau (B=1024, the stiff
case); the stable-state search and the energy landscape; the solver
probes; ConfigManager().make_env(), the env and trainer checkpoint round
trips and step purity of the three envs on the card. Then the shell
(``shell_phase``): ``python -m spintorque_tpu_torch.cli info`` in a fresh
process, and in this one the CLI's ``benchmark`` (B=4096), ``train`` (B=4096,
the default PPO configuration, 3 updates) and ``eval --model`` of its
output (200 steps), the default ``sweep`` (16,384 trajectories) bit for bit
with a direct call, the serving endpoint (its health checks launch K1 from
the refresh thread), the coalescing ``PhysicsWorkerPool`` fed 4096 solves
from 8 threads, bit for bit with one ``solve_batch``, ``ParallelBenchmark``
and ``ScalableEnvironmentManager`` at B=1024/4096/16384. Each path's launch
counts are set to 0 just before it and read just after. Any failed check
raises and exits non-zero.

Beside the kernels' checks it holds the pulse kernel's design: ptxas's
report shows no spill in any pulse_kernel instance; div6, the kernel's
replacement for RK4's IEEE x / 6.0f, equals it on all 2^32 float32 inputs;
the thermal ring's ragged cases (a batch that is no multiple of 32, n = 0
and n = 1 in the warp of the longest env, every n = 0, n one past a
multiple of the ring's chunk, a nonzero env_offset) agree with the plain
version bit for bit; K1 thermal and deterministic at B=4096 are timed in
turns and their ratio printed; K2 is timed in turns with torch.add, per
call and by the profiler's device time; and each pulse kernel's chain
floor (``ops.cuda_integrator.pulse_chain_floor_ms``: the longest env's
substeps times the dependent depth of a substep, priced at K7's measured
latencies) stands beside its bound: for thermal runs on the normalization's
fallback path, which skips its division and is the shorter, for K1's and
K6's deterministic runs (``deterministic_ms`` in the kernels line) on the
finite path. The last two lines of standard output are the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": {...}};
the line before those lists each kernel with its launches, error, times and
bound. A longer record goes to build/chip_smoke.json.

Tolerances:
  * deterministic pulses, kernel vs plain (K1, K6 and K5 alike): rtol =
    atol = 2e-6 on m, with n_substeps and failed identical (the JAX
    package's Pallas contract); both usually agree to the bit;
  * thermal pulses with the same Philox stream: rtol = atol = 1e-5. Both
    sides draw the same bits; only the transcendentals (logf and the
    plain version's log) may differ by an ulp, and the field such a
    difference perturbs is tiny against the anisotropy field;
  * K5 against the unsharded K1 launch, and the two-rank env block against
    the one-process block: bit for bit (each shard draws its rows of the
    unsharded stream, and each env's integration is its own);
  * one env step on the card vs the CPU plain path, float32, thermal off:
    1e-4 on obs and reward, for the ulps by which the card's and the CPU's
    eager float32 ops may differ;
  * K6 against K1 on zero-current precession (<= 300 substeps, B=256):
    mean angle < 6 deg and max < 25 deg, the JAX package's bounds for its
    bf16 kernel at the batch of its test;
  * K7 against its plain chain: rtol 1e-6, atol 0, over ops.op_chain's
    CHECK_STEPS steps on its check_input, per-op inputs where every step
    moves x (on ones, the timing input, every chain sits at its fixed point
    and a copy would agree); there a copy, a step more or fewer, or another
    op differs by more than 1e-3.

  * the device factory and its analytics, card vs CPU float32 on the same
    (4096, 3) inputs: rtol 1e-6, with an atol of 1e-6 times the largest
    finite |value| of the output (its float32 rounding, for the outputs
    that cancel: sums of opposite terms). The Arrhenius switching times
    exp(x) / 1 GHz are compared by their exponent x = ln(t / 1 ns), at
    rtol = atol = 1e-6: in t itself a float32 exponent of up to ~88
    multiplies the rounding of its argument (7.7e-6 relative seen on the
    card). The VCMA switching probability 1 - exp(-r t) takes atol 1e-5
    for the same reason (its rate r is such an exponential);
  * the analysis phase: the solver's K1 results against the plain version
    on the card over the first 4096 rows of each batch (each env integrates
    and draws on its own; rk4 thermal over the solve's 5 ns, the other five
    over 1 ns, the plain loop's time being its substeps): 2e-6
    deterministic, 1e-5 thermal, n and failed identical; the trajectory's
    last row against the K1 solve at 2e-6; the adaptive methods in float32 on the card against the CPU port in
    float64 on their first 128 rows, within 10x the rtol; the stable
    states and the landscape's minima as sets, its effective field at rtol
    1e-12 (float64 on both); checkpoints and two steps of one state bit for
    bit;
  * the shell: the CLI sweep against a direct call with the same
    arguments, and the worker pool's coalesced solves against one
    ``solve_batch``, bit for bit (each env integrates on its own);
  * the functional envs of the Gymnasium ids, card vs CPU from the same
    state and actions, float32, thermal off: SpinTorque-v0 10 steps at
    1e-4 on obs and reward (as the one-step check); the array env one step
    at atol 1e-5 on the pattern and the array observation, rtol = atol =
    1e-5 on the reward; the racetrack one step at atol 1e-5 on positions
    over the track length, rtol 1e-5 on the reward and on velocities (atol
    1e-5 times the largest: at the action ranges' currents they are ~1e9
    m/s).

Bounds (``bound_ms``): the larger of the bytes a call must move over 3.35
TB/s (the H100 SXM's HBM rate) and its operations over the float32
instruction rate outside the tensor cores, 33.5 T/s (132 SMs x 128 lanes x
1.98 GHz, half the 67 TFLOP/s FMA flop rate), from this run's inputs. Every
kernel here is built with --fmad=false, so its adds and multiplies issue as
plain FADDs and FMULs, one instruction an operation: a pulse call's
operations are its envs' substeps times the per-substep count of
``ops.cuda_integrator.pulse_ops_per_substep`` (each add, multiply, divide,
sqrt, log, compare or select one, so a lower bound), the probe's one add an
element, K7's a plain FADD and FMUL a step.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RECORD = {}
PEAK_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores (an FMA is two flops)
# Float32 instructions (FADD, FMUL, FFMA alike) issue one per lane per
# clock: 132 SMs x 128 lanes x 1.98 GHz, half the FMA flop rate. The
# kernels are built with --fmad=false, so an add or a multiply is one
# instruction: the rate every bound below prices operations at.
PEAK_FP32_INSTR = PEAK_FLOPS / 2
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for ``ops`` float32 instructions
    at ``PEAK_FP32_INSTR`` per second and ``nbytes`` bytes at the card's
    HBM rate."""
    t_ops, t_bytes = ops / PEAK_FP32_INSTR, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def global_actions(batch, steps, seed):
    """(steps, batch, 2) random continuous actions of the default env
    config (the random policy's ranges), drawn on the host from ``seed``."""
    import torch

    u = torch.rand((steps, 2, batch), generator=torch.Generator().manual_seed(seed))
    current = -2e6 + 4e6 * u[:, 0]
    duration = 1e-12 + (5e-9 - 1e-12) * u[:, 1]
    return torch.stack([current, duration], dim=-1)


def env_block(env, seed, actions, mesh=None):
    """Reset ``env`` from ``seed`` and step it through ``actions`` (global
    rows; this rank's on a mesh). Returns the stacked obs, reward and m on
    the host."""
    import torch

    from spintorque_tpu_torch.parallel import shard_batch

    state, _ = env.reset(seed)
    obs, rew, ms = [], [], []
    for a in actions:
        a = a if mesh is None else shard_batch(a, mesh)
        state, ts = env.step(state, a.to(env.device))
        obs.append(ts.obs)
        rew.append(ts.reward)
        ms.append(state.m)
    return {k: torch.stack(v).cpu() for k, v in (("obs", obs), ("reward", rew), ("m", ms))}


def data_parallel_rank(batch, seed, actions):
    """One rank of the data-parallel phase: a 16-step env block and two PPO
    train steps (one timed) at global batch ``batch`` with the default
    configs, on this rank's rows; launch counts read around each."""
    import torch

    from spintorque_tpu_torch.envs import SpinTorqueEnv
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.parallel import make_mesh
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
    from spintorque_tpu_torch.utils import measure_train_throughput

    counters = (ci.PULSE_SHARDED_LAUNCHES, ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES)
    mesh = make_mesh()
    env = SpinTorqueEnv(batch_size=batch, mesh=mesh)
    for c in counters:
        c.reset()
    block = env_block(env, seed, actions, mesh)
    torch.cuda.synchronize()
    env_launches = [c.count for c in counters]
    trainer = PPOTrainer(SpinTorqueEnv(batch_size=batch, mesh=mesh), PPOConfig())
    for c in counters:
        c.reset()
    out = measure_train_throughput(trainer, warmup=1, steps=1)
    train_launches = [c.count for c in counters]
    params = torch.cat([p.detach().reshape(-1) for p in out["state"].network.parameters()])
    return dict(block=block, env_launches=env_launches, train_launches=train_launches,
                rank=mesh.data_rank, rows=env.local_batch_size, params=params.cpu(),
                **{k: out[k] for k in ("rates", "rollout_ms", "update_ms", "metrics",
                                       "world_size", "backend", "device")})


def timed(fn):
    """(result, ms) of one call of ``fn``, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def card_vs_cpu(make_env, to_numpy, from_numpy, actions, seed):
    """Steps ``make_env("cuda")`` and ``make_env("cpu")`` from the card env's
    reset state (carried to each side by ``to_numpy`` / ``from_numpy``)
    through the same host ``actions``. Returns, per side, the list of
    (state, TimeStep) after each step, read back to numpy."""
    from spintorque_tpu_torch.utils.host import to_host

    env_card, env_cpu = make_env("cuda"), make_env("cpu")
    snapshot = to_numpy(env_card.reset(seed)[0])
    sides = []
    for env in (env_card, env_cpu):
        state = from_numpy(snapshot, device=env.device)
        steps = []
        for a in actions:
            state, ts = env.step(state, a.to(env.device))
            steps.append((to_numpy(state), to_host(ts)))
        sides.append(steps)
    return sides


def max_diff(a, b):
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, float) - np.asarray(b, float))))


def kernels_per_call(fn):
    """(CUDA kernels and copies, their device ms) of one call of ``fn``, by
    the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in p.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.count for e in ops), sum(e.self_device_time_total for e in ops) / 1e3


def device_factory_phase(dev, smi):
    """Every device type of the factory on ``dev`` against the CPU, float32:
    the Device methods and the SOT / VCMA / skyrmion analytics on a batch of
    4096."""
    import numpy as np
    import torch

    from spintorque_tpu_torch import devices as D

    B = 4096
    g = torch.Generator().manual_seed(41)
    m = torch.randn(B, 3, generator=g, dtype=torch.float64)
    inputs = dict(
        m=m / m.norm(dim=-1, keepdim=True),
        h=1e5 * torch.randn(B, 3, generator=g, dtype=torch.float64),
        j=5e7 * (2 * torch.rand(B, generator=g, dtype=torch.float64) - 1),
        dur=1e-12 + 5e-9 * torch.rand(B, generator=g, dtype=torch.float64),
        # |V| from 1e-12 to 2.5 V, log-spread: every branch of the VCMA laws
        v=torch.sign(torch.randn(B, generator=g, dtype=torch.float64))
        * 2.5 * 10 ** (-12 * torch.rand(B, generator=g, dtype=torch.float64)),
        j2=1e11 * torch.randn(B, 2, generator=g, dtype=torch.float64),
        y=200e-9 * torch.rand(B, generator=g, dtype=torch.float64),
    )

    def outputs(device_type, device):
        d = D.create_device(device_type, device=device)
        x = {k: v.float().to(device) for k, v in inputs.items()}
        m, p = x["m"], d.params
        mx, my, mz = m.unbind(-1)
        out = dict(
            resistance=d.compute_resistance(m),
            effective_field=d.compute_effective_field(m, x["h"]),
            power=d.compute_power_consumption(x["j"], x["dur"], m),
            energy_barrier=D.energy_barrier(device_type, mx, my, mz, p, voltage=x["v"]),
            vcma_effective_anisotropy=D.vcma_effective_anisotropy(x["v"], p),
            vcma_pulse_energy=D.vcma_pulse_energy(x["v"], x["dur"], p),
            vcma_leakage_current=D.vcma_leakage_current(x["v"], p),
            vcma_switching_time=D.vcma_switching_time(x["v"], p),
            vcma_switching_probability=D.vcma_switching_probability(x["v"], x["dur"], p),
            sot_spin_torques=torch.stack([c for pair in D.sot_spin_torques(x["j"], mx, my, mz, p)
                                          for c in pair]),
            sot_switching_time=D.sot_switching_time(x["j"], p),
            skyrmion_velocity=D.skyrmion_velocity(p, x["j2"]),
            skyrmion_stability=D.skyrmion_stability(p, x["y"]),
            skyrmion_resistance=D.skyrmion_resistance(p, torch.arange(B, device=device) % 5),
            exchange_length=D.exchange_length(p),
            skyrmion_energy=D.skyrmion_energy(p),
            skyrmion_hall_angle=D.skyrmion_hall_angle(p),
            sot_switching_threshold=D.sot_switching_threshold(p),
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for k in ("vcma_switching_time", "sot_switching_time"):
            # Arrhenius times by their exponent, ln(t / 1 ns).
            with np.errstate(divide="ignore"):
                out[k] = np.log(out[k].astype(float) * 1e9)
        return out, d.get_switching_threshold()

    worst = {}
    for device_type in D.DEVICE_TYPES:
        got, got_threshold = outputs(device_type, dev)
        want, want_threshold = outputs(device_type, "cpu")
        check(got_threshold.keys() == want_threshold.keys(), f"{device_type} thresholds")
        for k in want_threshold:
            check(abs(got_threshold[k] - want_threshold[k]) <= 1e-6 * abs(want_threshold[k]),
                  f"{device_type} switching threshold {k}: {got_threshold} vs {want_threshold}")
        for name, ref in want.items():
            finite = np.isfinite(ref)
            scale = float(np.abs(ref[finite]).max()) if finite.any() else 0.0
            atol = {"vcma_switching_time": 1e-6, "sot_switching_time": 1e-6,
                    "vcma_switching_probability": 1e-5}.get(name, 1e-6 * scale)
            np.testing.assert_allclose(got[name], ref, rtol=1e-6, atol=atol,
                                       err_msg=f"{device_type} {name}: card vs CPU")
            ref_f = ref[finite].astype(float)
            err = np.abs(got[name][finite] - ref_f) / np.maximum(np.abs(ref_f), 1e-300)
            worst[name] = max(worst.get(name, 0.0), float(err.max()) if err.size else 0.0)
    print(f"device factory on the card: {len(D.DEVICE_TYPES)} types x {len(worst)} outputs on "
          f"B={B}, card vs CPU float32 within the stated tolerances; worst relative "
          f"{max(worst, key=worst.get)} {max(worst.values()):.2e}  [{smi}]")
    return dict(worst_relative=worst)


def gym_id_phases(dev, smi, main_rate):
    """The functional env of each registered id, with the configuration its
    adapter builds (``tests/test_torch_gym.py`` holds the adapters to these
    configurations), on ``dev``. ``main_rate`` is the main path's env-steps/s
    at B=4096 without the host round trip."""
    import numpy as np
    import torch

    from spintorque_tpu_torch import convert
    from spintorque_tpu_torch.envs import (
        ArrayEnvConfig,
        SkyrmionEnvConfig,
        SkyrmionRacetrackEnv,
        SpinTorqueArrayEnv,
        SpinTorqueEnv,
        SpinTorqueEnvConfig,
    )
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.utils.host import next_seed, to_host

    out = {}
    rng = np.random.default_rng(17)
    B = 4096

    # SpinTorque-v0 at B=1, as a Gymnasium loop drives its adapter: 100
    # steps (the id's max_episode_steps) of random actions, each with the
    # adapter's host read, and a reset from a fresh seed of the adapter's
    # seed sequence whenever an episode terminates or is truncated.
    cfg = SpinTorqueEnvConfig(autoreset=False)
    actions = np.stack([rng.uniform(-cfg.max_current, cfg.max_current, 100),
                        rng.uniform(0.0, cfg.max_duration, 100)], -1).astype(np.float32)
    seeds = np.random.SeedSequence(5)
    ci.PULSE_LAUNCHES.reset()
    ci.PROBE_LAUNCHES.reset()
    env = SpinTorqueEnv(batch_size=1, config=cfg, device=dev)

    def reset():
        t0 = time.perf_counter()
        state, obs = env.reset(next_seed(seeds))
        check(np.isfinite(to_host(obs)).all(), "SpinTorque-v0 reset")
        reset_ms.append((time.perf_counter() - t0) * 1e3)
        return state

    step_ms, reset_ms, episode_steps = [], [], [0]
    state = reset()
    for a in actions:
        t0 = time.perf_counter()
        state, ts = env.step(state, a[None])
        host = to_host(ts)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(host.obs).all(), "SpinTorque-v0: non-finite observation")
        episode_steps[-1] += 1
        if host.terminated[0] or host.truncated[0]:
            check(episode_steps[-1] <= cfg.max_steps, "SpinTorque-v0 ran past max_steps")
            state = reset()
            episode_steps.append(0)
    launches = (ci.PULSE_LAUNCHES.count, ci.PROBE_LAUNCHES.count)
    check(launches[0] == 100 and launches[1] <= 1,
          f"SpinTorque-v0 episodes launched K1 / K2 {launches}, want 100 / <= 1")
    episodes = [n for n in episode_steps if n]
    first_done = episode_steps[0] if len(episode_steps) > 1 else None
    card, cpu = card_vs_cpu(
        lambda d: SpinTorqueEnv(batch_size=1, config=cfg._replace(include_thermal=False),
                                device=d),
        convert.env_state_to_numpy, convert.env_state_from_numpy,
        [torch.from_numpy(a[None]) for a in actions[:10]], seed=6)
    obs_diff = max(max_diff(a[1].obs, b[1].obs) for a, b in zip(card, cpu))
    rew_diff = max(max_diff(a[1].reward, b[1].reward) for a, b in zip(card, cpu))
    check(obs_diff < 1e-4 and rew_diff < 1e-4, "SpinTorque-v0: card and CPU steps disagree")
    median_ms, p90_ms = (float(x) for x in np.percentile(step_ms, [50, 90]))
    reset_median_ms = float(np.median(reset_ms))
    n_kernels, busy_ms = kernels_per_call(lambda: to_host(env.step(state, actions[0][None])[1]))
    out["spin_torque_v0"] = dict(median_ms=median_ms, p90_ms=p90_ms, launches=launches,
                                 resets=len(reset_ms), reset_median_ms=reset_median_ms,
                                 episode_lengths=episodes, first_done_step=first_done,
                                 card_vs_cpu=(obs_diff, rew_diff),
                                 kernels_per_step=n_kernels, device_ms_per_step=busy_ms)
    print(f"SpinTorque-v0 (B=1, thermal, RK4): 100 steps in {len(episodes)} episodes (first "
          f"done at step {first_done}; {len(reset_ms)} resets, {reset_median_ms:.3f} ms median "
          f"each), K1 launched {launches[0]} times, K2 {launches[1]}; {median_ms:.3f} ms "
          f"median, {p90_ms:.3f} ms p90 per step with the host read; one profiled step: "
          f"{n_kernels} kernels and copies, {busy_ms:.3f} ms on the device; 10 steps thermal "
          f"off card vs CPU: obs {obs_diff:.2e}, reward {rew_diff:.2e}  [{smi}]")

    # VectorSpinTorqueEnv's configuration at its default width, with the
    # adapter's numpy round trip each step: actions in from numpy, every
    # output (obs, reward, flags, info) out to numpy in one wait.
    env = SpinTorqueEnv(batch_size=B, config=SpinTorqueEnvConfig(), device=dev)
    state, _ = env.reset(seed=7)
    blocks = []
    for _ in range(3):  # a warmup block, then two
        acts = np.stack([rng.uniform(-2e6, 2e6, (16, B)), rng.uniform(0.0, 5e-9, (16, B))],
                        -1).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state, ts = env.step(state, a)
            host = to_host(ts)
        blocks.append(16 * B / (time.perf_counter() - t0))
        check(np.isfinite(host.obs).all(), "non-finite vector-adapter observations")
    n_kernels, busy_ms = kernels_per_call(lambda: to_host(env.step(state, acts[0])[1]))
    out["vector_round_trip"] = dict(env_steps_per_s=blocks[1:], kernels_per_step=n_kernels,
                                    device_ms_per_step=busy_ms)
    print(f"VectorSpinTorqueEnv config B={B}, 16 steps with the numpy round trip: "
          f"{[round(r) for r in blocks[1:]]} env-steps/s (without it, the main path: "
          f"{main_rate:.0f}); one profiled step: {n_kernels} kernels and copies, "
          f"{busy_ms:.3f} ms on the device  [{smi}]")

    # SpinTorqueArray-v0: 4 x 4, dipolar, individual actions, B=4096.
    def array_actions(cfg, n_steps):
        idx = rng.integers(0, cfg.n_devices, (n_steps, B))
        cur = rng.uniform(-cfg.max_current, cfg.max_current, (n_steps, B))
        cur[rng.random((n_steps, B)) < 0.2] = 0.0
        dur = rng.uniform(1e-12, cfg.max_duration, (n_steps, B))
        return torch.from_numpy(np.stack([idx, cur, dur], -1).astype(np.float32))

    array_cfg = ArrayEnvConfig(autoreset=False)
    out["array"] = {}
    for label, cfg in (("4x4 sequential", array_cfg),
                       ("4x4 simultaneous", array_cfg._replace(coupling_update="simultaneous")),
                       ("16x16 simultaneous", array_cfg._replace(
                           rows=16, cols=16, coupling_update="simultaneous"))):
        env = SpinTorqueArrayEnv(batch_size=B, config=cfg, device=dev)
        acts = array_actions(cfg, 16).to(dev)
        state, _ = env.reset(seed=8)
        env.step(state, acts[0])  # warmup
        states = [state]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            states.append(env.step(states[-1], a)[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 16
        # After the clock: devices not selected, or driven by |J| <= 1e-12,
        # kept their bits.
        kept = True
        for a, old, new in zip(acts, states, states[1:]):
            moved = (torch.arange(cfg.n_devices, device=dev)[None, :] == a[:, :1].long()) \
                & (a[:, 1:2].abs() > 1e-12)
            kept &= bool(torch.equal(new.pattern[~moved], old.pattern[~moved]))
        state = states[-1]
        del states
        norm_err = float((torch.linalg.vector_norm(state.pattern, dim=-1) - 1).abs().max())
        check(kept, f"array {label}: an undriven device moved")
        check(norm_err < 1e-5, f"array {label}: |m| off 1 by {norm_err}")
        card, cpu = card_vs_cpu(
            lambda d, cfg=cfg: SpinTorqueArrayEnv(batch_size=B, config=cfg, device=d),
            convert.array_state_to_numpy, convert.array_state_from_numpy,
            [array_actions(cfg, 1)[0]], seed=9)
        (s_card, t_card), (s_cpu, t_cpu) = card[0], cpu[0]
        pattern_diff = max_diff(s_card["pattern"], s_cpu["pattern"])
        obs_diff = max_diff(t_card.obs, t_cpu.obs)
        check(pattern_diff < 1e-5 and obs_diff < 1e-5, f"array {label}: card vs CPU "
              f"pattern {pattern_diff}, obs {obs_diff}")
        np.testing.assert_allclose(t_card.reward, t_cpu.reward, rtol=1e-5, atol=1e-5,
                                   err_msg=f"array {label}: card vs CPU reward")
        n_kernels, busy_ms = kernels_per_call(lambda: env.step(state, acts[0]))
        out["array"][label] = dict(ms_per_step=ms, norm_err=norm_err, pattern_diff=pattern_diff,
                                   obs_diff=obs_diff, kernels_per_step=n_kernels,
                                   device_ms_per_step=busy_ms)
        print(f"SpinTorqueArray-v0 {label} B={B}: {ms:.2f} ms/step (16 steps); one profiled "
              f"step: {n_kernels} kernels and copies, {busy_ms:.3f} ms on the device; |m| - 1 "
              f"{norm_err:.1e}; undriven devices bit for bit; one step card vs CPU: pattern "
              f"{pattern_diff:.1e}, obs {obs_diff:.1e}  [{smi}]")

    # SkyrmionRacetrack-v0: 1 skyrmion, pinning and thermal on, B=4096, one
    # 150-step episode.
    cfg = SkyrmionEnvConfig(autoreset=False)

    def racetrack_actions(n_steps):
        a = np.concatenate([rng.uniform(-cfg.max_current, cfg.max_current, (n_steps, B, 2)),
                            rng.uniform(-cfg.max_gradient, cfg.max_gradient, (n_steps, B, 2)),
                            rng.uniform(0.0, 2e-9, (n_steps, B, 1))], -1)
        return torch.from_numpy(a.astype(np.float32))

    env = SkyrmionRacetrackEnv(batch_size=B, config=cfg, device=dev)
    acts = racetrack_actions(cfg.max_steps).to(dev)
    state, _ = env.reset(seed=10)
    lo = torch.tensor([cfg.skyrmion_radius] * 2, device=dev)
    hi = torch.tensor([cfg.track_length - cfg.skyrmion_radius,
                       cfg.track_width - cfg.skyrmion_radius], device=dev)
    inside = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        state, ts = env.step(state, a)
        inside &= ((state.positions >= lo) & (state.positions <= hi)).all()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cfg.max_steps
    check(bool(inside), "a skyrmion left the track")
    check(bool(ts.truncated.all()) and bool(torch.isfinite(ts.obs).all()), "racetrack episode")
    card, cpu = card_vs_cpu(
        lambda d: SkyrmionRacetrackEnv(batch_size=B, config=cfg._replace(include_thermal=False),
                                       device=d),
        convert.skyrmion_state_to_numpy, convert.skyrmion_state_from_numpy,
        [racetrack_actions(1)[0]], seed=11)
    (s_card, t_card), (s_cpu, t_cpu) = card[0], cpu[0]
    # At the action ranges' currents the skyrmions move at ~1e9 m/s and
    # stop at the walls: positions over the track length at atol 1e-5,
    # velocities relative to their largest.
    pos_diff = max_diff(s_card["positions"], s_cpu["positions"]) / cfg.track_length
    vel_scale = float(np.abs(s_cpu["velocities"]).max())
    np.testing.assert_allclose(s_card["velocities"], s_cpu["velocities"], rtol=1e-5,
                               atol=1e-5 * vel_scale, err_msg="racetrack: card vs CPU velocities")
    check(pos_diff < 1e-5, f"racetrack: card vs CPU positions / L {pos_diff}")
    np.testing.assert_allclose(t_card.reward, t_cpu.reward, rtol=1e-5,
                               err_msg="racetrack: card vs CPU reward")
    n_kernels, busy_ms = kernels_per_call(lambda: env.step(state, acts[0]))
    out["skyrmion"] = dict(ms_per_step=ms, positions_over_length_diff=pos_diff,
                           kernels_per_step=n_kernels, device_ms_per_step=busy_ms)
    print(f"SkyrmionRacetrack-v0 B={B}, pinning and thermal on: 150 steps, {ms:.2f} ms/step; "
          f"one profiled step: {n_kernels} kernels and copies, {busy_ms:.3f} ms on the device; "
          f"every skyrmion inside the walls; one step thermal off card vs CPU: positions / L "
          f"{pos_diff:.1e}, velocities (scale {vel_scale:.2e} m/s) within rtol 1e-5  [{smi}]")
    return out


# The analysis phase's device: STT-MRAM-like, its easy axis tilted off +z
# and taken from a dict, as a user characterizing a device passes it.
ANALYSIS_DEVICE = dict(volume=1e-23, saturation_magnetization=800e3, damping=0.01,
                       uniaxial_anisotropy=1.2e6, polarization=0.7, easy_axis=[0.6, 0.0, 0.8])
# The stiff high-damping case of the JAX package's adaptive tests.
STIFF_DEVICE = dict(ANALYSIS_DEVICE, damping=0.5, easy_axis=[0.0, 0.0, 1.0])


def analysis_phase(dev, smi):
    """The analysis physics on the card, at the sizes users characterize
    devices: the solver facade (K1) at B=65536 over a 5 ns pulse for each
    fixed-step method, thermal and deterministic, held to the plain version
    on the card; the trajectory at B=4096 over 2 ns against the K1 solve;
    the adaptive methods in float32 against the CPU port in float64; the
    stable-state search and the energy landscape; the solver probes; the
    config, checkpoint round trips and step purity of the three envs. K1's
    launches are counted from 0 over the solver's path."""
    import numpy as np
    import torch

    from spintorque_tpu_torch.config import ConfigManager
    from spintorque_tpu_torch.envs import (
        ArrayEnvConfig,
        SkyrmionEnvConfig,
        SkyrmionRacetrackEnv,
        SpinTorqueArrayEnv,
        SpinTorqueEnv,
        SpinTorqueEnvConfig,
    )
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.physics import (
        AdaptiveLLGSSolver,
        EnergyLandscape,
        IntegratorConfig,
        LLGSSolver,
        find_stable_states,
        integrate_pulse_plain,
        normalize_with_fallback,
        params_from_dict,
    )
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer
    from spintorque_tpu_torch.utils import (
        load_env_state,
        load_train_state,
        save_env_state,
        save_train_state,
    )

    out = {}
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(31)
    B = 65536
    m = torch.randn(B, 3, generator=g).to(dev)  # the solver normalizes
    # Currents of either sign, log-uniform over 1e-6..1e2 A/m^2: the
    # larger ones freeze some envs in float32 (the reference's failure).
    cur = (torch.sign(torch.randn(B, generator=g))
           * 10.0 ** (8.0 * torch.rand(B, generator=g) - 6.0)).to(dev)
    counters = (ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES, ci.PULSE_SHARDED_LAUNCHES)

    # ---- the solver facade: 6 solves at B=65536 through K1, timed
    for c in counters:
        c.reset()
    solves = {}
    for method in ("euler", "heun", "rk4"):
        solver = LLGSSolver(method=method, device=dev)
        for thermal in (False, True):
            solves[(method, thermal)] = timed(lambda: solver.solve(
                m, (0.0, 5e-9), ANALYSIS_DEVICE, current=cur, thermal_noise=thermal, seed=13))
    # the probes on the card: zero span, zero / NaN magnetization, unknown
    # method, float64
    solver = LLGSSolver(method="no-such-method", device=dev)
    check(solver.method == "euler", "an unknown method did not become euler")
    triv = solver.solve(torch.tensor([0.0, 0.0, 2.0]), (1e-9, 1e-9), ANALYSIS_DEVICE)
    fall = solver.solve(torch.tensor([[0.0, 0.0, 0.0], [float("nan"), 1.0, 0.0]]),
                        (0.0, 1e-10), STIFF_DEVICE)
    plus_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
    check(triv["success"] and triv["n_steps"] == 1 and torch.equal(triv["m"], plus_z),
          f"zero-span probe: {triv}")
    check(fall["success"] and torch.equal(fall["m"], plus_z.expand(2, 3)),
          f"zero / NaN magnetization probe: {fall['m']}")
    launched = counters[0].count
    try:
        LLGSSolver(dtype=torch.float64, device=dev).solve(m[:4], (0.0, 1e-10), ANALYSIS_DEVICE)
        check(False, "a float64 solve on the card did not raise")
    except ValueError:
        pass
    check(counters[0].count == launched, "the float64 solve launched K1")
    solver_launches = [c.count for c in counters]
    check(solver_launches == [7, 0, 0],
          f"the solver path launched K1/K6/K5 {solver_launches} times, want [7, 0, 0]")

    # ...each held to the plain version on the card over its first 4096
    # rows (each env integrates and draws on its own): 2e-6 deterministic,
    # 1e-5 thermal, n and failed identical. The plain loop is host-bound,
    # its time its substeps: rk4 thermal (the main path's method) is held
    # over the full 5 ns; the other five over 1 ns, against a K1 solve of
    # those rows over 1 ns.
    rows = 4096
    p = params_from_dict(ANALYSIS_DEVICE, device=dev)
    m0 = normalize_with_fallback(*m[:rows].unbind(-1))
    solve_rows = []
    for (method, thermal), (res, ms) in solves.items():
        span_s = 5e-9 if (method, thermal) == ("rk4", True) else 1e-9
        if span_s != 5e-9:
            res = LLGSSolver(method=method, device=dev).solve(
                m[:rows], (0.0, span_s), ANALYSIS_DEVICE, current=cur[:rows],
                thermal_noise=thermal, seed=13)
        cfg = IntegratorConfig(method=method, thermal=thermal)  # the solver's defaults
        span = torch.full((rows,), span_s, device=dev)
        want, plain_ms = timed(lambda: integrate_pulse_plain(
            m0, span, cur[:rows], p, cfg, seed=13 if thermal else None))
        tol = 1e-5 if thermal else 2e-6
        got = res["m"][:rows]
        torch.testing.assert_close(got, torch.stack(want.m, -1), rtol=tol, atol=tol)
        check(torch.equal(res["n_steps"][:rows], want.n_substeps)
              and torch.equal(res["failed"][:rows], want.failed),
              f"solver {method} thermal={thermal}: n or failed differ from the plain version")
        err = float((got - torch.stack(want.m, -1)).abs().max())
        frozen = int(solves[(method, thermal)][0]["failed"].sum())
        solve_rows.append(dict(method=method, thermal=thermal, ms=ms, plain_ms_4096=plain_ms,
                               plain_span_s=span_s, max_abs_err=err, failed=frozen))
        print(f"LLGSSolver {method:5s} {'thermal' if thermal else 'deterministic':13s} "
              f"B={B} 5 ns, tilted axis from a dict: {ms:.2f} ms (K1, with the host read of "
              f"success); plain on 4096 rows over {span_s * 1e9:g} ns {plain_ms:.0f} ms, "
              f"max_abs_err {err:.2e}; {frozen} envs failed  [{smi}]")
    out["solver"] = dict(solves=solve_rows, launches=solver_launches)

    # ---- the trajectory: B=4096, 2 ns, the defaults (euler, 5120 rows)
    solver = LLGSSolver(device=dev)
    mt, ct = m[:4096], cur[:4096]
    traj, traj_ms = timed(lambda: solver.solve(mt, (0.0, 2e-9), ANALYSIS_DEVICE, current=ct,
                                               return_trajectory=True))
    final = solver.solve(mt, (0.0, 2e-9), ANALYSIS_DEVICE, current=ct)
    check(traj["m"].shape == (4096, 5121, 3), f"trajectory shape {tuple(traj['m'].shape)}")
    torch.testing.assert_close(traj["m"][:, -1], final["m"], rtol=2e-6, atol=2e-6)
    check(torch.equal(traj["n_steps"], final["n_steps"]), "trajectory n differs")
    traj_err = float((traj["m"][:, -1] - final["m"]).abs().max())
    out["trajectory"] = dict(ms=traj_ms, last_row_vs_k1=traj_err)
    print(f"trajectory B=4096 2 ns (5121, 3) rows a state: {traj_ms:.0f} ms (the plain loop, "
          f"2000 substeps); last row vs the K1 solve {traj_err:.2e}  [{smi}]")
    del traj

    # ---- the adaptive methods: float32 on the card against the CPU port in
    # float64 on the first rows (each env adapts on its own), within 10x the
    # rtol; success everywhere.
    adaptive = []
    for method, batch, dp, span, cur_a, kw in (
        ("RK45", 4096, dict(ANALYSIS_DEVICE, damping=0.05), 1e-9, 1e-11,
         dict(rtol=1e-5, atol=1e-8)),
        ("midpoint", 1024, STIFF_DEVICE, 5e-9, 0.0, dict(rtol=1e-6, atol=1e-9, dt_max=5e-10)),
        ("Radau", 1024, STIFF_DEVICE, 5e-9, 0.0, dict(rtol=1e-6, atol=1e-9, dt_max=5e-10)),
    ):
        ma = m[:batch]
        res, ms = timed(lambda: AdaptiveLLGSSolver(method=method, device=dev, **kw).solve(
            ma, (0.0, span), dp, current=cur_a))
        ref = AdaptiveLLGSSolver(method=method, dtype=torch.float64, device="cpu", **kw).solve(
            ma[:128].cpu().double(), (0.0, span), dp, current=cur_a)
        err = float((res["m"][:128].cpu().double() - ref["m"]).abs().max())
        check(res["success"] and ref["success"], f"{method}: an env did not reach t_end")
        check(err < 10 * kw["rtol"], f"{method}: card vs CPU float64 {err}")
        row = dict(method=method, batch=batch, ms=ms, iterations=res["iterations"],
                   host_reads=res["host_reads"], mean_steps=float(res["n_steps"].float().mean()),
                   mean_rejected=float(res["n_rejected"].float().mean()), max_abs_err_vs_f64=err)
        adaptive.append(row)
        print(f"AdaptiveLLGSSolver {method} B={batch} float32 over {span:g} s: {ms:.0f} ms, "
              f"{res['iterations']} iterations, {res['host_reads']} host reads, "
              f"{row['mean_steps']:.1f} steps and {row['mean_rejected']:.1f} rejections a "
              f"row; vs the CPU port in float64 (128 rows) {err:.2e}  [{smi}]")
    out["adaptive"] = adaptive

    # ---- stable states and the landscape, card against CPU
    stiff_card = params_from_dict(STIFF_DEVICE, device=dev)
    states, search_ms = timed(lambda: find_stable_states(stiff_card, n_seeds=64, relax_time=2e-9))
    states_cpu = find_stable_states(params_from_dict(STIFF_DEVICE, device="cpu"), n_seeds=64,
                                    relax_time=2e-9)
    check(len(states) == 2 and bool(np.all(np.abs(states[:, 2]) > 0.99))
          and sorted(np.sign(states[:, 2]).tolist()) == [-1.0, 1.0],
          f"find_stable_states on the card: {states}")
    check(all(np.max(states_cpu @ s) > 1 - 1e-3 for s in states)
          and len(states_cpu) == len(states), f"card {states} vs CPU {states_cpu}")
    dirs = torch.randn(4096, 3, generator=g, dtype=torch.float64)
    land_card = EnergyLandscape(params_from_dict(ANALYSIS_DEVICE, device=dev))
    land_cpu = EnergyLandscape(params_from_dict(ANALYSIS_DEVICE, device="cpu"))
    h_card = land_card.effective_field(dirs.to(dev), (1e4, 0.0, -2e4)).cpu()
    h_cpu = land_cpu.effective_field(dirs, (1e4, 0.0, -2e4))
    torch.testing.assert_close(h_card, h_cpu, rtol=1e-12, atol=1e-12 * float(h_cpu.abs().max()))
    land_err = float(((h_card - h_cpu).abs() / h_cpu.abs().max()).max())
    # The same minima as a set: grid points that tie to an ulp of sin/cos
    # may pick another neighbour.
    a, b = land_card.find_stable_states(91, 180), land_cpu.find_stable_states(91, 180)
    check(a.shape == b.shape and bool((np.max(a @ b.T, axis=1) > 0.999).all()),
          f"landscape minima differ: card {a}, CPU {b}")
    out["search"] = dict(ms=search_ms, states=states.tolist(), landscape_field_rel=land_err)
    print(f"find_stable_states (64 seeds, RK45 float32, 2 ns) on the card: {states.round(4)} "
          f"in {search_ms:.0f} ms, the CPU's set; EnergyLandscape effective field on 4096 "
          f"directions, card vs CPU float64: {land_err:.1e} of the largest  [{smi}]")

    # ---- config, checkpoints and purity on the card
    env = ConfigManager().make_env()
    check(env.device.type == "cuda" and env.batch_size == 4096, "ConfigManager.make_env")
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    acts = global_actions(4096, 6, seed=41).to(dev)
    state, _ = env.reset(seed=7)
    for a in acts[:2]:
        state, _ = env.step(state, a)
    save_env_state(os.path.join(work, "env.pt"), state)
    straight, resumed = state, load_env_state(os.path.join(work, "env.pt"), dev)
    for a in acts[2:]:
        straight, ts1 = env.step(straight, a)
        resumed, ts2 = env.step(resumed, a)
    check(torch.equal(straight.m, resumed.m) and torch.equal(ts1.obs, ts2.obs)
          and straight.counter == resumed.counter == 6, "a saved env state did not resume")
    trainer = PPOTrainer(SpinTorqueEnv(batch_size=4096, device=dev), PPOConfig())
    tstate, _ = trainer.train_step(trainer.init(3))
    save_train_state(os.path.join(work, "train.pt"), tstate)
    tstate, _ = trainer.train_step(tstate)
    again, _ = trainer.train_step(load_train_state(os.path.join(work, "train.pt"), trainer))
    check(all(torch.equal(a, b) for a, b in zip(tstate.network.parameters(),
                                                again.network.parameters())),
          "a saved train state did not resume bit for bit")
    pure = {}
    for name, env, action in (
        ("spin_torque", SpinTorqueEnv(batch_size=4096, device=dev,
                                      config=SpinTorqueEnvConfig(max_steps=2)), acts[0]),
        ("array", SpinTorqueArrayEnv(batch_size=4096, device=dev, config=ArrayEnvConfig(
            max_steps=2)), torch.stack([torch.arange(4096, device=dev) % 16.0, acts[0, :, 0],
                                        acts[0, :, 1]], -1)),
        ("racetrack", SkyrmionRacetrackEnv(batch_size=4096, device=dev, config=SkyrmionEnvConfig(
            max_steps=2)), torch.cat([1e11 * acts[0].repeat(1, 2) / 2e6,
                                      acts[0, :, 1:] / 2.5], -1)),
    ):
        state, _ = env.reset(seed=5)
        state, _ = env.step(state, action)
        (s1, t1), (s2, t2) = env.step(state, action), env.step(state, action)
        same = torch.equal(t1.obs, t2.obs) and torch.equal(t1.reward, t2.reward)
        for f in dataclasses.fields(s1):
            x, y = getattr(s1, f.name), getattr(s2, f.name)
            same &= torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        resets = int((t1.terminated | t1.truncated).sum())
        check(same and resets > 0, f"{name}: two steps of one state differ ({resets} resets)")
        pure[name] = resets
    out["checkpoint_purity"] = dict(purity_resets=pure)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"config, checkpoints, purity on the card: ConfigManager().make_env() B=4096 on cuda; "
          f"an env state saved at step 2 resumes bit for bit over 4 steps; a PPOConfig() "
          f"train state resumes bit for bit; two steps of one state equal bit for bit, thermal "
          f"and auto-reset on, with {pure} envs reset; analysis phase {out['seconds']:.1f} s  "
          f"[{smi}]")
    return out


def write_record():
    """Writes RECORD to build/chip_smoke.json (the card's record, which the
    serving endpoint's readiness reads)."""
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)


def shell_phase(dev, smi, main_rate):
    """The command line and the serving shell on the card, each item with
    its K1 launches counted from 0 and its wall ms: ``python -m
    spintorque_tpu_torch.cli info`` in a subprocess (the standalone entry);
    in this process ``benchmark`` at B=4096, ``train`` at B=4096 with the
    default PPO configuration for 3 updates and ``eval --model`` of its
    output over 200 steps, the default ``sweep`` (16 x 16 x 64 = 16,384
    trajectories) against a direct ``switching_probability_diagram`` call;
    the serving endpoint with its health checks refreshed on its thread;
    the coalescing ``PhysicsWorkerPool`` fed 4096 solves from 8 threads
    against one ``solve_batch``; ``ParallelBenchmark`` and
    ``ScalableEnvironmentManager``."""
    import contextlib
    import io
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from spintorque_tpu_torch import cli
    from spintorque_tpu_torch.deployment import ServingEndpoint
    from spintorque_tpu_torch.devices import make_device_params
    from spintorque_tpu_torch.envs import SpinTorqueEnv
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.physics.solver import params_from_dict
    from spintorque_tpu_torch.research import switching_probability_diagram
    from spintorque_tpu_torch.utils import (
        ParallelBenchmark,
        PhysicsWorkerPool,
        ScalableEnvironmentManager,
        parallel_map,
    )

    out = {}
    t_phase = time.perf_counter()
    counters = (ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES, ci.PULSE_SHARDED_LAUNCHES)
    kind = torch.cuda.get_device_name(0)

    def start():
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        return time.perf_counter()

    def stop(name, t0, want=None, **extra):
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k1, k6, k5 = (c.count for c in counters)
        check(k6 == 0 and k5 == 0, f"{name} launched K6 {k6} / K5 {k5} times")
        if want is not None:
            check(k1 == want, f"{name} launched K1 {k1} times, want {want}")
        out[name] = dict(ms=ms, k1_launches=k1, **extra)
        return out[name]

    def run_cli(argv):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli.main(argv)
        check(rc == 0, f"cli {argv} exited {rc}")
        return buf.getvalue()

    # ---- the standalone entry: a fresh process that imports no JAX
    t0 = start()
    proc = subprocess.run([sys.executable, "-m", "spintorque_tpu_torch.cli", "info"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and kind in proc.stdout,
          f"cli info exited {proc.returncode} without naming {kind}: {proc.stderr[-2000:]}")
    stop("info_subprocess", t0, want=0)

    # ---- benchmark: measure_env_throughput at B=4096, 16-step programs
    t0 = start()
    bench = json.loads(run_cli(["benchmark", "--batch-size", "4096"]).strip().splitlines()[-1])
    steps = (min(12, 2 * 5) + 5) * 16
    stop("benchmark", t0, want=steps, env_steps_per_s=bench["env_steps_per_s"])
    check(bench["backend"] == "cuda" and bench["devices"] == 1, f"benchmark: {bench}")

    # ---- train (3 updates of PPOConfig() at B=4096), then eval --model
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    policy_path = os.path.join(work, "policy.pt")
    t0 = start()
    text = run_cli(["train", "--batch-size", "4096", "--timesteps", str(3 * 16 * 4096),
                    "--output", policy_path, "--log-every", "1"])
    summary = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    stop("train", t0, want=3 * 16, steps_per_s=summary["steps_per_s"], loss=summary["loss"])
    check(summary["updates"] == 3 and os.path.isfile(policy_path), f"train: {summary}")
    t0 = start()
    stats = json.loads(run_cli(["eval", "--model", policy_path, "--batch-size", "4096",
                                "--episodes-steps", "200"]).strip().splitlines()[-1])
    stop("eval", t0, want=200, env_steps_per_s=stats["env_steps_per_s"])
    check(stats["steps"] == 4096 * 200 and all(np.isfinite(v) for v in stats.values()),
          f"eval: {stats}")

    # ---- sweep: the default grid, one K1 launch, bit for bit with a direct call
    sweep_path = os.path.join(work, "sweep.json")
    t0 = start()
    run_cli(["sweep", "--output", sweep_path])
    stop("sweep", t0, want=1)
    with open(sweep_path) as f:
        sweep = json.load(f)
    direct = switching_probability_diagram(
        make_device_params("stt_mram", None, dtype=torch.float32, device=dev).llgs(),
        np.linspace(-4e6, 0.0, 16), np.linspace(1e-10, 2e-9, 16), n_ensemble=64,
        temperature=300.0, seed=0)
    p_direct = direct["p_switch"].cpu().numpy()
    check(sweep["p_switch"] == np.where(np.isfinite(p_direct), p_direct.astype(object),
                                        None).tolist()
          and sweep["failed_fraction"] == direct["failed_fraction"].cpu().numpy().tolist(),
          "the CLI sweep differs from a direct switching_probability_diagram call")

    # ---- the serving endpoint on the card (build/chip_smoke.json written)
    ep = ServingEndpoint(host="127.0.0.1", port=0, refresh_interval=0.5)
    t0 = time.perf_counter()
    ep.start()  # the first refresh runs here, on this thread
    first_refresh_ms = (time.perf_counter() - t0) * 1e3
    t0 = start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{ep.port}{path}", timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        code, body = get("/healthz")
        check(code == 200 and json.loads(body)["status"] == "HEALTHY", f"/healthz {code} {body}")
        code, body = get("/readiness")
        ready = json.loads(body)
        check(code == 200 and ready["production_ready"]
              and ready["checks"]["performance_evidence"]["card"] == RECORD["card"],
              f"/readiness {code} {body[:2000]}")
        code, body = get("/metrics")
        check(code == 200 and b"spintorque_health_ok 1" in body, f"/metrics {code} {body}")
        code, body = get("/info")
        check(code == 200 and json.loads(body)["device"] == kind, f"/info {code} {body}")
        check(get("/no-such-path")[0] == 404, "an unknown path did not give 404")
        # Two refreshes end on the refresh thread: the second began after
        # the counters' reset, so its launches are the refresh thread's.
        deadline = time.monotonic() + 300
        for _ in range(2):
            last = ep.state.metric("spintorque_last_refresh_unixtime")
            while ep.state.metric("spintorque_last_refresh_unixtime") == last:
                check(time.monotonic() < deadline, "the refresh thread did not refresh")
                time.sleep(0.02)
    finally:
        ep.stop()
    serve = stop("serve", t0, first_refresh_ms=first_refresh_ms)
    check(serve["k1_launches"] >= 2, f"the refresh thread launched K1 {serve['k1_launches']} times")

    # ---- PhysicsWorkerPool: 4096 solves from 8 threads at its defaults
    rng = np.random.default_rng(5)
    m0 = rng.normal(size=(4096, 3)).astype(np.float32)
    m0 /= np.linalg.norm(m0, axis=-1, keepdims=True)
    spans = rng.uniform(1e-10, 2e-9, 4096).astype(np.float32)
    currents = rng.uniform(-1e11, 1e11, 4096).astype(np.float32)
    pool_params = params_from_dict(dict(volume=1e-24), device=dev)
    with PhysicsWorkerPool(pool_params) as ref:
        whole = ref.solve_batch(m0, spans, currents)
    t0 = start()
    with PhysicsWorkerPool(pool_params) as pool:
        futs = parallel_map(lambda i: pool.submit(m0[i], (0.0, float(spans[i])), currents[i]),
                            range(4096), max_workers=8)
        rows = np.stack([f.result(timeout=300) for f in futs])
        stats = pool.get_statistics()
    res = stop("worker_pool", t0, want=stats["batches"], batches=stats["batches"],
               mean_batch_size=stats["mean_batch_size"])
    check(np.array_equal(rows, whole), "coalesced solves differ from one solve_batch")
    check(stats["submitted"] == stats["solved"] == 4096, f"pool statistics {stats}")

    # ---- ParallelBenchmark and ScalableEnvironmentManager
    t0 = start()
    bench_out = ParallelBenchmark(pool_params, n_solves=256).run()
    stop("parallel_benchmark", t0, **bench_out)
    t0 = start()
    mgr = ScalableEnvironmentManager(lambda b: SpinTorqueEnv(batch_size=b, device=dev),
                                     initial_batch=1024, min_batch=1024, max_batch=16384,
                                     autoscale=False)
    chunks = [mgr.run_batch_steps(16, batch=b) for b in (1024, 4096, 16384)]
    stop("scalable_env", t0, want=3 * 17,
         env_steps_per_s={c["batch"]: c["env_steps_per_s"] for c in chunks})
    check(all(np.isfinite(c["mean_reward"]) for c in chunks), f"scalable env: {chunks}")

    out["seconds"] = time.perf_counter() - t_phase
    o = out
    print(f"shell: `python -m spintorque_tpu_torch.cli info` {o['info_subprocess']['ms']:.0f} ms "
          f"(names {kind}); benchmark B=4096 {o['benchmark']['env_steps_per_s']:.0f} "
          f"env-steps/s, K1 {o['benchmark']['k1_launches']} in {steps} steps (main path "
          f"{main_rate:.0f}); train 3 updates {o['train']['ms']:.0f} ms, "
          f"{o['train']['steps_per_s']:.0f} train env-steps/s, K1 {o['train']['k1_launches']}; "
          f"eval --model 200 steps {o['eval']['env_steps_per_s']:.0f} env-steps/s, K1 "
          f"{o['eval']['k1_launches']}; sweep 16x16x64 {o['sweep']['ms']:.0f} ms, K1 1, the "
          f"direct call's bits  [{smi}]")
    print(f"shell: serving endpoint first refresh {first_refresh_ms:.0f} ms, K1 "
          f"{serve['k1_launches']} from the refresh thread; worker pool 4096 solves from 8 "
          f"threads {res['ms']:.0f} ms in {res['batches']} K1 launches (mean batch "
          f"{res['mean_batch_size']:.1f}), solve_batch's bits; ParallelBenchmark 256 solves "
          f"batched {bench_out['batched_s'] * 1e3:.2f} ms, serial estimate "
          f"{bench_out['serial_estimate_s'] * 1e3:.1f} ms, coalesced "
          f"{bench_out['coalesced_queue_s'] * 1e3:.1f} ms; scalable env env-steps/s "
          f"{ {b: round(r) for b, r in o['scalable_env']['env_steps_per_s'].items()} }; "
          f"shell phase {out['seconds']:.1f} s  [{smi}]")
    return out


def main():
    import torch

    # ---------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    import numpy as np
    import torch.distributed as dist
    from scipy import integrate as sp_integrate
    from scipy import stats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spintorque_tpu_torch import convert
    from spintorque_tpu_torch.constants import KB_SOLVER, MU0
    from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
    from spintorque_tpu_torch.ops import _build
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.ops import op_chain as oc
    from spintorque_tpu_torch.parallel import initialize, make_mesh, random_policy, spawn_ranks
    from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams
    from spintorque_tpu_torch.physics import integrate_pulse_plain
    from spintorque_tpu_torch.research import parameter_ladder_sweep, switching_probability_diagram
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
          f"(nvcc, one per source in parallel, then one link: {lib.build_seconds:.1f} s)")
    report = _build.ptxas_report(lib.log)
    pulse_instances = {k: v for k, v in report.items() if "pulse_kernel" in k}
    spills = {k: (v["spill_stores"], v["spill_loads"]) for k, v in pulse_instances.items()
              if v["spill_stores"] or v["spill_loads"]}
    print(f"ptxas: {len(report)} kernels, registers per thread "
          f"{sorted({v['registers'] for v in report.values()})}; {len(pulse_instances)} "
          f"pulse_kernel instances, registers {sorted({v['registers'] for v in pulse_instances.values()})}, "
          f"spill bytes (stores, loads) {sum(a + b for a, b in spills.values())}")
    check(len(pulse_instances) == 28, f"ptxas reported {len(pulse_instances)} pulse_kernel instances")
    check(not spills, f"pulse_kernel instances spill: {spills}")
    RECORD["ptxas"] = report
    div6_bad, div6_payload = ci.check_div6()
    print(f"div6 vs IEEE x / 6.0f over all 2^32 float32 inputs: {div6_bad} differ in value, "
          f"{div6_payload} NaNs differ in payload")
    check(div6_bad == 0 and div6_payload == 0, "div6 differs from x / 6.0f")
    check(ci.cuda_kernel_available(), "probe failed")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev)
    probe_err = (ci.probe_add_one(x) - ci.probe_add_one_plain(x)).abs().max().item()
    check(probe_err == 0.0, f"probe disagrees with x + 1 by {probe_err}")
    # Per call, 100 back-to-back calls each, in turns (K2, add, add, K2):
    # the host's rate of launches, which the profiler's device times below
    # (section 9) split from the kernels' own time.
    k2_turns = [cuda_ms(lambda: ci.probe_add_one(x), 100)]
    add_turns = [cuda_ms(lambda: torch.add(x, 1.0), 100) for _ in range(2)]
    k2_turns.append(cuda_ms(lambda: ci.probe_add_one(x), 100))
    probe_ms, probe_library_ms = sum(k2_turns) / 2, sum(add_turns) / 2
    probe_plain_ms = cuda_ms(lambda: ci.probe_add_one_plain(x), 100)
    probe_bound = bound(x.numel(), 2 * 4 * x.numel())
    print(f"probe: ok, max_abs_err {probe_err}, in turns {[round(t, 5) for t in k2_turns]} ms "
          f"vs torch.add {[round(t, 5) for t in add_turns]} ms per call: K2 {probe_ms:.4f} ms, "
          f"torch.add {probe_library_ms:.4f} ms ({probe_ms / probe_library_ms:.2f}x); plain "
          f"{probe_plain_ms:.4f} ms, bound {probe_bound[0]:.6f} ms  [{smi}]")

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

    def same_bits(a, want):
        m, n_sub, failed = want
        return (all(torch.equal(x, y) for x, y in zip(a.m, m)) and torch.equal(a.n_substeps, n_sub)
                and torch.equal(a.failed, failed))

    def result(r):
        return r.m, r.n_substeps, r.failed

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

    # The ring's ragged cases, each bit for bit with the plain version, for
    # both record layouts (per_substep: one record per substep; per_stage:
    # three). Counts that the dt law cannot give (n = 0, 1) go through
    # launch_pulse, and their reference is the plain version on each group of
    # rows with that count (max_substeps = the count, env_offset = the
    # group's first row): each env's draws and integration are its own.
    ragged = []
    for noise in ("per_substep", "per_stage"):
        cfg = IntegratorConfig(method="rk4", max_substeps=512, thermal=True, rk4_noise=noise)
        m0, spans, cur = setup(100)
        ragged.append((noise, "B=100", same_bits(
            ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg, seed=5),
            result(integrate_pulse_plain(m0, spans, cur, params(), cfg, seed=5)))))
        m0, spans, cur = setup(32, lo=3e-10, hi=4e-10)
        groups = ((0, 30, 300), (30, 31, 1), (31, 32, 0))
        n_rows = torch.tensor([c for lo, hi, c in groups for _ in range(lo, hi)],
                              dtype=torch.int32, device=dev)
        got = ci.launch_pulse(m0, spans / n_rows.float(), n_rows, cur, params(), cfg, seed=5)
        parts = [integrate_pulse_plain(tuple(c[lo:hi] for c in m0), spans[lo:hi], cur[lo:hi],
                                       params(), cfg._replace(max_substeps=cap), seed=5,
                                       env_offset=lo) for lo, hi, cap in groups]
        ragged.append((noise, "n = 300 x 30, 1, 0 in one warp", same_bits(
            got, (tuple(torch.cat([r.m[k] for r in parts]) for k in range(3)),
                  torch.cat([r.n_substeps for r in parts]), torch.cat([r.failed for r in parts])))))
        m0, spans, cur = setup(64)
        zero = torch.zeros(64, dtype=torch.int32, device=dev)
        got = ci.launch_pulse(m0, spans / zero.float(), zero, cur, params(), cfg, seed=5)
        ragged.append((noise, "every n = 0", same_bits(
            got, (m0, zero, torch.zeros(64, dtype=torch.bool, device=dev)))))
        m0, _, cur = setup(96)
        n_odd = ci.PULSE_CHUNK * 13 + 1
        spans = torch.full((96,), (n_odd + 0.5) * 1e-12, device=dev)
        got = ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg, seed=5)
        check(int(got.n_substeps.min()) == int(got.n_substeps.max()) == n_odd, "n != 8k + 1")
        ragged.append((noise, f"n = {n_odd} (chunk x 13 + 1)", same_bits(
            got, result(integrate_pulse_plain(m0, spans, cur, params(), cfg, seed=5)))))
        m0, spans, cur = setup(256)
        ragged.append((noise, "K5, env_offset 4096", same_bits(
            ci.integrate_pulse_cuda(m0, spans, cur, params(), cfg, seed=5, env_offset=4096,
                                    sharded=True),
            result(integrate_pulse_plain(m0, spans, cur, params(), cfg, seed=5,
                                         env_offset=4096)))))
    for noise, label, ok in ragged:
        print(f"K1 thermal ring, {noise}, {label}: {'bit for bit' if ok else 'DIFFERS'}")
    check(all(ok for _, _, ok in ragged), "a ragged ring case differs from the plain version")
    RECORD["ragged_ring"] = ragged

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
    # The plain versions are timed at B=4096, thermal (14-28 s a call), and
    # their results held to the kernels' at the thermal tolerance: the only
    # comparison at the main path's spans and 5001 max substeps.
    main_cfg = SpinTorqueEnvConfig().integrator()
    p_main = dataclasses.replace(params(), plus_z=True)
    det_cfg = main_cfg._replace(thermal=False)
    timing = {}
    for B in (4096, 65536):
        m0, spans, cur = setup(B, lo=1e-12, hi=5e-9, cur=2e6)
        calls = {
            (kernel, label): (lambda cfg=cfg._replace(bf16_rhs=kernel == "K6"):
                              ci.integrate_pulse_cuda(m0, spans, cur, p_main, cfg, seed=5))
            for kernel in ("K1", "K6")
            for label, cfg in (("thermal", main_cfg), ("deterministic", det_cfg))
        }
        for fn in calls.values():
            fn()
        # In turns, forth and back, so that every call sees the same card state.
        times = {key: [] for key in calls}
        for key in [*calls, *reversed(list(calls))]:
            times[key].append(cuda_ms(calls[key], 3))
        for label in ("thermal", "deterministic"):
            k1_ms = sum(times[("K1", label)]) / 2
            k6_ms = sum(times[("K6", label)]) / 2
            row = dict(ms=k1_ms, bf16_ms=k6_ms)
            line = f"K1 {label} B={B} max_substeps={main_cfg.max_substeps}: kernel {k1_ms:.3f} ms"
            if B == 4096 and label == "thermal":
                cfg = main_cfg
                want, row["plain_ms"] = timed(
                    lambda: integrate_pulse_plain(m0, spans, cur, p_main, cfg, seed=5))
                got = calls[("K1", label)]()
                row["max_abs_err"] = compare(got, want, 1e-5)
                row["n_substeps"] = got.n_substeps
                want, row["bf16_plain_ms"] = timed(lambda: integrate_pulse_plain(
                    m0, spans, cur, p_main, cfg._replace(bf16_rhs=True), seed=5))
                row["bf16_max_abs_err"] = compare(calls[("K6", label)](), want, 1e-5)
                row["bound_ms"], row["bound_by"] = bound(*ci.pulse_work(got.n_substeps, cfg, True))
                line += (f", plain {row['plain_ms']:.1f} ms, max_abs_err "
                         f"{row['max_abs_err']:.3e}; K6 {k6_ms:.3f} ms, plain bf16 "
                         f"{row['bf16_plain_ms']:.1f} ms, max_abs_err "
                         f"{row['bf16_max_abs_err']:.3e}; bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']})")
            else:
                line += f"; K6 {k6_ms:.3f} ms"
            timing[f"{label}_B{B}"] = row
            print(f"{line}  [{smi}]")
        ratio = timing[f"thermal_B{B}"]["ms"] / timing[f"deterministic_B{B}"]["ms"]
        ratio16 = timing[f"thermal_B{B}"]["bf16_ms"] / timing[f"deterministic_B{B}"]["bf16_ms"]
        timing[f"thermal_over_deterministic_B{B}"] = dict(k1=ratio, k6=ratio16)
        print(f"K1 B={B}: thermal / deterministic {ratio:.3f} (in turns, "
              f"{[round(t, 3) for t in times[('K1', 'thermal')]]} / "
              f"{[round(t, 3) for t in times[('K1', 'deterministic')]]} ms); K6 {ratio16:.3f}  "
              f"[{smi}]")
    RECORD["k1_timing"] = {k: {kk: vv for kk, vv in v.items() if kk != "n_substeps"}
                           for k, v in timing.items()}

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

    # K2 and torch.add by the profiler's device time, in turns (K2, add, add,
    # K2), 100 calls per profile: the kernels' own time, apart from the host's
    # launch rate that the per-call times of section 2 measure.
    def device_ms_per_call(fn, calls=100):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        check(sum(e.count for e in kernels) == calls, f"{len(kernels)} kernels in {calls} calls")
        return sum(e.self_device_time_total for e in kernels) / calls / 1e3

    k2_dev = [device_ms_per_call(lambda: ci.probe_add_one(x))]
    add_dev = [device_ms_per_call(lambda: torch.add(x, 1.0)) for _ in range(2)]
    k2_dev.append(device_ms_per_call(lambda: ci.probe_add_one(x)))
    probe_device_ms, add_device_ms = sum(k2_dev) / 2, sum(add_dev) / 2
    print(f"probe device time per call, in turns: K2 {[round(t, 5) for t in k2_dev]} ms, "
          f"torch.add {[round(t, 5) for t in add_dev]} ms ({probe_device_ms / add_device_ms:.2f}x); "
          f"per call (section 2) K2 {probe_ms:.4f} ms, torch.add {probe_library_ms:.4f} ms  "
          f"[{smi}]")
    RECORD["probe"] = dict(per_call_ms=probe_ms, torch_add_per_call_ms=probe_library_ms,
                           device_ms=probe_device_ms, torch_add_device_ms=add_device_ms,
                           per_call_turns=dict(k2=k2_turns, add=add_turns),
                           device_turns=dict(k2=k2_dev, add=add_dev))

    # One float32 step, thermal off, on the card and on the CPU plain path.
    # Without auto-reset: the card's and the CPU's reset generators draw
    # different streams.
    cfg = SpinTorqueEnvConfig(include_thermal=False, autoreset=False)
    B = 1024
    action = torch.stack([2e6 * (2 * torch.rand(B, generator=gen) - 1),
                          1e-12 + 5e-9 * torch.rand(B, generator=gen)], -1)
    (card,), (cpu,) = card_vs_cpu(lambda d: SpinTorqueEnv(batch_size=B, config=cfg, device=d),
                                  convert.env_state_to_numpy, convert.env_state_from_numpy,
                                  [action], seed=21)
    obs_diff, rew_diff = max_diff(card[1].obs, cpu[1].obs), max_diff(card[1].reward, cpu[1].reward)
    print(f"one step card vs CPU plain path (B={B}, f32, thermal off): "
          f"obs max diff {obs_diff:.3e}, reward max diff {rew_diff:.3e}")
    check(obs_diff < 1e-4 and rew_diff < 1e-4, "card and CPU steps disagree")
    RECORD["card_vs_cpu_step"] = dict(obs=obs_diff, reward=rew_diff)

    # ------------- 10. K5 in one process: the main config cut into shards
    # B=4096 in four shards of 1024, each launched with env_offset = its
    # first row, against the unsharded K1 launch bit for bit (m, n, failed)
    # at the main path's spans (1 ps-5 ns, 5001 max substeps), thermal and
    # deterministic (+z, tilted, per-env); then against the same cut of the
    # plain version at spans of 50-300 ps (max_substeps 512).
    B, W = 4096, 4
    n = B // W

    def shards(m0, spans, cur, p, cfg, run, **kw):
        def cut(x, rows):
            per_env = x.ndim == 2 or (x.ndim == 1 and x.shape[0] == B)
            return x[rows].contiguous() if per_env else x

        out = []
        for r in range(W):
            rows = slice(r * n, (r + 1) * n)
            pr = dataclasses.replace(p, **{f.name: cut(getattr(p, f.name), rows)
                                           for f in dataclasses.fields(p) if f.name != "plus_z"})
            out.append(run(tuple(c[rows].contiguous() for c in m0), spans[rows].contiguous(),
                           cur[rows].contiguous(), pr, cfg, env_offset=r * n, **kw))
        return out

    def k5(*args, **kw):
        return ci.integrate_pulse_cuda(*args, sharded=True, **kw)

    def plain(*args, seed=None, env_offset=0):
        return integrate_pulse_plain(*args, seed=seed, env_offset=env_offset)

    k5_cases = []
    for label, p, cfg in (
        ("thermal +z", p_main, main_cfg),
        ("deterministic +z", p_main, main_cfg._replace(thermal=False)),
        ("deterministic tilted", params((0.6, 0.0, 0.8)), main_cfg._replace(thermal=False)),
        ("deterministic per-env", per_env_params(B), main_cfg._replace(thermal=False)),
    ):
        m0, spans, cur = setup(B, lo=1e-12, hi=5e-9, cur=2e6)
        ref = ci.integrate_pulse_cuda(m0, spans, cur, p, cfg, seed=17)
        for r, out in enumerate(shards(m0, spans, cur, p, cfg, k5, seed=17)):
            rows = slice(r * n, (r + 1) * n)
            check(all(torch.equal(a, b[rows]) for a, b in zip(out.m, ref.m))
                  and torch.equal(out.n_substeps, ref.n_substeps[rows])
                  and torch.equal(out.failed, ref.failed[rows]),
                  f"K5 shard {r} differs from the unsharded K1 launch ({label})")
        k5_cases.append(label)
        print(f"K5 {label} B={B} in {W} shards of {n}: bit for bit with the unsharded K1 launch")
    k5_err = 0.0
    for label, p, cfg, tol in (
        ("thermal +z", p_main, main_cfg._replace(max_substeps=512), 1e-5),
        ("deterministic +z", p_main, main_cfg._replace(max_substeps=512, thermal=False), 2e-6),
        ("deterministic tilted", params((0.6, 0.0, 0.8)),
         main_cfg._replace(max_substeps=512, thermal=False), 2e-6),
        ("deterministic per-env", per_env_params(B),
         main_cfg._replace(max_substeps=512, thermal=False), 2e-6),
    ):
        m0, spans, cur = setup(B)
        for a, b in zip(shards(m0, spans, cur, p, cfg, k5, seed=23),
                        shards(m0, spans, cur, p, cfg, plain, seed=23)):
            k5_err = max(k5_err, compare(a, b, tol))
        print(f"K5 {label} B={B} in {W} shards vs the sharded plain version: "
              f"max_abs_err {k5_err:.3e}")
    RECORD["k5_bitwise_cases"] = k5_cases

    # K1 at the per-rank batches of 4 and 2 cards and at one card's, and K5
    # on rank 1's shard of two, at the main config.
    m0, spans, cur = setup(4096, lo=1e-12, hi=5e-9, cur=2e6)
    k1_by_batch = {}
    for b in (1024, 2048, 4096):
        sub = tuple(c[:b].contiguous() for c in m0)
        k1_by_batch[b] = cuda_ms(lambda: ci.integrate_pulse_cuda(
            sub, spans[:b].contiguous(), cur[:b].contiguous(), p_main, main_cfg, seed=5), 5)
    shard = (tuple(c[2048:].contiguous() for c in m0), spans[2048:].contiguous(),
             cur[2048:].contiguous())

    def k5_shard():
        return ci.integrate_pulse_cuda(*shard, p_main, main_cfg, seed=5, env_offset=2048,
                                       sharded=True)

    k5_shard()
    k5_ms = cuda_ms(k5_shard, 5)
    want, k5_plain_ms = timed(lambda: integrate_pulse_plain(*shard, p_main, main_cfg, seed=5,
                                                            env_offset=2048))
    got = k5_shard()
    k5_n = got.n_substeps
    k5_main_err = compare(got, want, 1e-5)
    k5_err = max(k5_err, k5_main_err)
    RECORD["k5_max_abs_err"] = k5_err
    k5_bound = bound(*ci.pulse_work(got.n_substeps, main_cfg, True))
    print(f"K1 thermal main config: B=1024 {k1_by_batch[1024]:.3f} ms, B=2048 "
          f"{k1_by_batch[2048]:.3f} ms, B=4096 {k1_by_batch[4096]:.3f} ms; K5 on rank 1's "
          f"shard of 2 (B=2048, env_offset 2048) {k5_ms:.3f} ms, plain {k5_plain_ms:.1f} ms, "
          f"max_abs_err {k5_main_err:.3e}; bound {k5_bound[0]:.4f} ms  [{smi}]")
    RECORD["k1_ms_by_batch"] = k1_by_batch
    RECORD["k5_timing"] = dict(ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound[0],
                               max_abs_err=k5_main_err)

    # ---------------- 11. the data-parallel path: two ranks on one card
    # gloo (NCCL takes one rank per device), rendezvous by file:// under
    # build/; the library is built above, so the ranks only load it. The
    # one-process 16-step block at B=4096 is the reference.
    B, seed = 4096, 7
    actions = global_actions(B, 16, seed=8)
    ref_block = env_block(SpinTorqueEnv(batch_size=B), seed, actions)
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    ranks = spawn_ranks(data_parallel_rank, 2, args=(B, seed, actions), backend="gloo",
                        timeout=600.0, workdir=work)
    dp_wall = time.perf_counter() - t0
    for key in ("obs", "reward", "m"):
        got = torch.cat([r["block"][key] for r in sorted(ranks, key=lambda r: r["rank"])], dim=1)
        check(torch.equal(got, ref_block[key]),
              f"two-rank env block differs from one process in {key}")
    check(torch.equal(ranks[0]["params"], ranks[1]["params"]),
          "the two ranks hold different parameters after the train steps")
    for r in ranks:
        check(r["rows"] == B // 2 and r["world_size"] == 2 and r["backend"] == "gloo",
              f"rank layout: {r['rows']} rows, {r['world_size']} ranks, {r['backend']}")
        check(r["env_launches"] == [16, 0, 0],
              f"env block launched K5/K1/K6 {r['env_launches']} times, want [16, 0, 0]")
        check(r["train_launches"] == [32, 0, 0],
              f"2 train steps launched K5/K1/K6 {r['train_launches']} times, want [32, 0, 0]")
        check(all(np.isfinite(v) for v in r["metrics"].values()), f"non-finite metrics {r}")
    dp_launches = sum(r["env_launches"][0] + r["train_launches"][0] for r in ranks)
    r0 = ranks[0]
    print(f"data-parallel, two ranks sharing one card (gloo), global B=4096: 16-step env block "
          f"bit for bit with one process (obs, reward, m); 2 PPO train steps with PPOConfig(), "
          f"parameters equal on both ranks; K5 launched 16 + 32 times per rank; global "
          f"{r0['rates'][0]:.0f} train env-steps/s on two ranks sharing one card (not a "
          f"scaling number), rollout {r0['rollout_ms'][0]:.1f} ms, update "
          f"{r0['update_ms'][0]:.1f} ms; {dp_wall:.1f} s with spawning  [{smi}]")
    RECORD["two_ranks_one_card"] = dict(
        rates=[r["rates"] for r in ranks], rollout_ms=[r["rollout_ms"] for r in ranks],
        update_ms=[r["update_ms"] for r in ranks], metrics=r0["metrics"], wall_s=dp_wall,
        k5_launches=dp_launches)

    # One NCCL rank (world size 1) through the same calls, in this process.
    initialize(init_method="file://" + os.path.join(tempfile.mkdtemp(dir=work), "rendezvous"),
               world_size=1, rank=0, backend="nccl")
    try:
        mesh = make_mesh()
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        trainer = PPOTrainer(SpinTorqueEnv(batch_size=B, mesh=mesh), PPOConfig())
        for c in (ci.PULSE_SHARDED_LAUNCHES, ci.PULSE_LAUNCHES):
            c.reset()
        out = measure_train_throughput(trainer, warmup=1, steps=1)
        nccl_launches = (ci.PULSE_SHARDED_LAUNCHES.count, ci.PULSE_LAUNCHES.count)
    finally:
        dist.destroy_process_group()
    check(nccl_launches == (32, 0), f"NCCL trainer launched K5/K1 {nccl_launches}")
    check(all(np.isfinite(v) for v in out["metrics"].values()), "non-finite NCCL metrics")
    print(f"data-parallel, one NCCL rank (world size 1), B=4096: 2 train steps, K5 launched "
          f"{nccl_launches[0]} times; {out['rates'][0]:.0f} train env-steps/s, rollout "
          f"{out['rollout_ms'][0]:.1f} ms, update {out['update_ms'][0]:.1f} ms  [{smi}]")
    RECORD["nccl_world1"] = dict(rates=out["rates"], rollout_ms=out["rollout_ms"],
                                 update_ms=out["update_ms"], metrics=out["metrics"])
    dp_launches += nccl_launches[0]

    # ------------------------------------------ 12. sweeps at full width
    # The JAX package's sweep device (tests/unit/test_research_sweeps.py).
    sweep_p = params(damping=0.05, volume=1e-22)
    ci.PULSE_LAUNCHES.reset()
    t0 = time.perf_counter()
    currents, durations = np.linspace(-2e7, 2e7, 16), np.linspace(1e-10, 5e-9, 16)
    out = switching_probability_diagram(sweep_p, currents, durations, n_ensemble=256,
                                        temperature=300.0, seed=1)
    p_sw, failed_frac = out["p_switch"].cpu().numpy(), out["failed_fraction"].cpu().numpy()
    diagram_s = time.perf_counter() - t0
    valid = failed_frac < 1.0
    check(p_sw.shape == (16, 16) and out["final_mz"].shape == (65536,), "diagram shapes")
    check(bool(np.all((p_sw[valid] >= 0) & (p_sw[valid] <= 1)))
          and bool(np.all(np.isnan(p_sw[~valid]))), "p_switch outside [0, 1] or nan misplaced")
    check(bool(np.all(p_sw[0] > 0.9)), f"J=-2e7 does not switch: {p_sw[0]}")
    check(bool(torch.isfinite(out["final_mz"]).all()), "non-finite final m_z")
    # The JAX test's own grid and checks (:29-43).
    small = switching_probability_diagram(sweep_p, [-2e7, 0.0, 2e7], [2e-10, 1e-9],
                                          n_ensemble=16, temperature=300.0, max_substeps=1024,
                                          seed=1)["p_switch"].cpu().numpy()
    check(bool(np.all((small >= 0) & (small <= 1)) and np.all(small[0] > 0.9)
               and np.all(small[1] < 0.1) and np.all(small[2] < 0.1)),
          f"the JAX test's switching checks fail: {small}")
    ms, vol, temp = 800e3, 1e-24, 300.0
    k_ladder = 0.5 * MU0 * ms**2 + np.array([1.0, 3.0, 8.0, 20.0]) * KB_SOLVER * temp / vol
    t0 = time.perf_counter()
    ladder = parameter_ladder_sweep(params(damping=0.5, volume=vol),
                                    {"uniaxial_anisotropy": k_ladder}, current=0.0,
                                    duration=4e-9, n_ensemble=1024, temperature=temp, seed=5)
    p_lad = ladder["p_switch"].cpu().numpy()
    ladder_s = time.perf_counter() - t0
    check(p_lad[0] > 0.25 and p_lad[1] > p_lad[2] + 0.1 and p_lad[3] < 0.02
          and p_lad[0] > p_lad[1] > p_lad[2] >= p_lad[3],
          f"the Neel-Brown ladder is not monotone in Delta: {p_lad}")
    sweep_launches = ci.PULSE_LAUNCHES.count
    check(sweep_launches == 3, f"the sweeps launched K1 {sweep_launches} times, want 3")
    print(f"sweeps: switching diagram 16 x 16 x 256 = 65536 trajectories (heun, physical) in "
          f"{diagram_s * 1e3:.1f} ms wall, J=-2e7 row p >= {p_sw[0].min():.3f}, "
          f"{int((~valid).sum())} points all failed (|J| < 2e6: the reference's float32 "
          f"freeze); JAX test grid p {small.round(3).tolist()}; Neel-Brown ladder n_ensemble "
          f"1024 p {p_lad.round(4).tolist()} in {ladder_s * 1e3:.1f} ms wall; K1 launched "
          f"{sweep_launches} times  [{smi}]")
    RECORD["sweeps"] = dict(p_switch=p_sw.tolist(), failed_fraction=failed_frac.tolist(),
                            diagram_s=diagram_s, small=small.tolist(), ladder=p_lad.tolist(),
                            ladder_s=ladder_s)

    # ------------------------------------- 13. K7: per-op prices on the card
    oc.OP_CHAIN_LAUNCHES.reset()
    costs = oc.measure_op_costs()
    k7_launches = oc.OP_CHAIN_LAUNCHES.count
    check(k7_launches > 0, "measure_op_costs launched no chain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k7_err = 0.0
    for threads, block in ((1024, 1024), (sms * 2048, 256)):
        for op in oc.OPS:
            xk = oc.check_input(op, threads, device=dev)
            got = oc.op_chain(xk, op, oc.CHECK_STEPS, block)
            want = oc.op_chain_plain(xk, op, oc.CHECK_STEPS)
            torch.testing.assert_close(got, want, rtol=oc.CHECK_RTOL, atol=0.0,
                                       msg=lambda m, op=op: f"K7 {op}: {m}")
            k7_err = max(k7_err, float((got - want).abs().max()))
    xk = torch.ones(sms * 2048, dtype=torch.float32, device=dev)
    k7_ms = cuda_ms(lambda: oc.op_chain(xk, "base2", 20_000, 256), 5)
    k7_plain_ms = cuda_ms(lambda: oc.op_chain_plain(xk, "base2", 20_000), 1)
    # base2 is a plain FADD and a plain FMUL a step (--fmad=false).
    k7_bound = bound(xk.numel() * 20_000 * 2, 2 * 4 * xk.numel())
    for shape, key in (("latency, 1 block of 1024", "latency_ns"),
                       ("throughput, per 1024 lanes", "throughput_ns_per_1024")):
        print(f"K7 ns/op ({shape}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in costs[key].items()) + f"  [{smi}]")
    print(f"K7 base2 x 20000 steps on {xk.numel()} threads: {k7_ms:.3f} ms, plain "
          f"{k7_plain_ms:.1f} ms, bound {k7_bound[0]:.4f} ms; {k7_launches} launches, "
          f"max_abs_err {k7_err:.1e} (check inputs, {oc.CHECK_STEPS} steps)  [{smi}]")
    RECORD["op_costs"] = costs

    # Chain floors: the longest env's substeps times the dependent depth of
    # one substep (ops.cuda_integrator.pulse_chain_depth), priced at K7's
    # latencies measured above. The thermal floors price the fallback path,
    # which skips the normalization's division: at the main config nearly
    # every thermal substep's increment is non-finite (its float32 freeze),
    # and the shorter path's floor holds whatever the draw. The deterministic
    # floors price the finite path, which those substeps take.
    t_main = timing["thermal_B4096"]
    t_det = timing["deterministic_B4096"]
    lat = costs["latency_ns"]
    n_main = t_main["n_substeps"]
    k6_cfg, k6_det_cfg = main_cfg._replace(bf16_rhs=True), det_cfg._replace(bf16_rhs=True)
    floor_rows = {  # name: (config, fallback, substep counts, kernel ms)
        "K1": (main_cfg, True, n_main, t_main["ms"]),
        "K1 deterministic": (det_cfg, False, n_main, t_det["ms"]),
        "K6": (k6_cfg, True, n_main, t_main["bf16_ms"]),
        "K6 deterministic": (k6_det_cfg, False, n_main, t_det["bf16_ms"]),
        "K5": (main_cfg, True, k5_n, k5_ms),
    }
    floors = {}
    for name, (cfg, fallback, n, ms) in floor_rows.items():
        floors[name] = ci.pulse_chain_floor_ms(n, cfg, True, lat, fallback)
        d = ci.pulse_chain_depth(cfg, True, fallback)
        ns = sum(v * lat[k] for k, v in d.items() if v)
        print(f"{name} chain floor (max n {int(n.max())}): {floors[name]:.3f} ms = depth {d} "
              f"at {ns:.1f} ns a substep; kernel {ms:.3f} ms, {ms / floors[name]:.2f}x  [{smi}]")
    RECORD["chain_floor_ms"] = floors

    # ----------- 14. the device factory, and the envs of the Gymnasium ids
    RECORD["device_factory"] = device_factory_phase(dev, smi)
    RECORD["gym_ids"] = gym_id_phases(dev, smi, rates[len(rates) // 2])

    # ---------------------------------------------- 15. the analysis physics
    RECORD["analysis"] = analysis_phase(dev, smi)
    solver_launches = RECORD["analysis"]["solver"]["launches"][0]

    # ------------------------------------ 16. the command line and serving
    write_record()  # the serving endpoint's readiness evidence
    RECORD["shell"] = shell_phase(dev, smi, rates[len(rates) // 2])
    shell_launches = {k: v["k1_launches"] for k, v in RECORD["shell"].items()
                      if isinstance(v, dict)}

    pulse = "spintorque_tpu_torch/csrc/pulse_integrator.cu"
    kernels = [
        dict(name="llgs_pulse", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:283",
             launches=launches["llgs_pulse"] + solver_launches + sum(shell_launches.values()),
             launches_by_path=dict(env=launches["llgs_pulse"], solver=solver_launches,
                                   **{f"shell_{k}": v for k, v in shell_launches.items()}),
             max_abs_err=max(det_err, thermal_err, t_main["max_abs_err"],
                             *(r["max_abs_err"] for r in RECORD["analysis"]["solver"]["solves"])),
             ms=t_main["ms"], plain_ms=t_main["plain_ms"], bound_ms=t_main["bound_ms"],
             bound_by=t_main["bound_by"], library_ms=None, chain_floor_ms=floors["K1"],
             deterministic_ms=t_det["ms"],
             deterministic_chain_floor_ms=floors["K1 deterministic"]),
        dict(name="llgs_pulse_bf16", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:316",
             launches=launches["llgs_pulse_bf16"],
             max_abs_err=max(bf16_err, bf16_thermal_err, t_main["bf16_max_abs_err"]),
             ms=t_main["bf16_ms"], plain_ms=t_main["bf16_plain_ms"], bound_ms=t_main["bound_ms"],
             bound_by=t_main["bound_by"], library_ms=None, chain_floor_ms=floors["K6"],
             deterministic_ms=t_det["bf16_ms"],
             deterministic_chain_floor_ms=floors["K6 deterministic"]),
        dict(name="probe_add_one", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:118",
             launches=launches["probe_add_one"], max_abs_err=probe_err,
             ms=probe_ms, plain_ms=probe_plain_ms, bound_ms=probe_bound[0],
             bound_by=probe_bound[1], library_ms=probe_library_ms, chain_floor_ms=None,
             device_ms=probe_device_ms, library_device_ms=add_device_ms),
        dict(name="llgs_pulse_sharded", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:720",
             launches=dp_launches, max_abs_err=k5_err,
             ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound[0], bound_by=k5_bound[1],
             library_ms=None, chain_floor_ms=floors["K5"]),
        dict(name="op_chain", route="cuda", source="spintorque_tpu_torch/csrc/op_chain.cu",
             replaces="scripts/bench_vpu_op_costs.py:43",
             launches=k7_launches, max_abs_err=k7_err,
             ms=k7_ms, plain_ms=k7_plain_ms, bound_ms=k7_bound[0], bound_by=k7_bound[1],
             library_ms=None, chain_floor_ms=None),
    ]
    RECORD["kernels"] = kernels
    write_record()

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
