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
and ``ScalableEnvironmentManager`` at B=1024/4096/16384. Then the 'model'
mesh axis (``model_axis_phase``): two gloo ranks sharing the card on a
(data 1, model 2) mesh train ``PPOConfig()`` at global B=4096 for two
steps, each rank holding its half of the hidden layers; their env states
and gathered parameters equal bit for bit, step 1's update against a
world-size-1 trainer's on the card. Then the classical research tier
(``research_phase``): the cross-entropy, grid and annealing searches of the
switching pulse (one K1 launch per population), the switching objective
against its plain version on the CPU, the standard benchmark suite,
``compare_policies`` at B=4096, the validation checks in float32, the
optimal-control baseline (the plain loop under autograd: no kernel, its
loss and gradient against the CPU) and the comparative analysis's default
controllers one by one (the optimal-control one's energy must be finite).
Then the quantum tier (``quantum_phase``): the quantum benchmark suite at
its defaults, QAOA at 14 qubits against the CPU, a 20-qubit, depth-20
circuit at batch 64 (norms, and two states against the CPU by fidelity),
the hybrid paths onto K1 (the scheduler's B=4096 classical task bit for
bit with the plain loop, the hybrid simulator at 12 devices, the
surrogate optimizer over the switching objective at n_train 2048, the
QAOA device-design optimizer with its cross-entropy stage) and the quantum
validation checks. Then the six examples of ``examples/torch/``
(``examples_phase``: each ``main`` at its defaults with its wall time and
pulse launches; the Gymnasium quickstart only where gymnasium is
installed, else the phase says it skipped it), the soak (``soak_phase``:
``utils.soak`` for 60 s at B=4096, which must be healthy) and, last, the
programs beside the package (``scripts_phase``: bench, bench_integrator,
bench_roofline, bench_sort_overhead, bench_bf16, bench_ppo,
bench_stiff_solvers and verify_thermal of ``scripts/torch/`` through their
``main`` on the card, each of which must pass its own checks). Each
path's launch counts are set to 0 just before it and read just after.
Any failed check raises and exits non-zero.

Beside the kernels' checks it holds the pulse kernel's design: ptxas's
report shows no spill in any pulse_kernel instance; div6, the kernel's
replacement for RK4's IEEE x / 6.0f, equals it on all 2^32 float32 inputs;
K6's native bf16 ops (add, sub, mul over all 2^32 ordered pairs; neg and
the products by 0.5 and 2 over all 2^16 values) equal torch's bf16 ops, the
float op rounded once, bit for bit (``ops.cuda_integrator.check_bf16_ops``);
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
    op differs by more than 1e-3. base2_bf16, the Newton step in K6's
    native bf16 ops, is held to torch's bf16 chain the same way (its values
    are bf16, so the two agree to the bit or not at all);

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
  * the 'model' axis: the two ranks' env states and gathered parameters
    bit for bit; step 1's parameter update (gathered parameters less the
    initial ones, which equal one process's bit for bit) within 1% in L2
    norm of a world-size-1 trainer's from the same seed: the row-parallel
    sums round otherwise, and Adam's first step moves each parameter by
    about the learning rate whatever its gradient's size;
  * the research tier: the switching objective on the card against its
    plain version on the CPU at rtol = atol = 2e-6; the optimal-control
    loss and gradient on the card against the CPU at 1e-4 and 1e-3 of
    their largest magnitude (float32 physics through 600 substeps under
    autograd, eager on both);
  * the quantum tier: the 14-qubit QAOA grid of expectation values on the
    card against the CPU port within 1e-4 of its largest magnitude
    (float32 products summed in another order); the 20-qubit states' norms
    within 1e-4 of 1 and two of them against the CPU port by fidelity
    within 1e-4 (float32 through ~590 gates); the scheduler's classical
    task against the plain loop on the card bit for bit (max_abs_err 0);
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
element, K7's a plain FADD and FMUL a step. K6 runs most of its operations
(``pulse_bf16_ops_per_substep``) as native bf16 instructions, which are
priced at twice the float32 rate (the card's 133.8 TFLOP/s bf16 outside the
tensor cores, pairs of values in one instruction).
"""

import contextlib
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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def bound(ops, nbytes, bf16_ops=0):
    """(bound_ms, bound_by): the least time for ``ops`` instructions, of
    which ``bf16_ops`` bf16 at ``PEAK_BF16_INSTR`` per second and the rest
    float32 at ``PEAK_FP32_INSTR``, and ``nbytes`` bytes at the card's HBM
    rate (``utils.benchmark``'s peaks)."""
    from spintorque_tpu_torch.utils.benchmark import PEAK_BF16_INSTR, PEAK_BYTES, PEAK_FP32_INSTR

    t_ops = (ops - bf16_ops) / PEAK_FP32_INSTR + bf16_ops / PEAK_BF16_INSTR
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def pulse_bound(n_substeps, cfg):
    """``bound`` of a pulse call (K1, K5 or K6 as ``cfg`` says) over envs
    with these substep counts, from ``ops.cuda_integrator``'s counts."""
    import torch

    from spintorque_tpu_torch.ops import cuda_integrator as ci

    bf16_ops = int(n_substeps.to(torch.int64).sum()) * ci.pulse_bf16_ops_per_substep(cfg, True)
    return bound(*ci.pulse_work(n_substeps, cfg, True), bf16_ops)


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
    rows; this rank's on a mesh, all of them where the mesh replicates the
    batch). Returns the stacked obs, reward and m on the host."""
    import torch

    from spintorque_tpu_torch.parallel import local_rows

    state, _ = env.reset(seed)
    obs, rew, ms = [], [], []
    for a in actions:
        a = a if mesh is None else a[local_rows(a.shape[0], mesh)]
        state, ts = env.step(state, a.to(env.device))
        obs.append(ts.obs)
        rew.append(ts.reward)
        ms.append(state.m)
    return {k: torch.stack(v).cpu() for k, v in (("obs", obs), ("reward", rew), ("m", ms))}


def data_parallel_rank(batch, seed, actions, odd_batch, odd_actions):
    """One rank of the data-parallel phase: a 16-step env block and two PPO
    train steps (one timed) at global batch ``batch`` with the default
    configs, on this rank's rows; then a 16-step env block at ``odd_batch``,
    which does not divide the ranks, so every rank holds and steps all of
    it; launch counts read around each."""
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
    odd_env = SpinTorqueEnv(batch_size=odd_batch, mesh=mesh)
    for c in counters:
        c.reset()
    odd_block = env_block(odd_env, seed, odd_actions, mesh)
    torch.cuda.synchronize()
    odd_launches = [c.count for c in counters]
    return dict(block=block, env_launches=env_launches, train_launches=train_launches,
                odd_block=odd_block, odd_launches=odd_launches,
                odd_rows=(odd_env.local_batch_size, odd_env.replicated),
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


def bits(x):
    """The int32 bit patterns of a float32 tensor: -0 and +0 differ."""
    return x.contiguous().view(__import__("torch").int32)


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


# The subnormal cases of tests/test_torch_subnormal_parity.py: the pulse's
# subnormal test device, a current that destabilizes the -z pole, and one
# that weakly stabilizes it.
SUBNORMAL_DEVICE = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
                        uniaxial_anisotropy=8e5, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])
SUBNORMAL_CASES = (  # (name, span s, current A/m^2, transverse start)
    ("pole 0.25 ns", 2.5e-10, -2.7e-7, None),
    ("pole 5 ns", 5e-9, -2.7e-7, None),
    ("decay 0.25 ns", 2.5e-10, 2e-12, 1e-30),
)


@contextlib.contextmanager
def without_flush(module, op=lambda x: x):
    """The parent tree's code path in ``module``: its ``flush_subnormal``
    replaced by ``op`` (the op that stood there before the flush: a clone
    in the array env's sequential sweep, nothing elsewhere). For the
    before-and-after comparison of ``subnormal_phase`` only."""
    saved = module.flush_subnormal
    module.flush_subnormal = op
    try:
        yield
    finally:
        module.flush_subnormal = saved


def subnormal_phase(dev, smi, B=4096):
    """The plain-torch state loops on the card from float32 subnormal states,
    against the CPU port, and before and after their flush of subnormals.

    * ``integrate_adaptive`` (rk45, midpoint, radau) on B rows at the -z
      pole, each with its own subnormal transverse parts (log-uniform over
      float32's subnormals, either sign), over 0.25 and 5 ns of a
      destabilizing current; and from (1e-30, 1e-30, -1) under a weakly
      stabilizing one. Every row must end at exactly the pole (by
      magnitude, read from the bits), with success and the CPU port's
      accepted and rejected step counts for the case's single state, and
      the first 64 rows bit for bit (int32 bits, the sign of every zero
      included) with the CPU port on the same rows. Then ``AdaptiveLLGSSolver``
      (RK45) from the pole. The parent's path (no flush) runs the 0.25 ns
      pole case again, capped at 64 iterations, to show the fault on the
      card; the profiler counts the kernels of one chunk of 8 iterations of
      the decay case with and without the flush.
    * The array env, 4 x 4 at B in both coupling modes: rows of +z and -z
      devices with subnormal transverse parts, 20 'global' steps of +-2e6
      A/m^2. Every device must stay at its pole exactly, its pattern bit for
      bit with the CPU port's (int32 bits), and agree with it within 1e-5
      (observation, reward); the path without the flush shows the
      fault. Then ms and kernels per step of the main
      configuration (individual actions), parent's path and this one in
      turns (parent, this, this, parent), 16 steps each.
    * The racetrack (no flush: the CPU tests show none is needed): skyrmions
      90 radii off the pinning centerline (every exp(-dist / r) subnormal)
      with subnormal velocities, 6 steps, card against CPU within 1e-5;
      then ms and kernels per step of the main configuration.

    K1 is launched nowhere here: the loops are plain torch (checked)."""
    import numpy as np
    import torch

    from spintorque_tpu_torch import convert
    from spintorque_tpu_torch.envs import (
        ArrayEnvConfig,
        SkyrmionEnvConfig,
        SkyrmionRacetrackEnv,
        SpinTorqueArrayEnv,
    )
    from spintorque_tpu_torch.envs import array as array_module
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.physics import AdaptiveLLGSSolver, integrate_adaptive
    from spintorque_tpu_torch.physics import adaptive as adaptive_module
    from spintorque_tpu_torch.physics.solver import params_from_dict

    out = {}
    t_phase = time.perf_counter()
    ci.PULSE_LAUNCHES.reset()
    rng = np.random.default_rng(47)
    least = float(np.finfo(np.float32).smallest_subnormal)
    tiny = float(np.finfo(np.float32).tiny)

    def subnormals(shape):
        mag = np.exp(rng.uniform(np.log(least), np.log(tiny), shape))
        return torch.from_numpy(np.where(rng.random(shape) < 0.5, -mag, mag).astype(np.float32))

    def at_pole(m):
        """Every component exactly 0 or 1 by magnitude, read from its bits
        (sign bit masked): the pole, flushed."""
        mags = [bits(x) & 0x7FFFFFFF for x in m]
        one = int(bits(torch.ones(1))[0])
        return bool(((mags[0] == 0) & (mags[1] == 0) & (mags[2] == one)).all())

    # ---- the adaptive methods
    p_card = params_from_dict(SUBNORMAL_DEVICE, device=dev)
    p_cpu = params_from_dict(SUBNORMAL_DEVICE, device="cpu")
    rows = []
    for method in ("rk45", "midpoint", "radau"):
        for case, span, cur, start in SUBNORMAL_CASES:
            if start is None:
                m0 = (subnormals(B), subnormals(B), torch.full((B,), -1.0))
                one = (torch.tensor([1e-38]), torch.tensor([1e-38]), torch.tensor([-1.0]))
            else:
                m0 = tuple(torch.full((B,), v) for v in (start, start, -1.0))
                one = tuple(x[:1] for x in m0)
            args = (torch.full((B,), span, device=dev), torch.full((B,), cur, device=dev))
            kw = dict(max_steps=4000, method=method)
            want = integrate_adaptive(one, torch.tensor([span]), torch.tensor([cur]), p_cpu, **kw)
            card_m0 = tuple(x.to(dev) for x in m0)
            got, ms = timed(lambda: integrate_adaptive(card_m0, *args, p_card, **kw))
            steps, rejected = int(want.n_steps[0]), int(want.n_rejected[0])
            # The first 64 rows on the CPU, bit for bit with the card's, the
            # sign of every zero included.
            head = integrate_adaptive(tuple(x[:64] for x in m0), torch.full((64,), span),
                                      torch.full((64,), cur), p_cpu, **kw)
            check(all(torch.equal(bits(a[:64].cpu()), bits(b)) for a, b in zip(got.m, head.m)),
                  f"{method} {case}: the card's first 64 rows differ from the CPU's in bits")
            check(at_pole(want.m) and bool(want.success[0]),
                  f"{method} {case}: the CPU port left the pole: {want}")
            check(at_pole(got.m) and bool(got.success.all())
                  and bool((got.n_steps == steps).all())
                  and bool((got.n_rejected == rejected).all()),
                  f"{method} {case} on the card: pole {at_pole(got.m)}, steps "
                  f"{got.n_steps.unique().tolist()} vs the CPU's {steps}, rejected "
                  f"{got.n_rejected.unique().tolist()} vs {rejected}")
            row = dict(method=method, case=case, steps=steps, rejected=rejected, ms=ms,
                       iterations=got.iterations, host_reads=got.host_reads)
            if start is None and span < 1e-9:
                # Twice the iterations the flushed solve takes.
                with without_flush(adaptive_module):
                    before, before_ms = timed(lambda: integrate_adaptive(
                        card_m0, *args, p_card, **dict(kw, max_steps=64)))
                row["before"] = dict(
                    ms=before_ms, iterations=before.iterations,
                    steps=sorted(set(before.n_steps.tolist())),
                    success=float(before.success.float().mean()),
                    mz_range=[float(before.m[2].min()), float(before.m[2].max())],
                    transverse_max=float(torch.maximum(before.m[0].abs(),
                                                       before.m[1].abs()).max()))
            if start is not None:
                # One chunk of 8 iterations, the same iterations both ways.
                one_chunk = dict(kw, max_steps=8)
                k_after, _ = kernels_per_call(lambda: integrate_adaptive(
                    card_m0, *args, p_card, **one_chunk))
                with without_flush(adaptive_module):
                    k_before, _ = kernels_per_call(lambda: integrate_adaptive(
                        card_m0, *args, p_card, **one_chunk))
                row["kernels_8_iterations"] = dict(before=k_before, after=k_after)
            rows.append(row)
            b = row.get("before")
            k = row.get("kernels_8_iterations")
            print(f"integrate_adaptive {method} {case} B={B} float32 from subnormal states: "
                  f"{ms:.0f} ms, {got.iterations} iterations, every row at the pole with the "
                  f"CPU port's {steps} steps and {rejected} rejections"
                  + (f"; without the flush (the parent's path) {b['ms']:.0f} ms, "
                     f"{b['iterations']} iterations (at most 64), steps {b['steps'][:4]}, "
                     f"success {b['success']:.3f}, m_z {b['mz_range']}, |m_xy| up to "
                     f"{b['transverse_max']:.3g}" if b else "")
                  + (f"; CUDA kernels and copies of 8 iterations {k['before']} -> "
                     f"{k['after']}" if k else "") + f"  [{smi}]")
    solver = AdaptiveLLGSSolver(device=dev)
    m_pole = torch.stack([subnormals(B), subnormals(B), torch.full((B,), -1.0)], -1)
    res = solver.solve(m_pole, (0.0, 2.5e-10), SUBNORMAL_DEVICE, current=-2.7e-7)
    want = next(r for r in rows if r["method"] == "rk45" and r["case"] == "pole 0.25 ns")
    check(res["success"] and at_pole(res["m"].unbind(-1))
          and bool((res["n_steps"] == want["steps"]).all()),
          "AdaptiveLLGSSolver (RK45) on the card left the pole or took other steps")
    out["adaptive"] = rows

    # ---- the array env: the subnormal case, card against CPU, then timing
    out["array"] = {}
    for mode in ("sequential", "simultaneous"):
        cfg = ArrayEnvConfig(autoreset=False, action_mode="global", coupling_update=mode)
        n = cfg.n_devices
        rows_z = torch.where(torch.arange(n) // cfg.cols % 2 == 0, 1.0, -1.0)
        pattern = torch.cat([subnormals((B, n, 2)), rows_z.expand(B, n)[..., None]], -1)
        currents = torch.from_numpy(rng.choice([-2e6, 2e6], (20, B)).astype(np.float32))
        actions = torch.stack([torch.full_like(currents, 5e-9), currents], -1)
        finals = {}
        for side, device, flush in (("card", dev, True), ("cpu", "cpu", True),
                                    ("card before", dev, False)):
            env = SpinTorqueArrayEnv(batch_size=B, config=cfg, device=device)
            state, _ = env.reset(seed=3)
            state = dataclasses.replace(state, pattern=pattern.to(device))
            with (contextlib.nullcontext() if flush else without_flush(
                    array_module, torch.clone if mode == "sequential" else (lambda x: x))):
                for a in actions:
                    state, ts = env.step(state, a.to(device))
            finals[side] = (state.pattern.cpu(), ts.obs.cpu(), ts.reward.cpu())
        (p_card_, o_card, r_card), (p_cpu_, o_cpu, r_cpu) = finals["card"], finals["cpu"]
        check(at_pole(p_card_.unbind(-1)) and torch.equal(p_card_[..., 2].sign(),
                                                          pattern[..., 2].sign()),
              f"array {mode}: a subnormal pole device left its pole on the card")
        check(torch.equal(bits(p_card_), bits(p_cpu_)),
              f"array {mode} subnormal case: the card's pattern differs from the CPU's in bits")
        pattern_diff, obs_diff = max_diff(p_card_, p_cpu_), max_diff(o_card, o_cpu)
        check(pattern_diff < 1e-5 and obs_diff < 1e-5,
              f"array {mode} subnormal case: card vs CPU pattern {pattern_diff}, obs {obs_diff}")
        np.testing.assert_allclose(r_card.numpy(), r_cpu.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"array {mode} subnormal case: card vs CPU reward")
        left = float((finals["card before"][0][..., 2] - pattern[..., 2]).abs().max())
        out["array"][f"4x4 {mode} subnormal"] = dict(
            pattern_diff=pattern_diff, obs_diff=obs_diff, before_max_mz_change=left)
        print(f"SpinTorqueArray-v0 4x4 {mode} B={B}, +-z rows with subnormal transverse parts, "
              f"20 global steps of +-2e6 A/m^2: every device at its pole exactly; card vs CPU "
              f"pattern {pattern_diff:.1e}, obs {obs_diff:.1e}; without the flush (the "
              f"parent's path) m_z moved by up to {left:.3f}  [{smi}]")

    def individual_actions(cfg, n_steps):
        idx = rng.integers(0, cfg.n_devices, (n_steps, B))
        cur = rng.uniform(-cfg.max_current, cfg.max_current, (n_steps, B))
        dur = rng.uniform(1e-12, cfg.max_duration, (n_steps, B))
        return torch.from_numpy(np.stack([idx, cur, dur], -1).astype(np.float32)).to(dev)

    def step_cost(env, acts, state):
        env.step(state, acts[0])  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = state
        for a in acts:
            s = env.step(s, a)[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(acts)
        n_kernels, busy_ms = kernels_per_call(lambda: env.step(state, acts[0]))
        return dict(ms_per_step=ms, kernels_per_step=n_kernels, device_ms_per_step=busy_ms)

    for mode in ("sequential", "simultaneous"):
        cfg = ArrayEnvConfig(autoreset=False, coupling_update=mode)
        env = SpinTorqueArrayEnv(batch_size=B, config=cfg, device=dev)
        acts = individual_actions(cfg, 16)
        state, _ = env.reset(seed=8)
        parent_op = torch.clone if mode == "sequential" else (lambda x: x)
        turns = {"before": [], "after": []}
        for side in ("before", "after", "after", "before"):
            with (without_flush(array_module, parent_op) if side == "before"
                  else contextlib.nullcontext()):
                turns[side].append(step_cost(env, acts, state))
        rec = {side: dict(ms_per_step=[t["ms_per_step"] for t in ts],
                          kernels_per_step=ts[0]["kernels_per_step"],
                          device_ms_per_step=[t["device_ms_per_step"] for t in ts])
               for side, ts in turns.items()}
        out["array"][f"4x4 {mode}"] = rec
        print(f"SpinTorqueArray-v0 4x4 {mode} B={B} (individual actions, 16 steps; in turns "
              f"before, after, after, before): before the flush "
              f"{[round(x, 3) for x in rec['before']['ms_per_step']]} ms/step, "
              f"{rec['before']['kernels_per_step']} kernels a step; after "
              f"{[round(x, 3) for x in rec['after']['ms_per_step']]} ms/step, "
              f"{rec['after']['kernels_per_step']} kernels a step  [{smi}]")

    # ---- the racetrack: subnormal velocities far off the pinning sites
    width = 4e-6
    cfg = SkyrmionEnvConfig(autoreset=False, include_thermal=False, track_width=width,
                            n_skyrmions=2)
    r = cfg.skyrmion_radius
    x = torch.from_numpy(rng.uniform(r, cfg.track_length - r, (B, 2)).astype(np.float32))
    pos = torch.stack([x, torch.full_like(x, width / 2 + 90 * r)], -1)
    vel = subnormals((B, 2, 2))
    j = rng.uniform(-1e12, 1e12, (6, B, 2))
    j[:, : B // 2] = 0.0  # half the tracks undriven
    acts = np.concatenate([j, np.zeros((6, B, 2)), rng.uniform(1e-12, 2e-9, (6, B, 1))], -1)
    acts = torch.from_numpy(acts.astype(np.float32))
    finals = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        env = SkyrmionRacetrackEnv(batch_size=B, config=cfg, device=device)
        state, _ = env.reset(seed=3)
        state = dataclasses.replace(state, positions=pos.to(device), velocities=vel.to(device))
        for a in acts:
            state, ts = env.step(state, a.to(device))
        finals[side] = (state.positions.cpu(), state.velocities.cpu(), ts.reward.cpu())
    (pc, vc, rc), (pp, vp, rp) = finals["card"], finals["cpu"]
    pos_diff = max_diff(pc, pp) / cfg.track_length
    check(pos_diff < 1e-5 and torch.equal(pc[: B // 2], pos[: B // 2]),
          f"racetrack subnormal case: card vs CPU positions / L {pos_diff}, or an undriven "
          f"skyrmion moved")
    np.testing.assert_allclose(vc.numpy(), vp.numpy(), rtol=1e-5,
                               atol=1e-5 * float(vp.abs().max()),
                               err_msg="racetrack subnormal case: card vs CPU velocities")
    np.testing.assert_allclose(rc.numpy(), rp.numpy(), rtol=1e-5,
                               err_msg="racetrack subnormal case: card vs CPU reward")
    main_cfg = SkyrmionEnvConfig(autoreset=False)
    env = SkyrmionRacetrackEnv(batch_size=B, config=main_cfg, device=dev)
    state, _ = env.reset(seed=10)
    a = np.concatenate([rng.uniform(-main_cfg.max_current, main_cfg.max_current, (16, B, 2)),
                        rng.uniform(-main_cfg.max_gradient, main_cfg.max_gradient, (16, B, 2)),
                        rng.uniform(0.0, 2e-9, (16, B, 1))], -1)
    cost = step_cost(env, torch.from_numpy(a.astype(np.float32)).to(dev), state)
    out["racetrack"] = dict(subnormal_positions_over_length_diff=pos_diff, **cost)
    print(f"SkyrmionRacetrack-v0 B={B}, skyrmions 90 radii off the pinning sites with "
          f"subnormal velocities, 6 steps: card vs CPU positions / L {pos_diff:.1e}, undriven "
          f"skyrmions kept their bits; no flush added (before = after): "
          f"{cost['ms_per_step']:.3f} ms/step, {cost['kernels_per_step']} kernels a step "
          f"(pinning and thermal on, 16 steps)  [{smi}]")
    check(ci.PULSE_LAUNCHES.count == 0, "the subnormal phase launched K1")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"subnormal phase {out['seconds']:.1f} s  [{smi}]")
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


def model_axis_rank(batch, seed):
    """One rank of the 'model' axis phase: a (data 1, model 2) mesh, the
    PPO trainer at ``PPOConfig()`` on the global batch, two train steps from
    ``seed``, each its rollout and its update timed by CUDA events and the
    step by the host clock; launch and all-reduce counts read around each
    phase."""
    import torch

    from spintorque_tpu_torch.envs import SpinTorqueEnv
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.parallel import MODEL_ALL_REDUCES, make_mesh
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer

    counters = (ci.PULSE_SHARDED_LAUNCHES, ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES)
    mesh = make_mesh(n_data=1, n_model=2)
    trainer = PPOTrainer(SpinTorqueEnv(batch_size=batch, mesh=mesh), PPOConfig())
    ts = trainer.init(seed)
    out = dict(ranks=(mesh.data_rank, mesh.model_rank), backend=mesh.backend,
               shard=ts.network.trunks["actor"][0].weight.detach().cpu(),
               numel=sum(p.numel() for p in ts.network.parameters()),
               full0=ts.network.full_state_dict(), steps=[])
    out["full0"] = {k: v.cpu() for k, v in out["full0"].items()}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        MODEL_ALL_REDUCES.reset()
        t0 = time.perf_counter()
        events[0].record()
        ts, traj = trainer.collect(ts)
        events[1].record()
        torch.cuda.synchronize()
        rollout_reduces = MODEL_ALL_REDUCES.count
        MODEL_ALL_REDUCES.reset()
        metrics = trainer.update(ts, traj)
        events[2].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        update_reduces = MODEL_ALL_REDUCES.count
        out["steps"].append(dict(
            launches=[c.count for c in counters], rollout_all_reduces=rollout_reduces,
            update_all_reduces=update_reduces, wall_s=wall,
            rollout_ms=events[0].elapsed_time(events[1]),
            update_ms=events[1].elapsed_time(events[2]),
            rate=trainer.config.rollout_steps * batch / wall,
            metrics={k: float(v) for k, v in metrics.items()},
            m=ts.env_state.m.cpu(), obs=ts.obs.cpu(),
            full={k: v.cpu() for k, v in ts.network.full_state_dict().items()}))
    return out


def model_axis_phase(dev, smi):
    """The 'model' mesh axis on the card: two gloo ranks sharing it (NCCL
    takes one rank per device), a (data 1, model 2) mesh, ``PPOConfig()`` at
    global B=4096, two train steps from one seed. Each rank must hold a
    different half of ``actor_dense_0``, the ranks' env states and gathered
    parameters must be equal bit for bit, and the update of step 1 (the
    gathered parameters less the initial ones) must agree with a
    world-size-1 trainer's on the card from the same seed to 1% in L2 norm
    (the row-parallel sums round otherwise, and Adam's first step moves a
    parameter by about the learning rate whatever its gradient's size)."""
    import numpy as np
    import torch

    from spintorque_tpu_torch.envs import SpinTorqueEnv
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.parallel import spawn_ranks
    from spintorque_tpu_torch.rl import PPOConfig, PPOTrainer

    B, seed = 4096, 11
    work = os.path.join(ROOT, "build")
    t0 = time.perf_counter()
    ranks = spawn_ranks(model_axis_rank, 2, args=(B, seed), backend="gloo", timeout=600.0,
                        workdir=work)
    wall = time.perf_counter() - t0
    r0, r1 = sorted(ranks, key=lambda r: r["ranks"])
    check([r0["ranks"], r1["ranks"]] == [(0, 0), (0, 1)] and r0["backend"] == "gloo",
          f"mesh layout {r0['ranks']}, {r1['ranks']}, {r0['backend']}")
    full_numel = sum(v.numel() for v in r0["full0"].values())
    check(r0["shard"].shape == (128, 12) and not torch.equal(r0["shard"], r1["shard"])
          and torch.equal(torch.cat([r0["shard"], r1["shard"]]),
                          r0["full0"]["trunks.actor.0.weight"]),
          "the ranks do not hold the two halves of actor_dense_0")
    check(r0["numel"] == r1["numel"] < full_numel, f"{r0['numel']} of {full_numel} per rank")
    for s0, s1 in zip(r0["steps"], r1["steps"]):
        check(torch.equal(s0["m"], s1["m"]) and torch.equal(s0["obs"], s1["obs"]),
              "the model ranks' env states differ")
        check(all(torch.equal(v, s1["full"][k]) for k, v in s0["full"].items()),
              "the model ranks' gathered parameters differ")
        for s in (s0, s1):
            check(s["launches"] == [16, 0, 0],
                  f"a train step launched K5/K1/K6 {s['launches']} times, want [16, 0, 0]")
            check(all(np.isfinite(v) for v in s["metrics"].values()), f"metrics {s['metrics']}")

    # A world-size-1 trainer on the card from the same seed: step 1.
    trainer = PPOTrainer(SpinTorqueEnv(batch_size=B, device=dev), PPOConfig())
    ts = trainer.init(seed)
    init = {k: v.cpu() for k, v in ts.network.state_dict().items()}
    check(all(torch.equal(v, r0["full0"][k]) for k, v in init.items()),
          "the gathered initial parameters differ from one process's")
    ts, _ = trainer.train_step(ts)
    ref = {k: v.cpu() for k, v in ts.network.state_dict().items()}
    got = r0["steps"][0]["full"]
    d_ref = torch.cat([(ref[k] - init[k]).reshape(-1) for k in ref])
    d_got = torch.cat([(got[k] - init[k]).reshape(-1) for k in ref])
    rel = float(torch.linalg.vector_norm(d_got - d_ref) / torch.linalg.vector_norm(d_ref))
    max_abs = float((d_got - d_ref).abs().max())
    check(rel <= 1e-2, f"step 1's update differs from one process's by {rel:.3e} in L2")
    s = r0["steps"][1]
    cfg = PPOConfig()
    per_mb = (s["update_all_reduces"] - 2) / (cfg.num_epochs * cfg.num_minibatches)
    out = dict(wall_s=wall, rate=s["rate"], rollout_ms=s["rollout_ms"],
               update_ms=s["update_ms"], k5_launches_per_rank=[x["launches"][0] for x in
                                                               r0["steps"]],
               rollout_all_reduces=s["rollout_all_reduces"],
               update_all_reduces=s["update_all_reduces"], all_reduces_per_minibatch=per_mb,
               step1_rel_l2=rel, step1_max_abs=max_abs,
               rates=[x["rate"] for x in r0["steps"]],
               launches=sum(x["launches"][0] for r in (r0, r1) for x in r["steps"]))
    print(f"model axis, two gloo ranks sharing one card, mesh (data 1, model 2), PPOConfig(), "
          f"global B={B}: each rank holds {r0['numel']} of {full_numel} parameters (its half "
          f"of actor_dense_0); env states and gathered parameters equal bit for bit on both "
          f"ranks; step 1's update vs one process's: {rel:.3e} relative L2, max abs "
          f"{max_abs:.3e}; step 2: {s['rate']:.0f} train env-steps/s, rollout "
          f"{s['rollout_ms']:.1f} ms, update {s['update_ms']:.1f} ms (step 1: "
          f"{r0['steps'][0]['rate']:.0f}); K5 (K1 on the whole batch) "
          f"{out['k5_launches_per_rank']} per rank; 'model' all-reduces: rollout {s['rollout_all_reduces']}, update "
          f"{s['update_all_reduces']} ({per_mb:.0f} per minibatch step); {wall:.1f} s with "
          f"spawning  [{smi}]")
    return out


RESEARCH_DEVICE = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                       volume=1e-23, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])
# The JAX package's optimal-control test device (tests/unit/test_research_tier.py).
CONTROL_DEVICE = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.05,
                      uniaxial_anisotropy=4e5, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])


def research_phase(dev, smi):
    """The classical research tier on the card, each item with its K1
    launches counted from 0: ``optimize_switching_pulse`` by cross-entropy
    at its defaults (population 1024, 20 generations: 20 launches), and in
    the smooth current regime a 16 x 16 grid search (1) and simulated
    annealing of 256 chains x 100 (101); ``switching_objective`` on one
    population of that regime (pulses up to 2e-10 s) against its plain
    version on the CPU (2e-6);
    the standard benchmark suite; ``compare_policies`` at
    B=4096, ``ResearchValidationFramework`` in float32; one iteration of
    the optimal-control baseline at the JAX test's shape (3 segments of
    2e-10 s, 256 max substeps, 8 restarts: the plain loop under autograd,
    no kernel), its loss and gradient at one theta against the CPU (1e-4 of
    the largest loss, 1e-3 of the largest gradient component), its ms and
    CUDA kernels; and the comparative analysis's default controllers one
    by one on one task, the optimal-control one at 1 iteration (an
    iteration is ~9 s of eager launches; its 60 at 16 restarts would be
    minutes)."""
    import numpy as np
    import torch

    from spintorque_tpu_torch.envs import SpinTorqueEnv
    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.parallel import random_policy
    from spintorque_tpu_torch.physics import params_from_dict
    from spintorque_tpu_torch.research import (
        ComparativeAnalysis,
        OptimalControlBaseline,
        ResearchValidationFramework,
        compare_policies,
        create_standard_benchmark_suite,
        grid_search,
        optimize_switching_pulse,
        simulated_annealing,
        switching_objective,
    )

    out = {}
    t_phase = time.perf_counter()
    counters = (ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES, ci.PULSE_SHARDED_LAUNCHES)

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

    p = params_from_dict(RESEARCH_DEVICE, device=dev)
    # optimize_switching_pulse's default space (+-2e6 A/m^2) is flat for
    # this device: every pulse blows up in float32 and normalizes to +z,
    # in the JAX package too. The grid, the annealing and the card-vs-CPU
    # check search the smooth regime (~1e-5 A/m^2), where pulses switch or
    # not.
    space = {"current": (-2e-5, 2e-5), "duration": (1e-11, 2e-9)}
    objective = switching_objective(p)

    # ---- the optimizers: one K1 launch per objective call
    t0 = start()
    cem = optimize_switching_pulse(p)
    stop("cross_entropy", t0, want=20, best_value=cem.best_value, best=cem.best_params)
    t0 = start()
    grid = grid_search(objective, space, points_per_dim=16, device=dev)
    stop("grid_search", t0, want=1, best_value=grid.best_value)
    t0 = start()
    sa = simulated_annealing(objective, space, chains=256, iterations=100, device=dev)
    stop("simulated_annealing", t0, want=101, best_value=sa.best_value)
    for name, res in (("cross_entropy", cem), ("grid_search", grid), ("simulated_annealing", sa)):
        check(np.isfinite(res.best_value)
              and all(np.isfinite(v) for v in res.best_params.values()), f"{name}: {res}")

    # ---- the objective on one population: K1 against the plain version on
    # the CPU, over pulses of up to 2e-10 s (200 substeps), as the CPU tests
    # hold the plain version to JAX: two machines' float32 rounding drifts
    # apart over long switching pulses.
    g = torch.Generator().manual_seed(3)
    cand = {"current": -2e-5 + 4e-5 * torch.rand(1024, generator=g, dtype=torch.float64),
            "duration": 1e-11 + (2e-10 - 1e-11) * torch.rand(1024, generator=g,
                                                              dtype=torch.float64)}
    t0 = start()
    card, objective_ms = timed(lambda: objective({k: v.to(dev) for k, v in cand.items()}))
    stop("objective", t0, want=1, switched=float((card < 0.5).float().mean()))
    check(0.0 < out["objective"]["switched"] < 1.0,
          f"a population where {out['objective']['switched']} of the pulses switch")
    cpu_objective = switching_objective(params_from_dict(RESEARCH_DEVICE, device="cpu"))
    t0 = time.perf_counter()
    plain = cpu_objective(cand)
    plain_ms = (time.perf_counter() - t0) * 1e3
    objective_err = max_diff(card.cpu(), plain)
    torch.testing.assert_close(card.cpu(), plain, rtol=2e-6, atol=2e-6,
                               msg=lambda m: f"switching_objective card vs CPU: {m}")
    out["objective"].update(max_abs_err=objective_err, k1_ms=objective_ms, plain_ms=plain_ms)

    # ---- the standard benchmark suite and the policy comparison
    t0 = start()
    suite = create_standard_benchmark_suite().run()
    stop("suite", t0, want=4 + 2 * 4 * 32,
         **{k: v["value"] for k, v in suite["results"].items()})
    check(suite["backend"] == "cuda" and suite["card"] == smi, f"suite report {suite['card']}")
    env = SpinTorqueEnv(batch_size=4096, device=dev)

    def zero_policy(params, obs, generator):
        return torch.zeros((obs.shape[0], 2), dtype=obs.dtype, device=obs.device)

    t0 = start()
    cmp = compare_policies(env, {"random": random_policy(env), "zero": zero_policy}, horizon=100)
    stop("compare_policies", t0, want=200,
         mean_return={k: v["mean_return"] for k, v in cmp["policies"].items()},
         p_value=cmp["significance"]["random_vs_zero"]["p_value"])
    check(all(np.isfinite(v["mean_return"]) for v in cmp["policies"].values()), f"{cmp}")

    # ---- the validation checks in float32 through K1
    t0 = start()
    report = ResearchValidationFramework(device=dev).run_all()
    checks = {c["name"]: c for c in report["checks"]}
    validation = stop("validation", t0, checks=checks)
    order = checks["convergence_order"]
    check(all(c["passed"] for n, c in checks.items() if n != "convergence_order"),
          f"validation checks failed on the card: {checks}")
    check("error" not in order and np.isfinite(order["measured_order"]),
          f"the convergence-order check did not run: {order}")
    # norm 1, determinism 2 env steps, energy 1, convergence order 3, equilibrium 1
    check(validation["k1_launches"] == 8, f"validation launched K1 {validation['k1_launches']}")

    # ---- optimal control: the plain loop under autograd (no kernel)
    def control(device, max_substeps=256):
        return OptimalControlBaseline(params_from_dict(CONTROL_DEVICE, device=device),
                                      n_segments=3, segment_duration=2e-10,
                                      max_substeps=max_substeps)

    m0 = np.array([0.1, 0.0, 0.995], np.float32)
    m0 /= np.linalg.norm(m0)
    tgt = np.array([0.0, 0.0, -1.0], np.float32)
    theta = torch.tensor([[0.3, -0.8, 1.1]] * 8, dtype=torch.float64)

    def iteration(model, th):  # one Adam iteration's forward and backward
        th = th.clone().requires_grad_(True)
        losses = model.loss(model.max_current * torch.tanh(th), m0, tgt)
        (grad,) = torch.autograd.grad(losses.sum(), th)
        return losses.detach(), grad

    # The loop issues the same kernels every substep: profile iterations of
    # 10 and 20 substeps a segment and extrapolate the line to the 200 of
    # the real one (the profiler takes minutes over ~5e5 kernels).
    counts = {n: kernels_per_call(lambda n=n: iteration(control(dev, n), theta.to(dev)))
              for n in (10, 20)}
    per_substep = (counts[20][0] - counts[10][0]) / 10
    kernels = counts[10][0] + 190 * per_substep
    t0 = start()
    (loss, grad), iter_ms = timed(lambda: iteration(control(dev), theta.to(dev)))
    stop("control_iteration", t0, want=0)
    loss_cpu, grad_cpu = iteration(control("cpu"), theta)
    loss_err = float((loss.cpu() - loss_cpu).abs().max() / loss_cpu.abs().max())
    grad_err = float((grad.cpu() - grad_cpu).abs().max() / grad_cpu.abs().max())
    check(loss_err <= 1e-4 and grad_err <= 1e-3,
          f"optimal-control loss / gradient card vs CPU: {loss_err:.3e} / {grad_err:.3e}")
    check(bool(torch.isfinite(grad).all()), "a non-finite optimal-control gradient")
    out["control_iteration"].update(kernels=kernels, kernels_profiled=counts,
                                    loss_rel_err=loss_err, grad_rel_err=grad_err)

    # ---- the comparative analysis's default controllers, one by one
    analysis = ComparativeAnalysis(params_from_dict(
        dict(CONTROL_DEVICE, damping=0.01, uniaxial_anisotropy=8e5), device=dev))
    analysis.register_default_controllers()

    def optimal_control(task):  # the default controller at 1 of its 60 iterations
        res = OptimalControlBaseline(analysis.params, n_segments=3).optimize(
            *task, n_restarts=16, iterations=1)
        # The draw optimize starts from (the card's generator, seed 0), kept
        # so that a non-finite restart can be replayed on the CPU.
        theta0 = 0.5 * torch.randn((16, 3), dtype=torch.float64, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        return {"alignment": res["alignment"], "energy_J": res["energy_J"],
                "loss": res["loss"], "theta0": theta0.cpu().tolist()}

    analysis.register("optimal_control", optimal_control)
    task = analysis.default_tasks(1)[0]
    controllers = {}
    for name, controller in analysis.controllers.items():
        t0 = start()
        row = controller(task)
        controllers[name] = stop(f"controller_{name}", t0, **row)
        check(np.isfinite(row["alignment"]), f"controller {name}: {row}")
    check(np.isfinite(controllers["optimal_control"]["energy_J"]),
          f"the optimal-control controller's energy: {controllers['optimal_control']}")

    launches = {
        "research_objective": sum(out[k]["k1_launches"] for k in (
            "cross_entropy", "grid_search", "simulated_annealing", "objective",
            "controller_single_pulse_grid")),
        "research_suite": out["suite"]["k1_launches"],
        "research_validation": out["validation"]["k1_launches"],
        "compare_policies": out["compare_policies"]["k1_launches"],
    }
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    o = out
    print(f"research: cross-entropy (1024 x 20) best {cem.best_value:.4g} in "
          f"{o['cross_entropy']['ms']:.0f} ms, K1 20; grid 16 x 16 best {grid.best_value:.4g} in "
          f"{o['grid_search']['ms']:.0f} ms, K1 1; annealing 256 x 100 best {sa.best_value:.4g} "
          f"in {o['simulated_annealing']['ms']:.0f} ms, K1 101; switching_objective B=1024 "
          f"({o['objective']['switched']:.3f} of the pulses switch) K1 "
          f"{objective_ms:.3f} ms vs CPU plain {plain_ms:.0f} ms, max_abs_err "
          f"{objective_err:.3e}  [{smi}]")
    res = suite["results"]
    print(f"research: benchmark suite {res['solver_4096x1000']['value']:.0f} pulses/s "
          f"(B=4096 x 1000 rk4), env B=4096 {res['env_4096_thermal']['value']:.0f} thermal, "
          f"{res['env_4096_det']['value']:.0f} deterministic env-steps/s, K1 "
          f"{o['suite']['k1_launches']}; compare_policies B=4096 x 100 steps mean return "
          f"{ {k: round(v, 3) for k, v in o['compare_policies']['mean_return'].items()} }, K1 "
          f"{o['compare_policies']['k1_launches']}; validation (float32, K1 "
          f"{validation['k1_launches']}): "
          + ", ".join(f"{n} {'pass' if c['passed'] else 'FAIL'}" for n, c in checks.items())
          + f"; measured convergence order {order['measured_order']:.3f} (coarse error "
          f"{order['coarse_error']:.3e}, fine {order['fine_error']:.3e})  [{smi}]")
    print(f"research: optimal control (3 x 2e-10 s, 256 max substeps, 8 restarts): "
          f"{iter_ms:.0f} ms an iteration (forward and backward), ~{kernels:.0f} CUDA kernels "
          f"(profiled at 10 / 20 substeps a segment: {counts[10][0]} / {counts[20][0]} kernels, "
          f"{counts[10][1]:.1f} / {counts[20][1]:.1f} ms on the device), no K1; loss / gradient "
          f"vs CPU {loss_err:.1e} / {grad_err:.1e}; default controllers on one task: "
          + ", ".join(f"{n} alignment {c['alignment']:.4f} in {c['ms']:.0f} ms"
                      for n, c in controllers.items())
          + f" (optimal control at 1 iteration of 60); research phase {out['seconds']:.1f} s"
          f"  [{smi}]")
    return out


def quantum_phase(dev, smi):
    """The quantum tier on the card, each item with its K1 launches counted
    from 0: the quantum benchmark suite at its defaults (state vector 12
    qubits x depth 20 x batch 64, QAOA 10 variables x grid 24, surface code
    500,000 trials; no kernel); QAOA at 14 qubits, its grid of expectation
    values against the CPU port; a 20-qubit, depth-20 circuit at batch 64
    (512 MB a state batch, which ``AdaptiveResourceOptimizer`` marks
    feasible on this card): every norm within 1e-4 of 1, two of its states
    against the CPU by fidelity; the scheduler with a B=4096
    ``classical_llgs`` task (one K1 launch) bit for bit with the plain loop
    on the card; the hybrid simulator at 12 devices over 4 rounds (4);
    ``QuantumMLDeviceOptimizer`` over ``switching_objective`` at n_train =
    2048 (2: the training data and the re-rank);
    ``QuantumSpintronicOptimizer.optimize`` with a physics QUBO and the
    cross-entropy stage on ``switching_objective`` (1 + 10); the eager
    Adam loops at their defaults (the landscape's VQE, a QNN fit, QRL
    training, the surrogate's fit over the switching objective: 2), each
    timed, with its CUDA kernels and device ms a step from the profiler
    over 5 and 10 steps; and ``QuantumValidationFramework``, which must
    pass."""
    import numpy as np
    import torch

    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.physics import IntegratorConfig, integrate_pulse_plain
    from spintorque_tpu_torch.physics import params_from_dict
    from spintorque_tpu_torch.quantum import (
        AdaptiveResourceOptimizer,
        AdaptiveScheduler,
        HybridMultiDeviceSimulator,
        IterationFreeQAOA,
        QuantumCircuit,
        QuantumEnhancedEnergyLandscape,
        QuantumMLDeviceOptimizer,
        SimulationTask,
        SymmetryEnhancedVQE,
        create_standard_benchmark_suite,
    )
    from spintorque_tpu_torch.quantum import statevector as sv
    from spintorque_tpu_torch.research import (
        QuantumNeuralNetwork,
        QuantumReinforcementLearning,
        QuantumSpintronicOptimizer,
        QuantumValidationFramework,
        switching_objective,
    )

    out = {}
    t_phase = time.perf_counter()
    counters = (ci.PULSE_LAUNCHES, ci.PULSE_BF16_LAUNCHES, ci.PULSE_SHARDED_LAUNCHES)

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

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # ---- the quantum benchmark suite at its defaults
    t0 = start()
    suite = create_standard_benchmark_suite(device=dev).run()
    stop("suite", t0, want=0, **{k: v["value"] for k, v in suite["results"].items()})
    check(suite["backend"] == "cuda" and suite["card"] == smi, f"suite report {suite['card']}")

    # ---- QAOA at 14 qubits: the grid of 576 settings in one batch
    rng = np.random.default_rng(14)
    Q = np.triu(rng.normal(size=(14, 14)))
    t0 = start()
    qaoa = IterationFreeQAOA(max_qubits=14, device=dev)
    res = qaoa.optimize(Q)
    stop("qaoa_14", t0, want=0, best_value=res.best_value,
         approximation_ratio=qaoa.approximation_ratio(Q, res))
    cpu_qaoa = IterationFreeQAOA(max_qubits=14, device="cpu")
    cost = qaoa.qubo_cost_vector(Q, dev)
    values = qaoa.grid_values(cost, qaoa.angle_grid()).cpu()
    want = cpu_qaoa.grid_values(cost.cpu(), cpu_qaoa.angle_grid())
    qaoa_err = float((values - want).abs().max() / want.abs().max())
    check(qaoa_err < 1e-4, f"QAOA grid card vs CPU: {qaoa_err:.3e} of the largest value")
    out["qaoa_14"].update(grid_rel_err=qaoa_err, best_expectation=float(values.min()),
                          cpu_best_expectation=float(want.min()))

    # ---- a 20-qubit, depth-20 circuit at batch 64
    n, depth, batch = 20, 20, 64
    circ = QuantumCircuit(n)  # on the card: no device means the card
    for w in range(n):
        circ.ry(w, w)  # layer 0 reads one angle vector a state
    for d in range(1, depth):
        for w in range(n):
            circ.add("RY", w, float(rng.uniform(0, np.pi)))
        for w in range(d % 2, n - 1, 2):
            circ.cz(w, w + 1)
    task = SimulationTask("quantum_circuit", {"circuit": circ, "batch": batch})
    plan = AdaptiveResourceOptimizer(device=dev).recommend(task)
    check(plan["feasible"] and plan["batch"] == batch, f"the resource plan {plan}")
    angles = torch.tensor(rng.uniform(0, np.pi, size=(batch, n)), dtype=torch.float32)
    t0 = start()
    psi = circ.run(angles)  # host angles: the circuit moves them to the card
    check(psi.is_cuda, f"a circuit with no device ran on {psi.device}")
    big = stop("statevector_20q", t0, want=0, gates=len(circ.gates), batch=batch,
               state_batch_mb=psi.numel() * 4 / 2**20, plan=plan)
    norms = sv.probabilities(psi).sum(-1).cpu()
    norm_err = float((norms - 1).abs().max())
    check(norm_err < 1e-4, f"20-qubit norms off by {norm_err:.3e}")
    cpu_circ = QuantumCircuit(n, circ.gates, device="cpu")
    ref = cpu_circ.run(angles[:2])
    fid = sv.fidelity(psi[:2].cpu(), ref)
    fid_err = float((fid - 1).abs().max())
    check(fid_err < 1e-4, f"20-qubit states card vs CPU: fidelity off by {fid_err:.3e}")
    big.update(norm_err=norm_err, fidelity_err=fid_err)
    del psi

    # ---- the scheduler: a circuit task and a B=4096 classical_llgs task (K1)
    p = params_from_dict(RESEARCH_DEVICE, device=dev)
    m0 = torch.randn((4096, 3), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    m0 = (m0 / m0.norm(dim=-1, keepdim=True)).float()
    tasks = [SimulationTask("quantum_circuit", {"circuit": QuantumCircuit(12, device=dev).h(0)}),
             SimulationTask("classical_llgs", {"m0": m0.to(dev), "params": p, "span": 1e-9,
                                               "current": 200.0, "max_substeps": 2048})]
    t0 = start()
    done = AdaptiveScheduler(device=dev).submit(tasks)
    stop("scheduler", t0, want=1)
    got = next(t.result for t in done if t.kind == "classical_llgs")
    mg = m0.to(dev)
    cfg = IntegratorConfig(method="rk4", max_substeps=2048)
    plain = integrate_pulse_plain(tuple(mg[:, c].contiguous() for c in range(3)),
                                  torch.full((4096,), 1e-9, device=dev),
                                  torch.full((4096,), 200.0, device=dev), p, cfg)
    sched_err = max_diff(got.cpu(), torch.stack(plain.m, -1).cpu())
    check(sched_err == 0.0, f"the scheduler's K1 task vs the plain loop: {sched_err:.3e}")
    out["scheduler"]["max_abs_err"] = sched_err

    # ---- the hybrid simulator at 12 devices, 4 rounds: one K1 launch a round
    sim = HybridMultiDeviceSimulator(p, n_devices=12)
    hm0 = np.tile([0.1, 0.0, 0.995], (12, 1)).astype(np.float32)
    t0 = start()
    hyb = sim.run(hm0, currents=[200.0, -200.0, 200.0, -200.0], span=1e-10)
    stop("hybrid", t0, want=4, mean_alignment=hyb["info"][-1]["mean_alignment"])
    check(np.allclose(np.linalg.norm(hyb["final"], axis=-1), 1.0, atol=1e-5),
          f"hybrid norms {hyb['final']}")

    # ---- the surrogate optimizer over the switching objective (smooth regime)
    objective = switching_objective(p)
    space = {"current": (-2e-5, 2e-5), "duration": (1e-11, 2e-10)}
    t0 = start()
    sur = QuantumMLDeviceOptimizer(n_train=2048, device=dev).optimize(objective, space, seed=0)
    stop("surrogate", t0, want=2, best_value=sur.best_value, best=sur.best_params,
         final_fit_loss=float(sur.history[-1]))
    check(np.isfinite(sur.best_value) and sur.best_value < 1.0, f"surrogate: {sur}")

    # ---- the QAOA device-design optimizer: a physics QUBO over 6 polarity
    # bits (one K1 launch for its 22 probes), then CEM on the pulse (10)
    levels = torch.tensor([1e-6, 2e-6, 4e-6, 8e-6, 1.6e-5, -2e-5], dtype=torch.float64)

    def design_current(X):
        return (torch.as_tensor(np.asarray(X), dtype=torch.float64) * levels).sum(-1)

    def discrete_objective(X):
        cur = design_current(X).to(dev)
        return objective({"current": cur, "duration": torch.full_like(cur, 2e-10)})

    def continuous_objective(design, params):
        return objective(params) + 0.01 * float(design.sum())

    t0 = start()
    qso = QuantumSpintronicOptimizer(device=dev).optimize(
        discrete_objective, 6, continuous_objective, space)
    stop("spintronic_optimizer", t0, want=11, best_value=qso["best_value"],
         design=qso["design"].tolist(), discrete_best=qso["discrete"].best_value)
    check(np.isfinite(qso["best_value"]), f"spintronic optimizer: {qso}")

    # ---- the eager Adam loops at their defaults: ms, and CUDA kernels and
    # device ms a step from the profiler's difference of two short runs
    landscape = QuantumEnhancedEnergyLandscape(p)
    diag = landscape.diagonal_hamiltonian("uniaxial")
    X = rng.uniform(-1, 1, size=(48, 4)).astype(np.float32)
    y = np.sign(X[:, 0]).astype(np.float32)

    def sample_obs(generator, n):
        return 2.0 * torch.rand((n, 2), generator=generator, device=dev) - 1.0

    def reward_fn(obs, action):
        return 1.0 if action == int(obs[0] > 0) else 0.0

    loops = {  # name: (a run of n steps, the default n)
        "vqe": (lambda n: SymmetryEnhancedVQE(landscape.n_theta_qubits, iterations=n,
                                              device=dev).minimize_diagonal(diag), 300),
        "qnn_fit": (lambda n: QuantumNeuralNetwork(device=dev).fit(X, y, epochs=n), 100),
        "qrl_train": (lambda n: QuantumReinforcementLearning(2, 2, device=dev).train(
            sample_obs, reward_fn, episodes=n), 200),
        "surrogate_fit": (lambda n: QuantumMLDeviceOptimizer(
            n_train=2048, train_steps=n, refine_steps=0, device=dev).optimize(
            objective, space), 500),
    }
    for name, (run, steps) in loops.items():
        (k5, d5), (k10, d10) = (kernels_per_call(lambda n=n: run(n)) for n in (5, 10))
        t0 = start()
        run(steps)
        rec = stop(name, t0, want=2 if name == "surrogate_fit" else 0, steps=steps,
                   kernels_per_step=(k10 - k5) / 5, device_ms_per_step=(d10 - d5) / 5)
        rec["ms_per_step"] = rec["ms"] / steps

    # ---- the quantum tier's validation checks
    t0 = start()
    report = QuantumValidationFramework(device=dev).run_all()
    checks = {c["name"]: c for c in report["checks"]}
    stop("validation", t0, want=0, checks=checks)
    check(report["passed"], f"quantum validation failed on the card: {checks}")

    out["launches"] = {f"quantum_{k}": out[k]["k1_launches"]
                       for k in ("scheduler", "hybrid", "surrogate", "spintronic_optimizer",
                                 "surrogate_fit")}
    out["seconds"] = time.perf_counter() - t_phase
    o, res_ = out, suite["results"]
    print(f"quantum: suite state vector {res_['statevector']['value']:.0f} gate applications/s "
          f"(12 qubits x depth 20 x batch 64), QAOA {res_['qaoa']['value']:.0f} angle "
          f"evaluations/s (10 vars x grid 24), surface code {res_['surface_code']['value']:.0f} "
          f"decodes/s (500,000 trials); QAOA 14 qubits {o['qaoa_14']['ms']:.0f} ms, grid vs CPU "
          f"{qaoa_err:.1e}; 20 qubits x depth 20 x batch 64 ({big['gates']} gates, "
          f"{big['state_batch_mb']:.0f} MB) {big['ms']:.0f} ms, norm err {norm_err:.1e}, "
          f"fidelity err vs CPU {fid_err:.1e}  [{smi}]")
    print(f"quantum: scheduler B=4096 K1 {o['scheduler']['k1_launches']} in "
          f"{o['scheduler']['ms']:.0f} ms, max_abs_err vs plain {sched_err}; hybrid 12 devices x 4 "
          f"rounds K1 {o['hybrid']['k1_launches']} in {o['hybrid']['ms']:.0f} ms; surrogate "
          f"n_train 2048 best {sur.best_value:.4g} K1 {o['surrogate']['k1_launches']} in "
          f"{o['surrogate']['ms']:.0f} ms; spintronic optimizer best {qso['best_value']:.4g} K1 "
          f"{o['spintronic_optimizer']['k1_launches']} in {o['spintronic_optimizer']['ms']:.0f} ms; "
          f"validation " + ", ".join(f"{k} {'pass' if c['passed'] else 'FAIL'}"
                                     for k, c in checks.items())
          + f"; quantum phase {out['seconds']:.1f} s  [{smi}]")
    print("quantum: eager loops at their defaults: " + "; ".join(
        f"{k} {o[k]['steps']} steps {o[k]['ms']:.0f} ms ({o[k]['ms_per_step']:.2f} ms a step, "
        f"{o[k]['kernels_per_step']:.0f} CUDA kernels and {o[k]['device_ms_per_step']:.3f} "
        f"device ms a step)" for k in loops) + f"  [{smi}]")
    return out


EXAMPLES = ("quickstart_functional", "quickstart_gymnasium", "train_ppo", "switching_diagram",
            "optimize_pulse", "stiff_analysis")


def examples_phase(dev, smi):
    """Each example of ``examples/torch/`` through its ``main`` at its
    defaults on the card, with its wall time and the pulse launches counted
    from 0 around it: quickstart_functional (B=4096, 11 steps: 11 K1
    launches), train_ppo (40 updates of 8 steps at B=1024: 320),
    switching_diagram (16 x 16 x 64 trajectories on the single-process mesh
    of ``make_mesh()``: one launch, the sharded instance K5 at env offset
    0), optimize_pulse (population 512, 10 iterations: 10) and
    stiff_analysis (the plain adaptive loops: none). quickstart_gymnasium
    needs gymnasium; where it is missing the phase says so and does not
    count it as run (tests/test_torch_examples.py runs it on the CPU)."""
    import importlib.util
    import math

    import torch

    from spintorque_tpu_torch.ops import cuda_integrator as ci

    counters = dict(K1=ci.PULSE_LAUNCHES, K5=ci.PULSE_SHARDED_LAUNCHES, K6=ci.PULSE_BF16_LAUNCHES)
    want = dict(quickstart_functional=dict(K1=11, K5=0), train_ppo=dict(K1=320, K5=0),
                switching_diagram=dict(K1=0, K5=1), optimize_pulse=dict(K1=10, K5=0),
                stiff_analysis=dict(K1=0, K5=0))
    out = {}
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        if name == "quickstart_gymnasium" and importlib.util.find_spec("gymnasium") is None:
            out[name] = {"skipped": "gymnasium is not installed on this machine"}
            print(f"examples: {name} skipped, not run: gymnasium is not installed on this "
                  "machine (tests/test_torch_examples.py runs it on the CPU)")
            continue
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", os.path.join(ROOT, "examples", "torch", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        result = module.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        check(launches["K6"] == 0, f"example {name} launched K6")
        if name in want:
            check({k: launches[k] for k in ("K1", "K5")} == want[name],
                  f"example {name} launched {launches}, want {want[name]}")
        if name == "quickstart_functional":
            check(math.isfinite(result["mean_reward"]) and 0 <= result["success_rate"] <= 1,
                  f"quickstart_functional: {result}")
        elif name == "quickstart_gymnasium":
            check(math.isfinite(result["return"]), f"quickstart_gymnasium: {result}")
        elif name == "train_ppo":
            check(len(result["curve"]) == 21
                  and all(math.isfinite(c["mean_reward"]) for c in result["curve"]),
                  f"train_ppo: curve of {len(result['curve'])} entries")
        elif name == "switching_diagram":
            for p_row, f_row in zip(result["p_switch"], result["failed_fraction"]):
                for p, f in zip(p_row, f_row):
                    check(f == 1.0 if math.isnan(p) else 0.0 <= p <= 1.0,
                          f"switching_diagram: p {p} with failed fraction {f}")
        elif name == "optimize_pulse":
            check(math.isfinite(result["best_value"]), f"optimize_pulse: {result}")
        elif name == "stiff_analysis":
            check(result["rk45"]["success"] and result["radau"]["success"]
                  and result["max_diff"] < 1e-4, f"stiff_analysis: {result}")
        out[name] = dict(wall_s=wall, launches=launches,
                         result={k: v for k, v in result.items()
                                 if k not in ("p_switch", "failed_fraction", "curve")})
        print(f"examples: {name} {wall:.2f} s, pulse launches K1 {launches['K1']} / K5 "
              f"{launches['K5']}  [{smi}]")
    q, ppo = out["quickstart_functional"]["result"], out["train_ppo"]["result"]
    sd = out["switching_diagram"]["result"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"examples: quickstart_functional {q['env_steps_per_s']:.0f} env-steps/s at "
          f"B={q['batch']}; train_ppo {ppo['summary']['steps_per_s']:.0f} train env-steps/s at "
          f"B={ppo['batch']}, final success {ppo['summary']['success_rate']:.3f}; "
          f"switching_diagram {sd['trajectories_per_s']:.0f} "
          f"trajectories/s; examples phase {out['seconds']:.1f} s  [{smi}]")
    return out


def soak_phase(dev, smi, seconds=60.0):
    """The soak program (``python -m spintorque_tpu_torch.utils.soak``)
    through its ``main`` for ``seconds`` at B=4096 with the default env
    configuration: it must exit 0 (no bad block, mean failed-solve
    fraction under 5%), and every step of its blocks, the 6 warm-up blocks
    included, launches K1 once."""
    import torch

    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.utils import soak

    path = os.path.join(ROOT, "build", "soak.json")
    torch.cuda.synchronize()
    for c in (ci.PULSE_LAUNCHES, ci.PULSE_SHARDED_LAUNCHES, ci.PULSE_BF16_LAUNCHES):
        c.reset()
    t0 = time.perf_counter()
    rc = soak.main(["--seconds", str(seconds), "--out", path])
    wall = time.perf_counter() - t0
    with open(path) as fh:
        rec = json.load(fh)
    k1 = ci.PULSE_LAUNCHES.count
    check(rc == 0 and rec["healthy"], f"soak unhealthy (exit {rc}): {rec}")
    check(k1 == (6 + rec["blocks"]) * soak.N_INNER, f"soak launched K1 {k1} times in "
          f"{rec['blocks']} blocks")
    check(ci.PULSE_SHARDED_LAUNCHES.count == 0 and ci.PULSE_BF16_LAUNCHES.count == 0,
          "soak launched K5 or K6")
    rec.update(k1_launches=k1, command_s=wall)
    print(f"soak: {rec['wall_s']:.1f} s at B={rec['batch']}: {rec['env_steps_per_s']:.0f} "
          f"env-steps/s, failed-solve fraction mean {rec['failed_solve_fraction_mean']:.6f} "
          f"(max {rec['failed_solve_fraction_max']:.6f}), {rec['episodes_terminated']} "
          f"terminated / {rec['episodes_truncated']} truncated episodes, {rec['bad_blocks']} "
          f"bad blocks, K1 {k1}; healthy  [{smi}]")
    return rec


SCRIPTS = ("bench", "bench_integrator", "bench_roofline", "bench_sort_overhead", "bench_bf16",
           "bench_ppo", "bench_stiff_solvers", "verify_thermal")
# The programs' small-size options that keep the phase near two minutes:
# one timed call of the plain loop a row (~3 s a call at 1000 substeps),
# and the stiff ladder at one rtol against a Radau reference at 1e-8
# (~900 adaptive steps at ~10-20 ms each on the card).
SCRIPT_ARGS = {"bench_integrator": ["--plain-iters", "1"],
               "bench_stiff_solvers": ["--rtols", "1e-6", "--ref-rtol", "1e-8"]}


def scripts_phase(dev, smi):
    """The programs beside the package (``scripts/torch/``, programs 2-9 of
    the port's table) through their ``main`` on the card, with the options
    of ``SCRIPT_ARGS``, each with its wall time and the K1, K2, K5, K6 and
    K7 launches counted from 0 around it, which must equal what the
    program's settings launch: bench 3 fresh envs x (12 + 3 x 8) programs
    x 16 steps of K1 and the probe K2 once (as in a fresh process);
    bench_integrator 2 x (1 + 30) + 2 x (1 + 10) K1; bench_roofline 2 x
    ((1 + 12 + 20) x 2 + 1 + 12 + 10) K1 and its profiled calls (5 a
    point, or 10 or 15 where a profile missed a launch) and
    ``measure_op_costs``' 2 x 9 x (1 + 2 x 3) = 126 K7;
    bench_sort_overhead 2 x (12 + 20) K1; bench_bf16 2 x 3 x 32 + 1 each
    of K1 and K6; bench_ppo (3 x (10 + 2 x 8) + 10 + 8 + 1) x 16 K1; the
    stiff ladder none (plain adaptive loops);
    verify_thermal one. The run fails on a program's own failure (``ok``
    false, its exit code 1: a verify_thermal check failed,
    bench_integrator's deterministic |plain - kernel| is over 2e-6,
    bench_ppo's identity misses or its ablation moved the network, a stiff
    solve failed)."""
    import importlib.util

    import torch

    from spintorque_tpu_torch.ops import cuda_integrator as ci
    from spintorque_tpu_torch.ops import op_chain as oc

    counters = dict(K1=ci.PULSE_LAUNCHES, K2=ci.PROBE_LAUNCHES, K5=ci.PULSE_SHARDED_LAUNCHES,
                    K6=ci.PULSE_BF16_LAUNCHES, K7=oc.OP_CHAIN_LAUNCHES)
    want = dict(
        bench=dict(K1=3 * (12 + 3 * 8) * 16, K2=1),
        bench_integrator=dict(K1=2 * (1 + 30) + 2 * (1 + 10)),
        bench_roofline=dict(K1=2 * ((1 + 12 + 20) * 2 + 1 + 12 + 10),
                            K7=2 * len(oc.OPS) * (1 + 2 * oc.REPS)),
        bench_sort_overhead=dict(K1=2 * (12 + 20)),
        bench_bf16=dict(K1=2 * 3 * 32 + 1, K6=2 * 3 * 32 + 1),
        bench_ppo=dict(K1=(3 * (10 + 2 * 8) + 10 + 8 + 1) * 16),
        bench_stiff_solvers=dict(),
        verify_thermal=dict(K1=1),
    )
    out = {}
    t_phase = time.perf_counter()
    for name in SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            f"torch_script_{name}", os.path.join(ROOT, "scripts", "torch", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        if name == "bench":
            ci.forget_probe()  # bench probes the library as a fresh process does
        t0 = time.perf_counter()
        rec = module.main(SCRIPT_ARGS.get(name, []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        expected = {k: want[name].get(k, 0) for k in counters}
        if name == "bench_roofline":  # its profiled calls, a profile again where one missed
            expected["K1"] += sum(r["kernel_profiled_calls"] for r in rec["results"].values())
        check(launches == expected, f"{name} launched {launches}, want {expected}")
        check(rec["ok"], f"{name} failed: {rec}")
        check(rec.get("backend", rec.get("platform")) == "cuda", f"{name} did not run on the card")
        out[name] = dict(wall_s=wall, launches=launches, args=SCRIPT_ARGS.get(name, []),
                         record=rec)
        print(f"scripts: {name} {wall:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }  [{smi}]")
    b, bi = out["bench"]["record"], out["bench_integrator"]["record"]
    rf, so = out["bench_roofline"]["record"]["results"], out["bench_sort_overhead"]["record"]
    bf, pp = out["bench_bf16"]["record"], out["bench_ppo"]["record"]
    st, vt = out["bench_stiff_solvers"]["record"], out["verify_thermal"]["record"]
    print(f"scripts: bench {b['value']:.1f} {b['unit']} (fresh envs "
          f"{[round(r, 1) for r in b['per_compile_medians']]}), vs_baseline "
          f"{b['vs_baseline']:.1f}  [{smi}]")
    res = bi["results"]
    print(f"scripts: bench_integrator B={bi['batch']} {bi['substeps']} substeps: plain det "
          f"{res['plain_det_rk4']['ms_per_batch']:.1f} ms, kernel det "
          f"{res['kernel_det_rk4']['ms_per_batch']:.4f} ms, plain thermal "
          f"{res['plain_thermal_rk4']['ms_per_batch']:.1f} ms, kernel thermal "
          f"{res['kernel_thermal_rk4']['ms_per_batch']:.4f} ms; max |plain - kernel| "
          f"deterministic {bi['max_abs_diff_deterministic']:.3e}; kernel thermal "
          + ", ".join(f"B={k} {v['ms_per_batch']:.4f} ms"
                      for k, v in bi["kernel_thermal_large"].items()) + f"  [{smi}]")
    for label, r in rf.items():
        print(f"scripts: bench_roofline {label}: marginal "
              f"{r['us_per_substep_batch_marginal']:.4f} us/substep-batch (chain floor "
              f"{r['chain_floor_us_per_substep']:.4f}, {r['marginal_over_chain_floor']:.2f}x), "
              f"fixed {r['fixed_call_overhead_ms']:.4f} ms/call; the kernel alone "
              f"{r['kernel_ms_per_pulse_batch']} ms, marginal "
              f"{r['kernel_us_per_substep_batch_marginal']} us/substep-batch "
              f"({r['kernel_marginal_over_chain_floor']}x) + {r['kernel_fixed_ms']} ms; "
              f"{100 * r['marginal_fp32_utilization']:.2f}% of the fp32 instruction rate at the "
              f"margin, substeps {r['substeps_run']}  [{smi}]")
    print(f"scripts: bench_sort_overhead (a) {so['sorted_random_ms']:.4f} ms, (c) "
          f"{so['uniform_ms']:.4f} ms, (a)-(c) {so['sort_overhead_ms']:.4f} ms, argsort "
          f"{so['argsort_ms']:.4f} ms  [{smi}]")
    acc = bf["accuracy_det_bf16_vs_f32"]
    print(f"scripts: bench_bf16 best ms " + ", ".join(
        f"{k} {min(v['ms_per_pulse_batch_trials']):.4f}" for k, v in bf["results"].items())
        + f"; thermal speedup {bf['thermal_speedup_bf16_over_f32']:.4f}; angle mean "
        f"{acc['mean_angular_error_deg']:.5f} p99 {acc['p99_angular_error_deg']:.5f} max "
        f"{acc['max_angular_error_deg']:.5f} deg  [{smi}]")
    ph = pp["phases_in_situ_ms"]
    print(f"scripts: bench_ppo train_step {pp['train_step_ms']:.3f} ms = env "
          f"{ph['env_steps']:.3f} + policy {ph['policy_marginal']:.3f} + update "
          f"{ph['update_marginal']:.3f} (identity rel err {pp['identity_rel_err']:.1e}); "
          f"rollout-only {pp['rollout_ms']:.3f}, update-only "
          f"{pp['update_only_isolated_ms']:.3f} ms  [{smi}]")
    print("scripts: bench_stiff_solvers " + ", ".join(
        f"{e['method']} rtol {e['rtol']:g} {e['accepted_steps']}+{e['rejected_steps']} steps "
        f"err {e['true_error']:.3e} ({e['wall_s']:.2f} s)" for e in st["ladder"])
        + f"; {st['case']['reference']}  [{smi}]")
    print(f"scripts: verify_thermal ok {vt['ok']}, tilt std "
          f"{vt['thermal_tilt_std']:.5f}, x/y {vt['std_ratio_x_over_y']:.4f}  [{smi}]")
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = {k: sum(v["launches"][k] for v in out.values() if isinstance(v, dict)
                              and "launches" in v) for k in counters}
    print(f"scripts: phase {out['seconds']:.1f} s, launches {out['launches']}  [{smi}]")
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
    # K6 computes every op of ci.BF16_OPS natively: each must equal torch's
    # bf16 op on every input. The control (a fused multiply-add against
    # torch's two roundings) must differ: it shows the check can fail.
    t0 = time.perf_counter()
    bf16_ops = ci.check_bf16_ops()
    print(f"K6's native bf16 ops vs torch's (float op, one rounding) over all 2^32 pairs (add, "
          f"sub, mul, control fma) and 2^16 values (neg, x0.5, x2) in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{op} {bad} mismatches" + (f" (first {first})" if first else "")
                      for op, (bad, first) in bf16_ops.items()))
    check(all(bf16_ops[op][0] == 0 for op in ci.BF16_OPS),
          f"a native bf16 op of K6 differs from torch's: {bf16_ops}")
    check(bf16_ops[ci.BF16_CONTROL][0] > 0,
          f"the bf16 check found its control equal to torch's form: {bf16_ops}")
    RECORD["bf16_ops"] = {op: dict(mismatches=bad, first=first)
                          for op, (bad, first) in bf16_ops.items()}
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
        return (all(torch.equal(bits(x), bits(y)) for x, y in zip(a.m, m))
                and torch.equal(a.n_substeps, n_sub) and torch.equal(a.failed, failed))

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
                got16 = calls[("K6", label)]()
                row["bf16_max_abs_err"] = compare(got16, want, 1e-5)
                row["bound_ms"], row["bound_by"] = pulse_bound(got.n_substeps, cfg)
                row["bf16_bound_ms"], row["bf16_bound_by"] = pulse_bound(
                    got16.n_substeps, cfg._replace(bf16_rhs=True))
                line += (f", plain {row['plain_ms']:.1f} ms, max_abs_err "
                         f"{row['max_abs_err']:.3e}; K6 {k6_ms:.3f} ms, plain bf16 "
                         f"{row['bf16_plain_ms']:.1f} ms, max_abs_err "
                         f"{row['bf16_max_abs_err']:.3e}; bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}), K6 {row['bf16_bound_ms']:.4f} ms")
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
        launched = sum(e.count for e in kernels)
        check(launched == calls, f"{launched} launches of {len(kernels)} kernels in {calls} calls")
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
    k5_bound = pulse_bound(got.n_substeps, main_cfg)
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
    # A global batch of 4097 does not divide the two ranks: each holds and
    # steps all of it through K1, as the JAX package runs such a batch
    # unsharded (spintorque_tpu/ops/pallas_integrator.py:639).
    B, seed, B_odd = 4096, 7, 4097
    actions = global_actions(B, 16, seed=8)
    odd_actions = global_actions(B_odd, 16, seed=9)
    ref_block = env_block(SpinTorqueEnv(batch_size=B), seed, actions)
    ref_odd = env_block(SpinTorqueEnv(batch_size=B_odd), seed, odd_actions)
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    ranks = spawn_ranks(data_parallel_rank, 2, args=(B, seed, actions, B_odd, odd_actions),
                        backend="gloo", timeout=600.0, workdir=work)
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
        check(r["odd_rows"] == (B_odd, True),
              f"rank layout at B={B_odd}: {r['odd_rows']}, want every row replicated")
        check(r["odd_launches"] == [0, 16, 0],
              f"the B={B_odd} block launched K5/K1/K6 {r['odd_launches']} times, want [0, 16, 0]")
        for key in ("obs", "reward", "m"):
            check(torch.equal(r["odd_block"][key].view(torch.int32),
                              ref_odd[key].view(torch.int32)),
                  f"rank {r['rank']}'s B={B_odd} block differs from one process in {key}")
    dp_launches = sum(r["env_launches"][0] + r["train_launches"][0] for r in ranks)
    dp_k1_launches = sum(r["odd_launches"][1] for r in ranks)
    r0 = ranks[0]
    print(f"data-parallel, two ranks sharing one card (gloo), global B=4096: 16-step env block "
          f"bit for bit with one process (obs, reward, m); 2 PPO train steps with PPOConfig(), "
          f"parameters equal on both ranks; K5 launched 16 + 32 times per rank; global "
          f"{r0['rates'][0]:.0f} train env-steps/s on two ranks sharing one card (not a "
          f"scaling number), rollout {r0['rollout_ms'][0]:.1f} ms, update "
          f"{r0['update_ms'][0]:.1f} ms; {dp_wall:.1f} s with spawning  [{smi}]")
    print(f"data-parallel, two ranks sharing one card, global B={B_odd} (does not divide the "
          f"ranks): every rank holds all {B_odd} rows; 16-step env block bit for bit with one "
          f"process on each rank (obs, reward, m as int32 bits); K1 launched 16 times per "
          f"rank (one a step), K5 0  [{smi}]")
    RECORD["two_ranks_one_card"] = dict(
        rates=[r["rates"] for r in ranks], rollout_ms=[r["rollout_ms"] for r in ranks],
        update_ms=[r["update_ms"] for r in ranks], metrics=r0["metrics"], wall_s=dp_wall,
        k5_launches=dp_launches, odd_batch=B_odd, odd_k1_launches=dp_k1_launches)

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
    k7_bf16_ms = cuda_ms(lambda: oc.op_chain(xk, "base2_bf16", 20_000, 256), 5)
    k7_bf16_plain_ms = cuda_ms(lambda: oc.op_chain_plain(xk, "base2_bf16", 20_000), 1)
    # base2 is a plain FADD and a plain FMUL a step (--fmad=false).
    k7_bound = bound(xk.numel() * 20_000 * 2, 2 * 4 * xk.numel())
    for shape, key in (("latency, 1 block of 1024", "latency_ns"),
                       ("throughput, per 1024 lanes", "throughput_ns_per_1024")):
        print(f"K7 ns/op ({shape}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in costs[key].items()) + f"  [{smi}]")
    print(f"K7 base2 x 20000 steps on {xk.numel()} threads: {k7_ms:.3f} ms, plain "
          f"{k7_plain_ms:.1f} ms, bound {k7_bound[0]:.4f} ms; base2_bf16 {k7_bf16_ms:.3f} ms, "
          f"plain {k7_bf16_plain_ms:.1f} ms; {k7_launches} launches, max_abs_err {k7_err:.1e} "
          f"(check inputs, {oc.CHECK_STEPS} steps)  [{smi}]")
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
    RECORD["subnormal"] = subnormal_phase(dev, smi)

    # ------------------------------------ 16. the command line and serving
    write_record()  # the serving endpoint's readiness evidence
    RECORD["shell"] = shell_phase(dev, smi, rates[len(rates) // 2])
    shell_launches = {k: v["k1_launches"] for k, v in RECORD["shell"].items()
                      if isinstance(v, dict)}

    # -------------------------------------- 17. the 'model' mesh axis
    RECORD["model_axis"] = model_axis_phase(dev, smi)

    # ------------------------------------------- 18. the research tier
    RECORD["research"] = research_phase(dev, smi)
    research_launches = RECORD["research"]["launches"]

    # ------------------------------------------------ 19. the quantum tier
    RECORD["quantum"] = quantum_phase(dev, smi)
    quantum_launches = RECORD["quantum"]["launches"]

    # ------------------------------------------- 20. the examples, the soak
    RECORD["examples"] = examples_phase(dev, smi)
    example_launches = {k: sum(v["launches"][k] for v in RECORD["examples"].values()
                               if isinstance(v, dict) and "launches" in v)
                        for k in ("K1", "K5")}
    RECORD["soak"] = soak_phase(dev, smi)

    # ------------------------------------ 21. the programs beside the package
    RECORD["scripts"] = scripts_phase(dev, smi)
    script_launches = RECORD["scripts"]["launches"]

    pulse = "spintorque_tpu_torch/csrc/pulse_integrator.cu"
    kernels = [
        dict(name="llgs_pulse", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:283",
             launches=(launches["llgs_pulse"] + solver_launches + sum(shell_launches.values())
                       + sum(research_launches.values()) + sum(quantum_launches.values())
                       + example_launches["K1"] + RECORD["soak"]["k1_launches"]
                       + script_launches["K1"] + dp_k1_launches),
             launches_by_path=dict(env=launches["llgs_pulse"], solver=solver_launches,
                                   data_parallel=dp_k1_launches,
                                   **{f"shell_{k}": v for k, v in shell_launches.items()},
                                   **research_launches, **quantum_launches,
                                   examples=example_launches["K1"],
                                   soak=RECORD["soak"]["k1_launches"],
                                   scripts=script_launches["K1"]),
             max_abs_err=max(det_err, thermal_err, t_main["max_abs_err"],
                             *(r["max_abs_err"] for r in RECORD["analysis"]["solver"]["solves"]),
                             RECORD["research"]["objective"]["max_abs_err"],
                             RECORD["quantum"]["scheduler"]["max_abs_err"]),
             ms=t_main["ms"], plain_ms=t_main["plain_ms"], bound_ms=t_main["bound_ms"],
             bound_by=t_main["bound_by"], library_ms=None, chain_floor_ms=floors["K1"],
             deterministic_ms=t_det["ms"],
             deterministic_chain_floor_ms=floors["K1 deterministic"]),
        dict(name="llgs_pulse_bf16", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:316",
             launches=launches["llgs_pulse_bf16"] + script_launches["K6"],
             launches_by_path=dict(env=launches["llgs_pulse_bf16"], scripts=script_launches["K6"]),
             max_abs_err=max(bf16_err, bf16_thermal_err, t_main["bf16_max_abs_err"]),
             ms=t_main["bf16_ms"], plain_ms=t_main["bf16_plain_ms"],
             bound_ms=t_main["bf16_bound_ms"], bound_by=t_main["bf16_bound_by"], library_ms=None,
             chain_floor_ms=floors["K6"],
             deterministic_ms=t_det["bf16_ms"],
             deterministic_chain_floor_ms=floors["K6 deterministic"]),
        dict(name="probe_add_one", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:118",
             launches=launches["probe_add_one"] + script_launches["K2"],
             launches_by_path=dict(env=launches["probe_add_one"], scripts=script_launches["K2"]),
             max_abs_err=probe_err,
             ms=probe_ms, plain_ms=probe_plain_ms, bound_ms=probe_bound[0],
             bound_by=probe_bound[1], library_ms=probe_library_ms, chain_floor_ms=None,
             device_ms=probe_device_ms, library_device_ms=add_device_ms),
        dict(name="llgs_pulse_sharded", route="cuda", source=pulse,
             replaces="spintorque_tpu/ops/pallas_integrator.py:720",
             launches=(dp_launches + RECORD["model_axis"]["launches"] + example_launches["K5"]
                       + script_launches["K5"]),
             launches_by_path=dict(data_parallel=dp_launches,
                                   model_axis=RECORD["model_axis"]["launches"],
                                   examples=example_launches["K5"],
                                   scripts=script_launches["K5"]),
             max_abs_err=k5_err,
             ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound[0], bound_by=k5_bound[1],
             library_ms=None, chain_floor_ms=floors["K5"]),
        dict(name="op_chain", route="cuda", source="spintorque_tpu_torch/csrc/op_chain.cu",
             replaces="scripts/bench_vpu_op_costs.py:43",
             launches=k7_launches + script_launches["K7"],
             launches_by_path=dict(measure_op_costs=k7_launches, scripts=script_launches["K7"]),
             max_abs_err=k7_err,
             ms=k7_ms, plain_ms=k7_plain_ms, bound_ms=k7_bound[0], bound_by=k7_bound[1],
             library_ms=None, chain_floor_ms=None, base2_bf16_ms=k7_bf16_ms,
             base2_bf16_plain_ms=k7_bf16_plain_ms),
    ]
    RECORD["kernels"] = kernels
    write_record()

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
