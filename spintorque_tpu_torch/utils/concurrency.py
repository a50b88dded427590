"""Host-side concurrency: a coalescing physics pool, a resource pool, async
episodes, a parallelism benchmark.

PyTorch counterpart of ``spintorque_tpu/utils/concurrency.py``. A card
wants one large batch, not many small launches, so ``PhysicsWorkerPool``
keeps a submit / future surface but its drainer thread COALESCES queued
solves into one ``integrate_pulse`` call (the pulse kernel K1 on the
card), and ``ParallelBenchmark`` measures batched against one-at-a-time
and coalesced solves. Thread pools are for host-bound work (IO, plotting,
reports); no thread pool runs a kernel of its own.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ResourcePool",
    "PhysicsWorkerPool",
    "AsyncEnvironmentManager",
    "ParallelBenchmark",
    "parallel_map",
]


class ResourcePool:
    """Generic checkout/checkin pool."""

    def __init__(self, factory: Callable[[], Any], max_size: int = 8):
        self._factory = factory
        self._max_size = max_size
        self._available: "queue.LifoQueue[Any]" = queue.LifoQueue()
        self._created = 0
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> Any:
        try:
            return self._available.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            if self._created < self._max_size:
                self._created += 1
                return self._factory()
        return self._available.get(timeout=timeout)

    def release(self, resource: Any) -> None:
        self._available.put(resource)

    def __enter__(self):
        self._current = self.acquire()
        return self._current

    def __exit__(self, *exc):
        self.release(self._current)
        del self._current

    @property
    def size(self) -> int:
        return self._created


@dataclass
class _PendingSolve:
    m0: np.ndarray
    span: float
    current: float
    future: Future


class PhysicsWorkerPool:
    """Submit single LLGS solves; execution coalesces them into batches.

    ``submit`` returns a Future at once; a background drainer gathers up to
    ``max_batch`` pending requests (or waits ``max_wait_ms``) and runs them
    as ONE ``integrate_pulse`` call on ``device`` ("cuda" unless the caller
    asks for "cpu"): the pulse kernel K1 on the card, launched on the
    drainer thread's current stream. Each result is read to the host
    (numpy) before its future is set, so no waiter sees a tensor that the
    card is still writing. An env's result does not depend on the batch it
    lands in: each env integrates on its own, deterministically.
    """

    def __init__(
        self,
        params,
        method: str = "rk4",
        max_substeps: int = 2048,
        max_batch: int = 4096,
        max_wait_ms: float = 2.0,
        device=None,
    ):
        from ..parallel.mesh import resolve_device
        from ..physics.integrator import IntegratorConfig

        self.device = resolve_device(device, None)
        self.params = params.to(self.device, torch.float32)
        self.config = IntegratorConfig(method=method, max_substeps=max_substeps)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[_PendingSolve]" = queue.Queue()
        self._stop = threading.Event()
        self._stats = {"submitted": 0, "batches": 0, "solved": 0}
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._drain_loop, daemon=True,
                                        name="spintorque-physics-pool")
        self._thread.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def submit(self, m_initial, t_span: Tuple[float, float], current: float = 0.0) -> Future:
        fut: Future = Future()
        span = float(t_span[1]) - float(t_span[0])
        m0 = m_initial.detach().cpu().numpy() if isinstance(m_initial, torch.Tensor) else m_initial
        self._queue.put(_PendingSolve(np.asarray(m0, np.float32), span, float(current), fut))
        self._count("submitted")
        return fut

    def solve_batch(self, m_initials, spans, currents) -> np.ndarray:
        """Direct batched solve (no queue): one ``integrate_pulse`` call;
        returns the (B, 3) final magnetizations as float32 numpy."""
        from ..physics.integrator import integrate_pulse

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        m = t(m_initials)
        res = integrate_pulse(
            (m[:, 0].contiguous(), m[:, 1].contiguous(), m[:, 2].contiguous()),
            t(spans), t(currents), self.params, self.config,
        )
        self._count("solved", int(m.shape[0]))
        return torch.stack(res.m, dim=-1).cpu().numpy()

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                m = np.stack([p.m0 for p in batch])
                out = self.solve_batch(
                    m,
                    [p.span for p in batch],
                    [p.current for p in batch],
                )
                self._count("batches")
                for p, row in zip(batch, out):
                    p.future.set_result(row)
            except Exception as exc:  # propagate to every waiter
                for p in batch:
                    p.future.set_exception(exc)

    def get_statistics(self) -> Dict[str, float]:
        with self._stats_lock:
            stats = dict(self._stats)
        stats["mean_batch_size"] = (
            stats["solved"] / stats["batches"] if stats["batches"] else 0.0
        )
        return stats

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class AsyncEnvironmentManager:
    """Run policy episodes concurrently on a thread pool (their host-bound
    parts) while each episode's env math stays batched on its device.

    Each runner owns a vectorized env, so concurrency multiplies batching
    instead of replacing it. Episode ``i`` resets from seed ``seed + i``
    and draws its actions from a ``torch.Generator`` on the env's device,
    seeded from the same number; ``policy(params, obs, generator)`` is the
    rollout policy signature (``parallel.random_policy``).
    """

    def __init__(self, env_factory: Callable[[], Any], n_runners: int = 2):
        self.env_factory = env_factory
        self.n_runners = n_runners
        self._executor = ThreadPoolExecutor(max_workers=n_runners)

    def run_episodes(
        self, policy, n_episodes: int, steps_per_episode: int = 32, seed: int = 0
    ) -> List[Dict[str, float]]:
        from ..ops.philox import derive_seed

        def one_episode(idx: int) -> Dict[str, float]:
            env = self.env_factory()
            state, obs = env.reset(seed + idx)
            generator = torch.Generator(device=env.device)
            generator.manual_seed(derive_seed(seed + idx, 1))
            total = 0.0
            for _ in range(steps_per_episode):
                action = policy(None, obs, generator)
                state, ts = env.step(state, action)
                obs = ts.obs
                total += float(ts.reward.mean())
            return {"episode": idx, "mean_reward": total / steps_per_episode}

        futures = [
            self._executor.submit(one_episode, i) for i in range(n_episodes)
        ]
        return [f.result() for f in futures]

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False)


class ParallelBenchmark:
    """Measure one batched call against one-row calls and the coalescing
    queue on the same solves, on ``device`` ("cuda" unless the caller asks
    for "cpu")."""

    def __init__(self, params, n_solves: int = 256, span: float = 1e-10,
                 max_substeps: int = 128, device=None):
        self.params = params
        self.n_solves = n_solves
        self.span = span
        self.max_substeps = max_substeps
        self.device = device

    def run(self) -> Dict[str, float]:
        rng = np.random.default_rng(0)
        m0 = rng.normal(size=(self.n_solves, 3)).astype(np.float32)
        m0 /= np.linalg.norm(m0, axis=-1, keepdims=True)
        currents = rng.uniform(-1e-7, 1e-7, self.n_solves).astype(np.float32)

        pool = PhysicsWorkerPool(
            self.params, max_substeps=self.max_substeps, max_batch=self.n_solves,
            device=self.device,
        )
        try:
            # batched (one warm-up call, then measured; each call reads its
            # result to the host, so it ends when the device has)
            spans = np.full(self.n_solves, self.span, np.float32)
            pool.solve_batch(m0, spans, currents)
            t0 = time.perf_counter()
            pool.solve_batch(m0, spans, currents)
            batched_s = time.perf_counter() - t0

            # serial: one-row batches
            t0 = time.perf_counter()
            for i in range(min(16, self.n_solves)):  # sample; extrapolate
                pool.solve_batch(m0[i : i + 1], spans[:1], currents[i : i + 1])
            serial_s = (time.perf_counter() - t0) * self.n_solves / min(16, self.n_solves)

            # coalescing queue (submits, the drainer batches)
            t0 = time.perf_counter()
            futs = [
                pool.submit(m0[i], (0.0, self.span), currents[i])
                for i in range(self.n_solves)
            ]
            for f in futs:
                f.result(timeout=30)
            queued_s = time.perf_counter() - t0
        finally:
            pool.shutdown()

        return {
            "n_solves": self.n_solves,
            "batched_s": batched_s,
            "serial_estimate_s": serial_s,
            "coalesced_queue_s": queued_s,
            "batch_speedup_vs_serial": serial_s / max(batched_s, 1e-9),
            "mean_batch_size": pool.get_statistics()["mean_batch_size"],
        }


def parallel_map(
    fn: Callable, items: Sequence[Any], max_workers: int = 8
) -> List[Any]:
    """Threaded map for HOST-bound functions. For device math, batch
    instead."""
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(fn, items))
