"""Throughput-driven batch autoscaling and device load balancing.

PyTorch counterpart of ``spintorque_tpu/utils/scaling.py`` (host logic,
numpy only, as there):

  * ``AutoScaler`` tunes the ENV BATCH SIZE from measured env-steps/s
    (hill-climbing on throughput; the batch is the card's thread count);
  * ``LoadBalancer`` assigns work shares across the process's cards from
    measured per-card rates (the heterogeneous case; across ranks the
    mesh of ``spintorque_tpu_torch.parallel`` supersedes it);
  * ``AdaptiveResourceManager`` ties both to a background monitor loop
    with cooldowns.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["AutoScaler", "LoadBalancer", "AdaptiveResourceManager"]


@dataclass
class ScaleEvent:
    timestamp: float
    old_batch: int
    new_batch: int
    throughput: float
    reason: str


class AutoScaler:
    """Hill-climb the batch size on measured throughput (env-steps/s).

    Call ``record(batch, steps, elapsed_s)`` after each work chunk;
    ``recommend()`` proposes the next batch size: grow while throughput per
    step improves (the chip is underfed), back off when it saturates or
    regresses (memory pressure / padding waste). Growth is geometric between
    ``min_batch`` and ``max_batch``; cooldown avoids thrashing.
    """

    def __init__(
        self,
        initial_batch: int = 1024,
        min_batch: int = 128,
        max_batch: int = 1 << 20,
        growth: float = 2.0,
        cooldown_s: float = 5.0,
        improve_threshold: float = 1.10,
    ):
        self.batch = initial_batch
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.growth = growth
        self.cooldown_s = cooldown_s
        self.improve_threshold = improve_threshold
        self._samples: Dict[int, List[float]] = {}
        self._last_scale = 0.0
        self._direction = +1
        self.events: List[ScaleEvent] = []

    def record(self, batch: int, steps: int, elapsed_s: float) -> None:
        rate = batch * steps / max(elapsed_s, 1e-9)
        self._samples.setdefault(batch, []).append(rate)

    def throughput(self, batch: Optional[int] = None) -> float:
        xs = self._samples.get(batch or self.batch, [])
        return float(np.median(xs)) if xs else 0.0

    def recommend(self) -> int:
        now = time.monotonic()
        if now - self._last_scale < self.cooldown_s:
            return self.batch
        measured = {b: float(np.median(v)) for b, v in self._samples.items() if v}
        if not measured:
            return self.batch
        best_b = max(measured, key=measured.get)
        cur = measured.get(self.batch)
        # If the current batch measured WORSE than a known-better size,
        # revert to the best-known configuration first.
        if (
            cur is not None
            and best_b != self.batch
            and measured[best_b] > cur * self.improve_threshold
        ):
            self._scale_to(best_b, measured[best_b], "revert_to_best")
            return self.batch
        if cur is None:
            return self.batch  # wait for a measurement at the current size
        candidate = int(self.batch * self.growth) if self._direction > 0 else int(
            self.batch / self.growth
        )
        candidate = max(self.min_batch, min(self.max_batch, candidate))
        if candidate == self.batch:
            self._direction *= -1
            return self.batch
        cand_rate = measured.get(candidate)
        if cand_rate is None:
            # unexplored: move there so the caller measures it
            self._scale_to(candidate, cur, "explore")
        elif cand_rate > cur * self.improve_threshold:
            self._scale_to(candidate, cand_rate, "improved")
        else:
            self._direction *= -1
        return self.batch

    def _scale_to(self, new_batch: int, rate: float, reason: str) -> None:
        self.events.append(
            ScaleEvent(time.monotonic(), self.batch, new_batch, rate, reason)
        )
        self.batch = new_batch
        self._last_scale = time.monotonic()

    def get_statistics(self) -> Dict[str, Any]:
        return {
            "current_batch": self.batch,
            "throughput_by_batch": {
                b: float(np.median(v)) for b, v in self._samples.items()
            },
            "n_scale_events": len(self.events),
        }


class LoadBalancer:
    """Proportional work sharing across heterogeneous local devices (the
    process's cards by default).

    Strategies: 'round_robin', 'least_loaded' (in-flight items), and
    'fastest_response' (measured items/s EMA), applied to batch SHARES,
    not request routing.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 strategy: str = "fastest_response"):
        if devices is None:
            import torch

            devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
        self.devices = list(devices)
        if strategy not in ("round_robin", "least_loaded", "fastest_response"):
            raise ValueError(f"unknown strategy {strategy}")
        self.strategy = strategy
        self._rr = 0
        self._inflight = [0] * len(self.devices)
        self._rate_ema = [0.0] * len(self.devices)
        self._lock = threading.Lock()

    def select_device(self) -> int:
        with self._lock:
            if self.strategy == "round_robin":
                idx = self._rr % len(self.devices)
                self._rr += 1
            elif self.strategy == "least_loaded":
                idx = int(np.argmin(self._inflight))
            else:
                # prefer unmeasured devices, then highest measured rate
                unmeasured = [i for i, r in enumerate(self._rate_ema) if r == 0.0]
                idx = unmeasured[0] if unmeasured else int(np.argmax(self._rate_ema))
            self._inflight[idx] += 1
            return idx

    def record_completion(self, device_index: int, items: int, elapsed_s: float) -> None:
        with self._lock:
            self._inflight[device_index] = max(0, self._inflight[device_index] - 1)
            rate = items / max(elapsed_s, 1e-9)
            old = self._rate_ema[device_index]
            self._rate_ema[device_index] = rate if old == 0.0 else 0.8 * old + 0.2 * rate

    def partition(self, total: int) -> List[int]:
        """Split ``total`` items proportionally to measured device rates."""
        with self._lock:
            rates = np.asarray(self._rate_ema)
            if rates.sum() == 0.0:
                rates = np.ones(len(self.devices))
            shares = np.floor(total * rates / rates.sum()).astype(int)
            shares[0] += total - shares.sum()
            return shares.tolist()

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "devices": [str(d) for d in self.devices],
                "inflight": list(self._inflight),
                "rate_ema": list(self._rate_ema),
                "strategy": self.strategy,
            }


class AdaptiveResourceManager:
    """Background loop tying the autoscaler to live measurements.

    ``observe`` feeds work-chunk measurements; a monitor thread periodically
    asks the AutoScaler for a recommendation and publishes it via
    ``current_batch``.
    """

    def __init__(self, autoscaler: Optional[AutoScaler] = None,
                 interval_s: float = 2.0):
        self.autoscaler = autoscaler or AutoScaler()
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def current_batch(self) -> int:
        return self.autoscaler.batch

    def observe(self, batch: int, steps: int, elapsed_s: float) -> None:
        self.autoscaler.record(batch, steps, elapsed_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.autoscaler.recommend()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
