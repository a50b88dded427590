"""Computation helpers: memoization, batch padding, a function registry.

PyTorch counterpart of ``spintorque_tpu/utils/performance.py``, with the
same ``ComputationOptimizer`` / ``get_optimizer`` surface:

  * host-side memoization through the shared cache stack
    (``utils/cache.py``);
  * batch padding to a multiple of the pulse kernel's block, 32 envs;
  * a process-wide registry of named functions with call counters. The
    JAX package compiles each with ``jax.jit``; here a function runs
    eagerly as given. The port's kernels are launched through ctypes and
    its env step is eager, so there is nothing to compile, and a
    ``torch.compile`` would put its compile time into ``first_call_s``.
"""

from __future__ import annotations

import os
import threading
import time
from functools import wraps
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .cache import AdaptiveCache, LRUCache

__all__ = ["ComputationOptimizer", "get_optimizer", "pad_batch", "unpad_batch"]

# The pulse kernel (csrc/pulse_integrator.cu) runs one warp of 32 envs per
# block, one env a thread: a batch that is a multiple of 32 fills every
# block it launches.
ENV_BLOCK = 32


def pad_batch(x, multiple: int = ENV_BLOCK) -> Tuple[Any, int]:
    """Pad axis 0 of a numpy array or tensor up to a multiple of
    ``multiple`` by repeating its last row; returns (padded, original
    size)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])]), n
    pad = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, mode="edge"), n


def unpad_batch(x, original_size: int):
    return x[:original_size]


def device_memory_bytes(device=None) -> int:
    """Total memory of ``device``: the card's (``torch.cuda``'s device
    properties), or the host's RAM for "cpu". ``device`` defaults to
    "cuda"."""
    from ..parallel.mesh import resolve_device

    device = resolve_device(device, None)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class ComputationOptimizer:
    """Memoization, padding and a registry of counted functions."""

    def __init__(self, cache_size: int = 4096, ttl_s: Optional[float] = 300.0):
        self.cache = AdaptiveCache(max_size=cache_size, ttl_s=ttl_s)
        self._registered: Dict[str, Callable] = {}
        self._counters: Dict[str, Dict[str, float]] = {}
        self._lock = threading.RLock()

    # -- memoization (host-side only) ---------------------------------------
    @staticmethod
    def hash_parameters(params: Dict[str, Any]) -> str:
        """Collision-safe parameter hash (the full structure, no rounding)."""
        return LRUCache.make_key(params)

    def memoized(self, fn: Callable) -> Callable:
        sentinel = object()

        @wraps(fn)
        def wrapper(*args, **kwargs):
            key = LRUCache.make_key(fn.__qualname__, *args, **kwargs)
            out = self.cache.get(key, sentinel)
            if out is sentinel:
                out = fn(*args, **kwargs)
                self.cache.put(key, out)
            return out

        return wrapper

    def cached_computation(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        """Call-through memoization under ``name``."""
        sentinel = object()
        key = LRUCache.make_key(name, *args, **kwargs)
        out = self.cache.get(key, sentinel)
        if out is sentinel:
            out = fn(*args, **kwargs)
            self.cache.put(key, out)
        return out

    # -- function registry ---------------------------------------------------
    def jit(self, name: str, fn: Callable) -> Callable:
        """Register ``fn`` under ``name`` once; later calls with the same
        name return the first registered function. It runs eagerly and
        counts its calls and the host seconds of its first call
        (``first_call_s``)."""
        with self._lock:
            if name not in self._registered:
                self._counters[name] = {"calls": 0, "first_call_s": 0.0}

                @wraps(fn)
                def counted(*args, **kwargs):
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    el = time.perf_counter() - t0
                    c = self._counters[name]
                    if c["calls"] == 0:
                        c["first_call_s"] = el
                    c["calls"] += 1
                    return out

                self._registered[name] = counted
            return self._registered[name]

    # -- batch helpers -------------------------------------------------------
    def optimize_batch_size(self, item_bytes: int, hbm_bytes: Optional[float] = None,
                            reserve: float = 0.25, device=None) -> int:
        """The largest multiple of ``ENV_BLOCK`` envs of ``item_bytes`` each
        that fits in ``hbm_bytes`` (default: ``device``'s memory, the card's
        unless the caller asks for "cpu") less the ``reserve`` share."""
        if hbm_bytes is None:
            hbm_bytes = device_memory_bytes(device)
        usable = hbm_bytes * (1.0 - reserve)
        raw = int(usable / max(item_bytes, 1))
        return max(ENV_BLOCK, (raw // ENV_BLOCK) * ENV_BLOCK)

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache": self.cache.stats.as_dict(),
                "cache_size": len(self.cache),
                "jitted_functions": {k: dict(v) for k, v in self._counters.items()},
            }


_optimizer: Optional[ComputationOptimizer] = None
_optimizer_lock = threading.Lock()


def get_optimizer() -> ComputationOptimizer:
    """Process-global optimizer."""
    global _optimizer
    with _optimizer_lock:
        if _optimizer is None:
            _optimizer = ComputationOptimizer()
        return _optimizer
