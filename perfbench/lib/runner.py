"""One run of one cell: set-up, the measured window, the traced window,
the correctness check and the result line's contents.

``run.py`` calls ``run_cell`` after its look for the card; the CPU tests
call it directly with ``device="cpu"``, small overrides of the workload
and, for the fault tests, a ``patch`` that breaks the program underneath.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.lib import check, faults, manifest
from perfbench.lib.traffic import ENV_STREAM, SAMPLE_STREAM, subseed

# Top-level module names that the measured process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "spintorque_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver gets."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: Dict
    workload: Dict
    process_start: float  # time.time() of the process's start
    control: bool = False
    rank: int = 0  # this process's rank of ``world``, one process a card
    world: int = 1
    patch: Optional[Callable] = None  # plants a fault in the env or the trainer
    notes: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def env_seed(self) -> int:
        return subseed(self.seed, ENV_STREAM)

    def sampled(self, step: int) -> bool:
        """Whether the check compares the window's step ``step``: every
        ``check.every``-th step from an offset drawn from the seed."""
        every = int(self.workload["check"]["every"])
        return step % every == subseed(self.seed, SAMPLE_STREAM) % every

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, **kv) -> None:
        self.notes.append(kv)


def forbidden_modules() -> List[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole: the
    part of each name before its first dot."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             process_start: Optional[float] = None, control: bool = False,
             overrides: Optional[Dict] = None, config_overrides: Optional[Dict] = None,
             fault: Optional[str] = None, rank: int = 0, world: int = 1) -> Dict:
    """Runs the cell once. Returns ``records`` (the driver's raw spans and
    counts), ``check`` (the comparison's numbers and limits), ``correct``
    and the printed ``metrics``. ``overrides`` and ``config_overrides``
    are merged into the workload and the configuration (the tests' tiny
    sizes); ``fault`` plants one of ``lib/faults.py``'s faults. On several
    cards every rank calls it after joining the process group, and the
    result is rank 0's."""
    bench = manifest.manifest()
    entry = manifest.cell_entry(bench, cell)
    wl = manifest.workload(cell)
    if overrides:
        wl = _merge(wl, overrides)
    if wl["config"] != entry["config"]:
        raise ValueError(f"{cell}: the workload file names {wl['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    config = manifest.config(wl["config"])
    if config_overrides:
        config = _merge(config, config_overrides)
    ctx = Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
              config=config, workload=wl,
              process_start=time.time() if process_start is None else process_start,
              control=control, rank=rank, world=world)
    driver = manifest.load_module("drivers", wl["driver"])
    with faults.planted(fault) as ctx.patch:
        records, start, samples = driver.run(ctx)

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    t0 = time.perf_counter()
    if hasattr(driver, "check_run"):
        result = driver.check_run(ctx, start, samples)
    else:
        with torch.no_grad():
            result = check.compare(ctx.config, start, samples, wl["batch"], ctx.env_seed,
                                   graph=ctx.device.type == "cuda")
    ctx.sync()
    limits = wl["check"]["limits"]
    checks = {k: {"value": result["numbers"][k], "limit": limits[k]} for k in limits}
    correct = result["steps"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    ctx.note(check_steps=result["steps"], check_rows=result["rows"],
             reference_s=time.perf_counter() - t0)

    metrics = {}
    for m in manifest.metrics_for(bench, cell, trace):
        value = manifest.load_module("metrics", m["name"]).read(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return dict(records=records, checks=checks, correct=correct, metrics=metrics,
                notes=ctx.notes, chips=entry["chips"])


class ForbiddenModules(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("the measured process holds " + ", ".join(names))
        self.names = names
