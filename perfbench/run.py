"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the system under test, ``spintorque_tpu_torch``. The cell's files are
found by name (``perfbench/lib/manifest.py``). The run builds or loads the
port's kernels (``build/kernels/`` in the checkout, keyed by the sources'
digest), makes every input from ``--seed``, warms up the cell's own
shapes, measures for ``--seconds``, and, with ``--trace 1``, traces a short
window after it. Then it checks what the timed path produced against the
plain reference, and prints the numbers compared beside their limits as its
last lines on standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

A cell on several cards runs one process a card: this process is rank 0,
starts the others (``lib/ranks.py``) and alone prints a result.

Without a card (or with fewer cards than the cell asks for) it exits 3 and
prints no result; if the process holds JAX or the JAX package once the
window has closed, it exits 4. ``--control`` runs the port's bf16 paths
in place of float32 (the check's control), and ``--fault <name>`` plants a
fault of ``lib/faults.py``; no benchmark run passes either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port's
    own library goes to ``build/kernels`` there by itself), and one host
    thread for CPU work: the host side of a step is one Python thread, and
    idle worker threads only contend with it."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    os.environ["OMP_NUM_THREADS"] = "1"


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result_line(out, kind: str) -> dict:
    """The last line's object from a run's output (``runner.run_cell``):
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with the
    trace ``breakdown``, and last ``checks``."""
    rec = out["records"]
    device = {
        "platform": "gpu",
        "kind": kind,
        "count": out["chips"],
        "memory_peak_bytes": int(rec["memory_peak_bytes"]),
    }
    line = {"correct": bool(out["correct"]), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": out["metrics"], "device": device}
    t = rec.get("trace")
    if t is not None:
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from perfbench.lib import manifest, runner

    chips = manifest.cell_entry(manifest.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    procs, failed = [], []
    if chips > 1 and args.rendezvous is None:
        from perfbench.lib import ranks

        args.rendezvous = ranks.rendezvous()
        args.world = chips
        logs = args.rendezvous[len("file://"):] + ".log"
        procs = ranks.spawn([sys.argv[0], *(argv if argv is not None else sys.argv[1:])],
                            chips, args.rendezvous, logs)
    try:
        if chips > 1:
            from perfbench.lib import program

            program.join_ranks(args.rank, args.world, args.rendezvous)
        torch.cuda.set_device(args.rank)
        out = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device=f"cuda:{args.rank}", process_start=PROCESS_START,
                              control=args.control, fault=args.fault, rank=args.rank,
                              world=args.world)
    except runner.ForbiddenModules as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 4
    finally:
        if chips > 1:
            from perfbench.lib import program

            program.leave_ranks()
        if procs:
            failed = ranks.join(procs, logs)
    if failed:
        print("perfbench: " + "\n".join(failed), file=sys.stderr)
        return 1
    found = runner.forbidden_modules()
    if found:
        print(f"perfbench: the measured process holds {', '.join(found)}", file=sys.stderr)
        return 4
    if args.rank != 0:
        return 0

    line = result_line(out, torch.cuda.get_device_name(0))
    rec, t = out["records"], out["records"].get("trace")
    w = rec["window"]
    print(json.dumps({"note": "window", **w, "card": _power_limit(), "seed": args.seed,
                      "control": args.control, "fault": args.fault}))
    if "step_ms" in rec:
        print(json.dumps({"note": "steps timed", "count": len(rec["step_ms"])}))
    if t is not None:
        print(json.dumps({"note": "trace", **{k: v for k, v in t.items()
                                               if k not in ("device_ops", "idle_gaps")}}))
    for n in out["notes"]:
        print(json.dumps({"note": "run", **n}))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
