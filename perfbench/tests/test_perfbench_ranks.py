"""The four-card cell's path on the CPU: four gloo ranks, one process
each, at a tiny size. Rank 0 follows the trainer from every rank's rollout
and reports the check; the gradient sums' order differs from the
reference's, so its gaps are small but need not be 0. With the exchange
between cards left out (``lib/faults.py``'s ``exchange``), the check reads
``correct`` false."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT, TINY, TINY_CONFIG

CELL = "ppo-thermal-4x4096"


def _four_ranks(tmp_path, fault=None):
    """Rank 0's checks (``value`` and ``limit``), its ``correct`` and the
    window's records."""
    url = f"file://{tmp_path}/rendezvous"
    code = (
        f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from perfbench.lib import manifest, program, runner\n"
        "rank = int(sys.argv[1])\n"
        f"program.join_ranks(rank, 4, {url!r}, backend='gloo')\n"
        f"out = runner.run_cell({CELL!r}, 7, 0.3, False, device='cpu', overrides={TINY!r}, "
        f"config_overrides={TINY_CONFIG!r}, rank=rank, world=4, fault={fault!r})\n"
        "program.leave_ranks()\n"
        "print(json.dumps([out['checks'], out['correct']]))\n"
        "print(json.dumps(out['records']['window']))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    (checks, correct), window = (json.loads(line)
                                 for line in outs[0][0].strip().splitlines()[-2:])
    return checks, correct, window


def test_four_gloo_ranks_run_the_four_card_cell(tmp_path):
    checks, _, window = _four_ranks(tmp_path)
    checks = {k: c["value"] for k, c in checks.items()}
    assert checks["state_err"] == 0.0
    for k in ("policy_err", "loss_gap", "grad_gap", "change_gap"):
        assert checks[k] < 1e-3, (k, checks[k])
    # Global env-steps: 16 steps of 8 envs on each of the four ranks a train step.
    assert window["env_steps"] == window["steps"] * 16 * 8 * 4


def test_exchange_left_out_is_not_correct_on_four_gloo_ranks(tmp_path):
    checks, correct, _ = _four_ranks(tmp_path, fault="exchange")
    assert not correct, checks
