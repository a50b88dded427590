"""The comparison that decides ``correct`` for the env cells.

The driver keeps, for a sample of the window's steps drawn from the seed,
the state the step started from, the action the benchmark handed to it, and
what the program returned. Once the window has closed the plain reference
(``perfbench/reference/spintorque.py``) recomputes each of those steps
from the same state and action, and from the seed it recomputes the reset
the window started from. Each number compared has its limit in the cell's
workload file (``check.limits``):

- ``m_err``: the largest |difference| of a component of m after the pulse,
  before the auto-reset (the pulse layer);
- ``obs_err``: the largest |difference| in the 12-dim observation after
  the auto-reset, each column divided by the reference's largest |value|
  in it;
- ``reward_err``: the largest |difference| of the reward;
- ``state_err``: as ``obs_err``, over the step's flags (failed solve,
  terminated, truncated, as 0 or 1), the next state's fields (m, target,
  step, energy, last action, episode return) and the initial reset.

Every row of every compared step counts. Sound runs give the reference's
bits (the same operations in the same order on the same card), so each
number reads 0 there; the limits leave room for a change that rounds
differently. A cell compares the numbers its workload file gives limits
for.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from perfbench.reference import spintorque as ref

NUMBERS = ("m_err", "obs_err", "reward_err", "state_err")


class Sample(NamedTuple):
    """One step of the program to compare."""

    state: object  # the program's state the step started from
    action: torch.Tensor  # (B, 2) the benchmark's action, on the program's device
    state_out: object  # the program's next state
    ts: object  # the program's TimeStep


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in float64; a NaN on one side only is infinite."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, torch.nan_to_num(d, nan=float("inf")))
    return float(d.max()) if d.numel() else 0.0


def _scaled(a: torch.Tensor, b: torch.Tensor) -> float:
    """``_max_abs`` of each column (the last axis; a 1-D tensor is one
    column) over the reference ``b``'s largest |value| there."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    worst = 0.0
    for j in range(b.shape[1]):
        scale = float(b[:, j].abs().max()) if b.numel() else 0.0
        worst = max(worst, _max_abs(a[:, j], b[:, j]) / (scale if scale > 0.0 else 1.0))
    return worst


def _state(s) -> ref.State:
    return ref.State(*(getattr(s, f) for f in ref.State._fields))


def _state_err(prog, want: ref.State) -> float:
    got = _state(prog)
    return max(_scaled(getattr(got, f), getattr(want, f)) for f in ref.State._fields)


def compare(config: Dict, start, samples: List[Sample], batch: int, seed: int,
            graph: bool = False, rows: Optional[torch.Tensor] = None) -> Dict:
    """The numbers of the comparison, and how many steps and rows it
    covered. ``start`` is the program's state after ``reset(seed)``;
    ``batch`` is the global batch and ``rows`` the global indices of the
    rows the program's tensors hold (all of them by default; a rank's on
    several cards); ``graph`` lets the reference replay its pulse loop as a
    CUDA graph."""
    device = start.m.device
    env = ref.make_env(config, device)
    if rows is None:
        rows = torch.arange(batch, device=device)
    numbers = dict.fromkeys(NUMBERS, 0.0)
    reset = ref.reset(env, seed, batch, device)
    numbers["state_err"] = _state_err(start, ref.State(*(x[rows] for x in reset)))
    if not samples:
        return dict(numbers=numbers, steps=0, rows=0)
    want = ref.steps(env, [ref.StepInput(_state(x.state), x.action, x.state.seed,
                                         x.state.counter, batch, rows) for x in samples],
                     graph=graph)

    def cat(get):
        return torch.cat([get(x) for x in samples])

    info = {k: cat(lambda x: x.ts.info[k]) for k in ("final_magnetization",
                                                     "simulation_success")}
    flags = torch.stack([~info["simulation_success"], cat(lambda x: x.ts.terminated),
                         cat(lambda x: x.ts.truncated)], dim=-1)
    want_flags = torch.stack([want.failed, want.terminated, want.truncated], dim=-1)
    numbers["m_err"] = _max_abs(info["final_magnetization"], want.m_new)
    numbers["obs_err"] = _scaled(cat(lambda x: x.ts.obs), want.obs)
    numbers["reward_err"] = _max_abs(cat(lambda x: x.ts.reward), want.reward)
    got = ref.State(*(cat(lambda x: getattr(x.state_out, f)) for f in ref.State._fields))
    numbers["state_err"] = max(numbers["state_err"], _state_err(got, want.next_state),
                               _scaled(flags, want_flags))
    return dict(numbers=numbers, steps=len(samples), rows=len(samples) * len(rows))
