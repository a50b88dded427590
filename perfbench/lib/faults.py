"""Faults planted in the program underneath a run, each of which the
correctness check must see (``run.py --fault <name>``, and the CPU tests).
No benchmark run plants one.

- ``unchanged``: a step that returns its state unchanged (the env's step
  returns the state it was given; the trainer's update leaves the network
  as it was);
- ``half``: half of the batch left out (the pulse integrates the first half
  of the rows and leaves the rest; the trainer's loss is the mean over the
  first half of each minibatch);
- ``altered``: an answer altered where it is produced (the pulse's result
  for row 0 moved by 0.05 in m_x);
- ``exchange``: the exchange between cards left out (the trainer's
  flattened gradient all-reduce an identity: each rank divides its own
  gradient by W). Only a trainer on several cards exchanges anything.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

NAMES = ("unchanged", "half", "altered", "exchange")
# The faults of a cell on one card, which exchanges nothing between cards.
ONE_CARD = NAMES[:3]
ENV_MODULE = "spintorque_tpu_torch.envs.spin_torque"


def _half_pulse(pulse):
    def half(m0, span, current, params, config, seed=None, temperature=300.0, **kw):
        b = m0[0].shape[0]
        h = max(b // 2, 1)
        res = pulse(tuple(x[:h] for x in m0), span[:h], current[:h], params, config, seed,
                    temperature, **kw)
        return res._replace(m=tuple(torch.cat([a, x[h:]]) for a, x in zip(res.m, m0)),
                            failed=torch.cat([res.failed, torch.zeros_like(m0[0], dtype=bool)])[:b])
    return half


def _altered_pulse(pulse):
    def altered(*args, **kw):
        res = pulse(*args, **kw)
        mx = res.m[0].clone()
        mx[0] += 0.05
        return res._replace(m=(mx,) + tuple(res.m[1:]))
    return altered


@contextlib.contextmanager
def planted(name):
    """Within the block, ``patch(target)`` plants the fault ``name`` in an
    env or a trainer (None: no fault)."""
    if name is None:
        yield None
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
    module = importlib.import_module(ENV_MODULE)
    pulse = module.integrate_pulse

    def patch(target):
        trainer = hasattr(target, "update")
        if name == "exchange":
            if not trainer or target.mesh is None:
                raise ValueError("fault 'exchange': nothing is exchanged between cards here")
            ranks = target.mesh.shape["data"]

            def identity_all_reduce(network):
                for p in network.parameters():
                    if p.grad is not None:
                        p.grad /= ranks

            target.average_grads = identity_all_reduce
        elif name == "unchanged":
            if trainer:
                target.update = lambda ts, traj: {"loss": torch.zeros((), device=ts.obs.device)}
            else:
                step = target.step

                def unchanged(state, action):
                    return state, step(state, action)[1]

                target.step = unchanged
        elif name == "half" and trainer:
            loss = target.loss

            def half_loss(network, mb):
                n = mb["obs"].shape[0] // 2
                return loss(network, {k: v[:n] for k, v in mb.items()})

            target.loss = half_loss
        else:
            module.integrate_pulse = (_half_pulse if name == "half" else _altered_pulse)(pulse)

    try:
        yield patch
    finally:
        module.integrate_pulse = pulse
