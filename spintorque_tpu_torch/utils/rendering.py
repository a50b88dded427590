"""Matplotlib rendering for the Gym adapters.

PyTorch counterpart of ``spintorque_tpu/utils/rendering.py``: kept out of
the env step, and matplotlib is imported only when a render mode asks for
it. The state is read back to the host first (``numpy`` of a CUDA tensor
raises).
"""

from __future__ import annotations

import numpy as np


def render_spin_torque(gym_env, mode: str = "rgb_array"):
    """Render the current single-env state; returns an RGB array for
    'rgb_array' mode."""
    import matplotlib

    if mode == "rgb_array":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    state = gym_env._state
    if state is None:
        return None
    m = state.m[0].detach().cpu().numpy()
    t = state.target[0].detach().cpu().numpy()
    step = int(state.step[0])

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.quiver(0, 0, m[0], m[1], color="red", scale=1, label="Current",
              angles="xy", scale_units="xy")
    ax.quiver(0, 0, t[0], t[1], color="blue", scale=1, label="Target",
              angles="xy", scale_units="xy")
    circle = plt.Circle((0, 0), 1, fill=False, color="gray", alpha=0.5)
    ax.add_patch(circle)
    ax.set_xlim([-1.5, 1.5])
    ax.set_ylim([-1.5, 1.5])
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(f"Step {step}: Alignment = {float(np.dot(m, t)):.3f}")

    if mode == "human":
        plt.show(block=False)
        plt.pause(0.01)
        return None

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.copy()
