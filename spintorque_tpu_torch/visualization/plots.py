"""Plotting utilities for trajectories, energy landscapes and training runs.

PyTorch counterpart of ``spintorque_tpu/visualization/plots.py``. Every
function takes numpy arrays or torch tensors (on any device: they are
copied to the host) and returns the matplotlib Figure so callers can save
or display it. Matplotlib is imported when a figure is made, not with the
module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..utils.host import as_numpy


def _np(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a sequence) as numpy."""
    return np.asarray(as_numpy(x), dtype)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(trajectory: np.ndarray, dt: float = 1e-12, title: str = ""):
    """Magnetization component traces + Bloch-sphere path.

    trajectory: (T, 3) array of unit magnetizations.
    """
    plt = _plt()
    traj = _np(trajectory)
    t = np.arange(traj.shape[0]) * dt * 1e9

    fig = plt.figure(figsize=(11, 4.5))
    ax1 = fig.add_subplot(121)
    for i, label in enumerate("xyz"):
        ax1.plot(t, traj[:, i], label=f"m_{label}")
    ax1.set_xlabel("time (ns)")
    ax1.set_ylabel("magnetization component")
    ax1.legend()
    ax1.set_title(title or "LLGS trajectory")

    ax2 = fig.add_subplot(122, projection="3d")
    ax2.plot(traj[:, 0], traj[:, 1], traj[:, 2], lw=0.8)
    ax2.scatter(*traj[0], color="green", label="start")
    ax2.scatter(*traj[-1], color="red", label="end")
    u, v = np.mgrid[0 : 2 * np.pi : 24j, 0 : np.pi : 12j]
    ax2.plot_wireframe(
        np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v),
        color="gray", alpha=0.15,
    )
    ax2.legend()
    fig.tight_layout()
    return fig


def plot_energy_surface(surface: Dict[str, np.ndarray], title: str = ""):
    """Heatmap of an EnergyLandscape.energy_surface result."""
    plt = _plt()
    theta = _np(surface["theta"])
    phi = _np(surface["phi"])
    E = _np(surface["energy"])
    fig, ax = plt.subplots(figsize=(7, 4.5))
    im = ax.pcolormesh(
        np.degrees(phi), np.degrees(theta), E / 1.380649e-23 / 300.0,
        shading="auto", cmap="viridis",
    )
    fig.colorbar(im, ax=ax, label="E / kT(300K)")
    ax.set_xlabel("phi (deg)")
    ax.set_ylabel("theta (deg)")
    ax.set_title(title or "Energy landscape")
    fig.tight_layout()
    return fig


def plot_switching_diagram(diagram: Dict[str, np.ndarray], title: str = ""):
    """Heatmap of a research.sweeps.switching_probability_diagram result:
    P(switch) over the (current, duration) grid."""
    plt = _plt()
    currents = _np(diagram["currents"])
    durations = _np(diagram["durations"])
    p = _np(diagram["p_switch"])
    fig, ax = plt.subplots(figsize=(7, 4.5))
    im = ax.pcolormesh(
        durations * 1e9, currents / 1e6, p,
        shading="auto", cmap="magma", vmin=0.0, vmax=1.0,
    )
    fig.colorbar(im, ax=ax, label="P(switch)")
    ax.set_xlabel("pulse duration (ns)")
    ax.set_ylabel("current density (MA/m$^2$)")
    ax.set_title(title or "Switching probability")
    fig.tight_layout()
    return fig


class SpintronicVisualizer:
    """Named-figure convenience wrapper."""

    def __init__(self, output_dir: str = "figures"):
        from pathlib import Path

        self.output_dir = Path(output_dir)

    def _save(self, fig, name: str):
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / f"{name}.png"
        fig.savefig(path, dpi=150)
        return path

    def trajectory(self, trajectory, name: str = "trajectory", **kw):
        return self._save(plot_trajectory(_np(trajectory), **kw), name)

    def energy_surface(self, surface, name: str = "energy_surface", **kw):
        return self._save(plot_energy_surface(surface, **kw), name)

    def training_curves(self, metrics: Dict[str, Sequence[float]],
                        name: str = "training"):
        plt = _plt()
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for label, values in metrics.items():
            ax.plot(_np(values), label=label)
        ax.set_xlabel("update")
        ax.legend()
        fig.tight_layout()
        return self._save(fig, name)

    def switching_phase_diagram(self, diagram: Dict, name: str = "phase_diagram"):
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4.5))
        ax.pcolormesh(
            np.degrees(_np(diagram["angles"])),
            _np(diagram["fields"]) / float(diagram["anisotropy_field"]),
            _np(diagram["bistable"]).astype(float),
            shading="auto", cmap="RdYlGn",
        )
        ax.set_xlabel("field angle (deg)")
        ax.set_ylabel("H / H_k")
        ax.set_title("Bistability (Stoner-Wohlfarth)")
        fig.tight_layout()
        return self._save(fig, name)
