"""Quantum-research figures: advantage comparisons, landscapes, convergence.

PyTorch counterpart of ``spintorque_tpu/visualization/research_plots.py``:
figures of the quantum and research tier's outputs (verified-advantage
reports, error-correction rates, VQE histories, hybrid trajectories).
Inputs may be numpy arrays or torch tensors on any device (copied to the
host first); matplotlib is imported when a figure is made.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..utils.host import as_numpy

__all__ = ["QuantumSpintronicVisualizer"]


def _np(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a sequence) as numpy."""
    return np.asarray(as_numpy(x), dtype)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class QuantumSpintronicVisualizer:
    """Figure factory for the quantum/research tier."""

    def __init__(self, output_dir: Optional[str | Path] = None, dpi: int = 150):
        self.output_dir = Path(output_dir) if output_dir else None
        self.dpi = dpi

    def _finish(self, fig, name: str):
        if self.output_dir is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            path = self.output_dir / f"{name}.png"
            fig.savefig(path, dpi=self.dpi, bbox_inches="tight")
            _plt().close(fig)
            return str(path)
        return fig

    def plot_advantage_comparison(
        self, reports: Sequence[Any], name: str = "advantage"
    ):
        """Bar chart of AdvantageReport speedups/quality deltas with CIs."""
        plt = _plt()
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        labels = [getattr(r, "claim", str(i))[:28] for i, r in enumerate(reports)]
        speed = [r.speedup for r in reports]
        s_err = _np(
            [(r.speedup - r.speedup_ci[0], r.speedup_ci[1] - r.speedup)
             for r in reports]
        ).T
        axes[0].bar(labels, speed, yerr=np.abs(s_err), capsize=4)
        axes[0].axhline(1.0, ls="--", c="gray")
        axes[0].set_ylabel("speedup (x)")
        axes[0].tick_params(axis="x", rotation=20)
        quality = [r.quality_delta for r in reports]
        q_err = _np(
            [(r.quality_delta - r.quality_delta_ci[0],
              r.quality_delta_ci[1] - r.quality_delta) for r in reports]
        ).T
        axes[1].bar(labels, quality, yerr=np.abs(q_err), capsize=4, color="tab:green")
        axes[1].axhline(0.0, ls="--", c="gray")
        axes[1].set_ylabel("quality delta")
        axes[1].tick_params(axis="x", rotation=20)
        for ax, rep in ((axes[0], reports), (axes[1], reports)):
            ax.grid(axis="y", alpha=0.3)
        fig.suptitle("Verified performance comparison")
        return self._finish(fig, name)

    def plot_error_correction(
        self,
        physical_rates: Sequence[float],
        logical_rates: Dict[str, Sequence[float]],
        name: str = "error_correction",
    ):
        """Log-log physical vs logical error rates per code."""
        plt = _plt()
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        p = _np(physical_rates, float)
        ax.loglog(p, p, "k--", label="unencoded")
        for label, rates in logical_rates.items():
            ax.loglog(p, _np(rates, float), "o-", label=label)
        ax.set_xlabel("physical error rate p")
        ax.set_ylabel("logical error rate")
        ax.legend()
        ax.grid(which="both", alpha=0.3)
        return self._finish(fig, name)

    def plot_vqe_convergence(
        self, histories: Dict[str, Sequence[float]],
        exact_minimum: Optional[float] = None, name: str = "vqe",
    ):
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        for label, h in histories.items():
            ax.plot(_np(h, float), label=label)
        if exact_minimum is not None:
            ax.axhline(exact_minimum, ls="--", c="red", label="exact minimum")
        ax.set_xlabel("iteration")
        ax.set_ylabel("energy")
        ax.legend()
        ax.grid(alpha=0.3)
        return self._finish(fig, name)

    def plot_energy_landscape_3d(
        self, theta: np.ndarray, phi: np.ndarray, energy: np.ndarray,
        minima: Optional[np.ndarray] = None, name: str = "landscape3d",
    ):
        """3-D energy surface over (theta, phi), with optional minima marks.

        energy: (len(theta), len(phi)) grid (host array).
        """
        plt = _plt()
        fig = plt.figure(figsize=(7, 5))
        ax = fig.add_subplot(projection="3d")
        tt, pp = np.meshgrid(_np(theta), _np(phi), indexing="ij")
        ax.plot_surface(tt, pp, _np(energy), cmap="viridis", alpha=0.9)
        if minima is not None:
            minima = np.atleast_2d(_np(minima))
            ax.scatter(
                minima[:, 0], minima[:, 1], minima[:, 2],
                c="red", s=40, label="minima",
            )
            ax.legend()
        ax.set_xlabel(r"$\theta$")
        ax.set_ylabel(r"$\phi$")
        ax.set_zlabel("E (J)")
        return self._finish(fig, name)

    def plot_qaoa_angle_landscape(
        self, gammas: np.ndarray, betas: np.ndarray, values: np.ndarray,
        best: Optional[Sequence[float]] = None, name: str = "qaoa_angles",
    ):
        """Heatmap of the p=1 QAOA cost expectation over the angle grid."""
        plt = _plt()
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        im = ax.pcolormesh(
            _np(betas), _np(gammas),
            _np(values).reshape(len(gammas), len(betas)),
            shading="auto", cmap="magma",
        )
        fig.colorbar(im, ax=ax, label="cost expectation")
        if best is not None:
            ax.plot(best[1], best[0], "c*", ms=14, label="selected")
            ax.legend()
        ax.set_xlabel(r"$\beta$")
        ax.set_ylabel(r"$\gamma$")
        return self._finish(fig, name)

    def plot_hybrid_trajectory(
        self, trajectory: np.ndarray, z_expectations: Optional[np.ndarray] = None,
        name: str = "hybrid",
    ):
        """Device alignments over hybrid rounds, optionally with <Z_i>."""
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        traj = _np(trajectory)  # (T, n_devices, 3)
        for d in range(traj.shape[1]):
            ax.plot(traj[:, d, 2], label=f"device {d} $m_z$")
        if z_expectations is not None:
            z = np.atleast_2d(_np(z_expectations))
            for d in range(z.shape[1]):
                ax.plot(z[:, d], "--", alpha=0.6, label=f"device {d} $\\langle Z\\rangle$")
        ax.set_xlabel("hybrid round")
        ax.set_ylabel("alignment")
        ax.legend(ncol=2, fontsize=8)
        ax.grid(alpha=0.3)
        return self._finish(fig, name)
