"""Visualization: publication-style plots over the engine's outputs.

PyTorch counterpart of ``spintorque_tpu/visualization``. Matplotlib is
imported lazily; tensors are copied to the host, and nothing here runs on
the card.
"""

from .plots import (
    SpintronicVisualizer,
    plot_energy_surface,
    plot_switching_diagram,
    plot_trajectory,
)
from .research_plots import QuantumSpintronicVisualizer

__all__ = [
    "SpintronicVisualizer",
    "plot_energy_surface",
    "plot_switching_diagram",
    "plot_trajectory",
    "QuantumSpintronicVisualizer",
]
