"""Research tooling: the mesh-sharded switching and parameter sweeps.

PyTorch counterpart of ``spintorque_tpu/research``; only ``sweeps`` is
ported so far.
"""

from .sweeps import parameter_ladder_sweep, switching_probability_diagram

__all__ = ["parameter_ladder_sweep", "switching_probability_diagram"]
