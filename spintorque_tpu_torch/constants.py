"""Physical constants shared across the port.

The values are those of ``spintorque_tpu.constants``, which in turn match the
reference implementation. Both Boltzmann constants are kept: the solver hot
path uses the truncated 1.38e-23 (``KB_SOLVER``) while the device analytics
use the CODATA value (``KB``).
"""

import numpy as np

# Gyromagnetic ratio used by the LLGS solvers (m / (A * s)).
GAMMA = 2.21e5

# Permeability of free space (H/m).
MU0 = 4.0 * np.pi * 1e-7

# Boltzmann constant - CODATA value (J/K). Used by device analytics.
KB = 1.380649e-23

# Boltzmann constant - truncated value used inside the solver hot path.
KB_SOLVER = 1.38e-23

# Elementary charge (C).
E_CHARGE = 1.602176634e-19

# Reduced Planck constant (J*s).
HBAR = 1.054571817e-34

# Vacuum permittivity (F/m) - used by the VCMA capacitance model.
EPSILON0 = 8.854e-12
