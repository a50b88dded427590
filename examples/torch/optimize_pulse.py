"""Optimize a switching pulse with the cross-entropy method.

PyTorch counterpart of examples/optimize_pulse.py: population 512, 32
elites, 10 iterations, one pulse-kernel launch per population on the card.

Run: python examples/torch/optimize_pulse.py [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse

from spintorque_tpu_torch.physics import params_from_dict
from spintorque_tpu_torch.research import optimize_switching_pulse

DEVICE = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
              volume=1e-23, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--population", type=int, default=512)
    ap.add_argument("--elites", type=int, default=32)
    ap.add_argument("--iterations", type=int, default=10)
    args = ap.parse_args(argv)

    params = params_from_dict(DEVICE, device=args.device)
    result = optimize_switching_pulse(params, method="cross_entropy",
                                      population=args.population, elites=args.elites,
                                      iterations=args.iterations)
    print(f"best pulse: J={result.best_params['current']:.3e} A/m^2, "
          f"dt={result.best_params['duration']:.3e} s "
          f"(objective {result.best_value:.4f}, {result.n_evaluations} evals)")
    return {"best_value": float(result.best_value),
            "best_params": {k: float(v) for k, v in result.best_params.items()},
            "n_evaluations": int(result.n_evaluations)}


if __name__ == "__main__":
    main()
