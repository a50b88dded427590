"""Switching-probability phase diagram over a (current, duration) grid.

PyTorch counterpart of examples/switching_diagram.py. The whole grid x
thermal ensemble (16 x 16 x 64 = 16,384 trajectories) runs as one batch
through the pulse kernel, on the mesh of this process's ranks (one card in
a plain run). Prints an ASCII diagram and writes build/switching_diagram.json.

Run: python examples/torch/switching_diagram.py [--device cpu]
"""

import os as _os
import sys as _sys

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _ROOT)

import argparse
import json
import math
import time

import torch

from spintorque_tpu_torch.parallel import make_mesh
from spintorque_tpu_torch.physics import params_from_dict
from spintorque_tpu_torch.research import switching_probability_diagram
from spintorque_tpu_torch.utils.host import card_line

DEVICE = dict(saturation_magnetization=800e3, damping=0.05, uniaxial_anisotropy=1.2e6,
              volume=1e-22, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])
SHADES = " .:-=+*#%@"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grid", type=int, default=16, help="currents and durations each")
    ap.add_argument("--ensemble", type=int, default=64)
    ap.add_argument("--out", default=_os.path.join("build", "switching_diagram.json"))
    args = ap.parse_args(argv)

    mesh = make_mesh(device=args.device)  # the batch's shards over this process's ranks
    params = params_from_dict(DEVICE, device=mesh.device)
    currents = torch.linspace(-4e6, 0.0, args.grid)  # threshold sits near -2e6 A/m^2
    durations = torch.linspace(1e-10, 2e-9, args.grid)

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = switching_probability_diagram(params, currents, durations,
                                        n_ensemble=args.ensemble, temperature=300.0, seed=0,
                                        mesh=mesh)
    p = out["p_switch"].cpu().tolist()  # waits for the card
    wall = time.perf_counter() - t0
    n_traj = args.grid * args.grid * args.ensemble
    where = card_line() if mesh.device.type == "cuda" else "cpu"
    print(f"{n_traj} thermal trajectories in {wall:.3f} s -> {n_traj / wall:,.0f} "
          f"trajectories/s on {mesh.shape['data']} rank(s)  [{where}]\n")

    print("P(switch)  duration ->  {:.1e} .. {:.1e} s".format(float(durations[0]),
                                                           float(durations[-1])))
    for j, row in zip(currents.tolist(), p):
        # '?' marks a grid point whose whole ensemble failed (p is NaN there).
        line = "".join("?" if not math.isfinite(v)
                       else SHADES[min(int(v * (len(SHADES) - 1)), len(SHADES) - 1)]
                       for v in row)
        print(f"J={j:+.2e}  |{line}|")

    record = {"currents": currents.tolist(), "durations": durations.tolist(),
              "p_switch": [[v if math.isfinite(v) else None for v in row] for row in p]}
    _os.makedirs(_os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=2)
    print(f"\nwrote {args.out}")
    return {"p_switch": p, "failed_fraction": out["failed_fraction"].cpu().tolist(),
            "trajectories": n_traj, "wall_s": wall,
            "trajectories_per_s": n_traj / wall, "path": args.out, "where": where}


if __name__ == "__main__":
    main()
