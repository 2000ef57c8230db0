"""The coupled configuration's constraint weights by the row-scale rule,
from the reference's float64 kernels (a frozen copy of `chip_smoke.py`'s
`coupling_weights`, as it was):

    python3 -m portbench.weights --config joint_coupled_262k

Each constraint row's largest coefficient is at most ROW_SCALE times the RMS
column norm of its problem's weighted data block (problem weight x ||S||_F /
sqrt(N)). The coefficients are bounded by the largest column weight and: for
the damping gradient, problem weight x beta / the shortest cell side; for
the cross-gradient, weight x the other model's steepest gradient (the true
model's range over the shortest side); for the clustering, weight x the
mixture's largest derivative over the models' ranges. Prints the weights and
the scales they came from; the configuration file holds what it printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from portbench import traffic
from portbench.reference import inversion as reference
from portbench.reference.parfile import read_parfile
from portbench.run import load_json

ROW_SCALE = 0.1


def coupling_weights(config, device):
    size = config["grid"]["size"]
    N = int(np.prod(size))
    with tempfile.TemporaryDirectory(prefix="portbench-weights-") as work:
        files, arrays = traffic.write_inputs(work, config, 0)
        parfile = traffic.write_parfile(os.path.join(work, "Parfile.txt"), config, files, work, 1, 1)
        cfg = read_parfile(parfile)
    pw = cfg.inversion.problem_weight
    cells = reference.lattice_cells(arrays["edges"])
    rms, cw_max = [], []
    for i in (0, 1):
        par = cfg.problem_params(i)
        cw = cfg.inversion.column_weight_multiplier[i] * reference.depth_weight(par, cells, arrays["points"], device)
        S = reference.build_kernel(par, arrays["edges"], arrays["points"], cw, size, torch.float64, device)
        rms.append(pw[i] * float(torch.linalg.vector_norm(S)) / np.sqrt(N))
        cw_max.append(float(cw.max()))
        del S
    dmin = float(min(np.diff(e).min() for e in arrays["edges"]))
    ranges = [max(b["density"] for b in config["model"]["blocks"])]
    ranges.append(ranges[0] * config["model"]["susceptibility_per_density"])
    grad = [r / dmin for r in ranges]
    deriv = [0.0, 0.0]
    for _, _, s11, _, s22, s12 in config["mixture"]:
        det = abs(s12**4 - s11**2 * s22**2)
        deriv[0] = max(deriv[0], (s22**2 * ranges[0] + s12**2 * ranges[1]) / det)
        deriv[1] = max(deriv[1], (s12**2 * ranges[0] + s11**2 * ranges[1]) / det)
    target = [ROW_SCALE * r for r in rms]
    weights = {
        "beta": [target[i] * dmin / (pw[i] * cw_max[i]) for i in (0, 1)],
        "cross_gradient": min(target[0] / (cw_max[0] * grad[1]), target[1] / (cw_max[1] * grad[0])),
        "clustering": [target[i] / (cw_max[i] * deriv[i]) for i in (0, 1)],
    }
    scales = {"rms_column": rms, "cw_max": cw_max, "shortest_side": dmin, "gradient_bound": grad,
              "mixture_derivative_bound": deriv}
    return weights, scales


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = load_json("configs", args.config)
    weights, scales = coupling_weights(config, args.device)
    print(json.dumps({"weights": weights, "scales": scales, "in_the_config": config.get("coupling_weights")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
