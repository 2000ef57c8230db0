#!/usr/bin/env python3
"""What one LSQR iteration of the port's lattice and per-cell matrix-free
operators costs as a CUDA graph, at the smoke shape of chip_smoke.py (4096
observations x 262144 cells, float32): the seconds to capture its products
(matvec + rmatvec) and to end the capture and instantiate the graph, the
graph's kernels, a replay's milliseconds against the same products launched
eagerly, and whether the replay equals them to the last bit.

    python3 scripts/probe_torch_graph_capture.py

Needs one CUDA device. This measurement kept both operators' majors out of
the fused loop's graph while their products were eager loops of tens of
thousands of launches; since their products are kernels B2 and B3, the fused
loop (inversion/joint.py) captures them (PERF.md)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    print(smoke.nvidia_smi_line())
    n, nd = smoke.NX, smoke.NDATA
    work = tempfile.mkdtemp(prefix="graph_capture_")
    out = {}
    try:
        inputs = smoke.write_inputs(work, n, n, n, smoke.SIDE, variants=("draped", "topography"))
        for name, grid_file, data_file in (("lattice", inputs["grid"], inputs["data_draped"]),
                                           ("per-cell", inputs["grid_topo"], inputs["data"])):
            pf = smoke.write_parfile(work, f"Parfile_{name}.txt", dict(inputs, grid=grid_file, data=data_file),
                                     os.path.join(work, name), 1, fmt="matrixfree", compression=0)
            par = read_parfile(pf).grav
            grid = model_io.read_model_grid(grid_file, n, n, n)
            data = data_io.read_data_points(data_file, nd, 1, grid_only=True)
            op = make_matrixfree_kernel(par, grid, data, np.ones(n**3), 1.0, np.ones((nd, 1)), torch.float32,
                                        device="cuda")
            out[name] = {"operator": type(op).__name__,
                         **smoke.graph_of_one_lsqr_iteration(f"{name} at {nd} x {n**3}", op, reps=3)}
            del op
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
