#!/usr/bin/env python3
"""The lattice main path of chip_smoke.py (4096 draped observations x 262144
cells, 3 majors x 20 LSQR iterations) solved four ways on one card, for
several drapes, and how far apart their final models and data costs lie: the
lattice operator in float32 through kernel B3 and through its plain chunk
loop on the card (~70 s of products a solve), the dense uncompressed kernel
in float32, and the dense kernel in float64 (--precision double).

    python3 scripts/probe_torch_lattice_solves.py [--seeds 0 1 2]

Seed 0 is chip_smoke.py's drape (observations 1 to 31 m above the grid, a
sine of x and y); seed s > 0 shifts the sine's phase and scales its height
by numbers drawn from the seed. What it answers: whether the spread between
two float32 solves of different rows comes from kernel B3 or from float32
LSQR at this depth, by whether B3's and the plain loop's distances to the
dense solve swing from drape to drape. Needs one CUDA device and nvcc."""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from tomofastx_tpu_torch import cli  # noqa: E402
from tomofastx_tpu_torch.ops import lattice_matvec as lm  # noqa: E402


def draped_data(work, inputs, seed):
    """The data file of drape `seed` over chip_smoke.py's observation points."""
    if seed == 0:
        return inputs["data_draped"]
    x, y = np.loadtxt(inputs["data"], skiprows=1, usecols=(0, 1), unpack=True)
    rng = np.random.default_rng(seed)
    phase, height = rng.uniform(0.0, 2.0 * np.pi), rng.uniform(15.0, 45.0)
    z = -1.0 - height * (0.5 + 0.5 * np.sin(0.013 * x + 0.021 * y + phase))
    return smoke.write_table(os.path.join(work, f"data_draped_{seed}.txt"), x.size,
                             np.column_stack([x, y, z, np.zeros(x.size)]), "%.3f")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    counters = {"lattice_matvec": lm.lattice_matvec, "lattice_rmatvec": lm.lattice_rmatvec}
    work = tempfile.mkdtemp()
    summary = []
    try:
        inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE, variants=("draped",))
        for seed in args.seeds:
            draped = dict(inputs, data=draped_data(work, inputs, seed))
            runs = {}

            def run(name, fmt, cli_args=()):
                out = os.path.join(work, f"out_{seed}_{name}")
                pf = smoke.write_parfile(work, f"Parfile_{seed}_{name}.txt", draped, out, smoke.N_MINOR, fmt=fmt,
                                         compression=0, extra=["tpu.sensitWriteCache = 0"])
                runs[name] = smoke.run_main_path(cli, counters, f"drape {seed}, {name}", pf, out, {}, args=cli_args,
                                                 sensit_written=False, compression="uncompressed", what="draped")

            run("lattice_f32_b3", "matrixfree")
            with smoke.lattice_products_by_the_plain_loop():
                run("lattice_f32_plain", "matrixfree")
            run("dense_f32", None)
            run("dense_f64", None, cli_args=("--precision", "double"))
            names = list(runs)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    m, r = runs[a]["model"], runs[b]["model"]
                    dm = float(np.abs(m - r).max() / (r.max() - r.min()))
                    ca, cb = runs[a]["data_cost"][-1], runs[b]["data_cost"][-1]
                    summary.append(f"drape {seed}: {a} against {b}: final model {dm:.3e} of the range apart, final "
                                   f"data cost {abs(ca - cb) / cb:.3e} relative ({ca:.6e} against {cb:.6e})")
                    print(summary[-1], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("\n".join(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
