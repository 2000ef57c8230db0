#!/usr/bin/env python3
"""What a fused major costs, with and without LSQR stopping early, at the
smoke shape of chip_smoke.py (4096 observations x 262144 cells, float32
solve, 3 majors x 20 LSQR iterations): for each `inversion.minResidual`
given and each format (tiled from one tiled cache, BTTB, bfloat16 dense), the
host-driven solve and the `--fused 3` solve of the same Parfile, through the
library entry point, with each major's seconds at full precision, LSQR
iterations a major, the WHILE node's body runs a major (fused) and the final
data cost. It first checks the port's WHILE node alone (ops/graph_while.py,
chip_smoke.while_node: loops of k body runs, a flag false at once and one
that never falls) and what torch.profiler sees of it.

With --parent-dir DIR (an unpacked earlier tree of the repository, e.g.
`git archive <commit> | tar -x -C build/parent`) the solves run in turns in
processes of their own: DIR's package, this one's, this one's, DIR's; so
two versions of the fused loop compare on one card.

    python3 scripts/probe_torch_early_exit.py [--rmin 0.2 1e-13] [--formats tiled bttb bf16]
    python3 scripts/probe_torch_early_exit.py --rmin 0.2 1e-13 --parent-dir build/parent

Needs one CUDA device; prints one JSON line last."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each format's tpu.kernelFormat (None: the default, dense), compression type
# and further Parfile lines (None: those that read the tiled cache).
FORMATS = {"tiled": ("tiled", 1, None), "bttb": ("matrixfree", 0, []),
           "bf16": (None, 1, ["tpu.kernelStoreDtype = bfloat16"])}


def conditional_nodes():
    """The port's WHILE node on the card (chip_smoke.while_node), with the
    torch and CUDA it ran under."""
    import torch

    import chip_smoke as smoke

    return {"torch": torch.__version__, "cuda": torch.version.cuda, **smoke.while_node()}


def solves(work, rmins, formats) -> list:
    """Each format's host-driven and fused solves at each minResidual, from
    the inputs and the tiled cache in `work`, by the package first on
    sys.path: their LSQR iterations, body runs, seconds a major and final
    data cost."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    with open(os.path.join(work, "inputs.json")) as f:
        inputs = json.load(f)
    cache = ["sensit.readFromFiles = 1", f"sensit.folderPath = {work}/out_cache/SENSIT/"]
    rows = []
    for fmt in formats:
        kernel_format, compression, extra = FORMATS[fmt]
        for rmin in rmins:
            row = {"format": fmt, "minResidual": rmin}
            for how, chunk in (("host", 0), ("fused", smoke.FUSED_M)):
                d = tempfile.mkdtemp(prefix=f"out_{fmt}_{how}_", dir=work)
                pf = smoke.write_parfile(d, "Parfile.txt", inputs, d, smoke.N_MINOR, fmt=kernel_format,
                                         compression=compression,
                                         extra=(cache if extra is None else extra) + [f"inversion.minResidual = {rmin}"])
                torch.cuda.synchronize()
                res = solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda", fused_chunk=chunk)
                torch.cuda.synchronize()
                t = res.timings
                r = {"lsqr_iterations": list(t["lsqr_iters"]), "solve_s": list(t["solve_s"]),
                     "final_data_cost": float(res.cost_data[0])}
                if chunk:
                    # The chunk's seconds less its capture (warm-up step included).
                    r["capture_s"] = t["capture_s"]
                    r["major_s"] = (sum(t["solve_s"]) - r["capture_s"]) / smoke.N_MAJOR
                    r["lsqr_body_runs"] = list(t.get("lsqr_body_runs", []))
                else:
                    r["major_s"] = sum(t["solve_s"]) / smoke.N_MAJOR
                r["model"] = np.asarray(res.models[0].val)
                row[how] = r
                shutil.rmtree(d, ignore_errors=True)
            m, h = row["fused"].pop("model"), row["host"].pop("model")
            row["fused_against_host_model_of_range"] = float(np.abs(m - h).max() / (h.max() - h.min()))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rmin", type=float, nargs="+", default=[0.3, 0.2, 0.1, 0.05, 0.02])
    ap.add_argument("--formats", nargs="+", default=["tiled"], choices=list(FORMATS))
    ap.add_argument("--parent-dir", help="an earlier tree of the repository, timed in turns with this one")
    ap.add_argument("--side", help=argparse.SUPPRESS)  # one turn: the solves of the tree SIDE in WORK
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        sys.path[:0] = [args.side, REPO]
        print(json.dumps({"rows": solves(args.work, args.rmin, args.formats)}))
        return 0
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    smi = smoke.nvidia_smi_line()
    print(smi)
    out = {"device": smi, "conditional_nodes": conditional_nodes()}
    print(json.dumps(out["conditional_nodes"]))
    work = tempfile.mkdtemp(prefix="early_exit_")
    try:
        inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE)
        with open(os.path.join(work, "inputs.json"), "w") as f:
            json.dump(inputs, f)
        pf = smoke.write_parfile(work, "Parfile_cache.txt", inputs, os.path.join(work, "out_cache"), 1, fmt="tiled",
                                 n_major=1)
        t0 = time.time()
        solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda")
        print(f"tiled cache written in {time.time() - t0:.1f} s")
        if not args.parent_dir:
            out["runs"] = solves(work, args.rmin, args.formats)
        else:
            parent = os.path.abspath(args.parent_dir)
            out["turns"] = []
            for name, tree in (("parent", parent), ("this", REPO), ("this", REPO), ("parent", parent)):
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", tree, "--work", work,
                                       "--rmin", *map(str, args.rmin), "--formats", *args.formats],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
                    return 1
                rows = json.loads(proc.stdout.strip().splitlines()[-1])["rows"]
                out["turns"].append({"tree": name, "rows": rows})
                print(f"{name}: " + "; ".join(
                    f"{r['format']} minResidual {r['minResidual']}: host {r['host']['major_s']:.4f}, fused "
                    f"{r['fused']['major_s']:.4f} s a major, LSQR {r['fused']['lsqr_iterations']}" for r in rows),
                    flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
