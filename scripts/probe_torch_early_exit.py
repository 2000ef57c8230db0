#!/usr/bin/env python3
"""What a fused major costs when its LSQR stops early, at the smoke shape of
chip_smoke.py (4096 observations x 262144 cells, tiled, float32 solve, 3
majors x 20 LSQR iterations): for each `inversion.minResidual` given, the
host-driven solve and the `--fused 3` solve of the same Parfile from one
tiled cache, through the library entry point, with each major's seconds,
LSQR iterations a major, and the fused model against the host-driven one.
It also says whether this torch can put a CUDA conditional node in a
captured graph (torch.cuda.CUDAGraph.begin_capture_to_if_node), and checks
one such node on the card (and what torch.profiler sees of its replays).

    python3 scripts/probe_torch_early_exit.py [--rmin 0.1 0.05 ...]

Needs one CUDA device; prints one JSON line last."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

CONDITIONAL_API = ("get_currently_capturing_graph", "begin_capture_to_if_node", "end_capture_to_conditional_node")


def conditional_nodes():
    """Whether torch.cuda.CUDAGraph has the conditional-node calls, and, if
    it has, one IF node replayed with its flag true and false: the body adds
    a tensor it allocates to a buffer made before the node."""
    have = {name: hasattr(torch.cuda.CUDAGraph, name) for name in CONDITIONAL_API}
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "has": have}
    if not all(have.values()):
        return out
    buf = torch.zeros(4, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        g = torch.cuda.CUDAGraph.get_currently_capturing_graph()
        g.begin_capture_to_if_node(flag)
        buf.add_(torch.arange(4, device="cuda", dtype=torch.float32) + 1.0)
        g.end_capture_to_conditional_node()
    got = []
    for f in (True, False, True):
        flag.fill_(f)
        graph.replay()
        torch.cuda.synchronize()
        got.append(buf.tolist())
    out["replays"] = got
    out["works"] = got == [[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0], [2.0, 4.0, 6.0, 8.0]]
    # What torch.profiler sees of a replay whose node runs and of one whose node is skipped.
    for f in (True, False):
        flag.fill_(f)
        out[f"profiled_kernels_flag_{f}"] = smoke.cuda_kernel_events(graph.replay)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rmin", type=float, nargs="+", default=[0.3, 0.2, 0.1, 0.05, 0.02])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    smi = smoke.nvidia_smi_line()
    print(smi)
    out = {"device": smi, "conditional_nodes": conditional_nodes()}
    print(json.dumps(out["conditional_nodes"]))
    work = tempfile.mkdtemp(prefix="early_exit_")
    try:
        inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE)
        cache_run = os.path.join(work, "out_cache")
        pf = smoke.write_parfile(work, "Parfile_cache.txt", inputs, cache_run, 1, fmt="tiled", n_major=1)
        t0 = time.time()
        solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda")
        print(f"tiled cache written in {time.time() - t0:.1f} s")
        cache = [f"sensit.readFromFiles = 1", f"sensit.folderPath = {cache_run}/SENSIT/"]
        runs = []
        for rmin in args.rmin:
            row = {"minResidual": rmin}
            for how, chunk in (("host", 0), ("fused", smoke.FUSED_M)):
                d = os.path.join(work, f"out_{how}_{rmin}")
                pf = smoke.write_parfile(work, f"Parfile_{how}_{rmin}.txt", inputs, d, smoke.N_MINOR, fmt="tiled",
                                         extra=cache + [f"inversion.minResidual = {rmin}"])
                torch.cuda.synchronize()
                res = solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda",
                                                  fused_chunk=chunk)
                torch.cuda.synchronize()
                t = res.timings
                r = {"lsqr_iterations": list(t["lsqr_iters"]), "solve_s": list(t["solve_s"]),
                     "data_cost": [row_[1] for row_ in smoke.read_costs(os.path.join(d, "costs.txt"))]}
                if chunk:
                    # The chunk's seconds less its capture (warm-up step included).
                    r["capture_s"] = t.get("capture_s", 0.0)
                    r["major_s"] = (sum(t["solve_s"]) - r["capture_s"]) / smoke.N_MAJOR
                else:
                    r["major_s"] = list(t["solve_s"])
                r["model"] = np.asarray(res.models[min(res.models)].val)
                row[how] = r
            m, h = row["fused"].pop("model"), row["host"].pop("model")
            row["fused_against_host_model_of_range"] = float(np.abs(m - h).max() / (h.max() - h.min()))
            print(json.dumps(row))
            runs.append(row)
        out["runs"] = runs
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
