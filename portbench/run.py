"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the program (`tomofastx_tpu_torch`),
`BENCHMARK.json` and this folder. The cell is found by name in
`BENCHMARK.json`; its workload file (`portbench/workloads/<cell>.json`), its
configuration (`portbench/configs/<config>.json`) and each metric's reader
(`portbench/metrics/<metric>.py`) are found by their names, so a cell, a
configuration or a metric is added by adding files.

The run needs CUDA cards, as many as the cell asks for, and exits with 2
without printing a result where they are missing; it never falls back to
the CPU. `--trace 0` measures the cell's end-to-end metrics; `--trace 1`
runs one more inversion after the window under torch.profiler (a fused one
up to its fused loop) and reports the per-layer metrics (the program's spans
read from the window's untraced inversions, the device's from the traced
one). Both
check every inversion of the window against the reference (check.py) once
the window has closed, print each number compared beside its limit as the
last lines of standard error, and print the result as one JSON line, last
on standard output.
"""

from __future__ import annotations

import time

T0 = time.time()  # the process's start, as near as Python code can read it

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tomofastx_tpu")
PROGRAM = "tomofastx_tpu_torch"


def load_json(kind, name, root=HERE):
    """`portbench/<kind>/<name>.json`: a configuration or a workload by name."""
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path} for {name!r}")
    with open(path) as f:
        return json.load(f)


def load_metric(name, root=HERE):
    """The reader of metric `name`: `read(run)` of `portbench/metrics/<name>.py`."""
    path = os.path.join(root, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader {path} for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench, cell, trace):
    """The metric entries a run of `cell` reports: with trace 0 the end-to-end
    ones, with trace 1 the per-layer ones, each where its `workloads` list
    names the cell or, without the list, wherever it applies."""
    name = cell["name"]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return end_to_end
    reported = {m["name"] for m in end_to_end}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported)]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric's reader reads: the cell, the set-up, the window and its
    untraced inversions and, in a traced run, the trace and products of the
    one inversion traced after the window."""

    cell: dict
    workload: dict
    config: dict
    seed: int
    setup_s: float
    window: object
    inversions: list
    arrays: dict
    trace: object = None
    products: object = None


def parts(timings):
    """One inversion's seconds by the program's spans: the inputs read, the
    builds, the depth weights, the solve (the capture in it, where fused),
    and the rest (synthetic data, costs, outputs)."""
    solve = sum(timings.get("solve_s", []))
    known = timings.get("read_inputs_s", 0.0) + timings.get("build_s", 0.0) + timings.get("depth_weight_s", 0.0)
    return {"read": timings.get("read_inputs_s"), "build": timings.get("build_s"),
            "depth_weight": timings.get("depth_weight_s"), "solve": solve, "capture": timings.get("capture_s"),
            "rest": timings.get("total_s", 0.0) - known - solve}


def run_cell(root, bench, cell, seed, seconds, trace, device="cuda"):
    """Set-up, window and comparison of one run; returns the result line's
    dict (with `each_s`, each inversion's seconds, which main prints apart)."""
    import numpy as np
    import torch

    from portbench import check
    from portbench import trace as tracing
    from portbench.reference import inversion as reference
    from portbench.window import Cell

    workload = load_json("workloads", cell["name"], os.path.join(root, "portbench"))
    config = load_json("configs", workload["config"], os.path.join(root, "portbench"))
    metrics = cell_metrics(bench, cell, trace)
    readers = {m["name"]: load_metric(m["name"], os.path.join(root, "portbench")) for m in metrics}
    work = tempfile.mkdtemp(prefix="portbench-")
    on_card = torch.device(device).type == "cuda"
    fused = int(workload.get("fused", 0)) > 0
    try:
        c = Cell(work, config, workload, seed, device)
        try:
            c.warm_up()
            setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
            setup_s = time.time() - T0
            w = c.window(seconds)
            untraced = list(w.inversions)
            traced = {}
            if trace:
                # One more inversion, traced after the window: the window's own
                # stay untraced, and the program's spans are read from them.
                stop_on = (importlib.import_module(f"{PROGRAM}.inversion.workflow"), "make_fused_solver") \
                    if fused and on_card else None

                def traced_solve():
                    inv, traced["trace"] = tracing.profiled(c.solve, stop_on)
                    return inv

                with tracing.spans() as traced["products"]:
                    c.attempt(w, traced_solve)
        finally:
            c.close()
        run = Run(cell=cell, workload=workload, config=config, seed=seed, setup_s=setup_s, window=w,
                  inversions=untraced, arrays=c.arrays, trace=traced.get("trace"), products=traced.get("products"))
        values = {m["name"]: readers[m["name"]](run) for m in metrics}
        result = {
            "correct": False,
            "attempted": w.attempted,
            "failed": w.failed,
            "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in metrics
                        if values[m["name"]] is not None},
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": int(max(setup_peak, w.peak_bytes))},
        }
        if run.trace is not None:
            result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
        run.trace = run.products = None  # the trace's events go before the reference runs
        traced.clear()
        if on_card:
            torch.cuda.empty_cache()
        ref = reference.invert(c.parfile, c.arrays, device=device, mixture=config.get("mixture"))
        numbers = check.numbers(w.inversions, ref)
        correct, held = check.judge(numbers, workload["checks"])
        result["correct"] = bool(correct and w.failed == 0 and len(w.inversions) > 0)
        result["each_s"] = [round(t, 4) for t in w.each_s]
        result["each_parts"] = [parts(inv.timings) for inv in w.inversions]
        result["checks"] = {k: {"value": v if np.isfinite(v) else None, "limit": lim} for k, (v, lim) in held.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or os.path.commonpath([os.path.abspath(spec.origin), root]) != root:
        print(f"portbench: the program {PROGRAM} is not in this checkout ({root})", file=sys.stderr)
        return 2

    result = run_cell(root, bench, cell, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"each inversion's seconds: {result.pop('each_s')}", file=sys.stderr)
    print("each inversion's parts (s): " + json.dumps(
        [{k: None if v is None else round(v, 4) for k, v in p.items()} for p in result.pop("each_parts")]),
        file=sys.stderr)
    for name, c in result["checks"].items():
        limit = "not held" if c["limit"] is None else f"limit {c['limit']:.6g}"
        print(f"check {name} = {c['value']} ({limit})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
