"""The benchmark is driven by data: every configuration, workload and
metric is a file found by its name, and one added as files is picked up
without an edit to any file the benchmark has."""

from __future__ import annotations

import json
import os
import re

from portbench import run
from portbench.tests.conftest import REPO, cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_named_file_is_found():
    b = bench()
    for c in b["configs"]:
        assert run.load_json("configs", c["name"])["name"] == c["name"]
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        wl = run.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(run.load_metric(m["name"]))


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == configs
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        reported = [m["name"] for m in b["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_cell_metrics_follow_the_workloads_lists():
    b = bench()
    lattice = [m["name"] for m in run.cell_metrics(b, cell(b, "draped_lattice.host"), 0)]
    assert lattice == ["inversion_s", "setup_s"]
    fused = [m["name"] for m in run.cell_metrics(b, cell(b, "joint_coupled.fused"), 1)]
    assert "capture_s" in fused and "lattice_op_roofline_pct" not in fused


def test_a_config_cell_and_metric_added_as_files_are_picked_up(tiny_root):
    root, b = tiny_root
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "grav_draped_lattice_262k.json").read_text())
    config["name"] = "grav_draped_lattice_added"
    (pb / "configs" / "grav_draped_lattice_added.json").write_text(json.dumps(config))
    workload = json.loads((pb / "workloads" / "draped_lattice.host.json").read_text())
    workload.update(name="added.host", config="grav_draped_lattice_added")
    (pb / "workloads" / "added.host.json").write_text(json.dumps(workload))
    (pb / "metrics" / "inversions_done.py").write_text(
        "def read(run):\n    return float(len(run.window.inversions))\n")
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file() and "added" not in p.name
              and p.name != "inversions_done.py"}
    b["configs"].append(dict(b["configs"][0], name="grav_draped_lattice_added",
                             file="portbench/configs/grav_draped_lattice_added.json"))
    b["workloads"].append({"name": "added.host", "config": "grav_draped_lattice_added", "traffic": "added.host",
                           "chips": 1, "why": workload["why"]})
    b["end_to_end"].append({"name": "inversions_done", "unit": "count", "better": "higher", "bound": 0.01,
                            "source": "host_clock", "workloads": ["added.host"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    result = run.run_cell(str(root), b, cell(b, "added.host"), 7, 0.1, 0, device="cpu")
    assert result["metrics"]["inversions_done"]["value"] >= 1.0
    assert set(result["metrics"]) == {"inversion_s", "setup_s", "inversions_done"}
    assert all(p.read_bytes() == data for p, data in before.items())
