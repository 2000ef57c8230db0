"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes)."""

from __future__ import annotations

import copy
import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shrink(config, majors=2, minors=10):
    """A configuration cut to a 16 x 16 x 8 lattice under 64 observations."""
    c = copy.deepcopy(config)
    c["grid"]["size"] = [16, 16, 8]
    c["survey"]["side"] = 8
    c["model"]["blocks"] = [{"size": [4, 4, 3], "density": 250.0}, {"size": [6, 6, 4], "density": 100.0}]
    c["parfile"] = [line.replace("64 64 64", "16 16 8").replace("nData = 4096", "nData = 64")
                    for line in c["parfile"]]
    c["inversion"] = {"majors": majors, "minors": minors}
    return c


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ whose configurations are cut
    to a tiny size; returns (root, BENCHMARK.json's content)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root / "BENCHMARK.json")
    for path in (root / "portbench" / "configs").glob("*.json"):
        path.write_text(json.dumps(shrink(json.loads(path.read_text()))))
    return root, json.loads((root / "BENCHMARK.json").read_text())


def cell(bench, name):
    return next(w for w in bench["workloads"] if w["name"] == name)
