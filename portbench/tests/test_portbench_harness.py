"""The harness fails without a card and never falls back to the CPU; it
fails where the checkout lacks the program; nothing it loads is JAX's or
the JAX package's, and the reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import torch

from portbench import run
from portbench.tests.conftest import REPO, cell


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "draped_lattice.host", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_too_few_cards_exit_without_a_result(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "joint_coupled.host", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_exits_without_a_result(tmp_path, capsys, monkeypatch):
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", "draped_lattice.host", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "draped_lattice.host",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import tomofastx_tpu_torch  # noqa: F401

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tomofastx_tpu.ops", types.ModuleType("tomofastx_tpu.ops"))
    assert run.forbidden_modules() == ["tomofastx_tpu"]


CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body, cwd=REPO):
    proc = subprocess.run([sys.executable, "-c", CHILD.format(repo=REPO, body=body)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax(tiny_root):
    root, _ = tiny_root
    body = (f"from portbench import run\nb = json.load(open({str(root / 'BENCHMARK.json')!r}))\n"
            "c = next(w for w in b['workloads'] if w['name'] == 'joint_coupled.host')\n"
            f"r = run.run_cell({str(root)!r}, b, c, 3, 0.1, 1, device='cpu')\nassert r['attempted'] >= 1")
    assert not loaded(body) & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = ["portbench.reference." + f[:-3] for f in os.listdir(os.path.join(REPO, "portbench", "reference"))
             if f.endswith(".py") and f != "__init__.py"]
    found = loaded("import importlib\n" + "\n".join(f"importlib.import_module({n!r})" for n in names))
    assert not found & (set(run.FORBIDDEN) | {run.PROGRAM})


def test_a_tiny_cpu_run_of_each_cell(tiny_root):
    root, b = tiny_root
    for name in ("draped_lattice.host", "joint_coupled.fused"):
        r = run.run_cell(str(root), b, cell(b, name), 11, 0.1, 0, device="cpu")
        assert r["failed"] == 0 and r["attempted"] >= 1
        assert set(r["metrics"]) >= {"inversion_s", "setup_s"}
        assert list(r)[-1] == "checks" and r["checks"]["synthetic"]["value"] < 1e-6
