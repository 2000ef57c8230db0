"""The inputs come from the seed alone: one seed gives the same bytes, two
seeds different models over the same geometry."""

from __future__ import annotations

import hashlib

from portbench import run, traffic
from portbench.tests.conftest import shrink


def digests(work, config, seed):
    files, _ = traffic.write_inputs(str(work), config, seed)
    return {k: hashlib.sha256(open(p, "rb").read()).hexdigest() for k, p in files.items()}


def test_one_seed_same_bytes_two_seeds_other_models(tmp_path):
    for name in ("grav_draped_lattice_262k", "joint_coupled_262k"):
        config = shrink(run.load_json("configs", name))
        a = digests(tmp_path / "a", config, 2**31 + 17)
        b = digests(tmp_path / "b", config, 2**31 + 17)
        c = digests(tmp_path / "c", config, 5)
        assert a == b
        assert a["synth"] != c["synth"] and a["synth_mag"] != c["synth_mag"]
        assert a["grid"] == c["grid"] and a["data"] == c["data"]


def test_every_seed_gives_the_same_sizes():
    config = run.load_json("configs", "joint_coupled_262k")
    for seed in (0, 1, 2**31 + 3, -4):
        rho, chi = traffic.true_models(config, seed)
        assert rho.size == 64**3 and (rho == 250.0).sum() > 0 and (rho == 100.0).sum() > 0
        assert set(rho.tolist()) <= {0.0, 100.0, 250.0}
