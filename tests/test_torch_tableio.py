"""Port parity of the native table reader and writer on the CPU
(io/tableio.py over io/_native/fasttab.cpp): fuzzed tables written by both
packages byte for byte and read back to the last bit, the library's place
in build/, and the numpy path where the library cannot be built."""

import os

import numpy as np
import pytest

from tomofastx_tpu.io import tableio as jtab

from tomofastx_tpu_torch.io import _native
from tomofastx_tpu_torch.io import tableio as ttab

FORMATS = ["%.9E", "%.3f", "%.17g", "%.6f %.6f %.6f %.6f %.6f %.6f %d %d %d", "%d"]


def fuzzed(seed, fmt):
    """A table of a random shape and scale; integers where fmt has %d."""
    rng = np.random.default_rng(seed)
    ncols = len(fmt.split()) if len(fmt.split()) > 1 else int(rng.integers(1, 8))
    nrows = int(rng.integers(1, 400))
    a = rng.normal(size=(nrows, ncols)) * 10.0 ** rng.integers(-12, 12, size=(1, ncols))
    specs = fmt.split() if len(fmt.split()) > 1 else [fmt] * ncols
    for c, s in enumerate(specs):
        if s == "%d":
            a[:, c] = np.round(a[:, c] % 1000.0)
    return a


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", FORMATS)
def test_save_and_load_match_jax_and_numpy(tmp_path, fmt, seed):
    """save_table byte-identical to the JAX package's and to np.savetxt
    (header line included); load_table equal to the last bit to the JAX
    package's and to np.loadtxt."""
    a = fuzzed(seed, fmt)
    header = None if seed % 2 else f" {a.shape[0]}"
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("port", "jax", "numpy")}
    ttab.save_table(paths["port"], a, fmt=fmt, header=header)
    jtab.save_table(paths["jax"], a, fmt=fmt, header=header)
    with open(paths["numpy"], "w") as f:
        if header is not None:
            f.write(header + "\n")
        np.savetxt(f, a, fmt=fmt)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"] == data["numpy"]
    skip = 0 if header is None else 1
    got = ttab.load_table(paths["port"], skiprows=skip)
    np.testing.assert_array_equal(got, jtab.load_table(paths["jax"], skiprows=skip))
    np.testing.assert_array_equal(got, np.loadtxt(paths["numpy"], skiprows=skip, ndmin=2))


def test_comments_blank_lines_and_one_column(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("3\n# a comment\n1.5 2.5\n\n 3.5\t4.5 # trailing\r\n5e-3 -6E+2\n")
    for mod in (ttab, jtab):
        np.testing.assert_array_equal(mod.load_table(str(p), skiprows=1), [[1.5, 2.5], [3.5, 4.5], [5e-3, -6e2]])
    q = tmp_path / "one.txt"
    q.write_text("1\n2\n3\n")
    assert ttab.load_table(str(q), ndmin=1).shape == (3,) and ttab.load_table(str(q)).shape == (3, 1)


def test_the_library_is_built_into_build_not_beside_its_source():
    assert _native.lib() is not None, _native.build_error()
    path = _native.library_path()
    assert os.path.dirname(path) == _native.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "build"
    assert not [f for f in os.listdir(os.path.dirname(_native.SOURCE)) if f.endswith(".so")]


def test_without_the_library_tables_go_through_numpy_and_it_is_said_once(tmp_path, monkeypatch, capsys):
    a = fuzzed(9, "%.9E")
    ttab.save_table(str(tmp_path / "native.txt"), a, header=" 7")
    monkeypatch.setattr(_native, "lib", lambda: None)
    monkeypatch.setattr(_native, "build_error", lambda: "g++ failed (1): no compiler")
    monkeypatch.setattr(ttab, "_reported", False)
    ttab.save_table(str(tmp_path / "numpy.txt"), a, header=" 7")
    got = ttab.load_table(str(tmp_path / "numpy.txt"), skiprows=1)
    ttab.load_table(str(tmp_path / "native.txt"), skiprows=1)
    err = capsys.readouterr().err
    assert err.count("native table reader is unavailable (g++ failed (1): no compiler)") == 1
    assert (tmp_path / "native.txt").read_bytes() == (tmp_path / "numpy.txt").read_bytes()
    np.testing.assert_array_equal(got, np.loadtxt(tmp_path / "numpy.txt", skiprows=1))
