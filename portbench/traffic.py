"""The one generator of the benchmark's inputs: the model grid, the survey,
the true models, the clustering mixture and the Parfile of a cell, written
from its configuration file, its workload file and the seed.

The recipe is a frozen copy of `chip_smoke.py`'s `write_inputs`,
`block_model`, `write_parfile` and `write_coupling_files` (the mixture):
a lattice of cells longer in x than in y, observations above the centres of
a sub-lattice (flat, or draped over a smooth surface), and a model of two
blocks of the ADMM lithologies in a background of 0. The seed moves the
blocks and nothing else, so every seed gives the same sizes, the same
geometry and the same amount of work.
"""

from __future__ import annotations

import os

import numpy as np


def _write_table(path, header, table, fmt):
    """A header line, then the table (np.savetxt's layout, which the
    program's native reader takes)."""
    np.savetxt(path, table, fmt=fmt, header=str(header), comments="")
    return path


def grid_edges(config):
    """Cell edges (xe, ye, ze) of the configuration's lattice, in metres."""
    (nx, ny, nz), h = config["grid"]["size"], config["grid"]["cell_m"]
    return tuple(np.arange(n + 1) * step for n, step in zip((nx, ny, nz), h))


def grid_table(config):
    """(N, 9): X1 X2 Y1 Y2 Z1 Z2 i j k, i fastest (the model grid file)."""
    (nx, ny, nz), h = config["grid"]["size"], config["grid"]["cell_m"]
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    return np.column_stack(
        [i * h[0], (i + 1) * h[0], j * h[1], (j + 1) * h[1], k * h[2], (k + 1) * h[2], i + 1, j + 1, k + 1])


def survey_points(config):
    """(X, Y, Z) of the observations: above the cell centres of a side x side
    sub-lattice, `height_m` above the top (z down), draped by `drape_m`."""
    (nx, ny, _), h = config["grid"]["size"], config["grid"]["cell_m"]
    survey = config["survey"]
    step = nx // survey["side"]
    jj, ii = np.meshgrid(np.arange(0, ny, step), np.arange(0, nx, step), indexing="ij")
    X = (ii.reshape(-1) + 0.5) * h[0]
    Y = (jj.reshape(-1) + 0.5) * h[1]
    Z = np.full(X.size, -float(survey["height_m"]))
    drape = float(survey.get("drape_m", 0.0))
    if drape:
        Z = Z - drape * (0.5 + 0.5 * np.sin(0.013 * X + 0.021 * Y))
    # The data file holds three decimals: the points are what the program reads.
    return tuple(np.round(a, 3) for a in (X, Y, Z))


def true_models(config, seed):
    """The true density model (N,) and susceptibility model (N,): each block of
    the configuration at a corner drawn from the seed, later blocks over
    earlier ones; a block's susceptibility is its own where it states one,
    else its density times the model's `susceptibility_per_density`."""
    nx, ny, nz = config["grid"]["size"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 0x7046]))
    m = np.zeros((2, nz, ny, nx))
    for block in config["model"]["blocks"]:
        sx, sy, sz = block["size"]
        x0, y0, z0 = (int(rng.integers(0, n - s + 1)) for n, s in ((nx, sx), (ny, sy), (nz, sz)))
        chi = block.get("susceptibility", block["density"] * float(config["model"]["susceptibility_per_density"]))
        m[:, z0 : z0 + sz, y0 : y0 + sy, x0 : x0 + sx] = np.array([block["density"], chi])[:, None, None, None]
    return m[0].reshape(-1), m[1].reshape(-1)


def write_inputs(work, config, seed):
    """Every input file of one run into `work`; returns their paths by name and
    the arrays the reference takes (the same numbers as the files hold)."""
    os.makedirs(work, exist_ok=True)
    N = int(np.prod(config["grid"]["size"]))
    X, Y, Z = survey_points(config)
    rho, chi = true_models(config, seed)
    files = {
        "grid": _write_table(os.path.join(work, "grid.txt"), N, grid_table(config),
                             "%.3f %.3f %.3f %.3f %.3f %.3f %d %d %d"),
        "data": _write_table(os.path.join(work, "data.txt"), X.size,
                             np.column_stack([X, Y, Z, np.zeros(X.size)]), "%.3f"),
        "synth": _write_table(os.path.join(work, "synth.txt"), N, rho[:, None], "%.9E"),
        "synth_mag": _write_table(os.path.join(work, "synth_mag.txt"), N, chi[:, None], "%.9E"),
    }
    mixture = config.get("mixture")
    if mixture:
        files["mixture"] = _write_table(os.path.join(work, "mixture.txt"), len(mixture), np.array(mixture), "%.9E")
    arrays = {"points": (X, Y, Z), "models": (rho, chi), "edges": grid_edges(config)}
    return files, arrays


def write_parfile(path, config, files, output, majors, minors):
    """The cell's Parfile: the configuration's lines with the input files, the
    output folder and the iteration counts filled in."""
    fill = dict(files, output=output, majors=majors, minors=minors)
    with open(path, "w") as f:
        for line in config["parfile"]:
            f.write(line.format(**fill) + "\n")
    return path
