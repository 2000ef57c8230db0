"""The lattice operator's pair count against a brute-force count."""

from __future__ import annotations

import numpy as np

from portbench import run, traffic, yardstick
from portbench.tests.conftest import shrink


def brute_force(edges, points):
    xe, ye, ze = edges
    (wz, wy, wx), start = yardstick.lattice_window(edges, points)
    near = window = far = 0
    for b, (x, y, z) in enumerate(zip(*points)):
        iz0, iy0, ix0 = start[b]
        for k in range(ze.size - 1):
            for j in range(ye.size - 1):
                for i in range(xe.size - 1):
                    inside = iz0 <= k < iz0 + wz and iy0 <= j < iy0 + wy and ix0 <= i < ix0 + wx
                    if not inside:
                        far += 1
                        continue
                    c = np.array([(xe[i] + xe[i + 1]) / 2, (ye[j] + ye[j + 1]) / 2, (ze[k] + ze[k + 1]) / 2])
                    h = np.array([xe[i + 1] - xe[i], ye[j + 1] - ye[j], ze[k + 1] - ze[k]]) / 2
                    r2 = np.sum((c - np.array([x, y, z])) ** 2)
                    if r2 <= yardstick.NEAR_RADIUS**2 * np.sum(h**2):
                        near += 1
                    else:
                        window += 1
    return near, window, far


def test_lattice_pairs_match_a_brute_force_count():
    config = shrink(run.load_json("configs", "grav_draped_lattice_262k"))
    config["grid"]["size"] = [40, 30, 8]
    config["survey"]["side"] = 4
    edges = traffic.grid_edges(config)
    points = traffic.survey_points(config)
    got = yardstick.lattice_pairs(edges, points, chunk=5)
    assert got == brute_force(edges, points)
    assert sum(got) == points[0].size * 40 * 30 * 8 and got[0] > 0 and got[1] > 0 and got[2] > 0


def test_least_times():
    assert yardstick.stored_product_s(4096, 262144) == (4096 * 262144 + 4096 + 262144) * 4 / 3.35e12
    config = shrink(run.load_json("configs", "grav_draped_lattice_262k"))
    edges, points = traffic.grid_edges(config), traffic.survey_points(config)
    near, window, far = yardstick.lattice_pairs(edges, points)
    assert yardstick.lattice_product_s(edges, points) == (27 * window + 8 * far) / yardstick.MUFU_PER_S
