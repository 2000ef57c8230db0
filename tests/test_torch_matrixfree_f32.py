"""Port parity of the blended float32 matrix-free operators on the CPU:
the per-cell and corner-lattice operators' products against the JAX
package's float32 and float64 products, for every physics family. (Beside
tests/test_torch_matrixfree.py so that the two halves run on two workers.)"""

import numpy as np
import pytest

from test_torch_matrixfree import FAMILIES, GEOMETRIES, both_operators, products, scattered, grid_dict


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_operator_f32_blend_as_accurate_as_jax(geometry, case):
    """float32 with the far-field blend: the port's products are no further
    from the JAX package's float64 products than 1.5x the JAX package's own
    float32 error. The grid is long enough for every tier of the blend. (The
    port evaluates the near cells' closed forms in float64, which makes its
    error the smaller: ops/matrixfree.py::_in_float64.)"""
    gkw, no_fft, cls = GEOMETRIES[geometry]
    g = grid_dict(40, 4, 3, **gkw)
    X, Y, Z = scattered(dict(g, X2=g["X2"] / 4), 6, 6)
    j64, _ = both_operators(case, g, X, Y, Z, "f64", force_no_fft=no_fft)
    j32, t32 = both_operators(case, g, X, Y, Z, "f32", force_no_fft=no_fft)
    blended = t32.far_quad if cls == "LatticeMatrixFreeKernel" else t32.phys.far_quad
    assert type(t32).__name__ == cls and blended
    rng = np.random.default_rng(4)
    ndc = t32.ndc if hasattr(t32, "ndc") else t32.phys.ndc
    x, u = rng.normal(size=t32.ncols), rng.normal(size=t32.nrows * ndc)
    ref, jax32, port32 = products(j64, x, u, False), products(j32, x, u, False), products(t32, x, u, True)
    for r, a, b in zip(ref, jax32, port32):
        err_jax, err_port = (np.linalg.norm(v - r) / np.linalg.norm(r) for v in (a, b))
        assert err_port <= 1.5 * err_jax, (err_port, err_jax)
