"""BTTB sensitivity operator: exact prism forward via per-layer 2-D FFTs.

Counterpart of tomofastx_tpu/ops/bttb.py. On a tensor-product grid with
uniform x/y spacing, the prism closed forms depend on the observation point
only through its displacement to each cell centre. When the observation
points also lie on a regular horizontal lattice commensurate with the cell
grid (a spacing that is an integer multiple of the cell's, any constant
offset) at one height, every layer of the sensitivity matrix is
block-Toeplitz-with-Toeplitz-blocks, and the operator is nz independent
2-D convolutions:

    S @ x  = gather_obs( sum_l  T_l (*) (cw * x)_l )
    S^T u  = cw * slice_cells( correlate(T_l, scatter_obs(u)) )

computed with 2-D real FFTs (torch.fft, cuFFT on the card): O(nz P log P)
work and an (nz, Py, Px//2+1) spectrum instead of the nd x N kernel.

The offset table T is built once in float64 through the same physics
dispatch as every other path (ops/sensitivity.py::forward_rows), on the
operator's device, and stored in the solve dtype, so the per-cell 8-corner
cancellation happens in float64: a float32 operator's error is the float32
rounding of exact entries. Applicability is detected automatically
(detect_bttb); any violation falls back to the corner-lattice or per-cell
operator (ops/matrixfree.py). The reference has no counterpart (it always
materializes the kernel's rows, sensitivity_gravmag.F90:189-318).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tomofastx_tpu_torch.ops.matrixfree import detect_lattice


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n: the JAX package's FFT sizes, kept so
    that both packages transform the same padded tables."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


@dataclass(frozen=True)
class BTTBGeometry:
    """Detected lattice structure of (grid, observations)."""

    no_x: int  # observation lattice dims
    no_y: int
    mx: int  # observation spacing in cell-spacing units
    my: int
    hx: float  # uniform cell spacings
    hy: float
    dx0: float  # obs-lattice origin minus first cell-centre (x)
    dy0: float
    zd: float  # the single observation height
    obs_flat: np.ndarray  # (nd,) int: iy * no_x + ix per data row
    xe: np.ndarray  # cell edge vectors (from detect_lattice)
    ye: np.ndarray
    ze: np.ndarray


def detect_bttb(grid, data, nmc: int = 1, ndc: int = 1, max_table_bytes: int = 4 << 30) -> Optional[BTTBGeometry]:
    """The BTTB geometry when (grid, data) qualify, else None. Float64 numpy
    throughout, as in the JAX package, so that both pick the same operator.

    Conditions (each falls back silently):
    - a tensor-product grid (detect_lattice) with uniform x and y spacing
      (z spacing may vary per layer);
    - every observation point at one height, strictly outside the volume's
      z-range (the table holds zero-horizontal-offset entries, which must be
      singularity-free; this also excludes the magnetic borehole case);
    - the observations' x/y positions form a full regular lattice whose
      spacing is a positive integer multiple of the cell spacing (any
      constant offset, any point order, a single row or column allowed);
    - the spectrum (nz, nmc, ndc, Py, Px//2+1) complex64 takes at most
      max_table_bytes, the JAX package's 4 GB, sized for a 16 GB TPU and
      kept so that both packages take the same operator."""
    lat = detect_lattice(grid)
    if lat is None:
        return None
    xe, ye, ze = lat
    dx = np.diff(xe)
    dy = np.diff(ye)
    hx, hy = float(dx[0]), float(dy[0])
    if hx <= 0.0 or hy <= 0.0:
        return None
    if not np.allclose(dx, hx, rtol=1e-9, atol=0.0):
        return None
    if not np.allclose(dy, hy, rtol=1e-9, atol=0.0):
        return None

    Z = np.asarray(data.Z, np.float64)
    if Z.size == 0:
        return None
    zd = float(Z[0])
    if not np.all(Z == zd):
        return None
    if min(ze.min(), ze.max()) <= zd <= max(ze.min(), ze.max()):
        return None

    X = np.asarray(data.X, np.float64)
    Y = np.asarray(data.Y, np.float64)
    ux = np.unique(X)
    uy = np.unique(Y)
    if ux.size * uy.size != X.size:
        return None

    def lattice_step(u: np.ndarray, h: float) -> Optional[float]:
        if u.size == 1:
            return h  # a single line: any commensurate stride works
        du = np.diff(u)
        s = float(du[0])
        if s <= 0.0 or not np.allclose(du, s, rtol=1e-9, atol=0.0):
            return None
        return s

    sx = lattice_step(ux, hx)
    sy = lattice_step(uy, hy)
    if sx is None or sy is None:
        return None
    mx = int(round(sx / hx))
    my = int(round(sy / hy))
    if mx < 1 or abs(sx - mx * hx) > 1e-9 * abs(sx):
        return None
    if my < 1 or abs(sy - my * hy) > 1e-9 * abs(sy):
        return None

    # Every data row's lattice coordinates (exact float match: unique()
    # returned these exact values), which must be one-to-one.
    ix = np.searchsorted(ux, X)
    iy = np.searchsorted(uy, Y)
    if not (np.array_equal(ux[ix], X) and np.array_equal(uy[iy], Y)):
        return None
    obs_flat = iy * ux.size + ix
    if np.unique(obs_flat).size != X.size:
        return None

    Lx = (ux.size - 1) * mx + grid.nx
    Ly = (uy.size - 1) * my + grid.ny
    spectrum_bytes = grid.nz * nmc * ndc * _next_fast_len(Ly) * (_next_fast_len(Lx) // 2 + 1) * 8
    if spectrum_bytes > max_table_bytes:
        return None

    return BTTBGeometry(
        no_x=ux.size, no_y=uy.size, mx=mx, my=my, hx=hx, hy=hy,
        dx0=float(ux[0] - (xe[0] + 0.5 * hx)), dy0=float(uy[0] - (ye[0] + 0.5 * hy)),
        zd=zd, obs_flat=obs_flat.astype(np.int32), xe=xe, ye=ye, ze=ze,
    )


@dataclass
class BTTBKernel:
    """FFT-convolution sensitivity operator ((nd*ndc) x (nmc*N)).

    Tf holds the rfft2 of the zero-padded per-layer offset tables, shape
    (nz, nmc, ndc, Py, Px//2+1); the matvec is
    gather(irfft2(sum_{z,k} Tf * rfft2(cw*x))) and the adjoint its exact
    transpose through the conjugate spectrum (circular correlation). Both
    are alias-free: the padded sizes satisfy P >= (no-1)*m + n, so no
    needed output index wraps around.

    layer_block: when set, the per-layer transforms run in blocks of this
    many z-layers (it divides nz), which bounds the transform temporaries
    while the table stays whole (make_bttb_kernel's rule)."""

    Tf: torch.Tensor  # (nz, nmc, ndc, Py, Pxr) complex
    cw: torch.Tensor  # (N,)
    row_w: torch.Tensor  # (nd, ndc)
    obs_flat: torch.Tensor  # (nd,) int64
    nx: int
    ny: int
    nz: int
    nmc: int
    ndc: int
    no_x: int
    no_y: int
    mx: int
    my: int
    nrows: int  # nd (data points)
    Py: int
    Px: int
    layer_block: int = None

    @property
    def N(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def ncols(self) -> int:
        return self.nmc * self.N

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.Tf, self.cw, self.row_w, self.obs_flat))

    def _blocks(self):
        """The z-layers in blocks: [(first, last + 1), ...]."""
        blk = self.layer_block or self.nz
        return [(s, s + blk) for s in range(0, self.nz, blk)]

    def _obs_window(self):
        return (
            slice(self.ny - 1, self.ny - 1 + self.no_y * self.my, self.my),
            slice(self.nx - 1, self.nx - 1 + self.no_x * self.mx, self.mx),
        )

    def _weighted_model(self, x):
        return (self.cw[None, :] * x.reshape(self.nmc, -1)).reshape(self.nmc, -1, self.ny, self.nx)

    def _spectrum(self, xw):
        """(ndc, Py, Pxr): sum over this operator's layers of Tf x rfft2(xw);
        xw (nmc, nz, ny, nx)."""
        Df = None
        for s, e in self._blocks():
            Xf = torch.fft.rfft2(xw[:, s:e], s=(self.Py, self.Px))  # (nmc, blk, Py, Pxr)
            part = torch.einsum("zkdyx,kzyx->dyx", self.Tf[s:e], Xf)
            Df = part if Df is None else Df + part
        return Df

    def _gather(self, Df):
        """The data rows of a summed spectrum: (nd * ndc,)."""
        dg = torch.fft.irfft2(Df, s=(self.Py, self.Px))  # (ndc, Py, Px)
        wy, wx = self._obs_window()
        dflat = dg[:, wy, wx].reshape(self.ndc, self.no_y * self.no_x)[:, self.obs_flat]
        return (dflat.T * self.row_w).reshape(-1)

    def _residual_spectrum(self, u):
        """rfft2 of the row-weighted residual scattered onto the padded
        observation lattice: (ndc, Py, Pxr)."""
        u2 = u.reshape(self.nrows, self.ndc) * self.row_w
        ug = torch.zeros((self.ndc, self.no_y * self.no_x), dtype=u2.dtype, device=u2.device)
        ug[:, self.obs_flat] = u2.T
        up = torch.zeros((self.ndc, self.Py, self.Px), dtype=u2.dtype, device=u2.device)
        wy, wx = self._obs_window()
        up[:, wy, wx] = ug.reshape(self.ndc, self.no_y, self.no_x)
        return torch.fft.rfft2(up)

    def _layers_adjoint(self, Uf):
        """(nmc, nz, ny, nx): this operator's layers of S^T u before cw."""
        out = []
        for s, e in self._blocks():
            Gf = torch.einsum("zkdyx,dyx->kzyx", torch.conj(self.Tf[s:e]), Uf)
            out.append(torch.fft.irfft2(Gf, s=(self.Py, self.Px))[:, :, : self.ny, : self.nx])
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(self._spectrum(self._weighted_model(x)))

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        g = self._layers_adjoint(self._residual_spectrum(u))
        return (g.reshape(self.nmc, self.N) * self.cw[None, :]).reshape(-1)


@dataclass
class ShardedBTTBKernel:
    """A BTTBKernel over the slots of a mesh. When the slots divide nz, slot
    s holds the layers [s*nz/n, (s+1)*nz/n) of the frequency table (the
    model-axis split of lsqr_solver2.F90:228-245, blocks = z-slabs): each
    slot transforms and convolves its layers, and matvec adds the slots'
    spectra on the home device in slot order before the one inverse
    transform; rmatvec sends the residual's spectrum to every slot and
    concatenates their layers. Otherwise every slot holds the whole table,
    as the JAX package replicates it, and the products run on the home
    slot's copy. The column and row weights and the observation map stay on
    the home device."""

    whole: BTTBKernel  # the operator on the home device (its table: the home slot's)
    parts: list  # one BTTBKernel per slot
    layered: bool
    mesh: object  # parallel.mesh.Mesh

    @classmethod
    def shard(cls, k: BTTBKernel, mesh) -> "ShardedBTTBKernel":
        slots = mesh.slots
        n = len(slots)
        layered = k.nz % n == 0
        parts = []
        for s, dev in enumerate(slots):
            if layered:
                nzl = k.nz // n
                blk = k.layer_block if k.layer_block and nzl % k.layer_block == 0 else None
                Tf = k.Tf[s * nzl : (s + 1) * nzl]
            else:
                nzl, blk, Tf = k.nz, k.layer_block, k.Tf
            parts.append(dataclasses.replace(k, Tf=Tf.to(dev), nz=nzl, layer_block=blk))
        home = mesh.home
        whole = dataclasses.replace(k, Tf=parts[0].Tf, cw=k.cw.to(home), row_w=k.row_w.to(home),
                                    obs_flat=k.obs_flat.to(home))
        return cls(whole, parts, layered, mesh)

    @property
    def nrows(self) -> int:
        return self.whole.nrows

    @property
    def ncols(self) -> int:
        return self.whole.ncols

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if not self.layered:
            return self.whole.matvec(x)
        home = self.mesh.home
        xw = self.whole._weighted_model(x)
        Df, lo = None, 0
        for p in self.parts:
            part = p._spectrum(xw[:, lo : lo + p.nz].to(p.Tf.device)).to(home)
            Df = part if Df is None else Df + part
            lo += p.nz
        return self.whole._gather(Df)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        if not self.layered:
            return self.whole.rmatvec(u)
        home = self.mesh.home
        Uf = self.whole._residual_spectrum(u)
        g = torch.cat([p._layers_adjoint(Uf.to(p.Tf.device)).to(home) for p in self.parts], dim=1)
        w = self.whole
        return (g.reshape(w.nmc, w.N) * w.cw[None, :]).reshape(-1)

    def slot_bytes(self) -> list:
        return [p.Tf.numel() * p.Tf.element_size() for p in self.parts]


def build_offset_table(phys, geom: BTTBGeometry, nx: int, ny: int, nz: int, device="cuda") -> torch.Tensor:
    """The per-layer offset table T in float64 on `device`, shape
    (nz, nmc, ndc, Ly, Lx).

    T[l, k, d, oy, ox] is the exact prism response of a cell in layer l
    whose centre sits at horizontal displacement
    (dx0 + (ox - (nx-1))*hx, dy0 + (oy - (ny-1))*hy) from the observation
    point, through the physics dispatch of the dense build and the
    matrix-free operators (ops/sensitivity.py::forward_rows). About 4N closed-form
    evaluations: the work of ~4 dense rows."""
    from tomofastx_tpu_torch.ops.sensitivity import forward_rows

    f64 = torch.float64
    Lx = (geom.no_x - 1) * geom.mx + nx
    Ly = (geom.no_y - 1) * geom.my + ny

    # Virtual observation points realizing every lattice displacement from
    # the virtual cell centre (hx/2, hy/2).
    vx = 0.5 * geom.hx + geom.dx0 + (np.arange(Lx) - (nx - 1)) * geom.hx
    vy = 0.5 * geom.hy + geom.dy0 + (np.arange(Ly) - (ny - 1)) * geom.hy
    VX, VY = np.meshgrid(vx, vy, indexing="xy")  # (Ly, Lx)
    pts_x = torch.as_tensor(VX.reshape(-1), dtype=f64, device=device)
    pts_y = torch.as_tensor(VY.reshape(-1), dtype=f64, device=device)
    npts = pts_x.shape[0]

    # A virtual one-column grid: one cell per layer at [0,hx] x [0,hy] with
    # the real layers' z-extents.
    z1 = np.minimum(geom.ze[:-1], geom.ze[1:])
    z2 = np.maximum(geom.ze[:-1], geom.ze[1:])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64, device=device)

    grid6 = (t(np.zeros(nz)), t(np.full(nz, geom.hx)), t(np.zeros(nz)), t(np.full(nz, geom.hy)), t(z1), t(z2))
    chunk = max(64, min(npts, (1 << 22) // max(nz * phys.nmc * phys.ndc, 1)))
    parts = []
    for s in range(0, npts, chunk):
        e = min(npts, s + chunk)
        parts.append(forward_rows(
            phys.problem, phys.data_type, phys.nmc, phys.ndc, phys.magv, phys.intensity, False, grid6,
            pts_x[s:e], pts_y[s:e], torch.full((e - s,), geom.zd, dtype=f64, device=device),
        ))  # (B, nz, nmc, ndc)
    T = torch.cat(parts).reshape(Ly, Lx, nz, phys.nmc, phys.ndc)
    if not bool(torch.isfinite(T).all()):
        raise ValueError(
            "Data coordinate coincides with model grid boundary. Adjust the model grid! (non-finite BTTB "
            "offset table; the reference aborts here, gravity_field.f90:99-107)"
        )
    return T.permute(2, 3, 4, 0, 1).contiguous()


def make_bttb_kernel(phys, geom: BTTBGeometry, grid, column_weight, problem_weight, data_weight,
                     dtype=torch.float32, device="cuda") -> BTTBKernel:
    """Assemble the FFT operator on `device`: the exact float64 offset table,
    cast to the storage dtype and zero-padded to 5-smooth FFT sizes, then
    rfft2 (complex64 for float32, complex128 for float64)."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    nd = geom.obs_flat.shape[0]
    T = build_offset_table(phys, geom, nx, ny, nz, device=device)
    Ly, Lx = T.shape[-2], T.shape[-1]
    Px, Py = _next_fast_len(Lx), _next_fast_len(Ly)
    G = nz * phys.nmc * phys.ndc
    Tp = torch.zeros((G, Py, Px), dtype=dtype, device=device)
    Tp[:, :Ly, :Lx] = T.reshape(G, Ly, Lx).to(dtype)
    del T
    Tf = torch.fft.rfft2(Tp).reshape(nz, phys.nmc, phys.ndc, Py, -1)
    del Tp

    # Layer blocking, the JAX package's rule for a 16 GB TPU, kept for
    # parity: the full-nz transform temporaries take about
    # nmc * nz * Py * Px * 20 bytes; above 3 GB the layers go in blocks of
    # the largest divisor of nz that keeps them near 1.5 GB.
    plane = phys.nmc * Py * Px * 20
    layer_block = None
    if nz * plane > (3 << 30):
        blk = max(1, (3 << 29) // plane)
        while nz % blk:
            blk -= 1
        layer_block = blk

    row_w = problem_weight * np.asarray(data_weight).reshape(nd, phys.ndc)
    return BTTBKernel(
        Tf=Tf,
        cw=torch.as_tensor(np.asarray(column_weight), dtype=dtype, device=device),
        row_w=torch.as_tensor(row_w, dtype=dtype, device=device),
        obs_flat=torch.as_tensor(geom.obs_flat, dtype=torch.int64, device=device),
        nx=nx, ny=ny, nz=nz, nmc=phys.nmc, ndc=phys.ndc,
        no_x=geom.no_x, no_y=geom.no_y, mx=geom.mx, my=geom.my,
        nrows=nd, Py=Py, Px=Px, layer_block=layer_block,
    )
