"""Device mesh and the sharded placement of the sensitivity operators.

Counterpart of tomofastx_tpu/parallel/mesh.py. The reference parallelizes
with MPI: data rows split over ranks for the build (sensitivity_gravmag.F90:
179-189) and model columns split for LSQR (lsqr_solver2.F90:208-245). Here
one process drives every slot of a mesh: a slot is a ``torch.device``, the
operator's large arrays are cut into one part per slot and live on that
slot's device, and each product launches its work slot by slot and gathers
the partial results on the home device (slot 0).

Only the operators are sharded. The per-cell and per-datum vectors of the
solve (N or nd entries against a kernel of nd x N) stay on the home device:
every elementwise constraint operation on them is trivial beside one
product, and keeping them whole spares a scatter and a gather around each
of the dozen vector operations of an LSQR iteration. The JAX package shards
those vectors whose length divides the mesh and replicates the rest; its
own docstring defends replication for them.

On ``cuda`` a mesh takes distinct cards, cuda:0 .. cuda:n-1, and refuses to
be made with more slots than there are cards. On ``cpu`` every slot names
the CPU: the counterpart of the JAX tests' virtual CPU devices. ``Mesh``
itself accepts any array of devices, so several slots may share one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CELLS_AXIS = "cells"
OBS_AXIS = "obs"


@dataclass(frozen=True, eq=False)
class Mesh:
    """An array of slots, (n,) with axis_names ("cells",) or (no, nc) with
    ("obs", "cells"); each slot is a torch.device."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        given = np.asarray(self.devices, dtype=object)
        devs = np.array([_indexed(d) for d in given.flat], dtype=object).reshape(given.shape)
        if devs.ndim != len(self.axis_names) or devs.size == 0:
            raise ValueError(f"a mesh of shape {devs.shape} cannot have the axes {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def slots(self) -> list:
        """The slots' devices in the flattened (row-major) order."""
        return list(self.devices.flat)

    @property
    def n_devices(self) -> int:
        """How many distinct devices the slots name."""
        return len(set(self.slots))

    @property
    def home(self) -> torch.device:
        """Slot 0: where the vectors live and the partial results meet."""
        return self.devices.flat[0]

    def __repr__(self):
        slots = ", ".join(str(d) for d in self.slots)
        return f"Mesh({'x'.join(str(s) for s in self.devices.shape)} {self.axis_names}: {slots})"


def _indexed(d) -> torch.device:
    """A slot's device; a bare "cuda" names the current card, so that slots
    compare equal to the devices of the tensors placed on them."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _parse_spec(spec):
    if isinstance(spec, str):
        spec = tuple(int(t) for t in spec.lower().split("x"))
        if len(spec) == 1:
            spec = spec[0]
    return spec


def make_mesh(spec=None, device="cuda") -> Mesh:
    """1-D cells mesh from a slot count (or "N"), or a 2-D (obs x cells) mesh
    from a (no, nc) tuple or an "RxC" string. On "cuda" the slots are the
    distinct cards cuda:0 .. cuda:n-1 (spec None: all of them), and a mesh of
    more slots than cards raises ValueError; on "cpu" every slot is the CPU
    (spec None: one slot)."""
    spec = _parse_spec(spec)
    kind = torch.device(device).type
    if isinstance(spec, (tuple, list)):
        no, nc = (int(v) for v in spec)
        shape, names = (no, nc), (OBS_AXIS, CELLS_AXIS)
    else:
        n = int(spec) if spec else (torch.cuda.device_count() if kind == "cuda" else 1)
        shape, names = (n,), (CELLS_AXIS,)
    n = int(np.prod(shape))
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {spec}")
    if kind == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"a mesh of {n} slots needs {n} CUDA devices; this machine has {have}")
        devs = [torch.device("cuda", k) for k in range(n)]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"make_mesh takes cuda or cpu, got {device}")
    return Mesh(np.array(devs, dtype=object).reshape(shape), names)


def assembly_device(mesh: Mesh) -> torch.device:
    """Where a kernel is built or read before shard_kernel cuts it over the
    mesh. When every slot is on the home device (one card holding several
    slots, or the CPU) that is the home device: the parts are then views of
    the whole, nothing is copied and the sharded products equal the
    unsharded ones bit for bit. When the slots are distinct cards it is the
    host, as in the JAX package (tomofastx_tpu/ops/sensitivity.py:889-894,
    parallel/mesh.py:102-112): each card then receives its own part and
    nothing else, so no card has to hold the whole kernel."""
    home = mesh.home
    if all(d == home for d in mesh.slots):
        return home
    return torch.device("cpu")


def obs_axis(mesh: Mesh):
    """The obs axis name when the mesh has one, else None (1-D cells mesh:
    data-space arrays stay whole)."""
    return OBS_AXIS if OBS_AXIS in mesh.axis_names else None


def shard_kernel(k, mesh: Mesh):
    """Place a sensitivity operator over the slots of the mesh. The result
    takes and returns vectors on mesh.home.

    - DenseKernel: columns zero-padded to a multiple of the cells axis and
      cut into column blocks; on a 2-D mesh the rows are cut over the obs
      axis too (block (i, j) on slot (i, j)).
    - PackedKernel: the row pack cut along its slot axis K (the products'
      partial sums meet on the home device); the heavy block along its
      column axis and the light pack along its leading axis.
    - TileKernel: both packs cut along their tile axis, one part per slot;
      every product runs tile_matvec_sharded.
    - MatrixFreeKernel: cells-sharded, its (padded) cells split over the
      slots (build it with pad_cells_to = the slot count).
    - BTTBKernel: the frequency table split by z-layers when the slots
      divide nz, each slot's spectrum summed on the home device; else
      replicated on every slot and run on the home slot's copy.
    - LatticeMatrixFreeKernel: observation-sharded, re-padded to a multiple
      of chunk x slots, with the windows recomputed at the tier-2 radius.

    A kernel already sharded over this mesh comes back as it is; any other
    type raises NotImplementedError."""
    from tomofastx_tpu_torch.ops.bttb import BTTBKernel, ShardedBTTBKernel
    from tomofastx_tpu_torch.ops.matrixfree import (
        LatticeMatrixFreeKernel,
        MatrixFreeKernel,
        ShardedLatticeMatrixFreeKernel,
        ShardedMatrixFreeKernel,
    )
    from tomofastx_tpu_torch.ops.sparse_kernel import (
        DenseKernel,
        PackedKernel,
        ShardedDenseKernel,
        ShardedPackedKernel,
    )
    from tomofastx_tpu_torch.ops.tile_kernel import ShardedTileKernel, TileKernel

    sharded = (ShardedDenseKernel, ShardedPackedKernel, ShardedTileKernel, ShardedMatrixFreeKernel,
               ShardedBTTBKernel, ShardedLatticeMatrixFreeKernel)
    if isinstance(k, sharded):
        if k.mesh is not mesh:
            raise ValueError("the kernel is already sharded over another mesh")
        return k
    if isinstance(k, DenseKernel):
        grid = mesh.devices if obs_axis(mesh) else mesh.devices[None, :]
        return ShardedDenseKernel.shard(k, grid, mesh)
    if isinstance(k, PackedKernel):
        return ShardedPackedKernel.shard(k, mesh.slots, mesh)
    if isinstance(k, TileKernel):
        return ShardedTileKernel.shard(k, mesh.slots, mesh)
    if isinstance(k, MatrixFreeKernel):
        return ShardedMatrixFreeKernel.shard(k, mesh)
    if isinstance(k, BTTBKernel):
        return ShardedBTTBKernel.shard(k, mesh)
    if isinstance(k, LatticeMatrixFreeKernel):
        return ShardedLatticeMatrixFreeKernel.shard(k, mesh)
    raise NotImplementedError(f"shard_kernel: {type(k).__name__} is not a sensitivity operator of this package")


def shard_system_arrays(arrays: dict, mesh: Mesh) -> dict:
    """The joint-system arrays with every operator under "S" (and "S_fwd")
    sharded by shard_kernel and every other tensor on the home device, where
    the solve's vectors stay (see the module docstring)."""
    out = {}
    for key, val in arrays.items():
        if key in ("S", "S_fwd"):
            out[key] = tuple(shard_kernel(k, mesh) for k in val)
        elif isinstance(val, tuple):
            # None stands for a problem whose block is off.
            out[key] = tuple(None if v is None else v.to(mesh.home) for v in val)
        elif isinstance(val, torch.Tensor):
            out[key] = val.to(mesh.home)
        else:
            out[key] = val
    return out


def slot_bytes_line(op) -> str:
    """The bytes each slot holds, for the log: "slot 0 (cuda:0) 2100.1 MB, ..."."""
    return ", ".join(
        f"slot {s} ({dev}) {b / 1e6:.1f} MB"
        for s, (dev, b) in enumerate(zip(op.mesh.slots, op.slot_bytes()))
    )
