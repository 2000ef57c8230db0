"""State carried across from the JAX package, given as numpy arrays.

A parity test computes with both packages from identical state: it pulls
the JAX package's arrays to numpy and hands them to these functions, which
build the objects this package computes with. The values are not changed
on the way (float32 packs stay float32; vectors are cast to the dtype the
caller names)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tomofastx_tpu_torch.ops.sparse_kernel import DenseKernel, PackedKernel
from tomofastx_tpu_torch.ops.tile_kernel import TileKernel


def tile_kernel_from_numpy(uvals, ubidx, uvalsT, ubidxT, nrows: int, ncols: int,
                           device="cuda") -> TileKernel:
    """The four arrays of a tile-union pack -> a TileKernel on `device`."""

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return TileKernel(
        uvals=put(uvals, torch.float32),
        ubidx=put(ubidx, torch.int32),
        uvalsT=put(uvalsT, torch.float32),
        ubidxT=put(ubidxT, torch.int32),
        nrows=int(nrows),
        ncols=int(ncols),
    )


def dense_kernel_from_numpy(S, ST=None, ncols_true=None, nrows_true=None,
                            dtype=torch.float64, device="cuda") -> DenseKernel:
    """A dense kernel's matrix (and its optional contiguous transpose) -> a
    DenseKernel on `device`, in the dtype of the vectors it will meet. A
    bfloat16 matrix (the JAX package's, an ml_dtypes.bfloat16 array) is
    carried across bit for bit through its 16-bit pattern and stays
    bfloat16, whatever `dtype` says."""

    def put(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
            return bits.view(torch.bfloat16).to(device)
        return torch.tensor(a, dtype=dtype, device=device)

    return DenseKernel(put(S), put(ST), ncols_true, nrows_true)


def packed_kernel_from_numpy(row_vals, row_idx, dense_cols, dense_block, light_cols,
                             light_vals, light_idx, nrows: int, ncols: int,
                             device="cuda") -> PackedKernel:
    """The seven arrays of a packed top-k kernel -> a PackedKernel on `device`."""

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return PackedKernel(
        row_vals=put(row_vals, torch.float32),
        row_idx=put(row_idx, torch.int32),
        dense_cols=put(dense_cols, torch.int32),
        dense_block=put(dense_block, torch.float32),
        light_cols=put(light_cols, torch.int32),
        light_vals=put(light_vals, torch.float32),
        light_idx=put(light_idx, torch.int32),
        nrows=int(nrows),
        ncols=int(ncols),
    )


def solver_state_from_numpy(
    model: Sequence, prior: Sequence, column_weight: Sequence,
    admm_z: Sequence, admm_u: Sequence, rho_admm,
    dtype=torch.float64, device="cuda",
) -> dict:
    """Per-active-problem sequences of numpy arrays (models and priors
    (ncomp, N); column weights, ADMM z and u (N,)) and the two ADMM weights
    -> the entries of the solver's dictionary of tensors that change from
    one major iteration to the next, plus the column weights."""

    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "model": tuple(put(a) for a in model),
        "prior": tuple(put(a) for a in prior),
        "cw": tuple(put(a) for a in column_weight),
        "admm_z": tuple(put(a) for a in admm_z),
        "admm_u": tuple(put(a) for a in admm_u),
        "rho_admm": put(rho_admm),
    }
