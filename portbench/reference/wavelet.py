"""Frozen copy of the program's ops/wavelet.py for the benchmark's reference
(later changes to the program do not reach it), from here on as it was:

Batched 3-D lifting-scheme wavelet transforms (Haar, Daubechies D4).

Counterpart of the reference's scalar-loop transforms
(wavelet_transform.F90:75-498). The reference applies these one
model-vector at a time; here each 1-D lifting pass is a strided-slice
tensor op over an arbitrary batch of fields at once.

Semantics exactly match the reference, including:
- the number of scales nscale = int(log(L)/log 2) evaluated in float64
  (which yields 2 for L=8 due to rounding — reproduced on purpose);
- non-power-of-2 lengths (leftover tail entries untouched at coarse scales);
- the D4 boundary handling (Kaplan 2001), which is equivalent to a circular
  wrap over the even/odd subsequences of each scale.

Layout: fields are shaped (..., nz, ny, nx); the flat model order is
i-fastest (x), so axis -1 is the reference's first transform dimension n1.

The public functions return a new tensor; inside, one copy of the input is
updated in place through strided views, scale by scale.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)
_C0 = math.sqrt(3.0)
_C1 = math.sqrt(3.0) / 4.0
_C2 = (math.sqrt(3.0) - 2.0) / 4.0
_C3 = (math.sqrt(3.0) - 1.0) / math.sqrt(2.0)
_C4 = (math.sqrt(3.0) + 1.0) / math.sqrt(2.0)

HAAR = 1
DAUB4 = 2


def n_scales(L: int) -> int:
    """Number of dyadic scales; replicates the reference's float-truncation
    int(log(L)/log(2)) (wavelet_transform.F90:85-92) exactly."""
    if L <= 1:
        return 0
    return int(math.log(float(L)) / math.log(2.0))


def _scale_slices(L: int, istep: int):
    """Even (smooth) and odd (detail) strided slices for one scale, 0-based.

    Fortran (wavelet_transform.F90:96-100): step = 2**istep,
    ngmin = step/2 + 1 (1-based), ng = floor((L - ngmin)/step) + 1."""
    step = 2**istep
    g0 = step // 2
    ng = (L - 1 - g0) // step + 1
    last = (ng - 1) * step
    sl_e = slice(0, last + 1, step)
    sl_g = slice(g0, g0 + last + 1, step)
    return sl_e, sl_g, ng


# Each scale function reads the even/odd views of `s`, computes the new
# values out of place, and writes them back into `s`.


def _haar_scale_fwd(s, sl_e, sl_g):
    E = s[..., sl_e]
    G = s[..., sl_g]
    G = G - E  # predict
    E = E + G / 2.0  # update
    s[..., sl_e] = E * SQRT2  # normalize
    s[..., sl_g] = G / SQRT2


def _haar_scale_inv(s, sl_e, sl_g):
    E = s[..., sl_e] / SQRT2
    G = s[..., sl_g] * SQRT2
    E = E - G / 2.0
    G = G + E
    s[..., sl_e] = E
    s[..., sl_g] = G


def _d4_scale_fwd(s, sl_e, sl_g):
    E = s[..., sl_e]
    G = s[..., sl_g]
    E = E + _C0 * G  # update 1
    G = G - (_C1 * E + _C2 * torch.roll(E, 1, dims=-1))  # predict (wrap boundary)
    E = E - torch.roll(G, -1, dims=-1)  # update 2 (wrap boundary)
    s[..., sl_e] = E * _C3
    s[..., sl_g] = G * _C4


def _d4_scale_inv(s, sl_e, sl_g):
    E = s[..., sl_e] * _C4
    G = s[..., sl_g] * _C3
    E = E + torch.roll(G, -1, dims=-1)
    G = G + (_C1 * E + _C2 * torch.roll(E, 1, dims=-1))
    E = E - _C0 * G
    s[..., sl_e] = E
    s[..., sl_g] = G


def _transform_last_axis(s, L: int, scale_fn, reverse: bool):
    scales = range(n_scales(L), 0, -1) if reverse else range(1, n_scales(L) + 1)
    for istep in scales:
        sl_e, sl_g, ng = _scale_slices(L, istep)
        if ng < 1:
            continue
        scale_fn(s, sl_e, sl_g)


def _apply_3d(s, wavelet_type: int, inverse: bool):
    if wavelet_type == HAAR:
        fn = _haar_scale_inv if inverse else _haar_scale_fwd
    elif wavelet_type == DAUB4:
        fn = _d4_scale_inv if inverse else _d4_scale_fwd
    else:
        raise ValueError(f"Unknown wavelet type {wavelet_type}!")

    # The reference transforms dims in order n1 (x), n2 (y), n3 (z); 1-D passes
    # along different axes commute, but we keep the same order anyway.
    # axis -1 = x, -2 = y, -3 = z.
    s = s.clone()
    for axis in (-1, -2, -3):
        _transform_last_axis(s.movedim(axis, -1), s.shape[axis], fn, reverse=inverse)
    return s


def forward_wavelet_3d(s, wavelet_type: int = HAAR):
    """Forward 3-D transform of (..., nz, ny, nx) fields
    (reference: forward_wavelet, wavelet_transform.F90:37-51)."""
    return _apply_3d(s, wavelet_type, inverse=False)


def inverse_wavelet_3d(s, wavelet_type: int = HAAR):
    """Inverse 3-D transform of (..., nz, ny, nx) fields
    (reference: inverse_wavelet, wavelet_transform.F90:56-70)."""
    return _apply_3d(s, wavelet_type, inverse=True)


def forward_wavelet_flat(v, nx: int, ny: int, nz: int, wavelet_type: int = HAAR):
    """Transform flat (..., N) model vectors in i-fastest order."""
    shape = v.shape
    cube = v.reshape(*shape[:-1], nz, ny, nx)
    return forward_wavelet_3d(cube, wavelet_type).reshape(shape)


def inverse_wavelet_flat(v, nx: int, ny: int, nz: int, wavelet_type: int = HAAR):
    shape = v.shape
    cube = v.reshape(*shape[:-1], nz, ny, nx)
    return inverse_wavelet_3d(cube, wavelet_type).reshape(shape)
