"""Noise generators for synthetic-data experiments.

Counterpart of utils/noise.f90 (Box-Muller Gaussian + uniform noise;
available for synthetic experiments, not wired into the main path in the
reference either)."""

from __future__ import annotations

import numpy as np


def gaussian_noise(rng: np.random.Generator, shape, std: float = 1.0) -> np.ndarray:
    """Box-Muller Gaussian noise (noise.f90:59-76 semantics)."""
    u1 = rng.random(shape)
    u2 = rng.random(shape)
    return std * np.sqrt(-2.0 * np.log(np.clip(u1, 1e-300, None))) * np.cos(2.0 * np.pi * u2)


def uniform_noise(rng: np.random.Generator, shape, amplitude: float = 1.0) -> np.ndarray:
    """Uniform noise in [-amplitude, amplitude] (noise.f90:81-90)."""
    return amplitude * (2.0 * rng.random(shape) - 1.0)


def add_relative_noise(rng: np.random.Generator, data: np.ndarray, relative_std: float) -> np.ndarray:
    """Add Gaussian noise scaled by the RMS of the data."""
    scale = relative_std * float(np.sqrt(np.mean(data**2)))
    return data + gaussian_noise(rng, data.shape, scale)
