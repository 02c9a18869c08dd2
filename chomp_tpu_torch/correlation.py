"""Static ell / theta grids and the fused Hankel + theta-binning operator.

Copy of the numpy half of the JAX package's ``correlation.py`` that the slice
needs (the JAX module imports jax): the log-ell FFTLog grid, the output
theta bins, and ``wtheta_bins_operator`` (FFTLog operator composed with
Catmull-Rom binning weights, float64).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from chomp_tpu_torch.fftlog import hankel_operator
from chomp_tpu_torch.grids import catmull_rom_weights_np
from chomp_tpu_torch.params import DEFAULT_GRID, GridSpec


def ell_grid(grid: GridSpec = DEFAULT_GRID):
    """The static log-ell FFTLog grid (numpy float64): (ells, ln0, dln)."""
    ln0 = float(np.log(grid.ell_min))
    dln = float(np.log(grid.ell_max / grid.ell_min) / (grid.n_ell - 1))
    return np.exp(ln0 + dln * np.arange(grid.n_ell)), ln0, dln


def wtheta_operator(grid: GridSpec = DEFAULT_GRID, mu: float = 0.0):
    """(theta_grid_rad, W) with w(theta_j) = sum_m W[j, m] C_l(l_m)."""
    ells, ln0, dln = ell_grid(grid)
    theta, h = hankel_operator(
        grid.n_ell, ln0, dln, mu, q=1.0,
        taper_lo=grid.fftlog_taper_lo, taper_hi=grid.fftlog_taper_hi)
    w_op = h * (ells[None, :] ** 2) / (2.0 * np.pi)
    return theta, w_op


def theta_bins_deg(grid: GridSpec = DEFAULT_GRID):
    """Log-spaced output theta bins in degrees."""
    return np.logspace(np.log10(grid.theta_min_deg),
                       np.log10(grid.theta_max_deg), grid.n_theta)


@lru_cache(maxsize=None)
def wtheta_bins_operator(theta_key, grid: GridSpec = DEFAULT_GRID,
                         mu: float = 0.0):
    """Static operator with w(theta_bins) = Op @ C_l (float64 numpy)."""
    theta_deg = np.asarray(theta_key)
    theta_grid, w_op = wtheta_operator(grid, mu)
    ln_t = np.log(theta_grid)
    d = ln_t[1] - ln_t[0]
    q = np.log(np.radians(theta_deg))
    w2 = catmull_rom_weights_np(len(ln_t), (q - ln_t[0]) / d)
    return np.ascontiguousarray(w2 @ w_op)
