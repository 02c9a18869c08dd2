"""Lattice Limber projection — the separable route of the w(theta) pipeline.

PyTorch counterpart of the separable half of the JAX package's
``limber_fft.py``.
With u = ln chi and s = ln(ell + 1/2), C(s) = ∫ du G(u) P(e^{s-u}) is a
1-D convolution of the P lattice (static ln k) with the window weights G
on the matching static ln chi lattice; z(chi) on that lattice comes from
Newton iteration off a static fiducial seed.  The numpy builders (the
lattices, the fiducial tables, the Catmull-Rom s-interpolation and the
composed lattice -> Hankel -> theta-bins operator) are copied from the
JAX module; the runtime pieces are batched torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from chomp_tpu_torch import background, correlation
from chomp_tpu_torch.grids import catmull_rom_weights_np
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams, GridSpec, col
from chomp_tpu_torch.projection import WindowConvergence, dndz


def _lattice_key(grid: GridSpec):
    return (grid.lattice_dln, grid.lattice_k_lo, grid.lattice_k_hi,
            grid.lattice_chi_lo, grid.lattice_chi_hi)


@lru_cache(maxsize=None)
def _lattices_from_key(key):
    dln, k_lo, k_hi, chi_lo, chi_hi = key
    n_k = int(np.ceil(np.log(k_hi / k_lo) / dln)) + 1
    ln_k = np.log(k_lo) + dln * np.arange(n_k)
    n_chi = int(np.ceil(np.log(chi_hi / chi_lo) / dln)) + 1
    ln_chi = np.log(chi_lo) + dln * np.arange(n_chi)
    return ln_k, ln_chi


def _lattices(grid: GridSpec):
    """(ln_k, ln_chi) static lattices (numpy)."""
    return _lattices_from_key(_lattice_key(grid))


@lru_cache(maxsize=None)
def _fiducial_chi_table():
    """Dense fiducial flat-LCDM (z, chi(z)) table (numpy, static)."""
    z_dense = np.linspace(0.0, 25.0, 20001)
    ez = np.sqrt(0.278 * (1.0 + z_dense) ** 3 + 0.722)
    dz = z_dense[1] - z_dense[0]
    integrand = 1.0 / ez
    chi_dense = C_OVER_H0 * dz * (np.cumsum(integrand) - 0.5 * integrand
                                  - 0.5 * integrand[0])
    return z_dense, chi_dense


@lru_cache(maxsize=None)
def _fiducial_z_seed(key, mid: bool = False):
    """Static Newton seed z_fid(chi) at the lattice nodes (or midpoints)."""
    dln = key[0]
    _, ln_chi = _lattices_from_key(key)
    chi = np.exp(ln_chi + (0.5 * dln if mid else 0.0))
    z_dense, chi_dense = _fiducial_chi_table()
    return np.interp(chi, chi_dense, z_dense)


@lru_cache(maxsize=None)
def _s_weights(ells_key, ell_offset: float, key):
    """Static Catmull-Rom matrix from the conv output C(s_n) to
    s_ell = ln(ell + offset)."""
    ells = np.asarray(ells_key)
    ln_k, ln_chi = _lattices_from_key(key)
    dln = key[0]
    s0 = ln_k[0] + ln_chi[0]
    n_out = len(ln_k) + len(ln_chi) - 1
    s_ell = np.log(ells + ell_offset)
    return catmull_rom_weights_np(n_out, (s_ell - s0) / dln)


@lru_cache(maxsize=None)
def wtheta_lattice_operator(theta_key, grid: GridSpec, mu: float = 0.0,
                            ell_offset: float = 0.5):
    """(j_lo, j_hi, A): the conv-output -> w(theta bins) map as one static
    float64 matrix (Catmull-Rom lattice interpolation composed with the
    Hankel + binning operator), restricted to the conv positions it uses."""
    ells = correlation.ell_grid(grid)[0]
    w_full = _s_weights(tuple(ells.tolist()), ell_offset, _lattice_key(grid))
    used = np.nonzero(np.any(w_full != 0.0, axis=0))[0]
    j_lo, j_hi = int(used[0]), int(used[-1]) + 1
    bins_op = correlation.wtheta_bins_operator(theta_key, grid, mu)
    return j_lo, j_hi, np.ascontiguousarray(bins_op @ w_full[:, j_lo:j_hi])


def _conv_direct_rows(p_rows, g_rows, j_lo: int, j_hi: int):
    """Paired per-row direct convolution over conv-output positions
    [j_lo, j_hi): ``p_rows`` (B, R, n_k), ``g_rows`` (B, R, n_chi) ->
    (B, R, j_hi - j_lo).  One grouped ``conv1d`` (groups = B R); like
    the JAX code, g is flipped so the cross-correlation is a convolution.

    The sum is accumulated in float64 whatever the input dtype (the
    output keeps it): PyTorch's grouped float32 conv1d sums the ~1.3k
    taps in float32, measured on an H100 (700 W) at 6.2e-6 worst
    relative error per output on the pipeline's own rows, against ~6e-8
    (the output rounding) in float64 at +0.8 ms per 512-cosmology batch.
    (Its TF32 switch does not reach this grouped kernel: measured the
    same error with it on.)"""
    b, r, n_k = p_rows.shape
    n_chi = g_rows.shape[-1]
    lhs = p_rows.reshape(1, b * r, n_k).to(torch.float64)
    rhs = g_rows.flip(-1).reshape(b * r, 1, n_chi).to(torch.float64)
    pad_l = n_chi - 1 - j_lo
    pad_r = max(j_hi - n_k, 0)
    lhs = F.pad(lhs, (pad_l, pad_r))
    out = F.conv1d(lhs, rhs, groups=b * r)
    return out[0, :, :j_hi - j_lo].reshape(b, r, j_hi - j_lo).to(
        p_rows.dtype)


def _window_on_lattice(cosmo, win, z, chi, st, z_mid):
    """Window values at the lattice nodes, (B, n_chi).  The convergence
    window uses cumulative Simpson in u = ln chi' with the exact-lattice
    midpoints (O(du^4), one reverse cumsum for each inner integral)."""
    if isinstance(win, WindowConvergence):
        dln = st.grid.lattice_dln
        chi_mid = chi * float(np.exp(0.5 * dln))

        def q(z_pts, chi_pts):
            p = dndz(win.dist, z_pts, st)
            jac = background.ez(cosmo, z_pts) / C_OVER_H0 * chi_pts
            return p * jac, p * jac / chi_pts

        q1, q2 = q(z, chi)
        q1m, q2m = q(z_mid, chi_mid)
        seg1 = dln / 6.0 * (q1[:, :-1] + 4.0 * q1m[:, :-1] + q1[:, 1:])
        seg2 = dln / 6.0 * (q2[:, :-1] + 4.0 * q2m[:, :-1] + q2[:, 1:])
        zero = torch.zeros_like(q1[:, :1])
        f1 = torch.cat([seg1.flip(-1).cumsum(-1).flip(-1), zero], dim=-1)
        f2 = torch.cat([seg2.flip(-1).cumsum(-1).flip(-1), zero], dim=-1)
        pref = col(1.5 * cosmo.omega_m0 / C_OVER_H0**2, 1)
        return pref * (1.0 + z) * chi * (f1 - chi * f2)
    return win.window_z(cosmo, z, st)


def _lattice_z(cosmo: CosmoParams, st):
    """(chi (1, n_chi), z, z_mid (B, n_chi)) at the lattice nodes and
    midpoints: Newton chi -> z from the static fiducial seeds."""
    chi = st.lattice_chi[None, :]
    n = st.grid.n_dist
    z = background.z_of_chi(cosmo, chi, st.z_seed[None, :], st, n)
    z_mid = background.z_of_chi(
        cosmo, chi * float(np.exp(0.5 * st.grid.lattice_dln)),
        st.z_seed_mid[None, :], st, n)
    return chi, z, z_mid


def _lattice_g_rows(cosmo: CosmoParams, pairs, st, growth_pivot):
    """Limber lattice weights G(u) = W_a W_b D^2 / chi * dln for each
    window pair in ``pairs``: (B, R, n_chi).  The lattice redshifts, the
    growth and each distinct window are evaluated once."""
    chi, z, z_mid = _lattice_z(cosmo, st)
    d = (background.growth_factor(cosmo, z, st, st.grid.n_growth)
         / col(growth_pivot, 1))
    wins = {}
    for win in (w for pair in pairs for w in pair):
        if id(win) not in wins:
            wins[id(win)] = _window_on_lattice(cosmo, win, z, chi, st, z_mid)
    return torch.stack([wins[id(wa)] * wins[id(wb)] * d * d / chi
                        * st.grid.lattice_dln for wa, wb in pairs], dim=1)


def p_lattice_halo_all(cosmo, halo_params, model, st):
    """All halo-model spectra on the static k lattice (one evaluation)."""
    from chomp_tpu_torch import halo as halo_mod

    return halo_mod.powers(cosmo, halo_params, model, st.lattice_k, st)

