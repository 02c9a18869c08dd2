"""Angular correlation functions: w(theta), gamma_t, xi_+/-.

PyTorch counterpart of the JAX package's ``correlation.py``.  The numpy
half (the log-ell FFTLog grid, the output theta bins, the Hankel operator
and the fused Hankel + theta-binning operator, float64) is copied, since
the JAX module imports jax; the runtime half is batched torch:

    C_ell rows (B, n_ell) -> one matmul with the Hankel operator -> w on
    the FFTLog theta grid -> zero-crossing-safe interpolation to the bins
    (``wtheta_from_cl``), or one matmul with the fused operator straight
    to static bins (``wtheta_from_cl_fused``; engine "pallas" is kernel B).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import projection
from chomp_tpu_torch.fftlog import hankel_operator
from chomp_tpu_torch.grids import catmull_rom_weights_np, interp_loglog_cubic
from chomp_tpu_torch.mass import interp
from chomp_tpu_torch.ops.hankel_matmul import hankel_matmul, hankel_matmul_ref
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


def _like(a, ref):
    """``a`` (numpy or tensor) as a tensor on ``ref``'s device and dtype."""
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=ref.dtype, device=ref.device)


def _interp_to_theta(theta_grid_rad, w_grid, theta_query_rad):
    """Interpolation of w (..., n_grid) on the log-spaced ``theta_grid_rad``
    to ``theta_query_rad`` (Q,), zero-crossing safe: log-magnitude
    Catmull-Rom wherever the stencil plus one guard point on each side
    is single-signed, plain linear interpolation where it straddles a
    zero crossing (ln|w| has a pole there).  Returns (..., Q)."""
    ln_t = torch.log(theta_grid_rad)
    ln0 = ln_t[0]
    dln = ln_t[1] - ln0
    lnq = torch.log(theta_query_rad)
    n = theta_grid_rad.shape[0]
    i = torch.clamp(torch.floor((lnq - ln0) / dln).long(), 1, n - 3)

    w = w_grid.reshape(-1, n)                                  # (M, n)
    linear = interp(lnq[None, :], ln_t[None, :], w)            # (M, Q)
    ln_absw = torch.log(torch.clamp_min(torch.abs(w), 1e-300))
    cubic = torch.sign(linear) * torch.exp(
        interp_loglog_cubic(lnq[None, :], ln0, dln, ln_absw))
    idx = torch.clamp(i[:, None] + torch.arange(-2, 4, device=i.device),
                      0, n - 1)                                # (Q, 6)
    stencil = w[:, idx]                                        # (M, Q, 6)
    single_signed = (torch.all(stencil > 0.0, dim=-1)
                     | torch.all(stencil < 0.0, dim=-1))
    out = torch.where(single_signed, cubic, linear)
    return out.reshape(*w_grid.shape[:-1], out.shape[-1])


def wtheta_from_cl(cl_grid, theta_deg, grid: GridSpec = DEFAULT_GRID,
                   mu: float = 0.0):
    """w(theta) (or gamma_t with mu=2, xi_- with mu=4) from C_l sampled
    on the static ell grid: ``cl_grid`` (..., n_ell) -> (..., n_query).
    The Hankel matmul runs at full float32 precision (no TF32): the
    oscillatory J0/J2 cancellations lose ~1e-3 at TF32 and ~1e-2 at
    bf16."""
    theta_grid, w_op = wtheta_operator(grid, mu)
    w = hankel_matmul_ref(cl_grid, _like(w_op, cl_grid).T)
    th = torch.deg2rad(_like(theta_deg, cl_grid).reshape(-1))
    return _interp_to_theta(_like(theta_grid, cl_grid), w, th)


@lru_cache(maxsize=None)
def wtheta_bins_operator(theta_key, grid: GridSpec = DEFAULT_GRID,
                         mu: float = 0.0):
    """Static operator with w(theta_bins) = Op @ C_l (float64 numpy): the
    Hankel operator composed with Catmull-Rom weights at the bins."""
    theta_deg = np.asarray(theta_key)
    theta_grid, w_op = wtheta_operator(grid, mu)
    ln_t = np.log(theta_grid)
    d = ln_t[1] - ln_t[0]
    q = np.log(np.radians(theta_deg))
    w2 = catmull_rom_weights_np(len(ln_t), (q - ln_t[0]) / d)
    return np.ascontiguousarray(w2 @ w_op)


def wtheta_from_cl_fused(cl_grid, theta_deg, grid: GridSpec = DEFAULT_GRID,
                         mu: float = 0.0, engine: str = "xla"):
    """w at STATIC theta bins from C_l rows (..., n_ell) through the fused
    operator, one matmul.  ``engine``: "xla" is ``torch.matmul`` at full
    float32 precision (TF32 off for the call); "pallas" is kernel B
    (:mod:`chomp_tpu_torch.ops.hankel_matmul`: the CUDA kernel for CUDA
    rows, its plain version for CPU rows, a raise on any other device).
    Unlike the JAX Pallas kernel, "pallas" keeps float64 rows in float64
    (the kernel's reference mode)."""
    if engine not in ("xla", "pallas"):
        raise ValueError(f"engine must be 'xla' or 'pallas', got {engine!r}")
    theta_np = (theta_deg.detach().cpu().numpy() if torch.is_tensor(theta_deg)
                else np.asarray(theta_deg))
    op = wtheta_bins_operator(tuple(theta_np.reshape(-1).tolist()), grid, mu)
    op_t = _like(op.T, cl_grid).contiguous()
    if engine == "xla":
        return hankel_matmul_ref(cl_grid, op_t)
    cl2 = torch.atleast_2d(cl_grid).contiguous()
    out = hankel_matmul(cl2, op_t)
    return out if cl_grid.dim() > 1 else out[0]


def _cl_transform(cosmo, win_a, win_b, p_table, st, theta_deg, mu):
    if theta_deg is None:
        theta_deg = theta_bins_deg(st.grid)
    ells, _, _ = ell_grid(st.grid)
    cl = projection.limber_cl(cosmo, win_a, win_b, ells, p_table, st)
    return wtheta_from_cl(cl, theta_deg, st.grid, mu=mu)


def wtheta(cosmo, win_a, win_b, p_table, st, theta_deg=None):
    """Angular correlation w(theta) [J0], (B, n_theta): Limber C_ell on
    the ell grid, then :func:`wtheta_from_cl`."""
    return _cl_transform(cosmo, win_a, win_b, p_table, st, theta_deg, 0.0)


def gamma_t(cosmo, win_lens, win_src, p_table, st, theta_deg=None):
    """Tangential shear gamma_t(theta) [J2]: the galaxy-convergence
    spectrum's J2 transform."""
    return _cl_transform(cosmo, win_lens, win_src, p_table, st, theta_deg,
                         2.0)


def xi_plus(cosmo, win_src_a, win_src_b, p_table, st, theta_deg=None):
    """Shear-shear xi_+(theta): the J0 transform of the convergence
    spectrum (flat-sky Limber, no B modes)."""
    return _cl_transform(cosmo, win_src_a, win_src_b, p_table, st,
                         theta_deg, 0.0)


def xi_minus(cosmo, win_src_a, win_src_b, p_table, st, theta_deg=None):
    """Shear-shear xi_-(theta): the J4 transform (see :func:`xi_plus`)."""
    return _cl_transform(cosmo, win_src_a, win_src_b, p_table, st,
                         theta_deg, 4.0)


def magnification_correlation(cosmo, win_gal, win_conv, p_table, st,
                              theta_deg=None, alpha_slope=2.0):
    """Galaxy-magnification correlation w_mag = 2 (alpha - 1) w_{g kappa},
    alpha the faint-end number-count slope."""
    return 2.0 * (alpha_slope - 1.0) * _cl_transform(
        cosmo, win_gal, win_conv, p_table, st, theta_deg, 0.0)


def write_ascii(path, theta_deg, w, header="theta_deg  w(theta)"):
    """ASCII output table: columns theta_deg and w (numpy or tensors)."""
    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    np.savetxt(path, np.column_stack([host(theta_deg), host(w)]),
               header=header)
