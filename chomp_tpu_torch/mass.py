"""Sheth-Tormen halo mass function and bias on GL mass nodes.

PyTorch counterpart of the JAX package's ``mass.py`` on the slice's path:
``build_mass_tables`` (one set of ln M GL nodes serving as evaluation
grid and quadrature rule, finite-range renormalized f(nu) and b(nu)),
``node_pack`` (the same quantities at per-cosmology panel nodes) and
``m_star``, with the Tinker 2008 multiplicity and Tinker 2010 bias
selected per element by ``HaloParams.mass_fn`` (0 Sheth-Tormen, 1
Tinker; the Tinker norms are pinned to 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chomp_tpu_torch import background, linear
from chomp_tpu_torch.params import CosmoParams, HaloParams, col


def interp(x, xp, fp):
    """Batched ``jnp.interp``: row b interpolates its queries in the
    sorted row ``xp[b]`` with values ``fp[b]``; ``xp`` and ``fp`` are
    (B|1, n), one shared row broadcasting.  ``x`` is (B|1,), one query
    per row (result (B,)), or (B|1, Q) (result (B, Q)).  Same
    searchsorted side, tie guard and end clamps as jnp.interp."""
    n = xp.shape[-1]
    one = x.dim() < 2
    xq = x.reshape(-1, 1) if one else x
    rows = max(xp.shape[0], fp.shape[0], xq.shape[0])
    xq = xq.expand(rows, xq.shape[1]).contiguous()
    xp = xp.expand(rows, n).contiguous()
    fp = fp.expand(rows, n)
    i = torch.clamp(torch.searchsorted(xp, xq, right=True),
                    1, n - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    df = f1 - f0
    dx = x1 - x0
    delta = xq - x0
    eps = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xq < xp[:, :1], fp[:, :1], f)
    f = torch.where(xq > xp[:, -1:], fp[:, -1:], f)
    return f[:, 0] if one else f


@dataclasses.dataclass(frozen=True)
class MassTables:
    """Mass-function state at one redshift; arrays (B, nM), scalars (B,)."""

    ln_m: torch.Tensor
    w_lnm: torch.Tensor
    m: torch.Tensor
    sigma: torch.Tensor
    nu: torch.Tensor
    dnu_dlnm: torch.Tensor
    f_nu: torch.Tensor
    bias: torch.Tensor
    dndlnm: torch.Tensor
    f_norm: torch.Tensor
    bias_norm: torch.Tensor
    ln_m_star: torch.Tensor
    delta_c: torch.Tensor
    growth: torch.Tensor
    z: torch.Tensor


def halo_delta_c(cosmo: CosmoParams, halo: HaloParams, z):
    """Collapse threshold by sentinel: > 0 literal, -1 NFW97, -2 KS96,
    -3 EdS.  ``z`` (B|1,) -> (B,)."""
    dc = halo.delta_c
    fit = torch.where(
        dc > -1.5, background.delta_c(cosmo, z),
        torch.where(dc > -2.5, background.delta_c_ks96(cosmo, z),
                    background.DELTA_C_EDS))
    return torch.where(dc > 0.0, dc, fit)


#: Tinker et al. 2008 redshift-evolution exponent of b(z) at Delta = 200
#: x mean: log10 alpha = -(0.75 / log10(Delta / 75))^1.2.
_T08_ALPHA = float(10.0 ** (-(0.75 / np.log10(200.0 / 75.0)) ** 1.2))
#: Tinker et al. 2010 bias coefficients at y = log10(Delta = 200).
_T10_Y = float(np.log10(200.0))
_T10_EXP = float(np.exp(-(4.0 / _T10_Y) ** 4))
_T10_BIG_A = 1.0 + 0.24 * _T10_Y * _T10_EXP
_T10_LIT_A = 0.44 * _T10_Y - 0.88
_T10_BIG_C = 0.019 + 0.107 * _T10_Y + 0.19 * _T10_EXP
#: Tinker 2010's bias is calibrated with the fixed EdS threshold.
_T10_DC = 1.686


def _f_tinker08_raw(nu, z, delta_c):
    """Tinker et al. 2008 multiplicity (Delta = 200 x mean, z-evolving
    coefficients clamped at z = 3) in the nu-squared convention:
    f_nu = f(sigma) / (2 nu).  ``z`` and ``delta_c`` broadcast against
    ``nu``."""
    sig = delta_c / torch.sqrt(nu)
    zc = torch.clamp(z, 0.0, 3.0)
    big_a = 0.186 * (1.0 + zc) ** -0.14
    a = 1.47 * (1.0 + zc) ** -0.06
    b = 2.57 * (1.0 + zc) ** -_T08_ALPHA
    f_sig = big_a * ((sig / b) ** -a + 1.0) * torch.exp(-1.19 / sig**2)
    return f_sig / (2.0 * nu)


def _bias_tinker10_raw(nu):
    """Tinker et al. 2010 halo bias (Delta = 200 x mean) in the peak
    height sqrt(nu); calibrated amplitude, not renormalized."""
    nut = torch.sqrt(nu)
    na = nut**_T10_LIT_A
    return (1.0 - _T10_BIG_A * na / (na + _T10_DC**_T10_LIT_A)
            + 0.183 * nut**1.5 + _T10_BIG_C * nut**2.4)


def _tinker(halo: HaloParams, nd: int):
    """Per-element selector of the Tinker forms, shaped as ``col``."""
    return col(halo.mass_fn, nd) >= 0.5


def f_nu_raw(halo: HaloParams, nu, z, delta_c):
    """Un-normalized multiplicity (nu-squared convention) of
    ``halo.mass_fn``: 0 Sheth-Tormen, 1 Tinker 2008, selected per element
    (the fields may carry a batch axis).  ``nu`` (B, N); ``z`` and
    ``delta_c`` (B|1,) feed the Tinker form only."""
    a, q = col(halo.st_little_a, 1), col(halo.stq, 1)
    anu = a * nu
    st = (1.0 + anu**-q) * torch.sqrt(anu) * torch.exp(-0.5 * anu) / nu
    return torch.where(_tinker(halo, 1), _f_tinker08_raw(
        nu, col(z, 1), col(delta_c, 1)), st)


def bias_raw(halo: HaloParams, nu, delta_c):
    """Un-normalized halo bias of ``halo.mass_fn``: 0 Sheth-Tormen, 1
    Tinker 2010, per element; ``delta_c`` (B,)."""
    a, q = col(halo.st_little_a, 1), col(halo.stq, 1)
    dc = col(delta_c, 1)
    anu = a * nu
    st = (1.0 + (anu - 1.0) / dc + 2.0 * q / (dc * (1.0 + anu**q)))
    return torch.where(_tinker(halo, 1), _bias_tinker10_raw(nu), st)


def _sigma_nu(cosmo, m, st, z, growth, dc):
    """(nu, dnu/dlnM) at masses ``m`` (B|1, N)."""
    r = linear.radius_of_mass(cosmo, m)
    s2_un, ds2_dlnr = linear.sigma2_unnorm_r_and_dlnr(cosmo, r, st, z,
                                                      species="cb")
    norm = col(linear.power_norm(cosmo, st), 1)
    sigma = torch.sqrt(norm * s2_un) * col(growth, 1)
    nu = (col(dc, 1) / sigma) ** 2
    dnu_dlnm = -nu * ds2_dlnr / (3.0 * s2_un)
    return sigma, nu, dnu_dlnm


def build_mass_tables(cosmo: CosmoParams, halo: HaloParams, z, st
                      ) -> MassTables:
    """All mass-function state at redshift ``z`` ((B|1,) tensor).  The
    Sheth-Tormen f and b are renormalized over the finite mass range;
    the Tinker forms keep their calibrated amplitudes (norms 1)."""
    ln_m = st.mass_ln_m[None, :]
    w_lnm = st.mass_w[None, :]
    m = torch.exp(ln_m)
    d = background.growth_factor(cosmo, z, st, st.grid.n_growth)
    dc = halo_delta_c(cosmo, halo, z)
    sigma, nu, dnu_dlnm = _sigma_nu(cosmo, m, st, z, d, dc)

    tinker = _tinker(halo, 0)
    f_raw = f_nu_raw(halo, nu, z, dc)
    f_norm = torch.where(
        tinker, 1.0, 1.0 / torch.sum(w_lnm * f_raw * dnu_dlnm, dim=-1))
    f_n = col(f_norm, 1) * f_raw
    b_raw = bias_raw(halo, nu, dc)
    bias_norm = torch.where(
        tinker, 1.0, 1.0 / torch.sum(w_lnm * f_n * b_raw * dnu_dlnm, dim=-1))
    b_n = col(bias_norm, 1) * b_raw
    dndlnm = f_n * (col(cosmo.rho_bar, 1) / m) * dnu_dlnm

    lnm_b = ln_m.expand_as(nu)
    ln_m_star = interp(torch.zeros_like(f_norm), torch.log(nu), lnm_b)
    return MassTables(
        ln_m=lnm_b, w_lnm=w_lnm.expand_as(nu), m=m.expand_as(nu),
        sigma=sigma, nu=nu, dnu_dlnm=dnu_dlnm, f_nu=f_n, bias=b_n,
        dndlnm=dndlnm, f_norm=f_norm, bias_norm=bias_norm,
        ln_m_star=ln_m_star, delta_c=dc, growth=d,
        z=z.expand_as(f_norm))


@dataclasses.dataclass(frozen=True)
class NodePack:
    """Mass-function quantities at per-cosmology quadrature nodes (B, N)."""

    ln_m: torch.Tensor
    w_lnm: torch.Tensor
    m: torch.Tensor
    nu: torch.Tensor
    dnu_dlnm: torch.Tensor
    f_nu: torch.Tensor
    bias: torch.Tensor
    dndlnm: torch.Tensor


def node_pack(cosmo: CosmoParams, halo: HaloParams, tables: MassTables,
              ln_lo, ln_hi, n: int, st) -> NodePack:
    """GL rule of order ``n`` on each panel [ln_lo, ln_hi] (both (B, P))
    with the mass-function quantities exact at the nodes, panels
    concatenated in order: (B, P*n).  Normalizations come from
    ``tables``."""
    x, w = st.gl(n)
    half = 0.5 * (ln_hi - ln_lo)
    ln_m = (0.5 * (ln_hi + ln_lo))[..., None] + half[..., None] * x
    w_lnm = half[..., None] * w
    ln_m = ln_m.reshape(ln_m.shape[0], -1)
    w_lnm = w_lnm.reshape(ln_m.shape)
    m = torch.exp(ln_m)
    _, nu, dnu_dlnm = _sigma_nu(cosmo, m, st, tables.z, tables.growth,
                                tables.delta_c)
    f_n = col(tables.f_norm, 1) * f_nu_raw(halo, nu, tables.z,
                                           tables.delta_c)
    b_n = col(tables.bias_norm, 1) * bias_raw(halo, nu, tables.delta_c)
    dndlnm = f_n * (col(cosmo.rho_bar, 1) / m) * dnu_dlnm
    return NodePack(ln_m=ln_m, w_lnm=w_lnm, m=m, nu=nu, dnu_dlnm=dnu_dlnm,
                    f_nu=f_n, bias=b_n, dndlnm=dndlnm)


def m_star(tables: MassTables):
    """M* with nu(M*) = 1, (B,)."""
    return torch.exp(tables.ln_m_star)
