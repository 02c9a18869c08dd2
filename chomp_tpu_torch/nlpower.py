"""Nonlinear matter power: revised halofit (Takahashi et al. 2012).

PyTorch counterpart of the JAX package's ``nlpower.py``: the Gaussian-
filtered variance sigma^2_G(R, z) and its analytic ln R derivatives on a
static 768-node ln k trapezoid, the nonlinear scale by 12 fixed Newton
steps in ln R (no loop that depends on the data), and

    P_NL(k, z) = (2 pi^2 / k^3) [Delta^2_Q(k) + Delta^2_H(k)]

with Takahashi 2012's coefficients on the EH98 linear spectrum of the
statics (``st.with_bao``), the CDM+baryon sector at m_nu > 0 rescaled to
total matter, and the a_mod interpolation against the total-matter linear
power.  The pipelines' ``matter_power="halofit"`` swaps the mm legs for
it.

The per-cosmology parameters (k_sigma, n_eff, C) come from ratios of sums
over the 768 nodes, and C from a difference of two such ratios; the
Newton steps and those sums run in float64 (per-cosmology scalars: it
costs little) on the spectrum of the pipeline's dtype, and the result is
rounded back.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import background, linear, neutrino
from chomp_tpu_torch.params import CosmoParams, col


@lru_cache(maxsize=None)
def _gauss_sigma_nodes(n: int = 768, k_lo: float = 1e-5, k_hi: float = 1e3):
    """Static ln-k trapezoid nodes and weights (numpy) of the Gaussian-
    filtered variance."""
    lnk = np.linspace(np.log(k_lo), np.log(k_hi), n)
    w = np.full(n, lnk[1] - lnk[0])
    w[0] *= 0.5
    w[-1] *= 0.5
    return np.exp(lnk), w


def _delta2_lin(cosmo: CosmoParams, k, z, st):
    """Linear Delta^2 of the collapsing (CDM+baryon) sector; ``k`` (B|1,
    nk), ``z`` (B|1,) -> (B, nk)."""
    return (k**3 / (2.0 * np.pi**2)
            * linear.linear_power(cosmo, k, z, st, species="cb"))


@lru_cache(maxsize=None)
def _device_nodes(device, dtype):
    """The nodes (1, n) and weights (n,) on ``device``, copied once."""
    k_np, w_np = _gauss_sigma_nodes()
    kw = dict(dtype=dtype, device=device)
    return torch.as_tensor(k_np, **kw)[None, :], torch.as_tensor(w_np, **kw)


def _nodes(st):
    return _device_nodes(st.device, st.dtype)


def sigma_g2(cosmo: CosmoParams, r, z, st):
    """Gaussian-filtered variance sigma^2_G(R, z) = ∫ dlnk Delta^2_L
    e^{-k^2 R^2}; ``r`` (B|1, M), ``z`` (B|1,) -> (B, M)."""
    k, w = _nodes(st)
    d2 = (_delta2_lin(cosmo, k, z, st) * w)[:, None, :]
    x2 = (k[:, None, :] * r[..., None]) ** 2
    return torch.sum(d2 * torch.exp(-x2), dim=-1)


def _sigma_g2_derivs(d2w, k, lnr):
    """(sigma^2, dln sigma^2/dlnR, d^2 ln sigma^2/dlnR^2) at ``lnr`` (B,)
    from the weighted spectrum ``d2w`` (B, n) on the nodes ``k`` (1, n):
    the derivatives are taken under the integral."""
    x2 = (k * torch.exp(lnr)[:, None]) ** 2
    e = torch.exp(-x2)
    s2 = torch.sum(d2w * e, dim=-1)
    ds2 = torch.sum(d2w * (-2.0 * x2) * e, dim=-1)
    d2s2 = torch.sum(d2w * (4.0 * x2 * x2 - 4.0 * x2) * e, dim=-1)
    dln = ds2 / s2
    return s2, dln, d2s2 / s2 - dln * dln


def halofit_params(cosmo: CosmoParams, z, st, n_newton: int = 12):
    """(k_sigma, n_eff, C), each (B,): sigma_G(1/k_sigma) = 1 by
    ``n_newton`` Newton steps in ln R from a growth-scaled seed, the
    effective index n_eff = -3 - dln sigma^2/dlnR and the curvature C =
    -d^2 ln sigma^2/dlnR^2 there.  The spectrum is evaluated in the
    statics' dtype, the steps and sums in float64."""
    k, w = _nodes(st)
    d2w = (_delta2_lin(cosmo, k, z, st) * w).double()
    k = k.double()
    d = background.growth_factor(cosmo, z, st, st.grid.n_growth)
    lnr = (np.log(2.7) + 1.3 * torch.log(cosmo.sigma_8 * d / 0.8)
           ).double().expand(d2w.shape[0])
    for _ in range(n_newton):
        s2, dln, _d2 = _sigma_g2_derivs(d2w, k, lnr)
        lnr = lnr - torch.log(s2) / dln
    _s2, dln, d2 = _sigma_g2_derivs(d2w, k, lnr)
    return tuple(v.to(st.dtype) for v in (torch.exp(-lnr), -3.0 - dln, -d2))


def _f_exponents(om_z, ol_z):
    """Smith03 f1-f3, interpolated between the open and flat-LCDM fits by
    Omega_L / (1 - Omega_m)."""
    f1a, f2a, f3a = om_z**-0.0732, om_z**-0.1423, om_z**0.0725
    f1b, f2b, f3b = om_z**-0.0307, om_z**-0.0585, om_z**0.0743
    denom = torch.clamp_min(1.0 - om_z, 1e-12)
    frac = torch.clamp(ol_z / denom, 0.0, 1.0)
    return (frac * f1b + (1.0 - frac) * f1a,
            frac * f2b + (1.0 - frac) * f2a,
            frac * f3b + (1.0 - frac) * f3a)


def halofit_power(cosmo: CosmoParams, k, z, st):
    """P_NL(k, z) in (Mpc/h)^3; ``k`` (B|1, nk) in h/Mpc, ``z`` (B|1,) ->
    (B, nk)."""
    k_sig, n, c = (col(v, 1) for v in halofit_params(cosmo, z, st))
    cs = cosmo.shaped(1)
    zc = col(z, 1)
    om_z = col(background.omega_m_z(cosmo, z), 1)
    ol_z = col(background.omega_l_z(cosmo, z), 1)
    ow1w = ol_z * (1.0 + (cs.w0 + cs.wa * zc / (1.0 + zc)))

    an = 10.0 ** (1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3
                  + 0.2250 * n**4 - 0.6038 * c + 0.1749 * ow1w)
    bn = 10.0 ** (-0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * c
                  + 0.2279 * ow1w)
    cn = 10.0 ** (0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * c)
    gam = 0.1971 - 0.0843 * n + 0.8460 * c
    alp = torch.abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * c)
    bet = (2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3
           + 0.3980 * n**4 - 0.1682 * c)
    nun = 10.0 ** (5.2105 + 3.6902 * n)
    f1, f2, f3 = _f_exponents(om_z, ol_z)

    y = k / k_sig
    d2l = _delta2_lin(cosmo, k, z, st)
    d2q = (d2l * (1.0 + d2l) ** bet / (1.0 + alp * d2l)
           * torch.exp(-(y / 4.0 + y * y / 8.0)))
    d2hp = (an * y ** (3.0 * f1)
            / (1.0 + bn * y**f2 + (cn * f3 * y) ** (3.0 - gam)))
    d2h = d2hp / (1.0 + nun / torch.clamp_min(y, 1e-30) ** 2)
    r = neutrino.m_over_cb(cosmo, k, z, st, st.grid.n_growth)
    p_nl = (d2q + d2h) * r * r * (2.0 * np.pi**2) / k**3
    p_lin_m = linear.linear_power(cosmo, k, z, st, species="m")
    return p_nl + (cs.a_mod - 1.0) * (p_nl - p_lin_m)


def p_lattice_halofit(cosmo: CosmoParams, z, st):
    """halofit P_NL on the pipeline's k lattice, (B, n_k): the mm row that
    ``matter_power="halofit"`` puts in place of the halo model's."""
    return halofit_power(cosmo, st.lattice_k[None, :], z, st)
