"""Linear matter power: the EH98 no-wiggle transfer, sigma(R), P_lin(k, z).

PyTorch counterpart of the JAX package's ``linear.py`` on the slice's
path.  The full-BAO transfer (``with_bao=True``) is not ported yet
(ROADMAP queue 1, item 7, "make_pipeline options").
"""

from __future__ import annotations

import math

import torch

from chomp_tpu_torch import background, neutrino
from chomp_tpu_torch.grids import recompute_in_backward
from chomp_tpu_torch.params import CosmoParams, col

_E = 2.718281828459045


def transfer_nowiggle(cosmo: CosmoParams, k):
    """EH98 zero-baryon shape fit; ``k`` (B|1, nk) in h/Mpc."""
    c = cosmo.shaped(k.dim() - 1)
    omh2 = c.omega_m0 * c.h**2
    obh2 = c.omega_b0 * c.h**2
    theta = c.t_cmb / 2.7
    s = 44.5 * torch.log(9.83 / omh2) / torch.sqrt(1.0 + 10.0 * obh2**0.75)
    fb = c.omega_b0 / c.omega_m0
    alpha_g = (1.0 - 0.328 * torch.log(431.0 * omh2) * fb
               + 0.38 * torch.log(22.3 * omh2) * fb * fb)
    ks = k * c.h * s
    gamma_eff = c.omega_m0 * c.h * (
        alpha_g + (1.0 - alpha_g) / (1.0 + (0.43 * ks) ** 4))
    q = k * theta * theta / gamma_eff
    l0 = torch.log(2.0 * _E + 1.8 * q)
    c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
    return l0 / (l0 + c0 * q * q)


def w_tophat(x):
    """W(x) = 3 (sin x - x cos x)/x^3, series-blended near 0."""
    x2 = x * x
    series = 1.0 - x2 / 10.0 + x2 * x2 / 280.0 - x2 * x2 * x2 / 15120.0
    xs = torch.where(torch.abs(x) < 0.5, 1.0, x)
    closed = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs**3
    return torch.where(torch.abs(x) < 0.5, series, closed)


def dw_tophat(x):
    """dW/dx = 3 ((x^2-3) sin x + 3 x cos x)/x^4, series-blended."""
    x2 = x * x
    series = -x / 5.0 + x * x2 / 70.0 - x * x2 * x2 / 2520.0
    xs = torch.where(torch.abs(x) < 0.5, 1.0, x)
    closed = 3.0 * ((xs * xs - 3.0) * torch.sin(xs)
                    + 3.0 * xs * torch.cos(xs)) / xs**4
    return torch.where(torch.abs(x) < 0.5, series, closed)


def _delta2_unnorm(cosmo, k, st, nu_z, species: str):
    """k^3 k^n_s T^2 S_X^2 / (2 pi^2) on ``k`` (1, nq) -> (B, nq)."""
    c = cosmo.shaped(k.dim() - 1)
    t = transfer_nowiggle(cosmo, k)
    s = neutrino.suppression(cosmo, k, nu_z, st, species, st.grid.n_growth)
    return k**3 * k**c.n_s * t * t * s * s / (2.0 * math.pi**2)


def _sigma_integrands(cosmo, r, st, nu_z, species):
    k = torch.exp(st.sigma_ln_k)[None, :]
    d2 = _delta2_unnorm(cosmo, k, st, nu_z, species)[:, None, :]
    x = k[:, None, :] * r[..., None]
    return d2, x, st.sigma_w


def sigma2_unnorm_r(cosmo: CosmoParams, r, st, nu_z, species: str = "m"):
    """Unnormalized sigma^2(R) = ∫ dln k Delta^2_un(k) W^2(kR); ``r``
    (B|1, M) -> (B, M)."""
    def s2(r):
        d2, x, w = _sigma_integrands(cosmo, r, st, nu_z, species)
        win = w_tophat(x)
        return torch.sum(d2 * win * win * w, dim=-1)

    return recompute_in_backward(s2, r, track=cosmo.fields().values())


def sigma2_unnorm_r_and_dlnr(cosmo: CosmoParams, r, st, nu_z,
                             species: str = "m"):
    """(sigma^2_un(R), d sigma^2_un/d lnR) sharing one node set."""
    def both(r):
        d2, x, w = _sigma_integrands(cosmo, r, st, nu_z, species)
        win = w_tophat(x)
        s2 = torch.sum(d2 * win * win * w, dim=-1)
        ds2 = torch.sum(d2 * 2.0 * win * dw_tophat(x) * x * w, dim=-1)
        return s2, ds2

    return recompute_in_backward(both, r, track=cosmo.fields().values())


def power_norm(cosmo: CosmoParams, st):
    """sigma_8^2 / sigma^2_un(8 Mpc/h) per cosmology, (B,)."""
    r8 = torch.full((1, 1), 8.0, dtype=st.dtype, device=st.device)
    z0 = torch.zeros((1,), dtype=st.dtype, device=st.device)
    s2 = sigma2_unnorm_r(cosmo, r8, st, z0)[:, 0]
    return cosmo.sigma_8**2 / s2


def linear_power(cosmo: CosmoParams, k, z, st, species: str = "m"):
    """Linear P_X(k, z) in (Mpc/h)^3; ``k`` (B|1, nk), ``z`` (B|1,)."""
    nd = k.dim() - 1
    c = cosmo.shaped(nd)
    norm = col(power_norm(cosmo, st), nd)
    t = transfer_nowiggle(cosmo, k)
    d = col(background.growth_factor(cosmo, z, st, st.grid.n_growth), nd)
    s = neutrino.suppression(cosmo, k, z, st, species, st.grid.n_growth)
    return norm * k**c.n_s * t * t * s * s * d * d


def radius_of_mass(cosmo: CosmoParams, m):
    """Lagrangian radius R(M) = (3M / 4 pi rho_bar)^(1/3); ``m`` (B|1, M)."""
    c = cosmo.shaped(m.dim() - 1)
    return (3.0 * m / (4.0 * math.pi * c.rho_bar)) ** (1.0 / 3.0)
