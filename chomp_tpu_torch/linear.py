"""Linear matter power: the EH98 transfers, sigma(R), P_lin(k, z).

PyTorch counterpart of the JAX package's ``linear.py``: the no-wiggle
shape fit, the full EH98 transfer with BAO wiggles and its sound horizon,
sigma(R) and the normalized P_lin.  The JAX package's ``with_bao``
argument is ``st.with_bao`` here, fixed when the
:class:`~chomp_tpu_torch.grids.Statics` are built, so every caller on
those statics (sigma(M), the halo model, the lattice and table spectra,
halofit and the non-Limber RSD term) gets the same transfer.
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


def _eh_scales(c):
    """The EH98 scales shared by the sound horizon and the full transfer:
    (omh2, obh2, theta^4, z_eq, k_eq [1/Mpc], z_d, R(z_d), R(z_eq))."""
    omh2 = c.omega_m0 * c.h * c.h
    obh2 = c.omega_b0 * c.h * c.h
    theta = c.t_cmb / 2.7
    th4 = theta**4
    z_eq = 2.50e4 * omh2 / th4
    k_eq = 7.46e-2 * omh2 / (theta * theta)
    b1d = 0.313 * omh2**-0.419 * (1.0 + 0.607 * omh2**0.674)
    b2d = 0.238 * omh2**0.223
    z_d = (1291.0 * omh2**0.251 / (1.0 + 0.659 * omh2**0.828)
           * (1.0 + b1d * obh2**b2d))
    r_d = 31.5 * obh2 / th4 * (1.0e3 / z_d)
    r_eq = 31.5 * obh2 / th4 * (1.0e3 / z_eq)
    return omh2, obh2, th4, z_eq, k_eq, z_d, r_d, r_eq


def _sound_horizon(k_eq, r_d, r_eq):
    return (2.0 / (3.0 * k_eq) * torch.sqrt(6.0 / r_eq)
            * torch.log((torch.sqrt(1.0 + r_d) + torch.sqrt(r_d + r_eq))
                        / (1.0 + torch.sqrt(r_eq))))


def sound_horizon_drag(cosmo: CosmoParams):
    """Comoving sound horizon at the drag epoch in Mpc (not Mpc/h), EH98
    eqs. 2-6: the ``s`` that places the wiggles of
    :func:`transfer_eh_full`.  Fields (B,) -> (B,)."""
    _o, _b, _t, _zeq, k_eq, _zd, r_d, r_eq = _eh_scales(cosmo)
    return _sound_horizon(k_eq, r_d, r_eq)


def _t0_tilde(q, alpha, beta):
    c = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q**1.08)
    lg = torch.log(_E + 1.8 * beta * q)
    return lg / (lg + c * q * q)


def transfer_eh_full(cosmo: CosmoParams, k):
    """Full EH98 transfer with BAO wiggles (the JAX package's
    ``with_bao=True``): the CDM part (eqs. 9-12, 17-20) and the baryon
    part (eqs. 13-15, 21-24) combined by eq. 16.  ``k`` (B|1, nk) in
    h/Mpc; k is in 1/Mpc inside.

    Evaluated in float64 whatever ``k``'s dtype, and returned in it: in
    float32 the wiggles' phase k s~ and the near-cancelling EH98 terms
    lose ~1e-6 of T, an error that oscillates in k with the wiggles and
    that the curved P_ell sums amplify ~100x where w(theta) nears zero at
    a few degrees (1.2e-4 of such a bin against 6e-7 with this)."""
    if k.dtype != torch.float64:
        return transfer_eh_full(cosmo.to(dtype=torch.float64),
                                k.double()).to(k.dtype)
    c = cosmo.shaped(k.dim() - 1)
    k = k * c.h
    om, ob = c.omega_m0, c.omega_b0
    oc = om - ob
    omh2, obh2, _th4, z_eq, k_eq, z_d, r_d, r_eq = _eh_scales(c)
    s = _sound_horizon(k_eq, r_d, r_eq)
    k_silk = 1.6 * obh2**0.52 * omh2**0.73 * (1.0 + (10.4 * omh2) ** -0.95)
    q = k / (13.41 * k_eq)
    ks = k * s

    a1 = (46.9 * omh2) ** 0.670 * (1.0 + (32.1 * omh2) ** -0.532)
    a2 = (12.0 * omh2) ** 0.424 * (1.0 + (45.0 * omh2) ** -0.582)
    alpha_c = a1 ** (-ob / om) * a2 ** (-((ob / om) ** 3))
    b1 = 0.944 / (1.0 + (458.0 * omh2) ** -0.708)
    b2 = (0.395 * omh2) ** -0.0266
    beta_c = 1.0 / (1.0 + b1 * ((oc / om) ** b2 - 1.0))
    f = 1.0 / (1.0 + (ks / 5.4) ** 4)
    t_c = (f * _t0_tilde(q, 1.0, beta_c)
           + (1.0 - f) * _t0_tilde(q, alpha_c, beta_c))

    y = (1.0 + z_eq) / (1.0 + z_d)
    sq = torch.sqrt(1.0 + y)
    g_y = y * (-6.0 * sq + (2.0 + 3.0 * y) * torch.log((sq + 1.0)
                                                      / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + r_d) ** -0.75 * g_y
    beta_b = 0.5 + ob / om + (3.0 - 2.0 * ob / om) * torch.sqrt(
        (17.2 * omh2) ** 2 + 1.0)
    beta_node = 8.41 * omh2**0.435
    s_tilde = s / (1.0 + (beta_node / ks) ** 3) ** (1.0 / 3.0)
    x = k * s_tilde
    xs = torch.where(torch.abs(x) < 1e-6, 1.0, x)
    j0 = torch.where(torch.abs(x) < 1e-6, 1.0 - x * x / 6.0,
                     torch.sin(xs) / xs)
    t_b = (_t0_tilde(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
           + alpha_b / (1.0 + (beta_b / ks) ** 3)
           * torch.exp(-((k / k_silk) ** 1.4))) * j0
    return ob / om * t_b + oc / om * t_c


def transfer(cosmo: CosmoParams, k, with_bao: bool = False):
    """The transfer of ``with_bao``: :func:`transfer_eh_full` or
    :func:`transfer_nowiggle`."""
    if with_bao:
        return transfer_eh_full(cosmo, k)
    return transfer_nowiggle(cosmo, k)


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
    t = transfer(cosmo, k, st.with_bao)
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
    t = transfer(cosmo, k, st.with_bao)
    d = col(background.growth_factor(cosmo, z, st, st.grid.n_growth), nd)
    s = neutrino.suppression(cosmo, k, z, st, species, st.grid.n_growth)
    return norm * k**c.n_s * t * t * s * s * d * d


def radius_of_mass(cosmo: CosmoParams, m):
    """Lagrangian radius R(M) = (3M / 4 pi rho_bar)^(1/3); ``m`` (B|1, M)."""
    c = cosmo.shaped(m.dim() - 1)
    return (3.0 * m / (4.0 * math.pi * c.rho_bar)) ** (1.0 / 3.0)
