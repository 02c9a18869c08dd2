"""Massive-neutrino EH99 suppression and the m/cb growth ratio.

PyTorch counterpart of the JAX package's ``neutrino.py``: ``suppression`` (the
linear spectra call it) and ``m_over_cb`` (``halo.powers`` applies it to
the matter legs), both identically 1 at m_nu = 0.  ``k_h`` carries the
cosmology batch as its first axis; ``z`` is one redshift per cosmology,
shape ``(B,)`` or ``(1,)``.
"""

from __future__ import annotations

import torch

from chomp_tpu_torch import background
from chomp_tpu_torch.params import CosmoParams, col

#: Omega_nu h^2 = sum m_nu [eV] / 93.14.
NU_MASS_TO_OMEGA_H2 = 1.0 / 93.14

_E = 2.718281828459045


def f_nu_of(cosmo: CosmoParams):
    """Neutrino mass fraction f_nu = Omega_nu/Omega_m (0 when m_nu = 0)."""
    onu = cosmo.m_nu * NU_MASS_TO_OMEGA_H2 / (cosmo.h ** 2)
    return onu / cosmo.omega_m0


def _safe_fractions(cosmo: CosmoParams):
    """(active, f_nu_safe, f_b, n_nu) with f_nu_safe = 0.01 where m_nu = 0
    (keeps the untaken EH99 branch finite)."""
    fnu = f_nu_of(cosmo)
    active = fnu > 0.0
    fnu_s = torch.where(active, fnu, 0.01)
    fb = cosmo.omega_b0 / cosmo.omega_m0
    return active, fnu_s, fb, cosmo.n_nu


def _p_of_f(f):
    """EH99 eq. 11: p = (5 - sqrt(1 + 24 f))/4."""
    return (5.0 - torch.sqrt(1.0 + 24.0 * f)) / 4.0


def _z_eq(cosmo: CosmoParams):
    theta = cosmo.t_cmb / 2.7
    return 2.50e4 * cosmo.omega_m0 * cosmo.h ** 2 / theta ** 4


def _alpha_nu(cosmo: CosmoParams, fnu, fb, n_nu):
    """EH99 eq. 15 small-scale suppression amplitude (per cosmology)."""
    omh2 = cosmo.omega_m0 * cosmo.h ** 2
    obh2 = cosmo.omega_b0 * cosmo.h ** 2
    fc = 1.0 - fnu - fb
    fcb = fc + fb
    fnub = fnu + fb
    pc = _p_of_f(fc)
    pcb = _p_of_f(fcb)
    b1 = 0.313 * omh2 ** -0.419 * (1.0 + 0.607 * omh2 ** 0.674)
    b2 = 0.238 * omh2 ** 0.223
    z_d = (1291.0 * omh2 ** 0.251 / (1.0 + 0.659 * omh2 ** 0.828)
           * (1.0 + b1 * obh2 ** b2))
    y_d = (1.0 + _z_eq(cosmo)) / (1.0 + z_d)
    alpha = (fc / fcb
             * (5.0 - 2.0 * (pc + pcb)) / (5.0 - 4.0 * pcb)
             * (1.0 + y_d) ** (pcb - pc)
             * (1.0 - 0.553 * fnub + 0.126 * fnub ** 3)
             / (1.0 - 0.193 * torch.sqrt(torch.clamp_min(fnu * n_nu, 1e-30))
                + 0.169 * fnu * n_nu ** 0.2)
             * (1.0 + 0.5 * (pc - pcb)
                * (1.0 + 1.0 / ((3.0 - 4.0 * pc) * (7.0 - 4.0 * pcb)))
                / (1.0 + y_d)))
    return alpha, pcb


def _t_sup(cosmo: CosmoParams, k_h, fnu, fb, n_nu):
    """EH99 eqs. 16-21: suppressed master shape T_sup(k) (no nu bump).
    Scalars per cosmology are ``(B,)``; ``k_h`` is ``(B|1, nk)``."""
    nd = k_h.dim() - 1
    c = cosmo.shaped(nd)
    omh2 = cosmo.omega_m0 * cosmo.h ** 2
    obh2 = cosmo.omega_b0 * cosmo.h ** 2
    fnub = fnu + fb
    s = col(44.5 * torch.log(9.83 / omh2)
            / torch.sqrt(1.0 + 10.0 * obh2 ** 0.75), nd)
    alpha, _pcb = _alpha_nu(cosmo, fnu, fb, n_nu)
    sqa = col(torch.sqrt(alpha), nd)
    k = k_h * c.h
    gamma_eff = col(omh2, nd) * (sqa + (1.0 - sqa)
                                 / (1.0 + (0.43 * k * s) ** 4))
    theta = c.t_cmb / 2.7
    q_eff = k * theta * theta / gamma_eff
    beta_c = col(1.0 / (1.0 - 0.949 * fnub), nd)
    ell = torch.log(_E + 1.84 * beta_c * sqa * q_eff)
    cc = 14.4 + 325.0 / (1.0 + 60.5 * q_eff ** 1.11)
    return ell / (ell + cc * q_eff * q_eff)


def shape_ratio(cosmo: CosmoParams, k_h):
    """[T_sup(f_nu) B(k)] / T_sup(f_nu = 0); exactly 1.0 where m_nu = 0."""
    nd = k_h.dim() - 1
    active, fnu, fb, n_nu = _safe_fractions(cosmo)
    c = cosmo.shaped(nd)
    k = k_h * c.h
    theta = c.t_cmb / 2.7
    omh2 = c.omega_m0 * c.h ** 2
    q = k * theta * theta / omh2
    fnu_c, n_nu_c = col(fnu, nd), col(n_nu, nd)
    q_nu = 3.92 * q * torch.sqrt(n_nu_c) / fnu_c
    bump = 1.0 + (1.24 * fnu_c ** 0.64 * n_nu_c ** (0.3 + 0.6 * fnu_c)
                  / (q_nu ** -1.6 + q_nu ** 0.8))
    ratio = (_t_sup(cosmo, k_h, fnu, fb, n_nu) * bump
             / _t_sup(cosmo, k_h, torch.zeros_like(fnu), fb, n_nu))
    return torch.where(col(active, nd), ratio, 1.0)


def _d1_eh99(cosmo: CosmoParams, z, st, n_growth: int):
    """EH99 growth variable D_1(z) = (1+z_eq) D_un(a), per cosmology."""
    a = 1.0 / (1.0 + z)
    return (1.0 + _z_eq(cosmo)) * background._growth_unnorm(cosmo, a, st,
                                                             n_growth)


def growth_ratios(cosmo: CosmoParams, k_h, z, st, n_growth: int = 64):
    """(D_cb/D_1, D_cbnu/D_1) at (k, z) — EH99 eqs. 12-14; both exactly
    1.0 where m_nu = 0."""
    nd = k_h.dim() - 1
    active, fnu, fb, n_nu = _safe_fractions(cosmo)
    fcb = col(1.0 - fnu, nd)
    pcb = _p_of_f(fcb)
    c = cosmo.shaped(nd)
    theta = c.t_cmb / 2.7
    omh2 = c.omega_m0 * c.h ** 2
    q = k_h * c.h * theta * theta / omh2
    fnu_c, n_nu_c = col(fnu, nd), col(n_nu, nd)
    y_fs = (17.2 * fnu_c * (1.0 + 0.488 * fnu_c ** (-7.0 / 6.0))
            * (n_nu_c * q / fnu_c) ** 2)
    d1 = col(_d1_eh99(cosmo, z, st, n_growth), nd)
    core = (d1 / (1.0 + y_fs)) ** 0.7
    d_cb = (1.0 + core) ** (pcb / 0.7) * d1 ** (1.0 - pcb)
    d_cbnu = ((fcb ** (0.7 / pcb) + core) ** (pcb / 0.7)
              * d1 ** (1.0 - pcb))
    one = torch.ones_like(core)
    act = col(active, nd)
    return (torch.where(act, d_cb / d1, one),
            torch.where(act, d_cbnu / d1, one))


def suppression(cosmo: CosmoParams, k_h, z, st, species: str = "m",
                n_growth: int = 64):
    """S_X(k, z) multiplying the EH98 transfer; ``species`` "m" or "cb"."""
    if species not in ("m", "cb"):
        raise ValueError(f"species must be 'm' or 'cb', got {species!r}")
    g_cb, g_m = growth_ratios(cosmo, k_h, z, st, n_growth)
    g = g_m if species == "m" else g_cb
    return shape_ratio(cosmo, k_h) * g


def m_over_cb(cosmo: CosmoParams, k_h, z, st, n_growth: int = 64):
    """r(k, z) = D_cbnu/D_cb, the per-matter-leg rescale of halo.powers."""
    g_cb, g_m = growth_ratios(cosmo, k_h, z, st, n_growth)
    return g_m / g_cb
