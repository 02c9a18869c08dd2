"""NFW halo profiles: concentration, virial radius, Fourier transform.

PyTorch counterpart of the JAX package's ``profiles.py``.  Masses carry the
cosmology batch as their first axis; ``m_star`` and ``z`` are per
cosmology, ``(B,)`` or ``(1,)``.
"""

from __future__ import annotations

import math

import torch

from chomp_tpu_torch import background
from chomp_tpu_torch.params import CosmoParams, HaloParams, col
from chomp_tpu_torch.special import nfw_n


def concentration(halo: HaloParams, m, m_star, z):
    """c(M) = c0/(1+z) (M/M*)^beta; ``m`` (B|1, N) -> (B, N)."""
    nd = m.dim() - 1
    h = halo.shaped(nd)
    return h.c0 / (1.0 + col(z, nd)) * (m / col(m_star, nd)) ** h.beta


def halo_delta_v(cosmo: CosmoParams, halo: HaloParams, z):
    """Virial overdensity by sentinel: > 0 literal, -1 Bryan-Norman,
    -2 Nakamura-Suto, -3 18 pi^2.  ``z`` (B|1,) -> (B,)."""
    dv = halo.delta_v
    fit = torch.where(
        dv > -1.5, background.delta_v(cosmo, z),
        torch.where(dv > -2.5, background.delta_v_ns97(cosmo, z),
                    18.0 * math.pi**2))
    return torch.where(dv > 0.0, dv, fit)


def virial_radius(cosmo: CosmoParams, halo: HaloParams, m, z):
    """r_v = (3M/(4 pi rho_bar Delta_v))^(1/3), Mpc/h."""
    nd = m.dim() - 1
    dv = col(halo_delta_v(cosmo, halo, z), nd)
    return (3.0 * m / (4.0 * math.pi * col(cosmo.rho_bar, nd) * dv)) ** (
        1.0 / 3.0)


def y_nfw(cosmo: CosmoParams, halo: HaloParams, k, m, m_star, z,
          c_scale=None, k_scale=None):
    """Normalized NFW transform y(k, M) truncated at r_vir, in the
    cancellation-free auxiliary-function form.  Pass ``k`` (B|1, nk, 1)
    and ``m`` (B|1, 1, nM) for the (B, nk, nM) matrix; ``c_scale`` (B,)
    and ``k_scale`` (broadcastable) are the matter-profile feedback
    hooks."""
    if k_scale is not None:
        k = k * k_scale
    c = concentration(halo, m, m_star, z)
    if c_scale is not None:
        c = c * col(c_scale, m.dim() - 1)
    rv = virial_radius(cosmo, halo, m, z)
    rs = rv / c
    x = k * rs
    mu = torch.log(1.0 + c) - c / (1.0 + c)
    return nfw_n(x, c) / mu
