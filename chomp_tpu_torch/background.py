"""Background cosmology: E(z), distances, growth, collapse thresholds.

PyTorch counterpart of the JAX package's ``background.py``.  Redshift arguments
carry the cosmology batch as their first axis (size B, or 1 to
broadcast); GL rules come from a :class:`~chomp_tpu_torch.grids.Statics`.
"""

from __future__ import annotations

import math

import torch

from chomp_tpu_torch.grids import gl_integrate, recompute_in_backward
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams

#: EdS spherical-collapse threshold (3/20)(12 pi)^(2/3).
DELTA_C_EDS = 0.15 * (12.0 * math.pi) ** (2.0 / 3.0)


def _dark_energy(c, zp1):
    """Omega_de(z) E^2(z) of the CPL dark energy; ``c`` already shaped."""
    return c.omega_l0 * zp1 ** (3.0 * (1.0 + c.w0 + c.wa)) * torch.exp(
        -3.0 * c.wa * (1.0 - 1.0 / zp1))


def e2z(cosmo: CosmoParams, z):
    """E^2(z) = H^2(z)/H0^2."""
    c = cosmo.shaped(z.dim() - 1)
    zp1 = 1.0 + z
    return c.omega_m0 * zp1**3 + c.omega_k0 * zp1**2 + _dark_energy(c, zp1)


def ez(cosmo: CosmoParams, z):
    return torch.sqrt(e2z(cosmo, z))


def omega_m_z(cosmo: CosmoParams, z):
    """Omega_m(z)."""
    c = cosmo.shaped(z.dim() - 1)
    zp1 = 1.0 + z
    return c.omega_m0 * zp1**3 / e2z(cosmo, z)


def omega_l_z(cosmo: CosmoParams, z):
    """Omega_de(z) of the CPL dark energy."""
    c = cosmo.shaped(z.dim() - 1)
    return _dark_energy(c, 1.0 + z) / e2z(cosmo, z)


def comoving_distance(cosmo: CosmoParams, z, st, n: int = 64):
    """Line-of-sight comoving distance chi(z) in Mpc/h (GL over [0, z])."""
    x, w = st.gl(n)

    def chi(z):
        return C_OVER_H0 * gl_integrate(lambda zp: 1.0 / ez(cosmo, zp),
                                        torch.zeros_like(z), z, x, w)

    return recompute_in_backward(chi, z, track=cosmo.fields().values())


def z_of_chi(cosmo: CosmoParams, chi, z_seed, st, n: int = 64,
             n_iter: int = 8):
    """chi -> z by Newton iteration from the static seed ``z_seed``
    (f(z) = chi(z) - chi, f'(z) = (c/H0)/E(z)); clamped to [0, 25].
    ``chi`` and ``z_seed`` are ``(1, N)``; the result is ``(B, N)``."""
    z = z_seed
    for _ in range(n_iter):
        f = comoving_distance(cosmo, z, st, n) - chi
        z = torch.clamp(z - f * ez(cosmo, z) / C_OVER_H0, 0.0, 25.0)
    return z


def _growth_unnorm(cosmo: CosmoParams, a, st, n: int):
    """Un-normalized D(a) = 2.5 om E(a) ∫_0^a da'/(a' E(a'))^3, with the
    a' = a u^2 substitution (smooth integrand)."""

    x, w = st.gl(n)

    def integral(a):
        def integrand(u):
            aa = a[..., None]
            ap = aa * u * u
            z = 1.0 / ap - 1.0
            e3 = e2z(cosmo, z) * ez(cosmo, z)
            return 2.0 / (aa * aa * u**5 * e3)

        return gl_integrate(integrand, torch.zeros_like(a),
                            torch.ones_like(a), x, w)

    integral = recompute_in_backward(integral, a,
                                     track=cosmo.fields().values())
    z_of_a = 1.0 / a - 1.0
    c = cosmo.shaped(a.dim() - 1)
    return 2.5 * c.omega_m0 * ez(cosmo, z_of_a) * integral


def growth_factor(cosmo: CosmoParams, z, st, n: int = 64):
    """Linear growth D(z), normalized so D(z=0) = 1."""
    a = 1.0 / (1.0 + z)
    one = torch.ones((1,) * max(z.dim(), 1), dtype=z.dtype, device=z.device)
    return _growth_unnorm(cosmo, a, st, n) / _growth_unnorm(cosmo, one, st, n)


def _dln_e2_dlna(cosmo: CosmoParams, a):
    """d ln E^2 / d ln a, analytic (CPL dark energy and curvature)."""
    c = cosmo.shaped(a.dim() - 1)
    zp1 = 1.0 / a
    de = c.omega_l0 * zp1 ** (3.0 * (1.0 + c.w0 + c.wa)) * torch.exp(
        -3.0 * c.wa * (1.0 - a))
    e2 = c.omega_m0 * zp1**3 + c.omega_k0 * zp1**2 + de
    d_e2 = (-3.0 * c.omega_m0 * zp1**3 - 2.0 * c.omega_k0 * zp1**2
            + de * (-3.0 * (1.0 + c.w0 + c.wa) + 3.0 * c.wa * a))
    return d_e2 / e2


def growth_rate(cosmo: CosmoParams, z, st, n: int = 64):
    """Linear growth rate f(z) = dlnD/dlna of the integral-form growth of
    :func:`growth_factor`, analytically:
    f = (1/2) dlnE^2/dlna + 2.5 Om / (a^2 E^2 D_un(a))."""
    a = 1.0 / (1.0 + z)
    c = cosmo.shaped(z.dim() - 1)
    d_un = _growth_unnorm(cosmo, a, st, n)
    return (0.5 * _dln_e2_dlna(cosmo, a)
            + 2.5 * c.omega_m0 / (a * a * e2z(cosmo, z) * d_un))


def delta_c(cosmo: CosmoParams, z):
    """Spherical-collapse threshold, NFW97 fit."""
    return DELTA_C_EDS * omega_m_z(cosmo, z) ** 0.0055


def delta_c_ks96(cosmo: CosmoParams, z):
    """Kitayama-Suto 1996 threshold fit (HaloParams.delta_c = -2)."""
    return DELTA_C_EDS * (1.0 + 0.0123 * torch.log10(omega_m_z(cosmo, z)))


def delta_v(cosmo: CosmoParams, z):
    """Virial overdensity w.r.t. the MEAN density: Bryan-Norman 1998."""
    om = omega_m_z(cosmo, z)
    x = om - 1.0
    return (18.0 * math.pi**2 + 82.0 * x - 39.0 * x * x) / om


def delta_v_ns97(cosmo: CosmoParams, z):
    """Nakamura-Suto 1997 virial overdensity (HaloParams.delta_v = -2)."""
    x = torch.clamp_min(1.0 / omega_m_z(cosmo, z) - 1.0, 1e-12)
    return 18.0 * math.pi**2 * (1.0 + 0.4093 * x**0.9052)
