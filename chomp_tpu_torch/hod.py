"""Halo occupation distributions: the Zheng et al. 2005 five-parameter
HOD and the Poisson, Mandelbaum et al. 2005 and Kravtsov et al. 2004
variants.

PyTorch counterpart of the JAX package's ``hod.py``.  Fields are 0-d
tensors (or ``(B,)``, broadcast over the cosmology batch); masses ``m``
carry the batch as their first axis.  Every family gives the central,
satellite, first, second and n-th factorial moments (Bernoulli centrals,
Poisson satellites that need a central, except :class:`HODPoisson`) and
``breakpoints()``, the lnM where its moments are non-smooth, which the
halo model makes panel edges of its galaxy quadrature.  Zheng's central
moment keeps the ``0.5*erfc(-x)`` form (float32-safe low-mass tail).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from chomp_tpu_torch.params import _Params, _as_tensor
from chomp_tpu_torch.special import erfc


class _CentralSatellite:
    """The moments of a Bernoulli central and Poisson satellites that
    need it: <N> = Nc + Ns, <N(N-1)> = 2 Nc Ns + Ns^2 and the factorial
    moment <(N)_n> = n Nc Ns^(n-1) + Ns^n."""

    def first_moment(self, m):
        return self.central_moment(m) + self.satellite_moment(m)

    def second_moment(self, m):
        nc = self.central_moment(m)
        ns = self.satellite_moment(m)
        return 2.0 * nc * ns + ns * ns

    def nth_moment(self, m, n: int):
        if n == 1:
            return self.first_moment(m)
        nc = self.central_moment(m)
        ns = self.satellite_moment(m)
        return n * nc * ns ** (n - 1) + ns**n


@dataclasses.dataclass(frozen=True)
class HODZheng(_CentralSatellite, _Params):
    """<N_cen> = 1/2 [1 + erf((log10 M - log10 M_min)/sigma)];
    <N_sat> = <N_cen> ((M - M_0)/M_1')^alpha for M > M_0, else 0."""

    log10_m_min: torch.Tensor
    sigma: torch.Tensor
    log10_m_0: torch.Tensor
    log10_m_1p: torch.Tensor
    alpha: torch.Tensor

    def central_moment(self, m):
        p = self.shaped(m.dim() - 1)
        x = (torch.log10(m) - p.log10_m_min) / p.sigma
        return 0.5 * erfc(-x)

    def satellite_moment(self, m):
        p = self.shaped(m.dim() - 1)
        m0 = 10.0**p.log10_m_0
        m1p = 10.0**p.log10_m_1p
        frac = torch.clamp_min(m - m0, 0.0) / m1p
        # The floor keeps the masked branch's gradient finite (the JAX
        # package's 1e-300, or the dtype's smallest normal in float32).
        floor = max(1e-300, torch.finfo(frac.dtype).tiny)
        return self.central_moment(m) * torch.where(
            frac > 0.0, torch.clamp_min(frac, floor) ** p.alpha, 0.0)

    def breakpoints(self):
        """Satellite onset ln M_0 (moments are C^0 there)."""
        return (self.log10_m_0 * math.log(10.0),)


@dataclasses.dataclass(frozen=True)
class HODPoisson(_Params):
    """Pure-Poisson occupation around a power-law mean: <N> =
    (M/M_min)^alpha for M > M_min, else 0; <(N)_n> = <N>^n."""

    log10_m_min: torch.Tensor
    alpha: torch.Tensor

    def first_moment(self, m):
        p = self.shaped(m.dim() - 1)
        frac = m / 10.0**p.log10_m_min
        return torch.where(frac > 1.0, frac**p.alpha, 0.0)

    def central_moment(self, m):
        return torch.clamp_max(self.first_moment(m), 1.0)

    def satellite_moment(self, m):
        return self.first_moment(m) - self.central_moment(m)

    def second_moment(self, m):
        n = self.first_moment(m)
        return n * n

    def nth_moment(self, m, n: int):
        return self.first_moment(m) ** n

    def breakpoints(self):
        """The onset ln M_min."""
        return (self.log10_m_min * math.log(10.0),)


@dataclasses.dataclass(frozen=True)
class HODMandelbaum(_CentralSatellite, _Params):
    """Central step at M0; satellites (M/(3 M0))^2 / w below 3 M0 and
    (M/(3 M0)) / w above (continuous)."""

    m0: torch.Tensor
    w: torch.Tensor

    def central_moment(self, m):
        p = self.shaped(m.dim() - 1)
        return torch.where(m > p.m0, 1.0, 0.0).to(m.dtype)

    def satellite_moment(self, m):
        p = self.shaped(m.dim() - 1)
        x = m / (3.0 * p.m0)
        return torch.where(x < 1.0, x * x, x) / p.w

    def breakpoints(self):
        """The central step ln M0 and the satellites' break ln 3 M0."""
        return (torch.log(self.m0), torch.log(3.0 * self.m0))


@dataclasses.dataclass(frozen=True)
class HODKravtsov(_CentralSatellite, _Params):
    """<N_cen> = theta(M - M_min), <N_sat> = <N_cen> (M/M_1)^alpha."""

    log10_m_min: torch.Tensor
    log10_m_1: torch.Tensor
    alpha: torch.Tensor

    def central_moment(self, m):
        p = self.shaped(m.dim() - 1)
        return torch.where(m > 10.0**p.log10_m_min, 1.0, 0.0).to(m.dtype)

    def satellite_moment(self, m):
        p = self.shaped(m.dim() - 1)
        return self.central_moment(m) * (m / 10.0**p.log10_m_1) ** p.alpha

    def breakpoints(self):
        """The central step ln M_min."""
        return (self.log10_m_min * math.log(10.0),)


def default_hod(*, device, dtype, **overrides) -> HODZheng:
    """Fiducial Zheng05 HOD (the JAX package's defaults)."""
    vals = dict(log10_m_min=12.14, sigma=0.15, log10_m_0=12.14,
                log10_m_1p=13.43, alpha=1.0)
    vals.update(overrides)
    return HODZheng(**{k: _as_tensor(float(v), device, dtype)
                       for k, v in vals.items()})
