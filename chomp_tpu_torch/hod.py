"""Halo occupation: the Zheng et al. 2005 five-parameter HOD.

PyTorch counterpart of the JAX package's ``hod.py``'s ``HODZheng``.  Fields are
0-d tensors (or ``(B,)``, broadcast over the cosmology batch); masses
``m`` carry the batch as their first axis.  The central moment keeps the
``0.5*erfc(-x)`` form (float32-safe low-mass tail).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from chomp_tpu_torch.params import _Params, _as_tensor
from chomp_tpu_torch.special import erfc


@dataclasses.dataclass(frozen=True)
class HODZheng(_Params):
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
        return self.central_moment(m) * torch.where(
            frac > 0.0, torch.clamp_min(frac, 1e-300) ** p.alpha, 0.0)

    def first_moment(self, m):
        return self.central_moment(m) + self.satellite_moment(m)

    def second_moment(self, m):
        nc = self.central_moment(m)
        ns = self.satellite_moment(m)
        return 2.0 * nc * ns + ns * ns

    def breakpoints(self):
        """Satellite onset ln M_0 (moments are C^0 there)."""
        return (self.log10_m_0 * math.log(10.0),)


def default_hod(*, device, dtype, **overrides) -> HODZheng:
    """Fiducial Zheng05 HOD (the JAX package's defaults)."""
    vals = dict(log10_m_min=12.14, sigma=0.15, log10_m_0=12.14,
                log10_m_1p=13.43, alpha=1.0)
    vals.update(overrides)
    return HODZheng(**{k: _as_tensor(float(v), device, dtype)
                       for k, v in vals.items()})
