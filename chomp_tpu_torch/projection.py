"""Redshift distributions and radial windows.

PyTorch counterpart of the slice's part of the JAX package's ``projection.py``:
the Gaussian dN/dz, its normalization, and the galaxy and convergence
windows.  The convergence window is evaluated only on the Limber lattice
(cumulative Simpson, ``limber_fft._window_on_lattice``).
"""

from __future__ import annotations

import dataclasses

import torch

from chomp_tpu_torch import background
from chomp_tpu_torch.grids import gl_integrate
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams, _Params, col


@dataclasses.dataclass(frozen=True)
class DNdzGaussian(_Params):
    """p(z) ∝ exp(-(z-z0)^2/(2 sigma_z^2)) on [z_min, z_max]."""

    z_min: torch.Tensor
    z_max: torch.Tensor
    z0: torch.Tensor
    sigma_z: torch.Tensor

    def raw_dndz(self, z):
        p = self.shaped(z.dim() - 1)
        return torch.exp(-0.5 * ((z - p.z0) / p.sigma_z) ** 2)


def dndz_norm(dist, st):
    """∫ raw_dndz dz over [z_min, z_max] (GL, grid.n_z_dndz nodes)."""
    x, w = st.gl(st.grid.n_z_dndz)
    return gl_integrate(dist.raw_dndz, dist.z_min, dist.z_max, x, w)


def dndz(dist, z, st):
    """Normalized p(z), zero outside [z_min, z_max]; ``z`` (B|1, N)."""
    nd = z.dim() - 1
    p = dist.shaped(nd)
    inside = (z >= p.z_min) & (z <= p.z_max)
    return (torch.where(inside, dist.raw_dndz(z), 0.0)
            / col(dndz_norm(dist, st), nd))


@dataclasses.dataclass(frozen=True)
class WindowGalaxy:
    """W_g(chi) = p(z) dz/dchi = p(z) E(z)/(c/H0)."""

    dist: object

    def window_z(self, cosmo: CosmoParams, z, st):
        return dndz(self.dist, z, st) * background.ez(cosmo, z) / C_OVER_H0


@dataclasses.dataclass(frozen=True)
class WindowConvergence:
    """Lensing efficiency W_kappa(chi) = (3/2) Omega_m (H0/c)^2 (1+z) chi
    ∫_z^{z_max} dz' p(z') (chi'-chi)/chi' (evaluated on the lattice)."""

    dist: object
