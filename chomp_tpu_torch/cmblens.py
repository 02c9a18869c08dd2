"""CMB-lensing cross-correlations: the kappa_CMB tracer.

PyTorch counterpart of the JAX package's ``cmblens.py``: the closed-form
single-source-plane lensing window of the CMB last-scattering surface,

    W_kCMB(chi) = (3/2) Omega_m (H0/c)^2 (1+z) chi (1 - chi/chi_*)_+,

chi_* = chi(z_*) per cosmology, zero above ``z_support``; and the static
configuration object that the pipelines' ``include_cmb_lensing`` takes.
The window has the projection windows' ``support`` / ``window_z``
protocol, so its rows ride the pipelines' grouped convolution (lattice
routes) and the GL Limber sum (table route) as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chomp_tpu_torch import background
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams, col

#: Redshift of the CMB last-scattering surface (Planck 2018: 1089.9).
Z_STAR_DEFAULT = 1090.0


@dataclasses.dataclass(frozen=True)
class WindowConvergenceCMB:
    """Single-source-plane lensing efficiency of the CMB (module
    docstring); ``z_star`` and ``z_support`` are 0-d tensors."""

    z_star: torch.Tensor
    z_support: torch.Tensor

    def support(self):
        return torch.zeros_like(self.z_support), self.z_support

    def window_z(self, cosmo: CosmoParams, z, st):
        """W at ``z`` (B|1, N) -> (B, N)."""
        nd = z.dim() - 1
        n = st.grid.n_dist
        chi = background.comoving_distance(cosmo, z, st, n)
        chi_star = col(background.comoving_distance(
            cosmo, self.z_star.reshape(1), st, n), nd)
        pref = col(1.5 * cosmo.omega_m0 / C_OVER_H0**2, nd)
        w = pref * (1.0 + z) * chi * torch.clamp_min(1.0 - chi / chi_star,
                                                     0.0)
        return torch.where(z <= self.z_support, w, 0.0)

    def to(self, device=None, dtype=None):
        return WindowConvergenceCMB(
            z_star=self.z_star.to(device=device, dtype=dtype),
            z_support=self.z_support.to(device=device, dtype=dtype))


class CMBLensingSpec:
    """Static kappa_CMB configuration: the source plane ``z_star``, the
    kernel truncation ``z_support`` and an optional reconstruction-noise
    table N_L at ``nl_ell`` (both 1-D, N_L > 0, ``nl_ell`` increasing;
    the covariance builders read it, the predictions do not)."""

    def __init__(self, z_star: float = Z_STAR_DEFAULT,
                 z_support: float = 12.0, nl_ell=None, nl=None):
        self.z_star = float(z_star)
        self.z_support = float(z_support)
        if (nl_ell is None) != (nl is None):
            raise ValueError("pass nl_ell and nl together (or neither)")
        if nl is None:
            self._ln_l = self._ln_n = None
            self.nl_inf = 0.0
            return
        nl_ell = np.asarray(nl_ell, dtype=float)
        nl = np.asarray(nl, dtype=float)
        if nl_ell.ndim != 1 or nl_ell.shape != nl.shape:
            raise ValueError("nl_ell and nl must be equal-length 1-D")
        if np.any(nl <= 0.0):
            raise ValueError("N_L must be positive (log-log interp)")
        if np.any(np.diff(nl_ell) <= 0.0):
            raise ValueError("nl_ell must be strictly increasing")
        self._ln_l, self._ln_n = np.log(nl_ell), np.log(nl)
        self.nl_inf = float(nl[-1])

    def window(self, *, device, dtype) -> WindowConvergenceCMB:
        kw = dict(device=device, dtype=dtype)
        return WindowConvergenceCMB(z_star=torch.tensor(self.z_star, **kw),
                                    z_support=torch.tensor(self.z_support,
                                                           **kw))

    def nl_total(self, ells_np) -> np.ndarray:
        """N_L at ``ells_np`` (numpy): log-log interpolation, clamped to
        the table's edges."""
        if self._ln_l is None:
            return np.zeros(np.shape(np.asarray(ells_np)))
        ln = np.interp(np.log(np.maximum(np.asarray(ells_np, dtype=float),
                                         1e-300)), self._ln_l, self._ln_n)
        return np.exp(ln)

    def nl_resid(self, ells_np) -> np.ndarray:
        """N_L - N_inf, the decaying part of the noise."""
        return self.nl_total(ells_np) - self.nl_inf


def as_cmb_spec(x) -> CMBLensingSpec:
    """The pipelines' ``include_cmb_lensing``: True -> the default
    (noiseless) spec; a :class:`CMBLensingSpec` passes through."""
    if x is True:
        return CMBLensingSpec()
    if isinstance(x, CMBLensingSpec):
        return x
    raise TypeError(f"cmb_lensing must be True or a CMBLensingSpec, got "
                    f"{type(x)!r}")
