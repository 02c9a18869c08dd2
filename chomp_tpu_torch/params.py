"""Parameter dataclasses and the static grid configuration.

PyTorch counterpart of the JAX package's ``params.py``.  :class:`CosmoParams`
carries the cosmology batch: every field is a tensor of shape ``(B,)``
(or ``()`` for a single cosmology), and every function of the port
broadcasts that leading axis where the JAX package used ``vmap``.
:class:`HaloParams` and the HOD / dN/dz dataclasses hold 0-d tensors
(or ``(B,)`` tensors, broadcast the same way).  :class:`GridSpec` is the
frozen static spec that fixes every array shape; it is a field-for-field
copy of the JAX package's, so one spec can be handed to both packages.

Shape convention used throughout the port: an argument that varies per
cosmology carries the batch as its FIRST axis (size B, or 1 to
broadcast), and :func:`col` shapes a batch parameter to broadcast
against it.
"""

from __future__ import annotations

import dataclasses

import torch

# Speed of light / (100 km/s): c/H0 in Mpc/h units.
C_OVER_H0 = 2997.92458

# rho_crit in (M_sun/h) / (Mpc/h)^3: rho_bar = RHO_CRIT * omega_m.
RHO_CRIT = 2.7754e11


def col(v: torch.Tensor, nd: int) -> torch.Tensor:
    """Shape a batch parameter (``(B,)`` or ``()``) to broadcast against a
    tensor of shape ``(B, *S)`` with ``len(S) == nd``."""
    if v.dim() == 0:
        return v
    return v.reshape(v.shape + (1,) * nd)


def _as_tensor(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


class _Params:
    """Shared helpers of the parameter dataclasses."""

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def to(self, device=None, dtype=None):
        return dataclasses.replace(self, **{
            k: v.to(device=device, dtype=dtype)
            for k, v in self.fields().items()})

    def shaped(self, nd: int):
        """Every field shaped by :func:`col` to broadcast against
        ``(B, *S)`` with ``len(S) == nd``."""
        return dataclasses.replace(self, **{
            k: col(v, nd) for k, v in self.fields().items()})

    def rows(self, lo: int, hi: int):
        """Batch rows ``lo:hi``: every field with a batch axis longer
        than 1 is sliced; 0-d and length-1 fields broadcast as before."""
        return dataclasses.replace(self, **{
            k: v[lo:hi] if v.dim() and v.shape[0] > 1 else v
            for k, v in self.fields().items()})


@dataclasses.dataclass(frozen=True)
class CosmoParams(_Params):
    """Background + linear-power parameters (14 leaves, as in the JAX
    package; flat LCDM fiducial by :func:`default_cosmo`)."""

    omega_m0: torch.Tensor
    omega_b0: torch.Tensor
    omega_l0: torch.Tensor
    h: torch.Tensor
    sigma_8: torch.Tensor
    n_s: torch.Tensor
    t_cmb: torch.Tensor
    w0: torch.Tensor
    wa: torch.Tensor
    m_nu: torch.Tensor
    n_nu: torch.Tensor
    bary_c: torch.Tensor
    bary_eta: torch.Tensor
    a_mod: torch.Tensor

    @property
    def omega_k0(self):
        return 1.0 - self.omega_m0 - self.omega_l0

    @property
    def rho_bar(self):
        return RHO_CRIT * self.omega_m0

    @property
    def batch(self) -> int:
        return max(v.numel() for v in self.fields().values())

    def batched(self) -> "CosmoParams":
        """Every field broadcast to shape ``(B,)``."""
        n = self.batch
        return dataclasses.replace(self, **{
            k: v.reshape(-1).expand(n).contiguous()
            for k, v in self.fields().items()})


_COSMO_DEFAULTS = dict(
    omega_m0=0.278, omega_b0=0.046, omega_l0=0.722, h=0.7, sigma_8=0.811,
    n_s=0.960, t_cmb=2.726, w0=-1.0, wa=0.0, m_nu=0.0, n_nu=3.0,
    bary_c=1.0, bary_eta=0.0, a_mod=1.0)


def default_cosmo(*, device, dtype, **overrides) -> CosmoParams:
    """Fiducial flat LCDM (chomp defaults; 0-d tensors)."""
    vals = dict(_COSMO_DEFAULTS, **overrides)
    return CosmoParams(**{k: _as_tensor(float(v), device, dtype)
                          for k, v in vals.items()})


@dataclasses.dataclass(frozen=True)
class HaloParams(_Params):
    """Halo-model parameters; ``delta_v``/``delta_c`` use the sentinels of
    the JAX package (> 0 literal, -1/-2/-3 fit conventions); ``mass_fn``
    0 selects Sheth-Tormen, 1 Tinker (per element)."""

    stq: torch.Tensor
    st_little_a: torch.Tensor
    c0: torch.Tensor
    beta: torch.Tensor
    alpha: torch.Tensor
    delta_v: torch.Tensor
    delta_c: torch.Tensor
    mass_fn: torch.Tensor


_HALO_DEFAULTS = dict(stq=0.3, st_little_a=0.707, c0=9.0, beta=-0.13,
                      alpha=-1.0, delta_v=-1.0, delta_c=-1.0, mass_fn=0.0)


def default_halo(*, device, dtype, **overrides) -> HaloParams:
    vals = dict(_HALO_DEFAULTS, **overrides)
    return HaloParams(**{k: _as_tensor(float(v), device, dtype)
                         for k, v in vals.items()})


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid/quadrature configuration (field-for-field the JAX
    package's ``GridSpec``; see its docstring for each knob)."""

    k_min: float = 1.0e-3
    k_max: float = 1.0e2
    n_k: int = 1024
    k_table_min: float = 1.0e-5
    k_table_max: float = 1.0e4
    n_k_table: int = 4096
    sigma_k_min: float = 1.0e-5
    sigma_k_max: float = 1.0e3
    sigma_panels: int = 16
    sigma_n_per_panel: int = 64
    n_growth: int = 64
    n_dist: int = 64
    m_min: float = 1.0e9
    m_max: float = 1.0e16
    n_mass: int = 256
    n_z_proj: int = 128
    n_z_lens: int = 128
    n_ell: int = 1024
    ell_min: float = 1.0e-1
    ell_max: float = 3.0e7
    fftlog_taper_lo: float = 0.08
    fftlog_taper_hi: float = 0.05
    theta_min_deg: float = 1.0e-3
    theta_max_deg: float = 1.0
    n_theta: int = 64
    n_z_dndz: int = 256
    lattice_dln: float = 0.008
    lattice_k_lo: float = 1.0e-5
    lattice_k_hi: float = 2.0e7
    lattice_chi_lo: float = 0.5
    lattice_chi_hi: float = 1.5e4
    n_mu: int = 32
    scranton_switch: bool = True
    nu_convention: str = "squared"

    def replace(self, **kw) -> "GridSpec":
        return dataclasses.replace(self, **kw)


DEFAULT_GRID = GridSpec()
