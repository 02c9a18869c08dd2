"""Redshift distributions, radial windows, power tables and Limber C_ell.

PyTorch counterpart of the JAX package's ``projection.py`` on the port's
paths: the dN/dz shapes (Gaussian, magnitude-limited, tabulated, and the
photo-z shift of any of them), their normalization, the galaxy and
convergence windows (the convergence window's nested-GL form here; the
lattice route evaluates it by cumulative Simpson in
``limber_fft._window_on_lattice``), the convergence window with NLA
intrinsic alignments,
the window-weighted mean redshift, the ln P tables on the static ln k
grid and the Gauss-Legendre Limber integral of the ``method="table"``
route.  Arrays carry the cosmology batch as their first axis.
"""

from __future__ import annotations

import dataclasses

import torch

from chomp_tpu_torch import background, linear
from chomp_tpu_torch.grids import (gl_integrate, interp_loglog_cubic, loggrid,
                                   recompute_in_backward)
from chomp_tpu_torch.mass import interp
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams, _Params, col

#: Elements of the (B, N, n_z_lens, n_dist) integrand of the nested
#: convergence window evaluated at once: the cosmology axis is cut into
#: chunks of at most this size (0.5 GB per float32 temporary).
NESTED_CHUNK_ELEMENTS = 1 << 27


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


@dataclasses.dataclass(frozen=True)
class DNdzMagLim(_Params):
    """p(z) ∝ z^a exp(-(z/z0)^b) on [z_min, z_max]."""

    z_min: torch.Tensor
    z_max: torch.Tensor
    a: torch.Tensor
    z0: torch.Tensor
    b: torch.Tensor

    def raw_dndz(self, z):
        p = self.shaped(z.dim() - 1)
        zs = torch.clamp_min(z, 1e-12)
        return zs**p.a * torch.exp(-((zs / p.z0) ** p.b))


@dataclasses.dataclass(frozen=True)
class DNdzInterpolation(_Params):
    """Tabulated p(z), linear between the nodes and 0 outside them (the
    JAX ``jnp.interp(..., left=0, right=0)``).  ``z_array`` / ``n_array``
    are (n,) or (B, n), one table per cosmology (then with (B,) limits);
    the limits (B,) or 0-d."""

    z_min: torch.Tensor
    z_max: torch.Tensor
    z_array: torch.Tensor
    n_array: torch.Tensor

    def shaped(self, nd: int):
        return dataclasses.replace(self, z_min=col(self.z_min, nd),
                                   z_max=col(self.z_max, nd))

    def rows(self, lo: int, hi: int):
        def cut(v, rank):
            return v[lo:hi] if v.dim() > rank and v.shape[0] > 1 else v

        return DNdzInterpolation(
            z_min=cut(self.z_min, 0), z_max=cut(self.z_max, 0),
            z_array=cut(self.z_array, 1), n_array=cut(self.n_array, 1))

    def raw_dndz(self, z):
        zp = torch.atleast_2d(self.z_array)
        fp = torch.atleast_2d(self.n_array)
        if zp.shape[0] == 1:
            zq, shape = z.reshape(1, -1), z.shape
        else:
            zq = z.reshape(z.shape[0], -1)
            shape = (zp.shape[0],) + z.shape[1:]
        inside = (zq >= zp[:, :1]) & (zq <= zp[:, -1:])
        return torch.where(inside, interp(zq, zp, fp), 0.0).reshape(shape)


@dataclasses.dataclass(frozen=True)
class DNdzShifted:
    """Additive photo-z shift of any dN/dz ``base``: p(z) = p_base(z - dz)
    on [z_min + dz, z_max + dz].  ``dz`` is (B,) or 0-d, so the support
    differs per cosmology row; the limits stay tensors."""

    base: object
    dz: torch.Tensor

    @property
    def z_min(self):
        return self.base.z_min + self.dz

    @property
    def z_max(self):
        return self.base.z_max + self.dz

    def raw_dndz(self, z):
        return self.base.raw_dndz(z - col(self.dz, z.dim() - 1))

    def shaped(self, nd: int):
        return DNdzShifted(base=self.base.shaped(nd), dz=col(self.dz, nd))

    def rows(self, lo: int, hi: int):
        dz = self.dz
        return DNdzShifted(base=self.base.rows(lo, hi),
                           dz=dz[lo:hi] if dz.dim() and dz.shape[0] > 1
                           else dz)

    def to(self, device=None, dtype=None):
        return DNdzShifted(base=self.base.to(device, dtype),
                           dz=self.dz.to(device=device, dtype=dtype))


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

    def support(self):
        return self.dist.z_min, self.dist.z_max

    def window_z(self, cosmo: CosmoParams, z, st):
        return dndz(self.dist, z, st) * background.ez(cosmo, z) / C_OVER_H0


@dataclasses.dataclass(frozen=True)
class WindowConvergence:
    """Lensing efficiency W_kappa(chi) = (3/2) Omega_m (H0/c)^2 (1+z) chi
    ∫_z^{z_max} dz' p(z') (chi'-chi)/chi'."""

    dist: object

    def support(self):
        return torch.zeros_like(self.dist.z_min), self.dist.z_max

    def window_z(self, cosmo: CosmoParams, z, st):
        """Nested GL (n_z_lens outer nodes, each chi' by n_dist nodes) at
        ``z`` (B|1, N) -> (B, N), as the JAX form.  The integrand is
        (B, N, n_z_lens, n_dist), so the cosmology axis is evaluated in
        chunks of at most NESTED_CHUNK_ELEMENTS."""
        g = st.grid
        per_cosmo = z[0].numel() * g.n_z_lens * g.n_dist
        step = max(1, NESTED_CHUNK_ELEMENTS // per_cosmo)
        b = max(cosmo.batch, z.shape[0])
        if b <= step:
            return self._window_z(cosmo, z, st)
        return torch.cat([
            WindowConvergence(self.dist.rows(lo, lo + step))._window_z(
                cosmo.rows(lo, lo + step),
                z[lo:lo + step] if z.shape[0] > 1 else z, st)
            for lo in range(0, b, step)])

    def _window_z(self, cosmo, z, st):
        g = st.grid
        nd = z.dim() - 1
        chi = background.comoving_distance(cosmo, z, st, g.n_dist)

        def efficiency(zp):
            chip = background.comoving_distance(cosmo, zp, st, g.n_dist)
            p = dndz(self.dist, zp, st)
            return p * (chip - chi[..., None]) / torch.clamp_min(chip, 1e-12)

        x, w = st.gl(g.n_z_lens)
        integral = gl_integrate(efficiency, z, col(self.dist.z_max, nd), x, w)
        pref = col(1.5 * cosmo.omega_m0 / C_OVER_H0**2, nd)
        return pref * (1.0 + z) * chi * integral


#: C1 rho_crit of the NLA intrinsic-alignment amplitude (C1 = 5e-14
#: h^-2 M_sun^-1 Mpc^3; Hirata & Seljak 2004, Bridle & King 2007).
C1_RHOCRIT = 0.0134


@dataclasses.dataclass(frozen=True)
class WindowConvergenceIA:
    """The lensing efficiency plus the NLA intrinsic-alignment term,
    W_E = W_kappa + W_IA with

        W_IA(chi) = -A_ia C1 rho_crit Omega_m / D(z)
                    ((1+z)/(1+z0))^eta p(z) dz/dchi.

    ``a_ia``, ``eta_ia`` and ``z0_ia`` are (B,) or 0-d.  Not a
    :class:`WindowConvergence`: the lattice route adds the IA term to the
    convergence window's cumulative path itself."""

    dist: object
    a_ia: torch.Tensor
    eta_ia: torch.Tensor
    z0_ia: torch.Tensor

    def support(self):
        return torch.zeros_like(self.dist.z_min), self.dist.z_max

    def ia_term_z(self, cosmo: CosmoParams, z, st):
        """W_IA at ``z`` (B|1, N) -> (B, N)."""
        nd = z.dim() - 1
        d = background.growth_factor(cosmo, z, st, st.grid.n_growth)
        amp = (-col(self.a_ia, nd) * C1_RHOCRIT * col(cosmo.omega_m0, nd) / d
               * ((1.0 + z) / (1.0 + col(self.z0_ia, nd)))
               ** col(self.eta_ia, nd))
        return amp * dndz(self.dist, z, st) * background.ez(cosmo, z) \
            / C_OVER_H0

    def window_z(self, cosmo: CosmoParams, z, st):
        base = WindowConvergence(dist=self.dist).window_z(cosmo, z, st)
        return base + self.ia_term_z(cosmo, z, st)


def _limits(win_a, win_b, top):
    """The shared integration range of two windows, (B|1, 1) each: lower
    end the larger lower support (at least 1e-4), upper end ``top`` of
    the upper supports."""
    lo_a, hi_a = win_a.support()
    lo_b, hi_b = win_b.support()
    lo = torch.clamp_min(torch.maximum(lo_a, lo_b), 1e-4)
    return lo.reshape(-1, 1), top(hi_a, hi_b).reshape(-1, 1)


def z_bar(cosmo: CosmoParams, win_a, win_b, st):
    """W_a W_b-weighted mean redshift, (B,)."""
    lo, hi = _limits(win_a, win_b, torch.maximum)
    x, w = st.gl(st.grid.n_z_proj)

    def wprod(z):
        return win_a.window_z(cosmo, z, st) * win_b.window_z(cosmo, z, st)

    num = gl_integrate(lambda z: wprod(z) * z, lo[:, 0], hi[:, 0], x, w)
    den = gl_integrate(wprod, lo[:, 0], hi[:, 0], x, w)
    return num / den


@dataclasses.dataclass(frozen=True)
class PowerTable:
    """ln P on a uniform ln k grid plus the pivot growth factor, for the
    separable P(k, z) = exp(ln_p(k)) (D(z)/growth_pivot)^2.  ``ln_k0`` and
    ``dln`` are 0-d, ``ln_p`` is (B, n_k_table), ``growth_pivot`` (B,)
    or 0-d."""

    ln_k0: torch.Tensor
    dln: torch.Tensor
    ln_p: torch.Tensor
    growth_pivot: torch.Tensor

    def __call__(self, k):
        """P at ``k`` (B|1, ...) -> (B, ...)."""
        return torch.exp(interp_loglog_cubic(torch.log(k), self.ln_k0,
                                             self.dln, self.ln_p))


def _k_table(grid):
    """The static ln k grid of the power tables (numpy): (ln_k, dln)."""
    return loggrid(grid.k_table_min, grid.k_table_max, grid.n_k_table)


def _table(ln_p, growth_pivot, st):
    ln_k, dln = _k_table(st.grid)
    return PowerTable(ln_k0=st.ref.new_tensor(ln_k[0]),
                      dln=st.ref.new_tensor(dln), ln_p=ln_p,
                      growth_pivot=growth_pivot)


def power_table_linear(cosmo: CosmoParams, st) -> PowerTable:
    """Linear P(k, z=0) table (pivot D = 1) on ``st.k_table``."""
    z = torch.zeros(1, dtype=st.dtype, device=st.device)
    p = linear.linear_power(cosmo, st.k_table[None, :], z, st)
    return _table(torch.log(p), torch.ones_like(st.ref), st)


def power_tables_halo(cosmo: CosmoParams, halo_params, model, kinds, st):
    """Halo-model P(k) tables at the model's redshift for every spectrum
    in ``kinds`` (linear_power, power_mm, power_gm, power_mg, power_gg),
    from ONE ``halo.powers`` evaluation on ``st.k_table`` (one launch of
    kernel A on the card).  A zero P gives ln P = -inf in float32, as
    the JAX ``log(max(p, 1e-300))`` does."""
    from chomp_tpu_torch import halo as halo_mod

    p = halo_mod.powers(cosmo, halo_params, model, st.k_table, st)
    return {kind: _table(torch.log(torch.clamp_min(p[kind], 1e-300)),
                         model.mass.growth, st) for kind in kinds}


def power_table_halo(cosmo: CosmoParams, halo_params, model, kind: str,
                     st) -> PowerTable:
    """One halo-model P(k) table (see :func:`power_tables_halo`)."""
    return power_tables_halo(cosmo, halo_params, model, (kind,), st)[kind]


def limber_cl(cosmo: CosmoParams, win_a, win_b, ells, p_table: PowerTable,
              st, ell_offset: float = 0.5):
    """Limber C_ell = ∫ dchi W_a W_b / chi^2 P((ell+offset)/chi, z) by
    Gauss-Legendre over z (grid.n_z_proj nodes) with the separable
    growth of ``p_table``: (B, n_ell) at ``ells`` (n_ell,)."""
    g = st.grid
    ells = torch.as_tensor(ells, dtype=st.dtype, device=st.device).reshape(-1)
    lo, hi = _limits(win_a, win_b, torch.minimum)
    x, w = st.gl_unit(g.n_z_proj)
    z = lo + (hi - lo) * x                                    # (B|1, nz)
    wz = w * (hi - lo)
    chi = background.comoving_distance(cosmo, z, st, g.n_dist)
    d = (background.growth_factor(cosmo, z, st, g.n_growth)
         / col(p_table.growth_pivot, 1))
    wa = win_a.window_z(cosmo, z, st)
    # kappa-kappa (xi_+-): one nested convergence window serves both.
    wb = wa if win_b is win_a else win_b.window_z(cosmo, z, st)
    dchi_dz = C_OVER_H0 / background.ez(cosmo, z)
    kern = wa * wb * dchi_dz / chi**2 * d * d * wz            # (B, nz)
    k = (ells[None, :, None] + ell_offset) / chi[:, None, :]  # (B, nl, nz)
    return recompute_in_backward(
        lambda k, kern: torch.sum(p_table(k) * kern[:, None, :], dim=-1),
        k, kern, track=(p_table.ln_p,))


def limber_cl_exact_z(cosmo: CosmoParams, halo_params, hod, win_a, win_b,
                      ells, st, kind: str = "power_gg", n_z: int = 32):
    """Limber C_ell with the halo model's exact redshift evolution, by
    Gauss-Legendre over z: the counterpart of the JAX package's
    ``projection.limber_cl_exact_z`` (the same arguments, plus ``st``,
    whose ``with_bao`` and grid are the JAX ones).  ``n_z`` GL nodes on
    [max(lo_a, lo_b, 1e-4), min(hi_a, hi_b)]; at node j the full halo
    model is built at z_j and ``kind`` evaluated at its own k = (ell +
    1/2) / chi_j, no interpolation.  (B, n_ell) at ``ells`` (n_ell,).

    The B x n_z models are ONE halo model over B n_z rows (row b n_z +
    j: cosmology b at node j), so kernel A launches once, with a k row
    per row; the gradient reaches the cosmology through chi_j in k as
    well (kernel A's backward gives grad_k).  The sum over the nodes is
    taken in float64 and rounded once."""
    from chomp_tpu_torch import halo as halo_mod
    from chomp_tpu_torch.limber_fft import _repeat_rows

    g = st.grid
    cosmo = cosmo.batched()
    b = cosmo.batch
    ells = torch.as_tensor(ells, dtype=st.dtype, device=st.device).reshape(-1)
    lo, hi = _limits(win_a, win_b, torch.minimum)
    x, w = st.gl_unit(n_z)
    z = (lo + (hi - lo) * x).expand(b, n_z)                   # (B, nz)
    wz = w * (hi - lo)
    chi = background.comoving_distance(cosmo, z, st, g.n_dist)
    wa = win_a.window_z(cosmo, z, st)
    wb = wa if win_b is win_a else win_b.window_z(cosmo, z, st)
    dchi_dz = C_OVER_H0 / background.ez(cosmo, z)
    kern = wa * wb * dchi_dz / chi**2 * wz                    # (B, nz)
    rows = _repeat_rows(cosmo, b, n_z)
    hp, hod_r = _repeat_rows(halo_params, b, n_z), _repeat_rows(hod, b, n_z)
    z_rows = z.reshape(-1)
    model = halo_mod.build_halo_model(rows, hp, hod_r, z_rows, st)
    k = (ells[None, None, :] + 0.5) / chi[..., None]          # (B, nz, nl)
    p = halo_mod.powers(rows, hp, model, k.reshape(b * n_z, -1), st)[kind]
    return (p.reshape(b, n_z, -1).double()
            * kern[..., None].double()).sum(1).to(st.dtype)
