"""Halo-model nonlinear power spectra: 1-halo + 2-halo, mm/gm/gg.

PyTorch counterpart of the JAX package's ``halo.py`` on the slice's path:
``build_halo_model`` (mass tables, HOD moments, the Newton-solved
Scranton switch masses and the panel-refined galaxy pack, batched over
cosmologies), and the spectra.  The (k, M) contraction block of the JAX
``two_halo_integrals`` / ``one_halo_integrals`` is :func:`contractions`,
which returns all five integrals from one launch of kernel A
(:mod:`chomp_tpu_torch.ops.halo_contract`): this module only folds the
profile parameters and the quadrature weights into its node arrays.
"""

from __future__ import annotations

import dataclasses

import torch

from chomp_tpu_torch import linear, neutrino, profiles
from chomp_tpu_torch.mass import (MassTables, build_mass_tables, interp,
                                  m_star, node_pack)
from chomp_tpu_torch.ops.halo_contract import halo_contract
from chomp_tpu_torch.params import CosmoParams, HaloParams, col


@dataclasses.dataclass(frozen=True)
class GalaxyPack:
    """Panel-refined GL quadrature for the HOD-weighted mass integrals,
    panel edges at every non-smooth mark; arrays (B, nG)."""

    ln_m: torch.Tensor
    w_lnm: torch.Tensor
    m: torch.Tensor
    dndlnm: torch.Tensor
    bias: torch.Tensor
    n_first: torch.Tensor
    n_second: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HaloModel:
    """Bound halo-model state at one redshift (per cosmology)."""

    mass: MassTables
    hod: object
    gal: GalaxyPack
    n_g: torch.Tensor       # (B,) mean galaxy density, (h/Mpc)^3
    m_star: torch.Tensor    # (B,)
    n_first: torch.Tensor   # (B, nM) <N> at the mass-table nodes
    n_second: torch.Tensor  # (B, nM) <N(N-1)>
    ln_m_sw1: torch.Tensor  # (B,) lnM where <N> crosses 1
    ln_m_sw2: torch.Tensor  # (B,) lnM where <N(N-1)> crosses 1


def _switch_lnm(moment_fn, tables: MassTables):
    """lnM where a monotone HOD moment crosses 1: interpolation seed off
    the table + 4 Newton steps on the closed form (derivative by
    ``torch.func``), each step clamped to +-20 e-folds; the result is
    clamped into the mass range.  (B,)."""
    vals = moment_fn(tables.m)
    lnv = torch.log(torch.clamp_min(vals, 1e-300))
    seed = interp(torch.zeros_like(tables.f_norm), lnv, tables.ln_m)

    def g(lnm):
        v = torch.log(torch.clamp_min(moment_fn(torch.exp(lnm)), 1e-300))
        return v.sum(), v

    for _ in range(4):
        dv, (_, val) = torch.func.grad_and_value(g, has_aux=True)(seed)
        seed = seed - torch.clamp(
            val / torch.where(torch.abs(dv) > 1e-30, dv, 1e-30), -20.0, 20.0)
    return torch.clamp(seed, tables.ln_m[:, 0], tables.ln_m[:, -1])


def build_halo_model(cosmo: CosmoParams, halo: HaloParams, hod, z, st
                     ) -> HaloModel:
    """Mass tables + HOD moments + n_g at redshift ``z`` ((B|1,))."""
    t = build_mass_tables(cosmo, halo, z, st)
    n_first = hod.first_moment(t.m)
    n_second = hod.second_moment(t.m)
    lo, hi = t.ln_m[:, 0], t.ln_m[:, -1]
    if st.grid.scranton_switch:
        sw1 = _switch_lnm(hod.first_moment, t)
        sw2 = _switch_lnm(hod.second_moment, t)
    else:
        sw1 = sw2 = lo.clone()

    bps = tuple(hod.breakpoints())
    marks = torch.sort(torch.stack(
        [torch.clamp(b.expand_as(lo), lo, hi) for b in (*bps, sw1, sw2)],
        dim=-1), dim=-1).values
    n_panels = marks.shape[-1] + 1
    n_per = max(st.grid.n_mass // n_panels, 64)
    edges = torch.cat([lo[:, None], marks, hi[:, None]], dim=-1)
    pack = node_pack(cosmo, halo, t, edges[:, :-1], edges[:, 1:], n_per, st)
    m_g = torch.exp(pack.ln_m)
    gal = GalaxyPack(ln_m=pack.ln_m, w_lnm=pack.w_lnm, m=m_g,
                     dndlnm=pack.dndlnm, bias=pack.bias,
                     n_first=hod.first_moment(m_g),
                     n_second=hod.second_moment(m_g), nu=pack.nu)
    n_g = torch.sum(gal.w_lnm * gal.dndlnm * gal.n_first, dim=-1)
    return HaloModel(mass=t, hod=hod, gal=gal, n_g=n_g, m_star=m_star(t),
                     n_first=n_first, n_second=n_second,
                     ln_m_sw1=sw1, ln_m_sw2=sw2)


def _mu(c):
    return torch.log(1.0 + c) - c / (1.0 + c)


def contraction_nodes(cosmo: CosmoParams, halo: HaloParams,
                      model: HaloModel):
    """Kernel A's node arrays: ``mat`` (B, nM, 4) and ``gal`` (B, nG, 9)
    (layout in :mod:`chomp_tpu_torch.ops.halo_contract`).  The matter
    profile carries the feedback hooks (c x bary_c, k x nu^(bary_eta/2),
    folded into r_s); 1/mu(c), the GL weights, the mass-function and
    HOD factors and the Scranton y / y^2 select go into the weights."""
    t, g = model.mass, model.gal
    z, mstar = t.z, model.m_star
    c_scale = col(cosmo.bary_c, 1)
    eta = col(cosmo.bary_eta, 1)
    rho = col(cosmo.rho_bar, 1)
    n_g = col(model.n_g, 1)

    c_m = profiles.concentration(halo, t.m, mstar, z) * c_scale
    rs_m = (profiles.virial_radius(cosmo, halo, t.m, z) / c_m
            * torch.sqrt(t.nu) ** eta)
    mu_m = _mu(c_m)
    f_dnu = t.f_nu * t.dnu_dlnm
    mat = torch.stack([
        rs_m, c_m,
        t.w_lnm * f_dnu * t.bias / mu_m,
        t.w_lnm * f_dnu * t.m / rho / (mu_m * mu_m),
    ], dim=-1)

    c_g = profiles.concentration(halo, g.m, mstar, z)
    rv_g = profiles.virial_radius(cosmo, halo, g.m, z)
    mu_g = _mu(c_g)
    c_gm = c_g * c_scale
    rs_gm = rv_g / c_gm * torch.sqrt(g.nu) ** eta
    mu_gm = _mu(c_gm)
    zero = torch.zeros_like(mu_g)
    w_gg = g.w_lnm * g.dndlnm * g.n_second / n_g**2
    p1_gg = g.ln_m < col(model.ln_m_sw2, 1)
    w_gm = g.w_lnm * g.dndlnm * g.m * g.n_first / (n_g * rho)
    p1_gm = g.ln_m < col(model.ln_m_sw1, 1)
    gal = torch.stack([
        rs_gm, c_gm, rv_g / c_g, c_g,
        g.w_lnm * g.dndlnm * g.n_first * g.bias / n_g / mu_g,
        torch.where(p1_gg, w_gg / mu_g, zero),
        torch.where(p1_gg, zero, w_gg / (mu_g * mu_g)),
        torch.where(p1_gm, w_gm / mu_gm, zero),
        torch.where(p1_gm, zero, w_gm / (mu_gm * mu_g)),
    ], dim=-1)
    return mat.contiguous(), gal.contiguous()


def contractions(cosmo: CosmoParams, halo: HaloParams, model: HaloModel,
                 k, st):
    """(h_m, h_g, pp_mm, pp_gg, pp_gm), each (B, nk), at the static
    ``k`` (nk,) through kernel A."""
    mat, gal = contraction_nodes(cosmo, halo, model)
    return halo_contract(k.contiguous(), mat, gal, st.cheb).unbind(1)


def powers(cosmo: CosmoParams, halo: HaloParams, model: HaloModel, k, st):
    """All halo-model spectra at the static ``k`` (nk,): dict with keys
    ``linear_power, power_mm, power_gm, power_mg, power_gg``, (B, nk)."""
    z = model.mass.z
    kb = k[None, :]
    p_lin = linear.linear_power(cosmo, kb, z, st, species="cb")
    h_m, h_g, pp_mm, pp_gg, pp_gm = contractions(cosmo, halo, model, k, st)
    p_mm = pp_mm + p_lin * h_m * h_m
    p_gg = pp_gg + p_lin * h_g * h_g
    p_gm = pp_gm + p_lin * h_m * h_g
    r = neutrino.m_over_cb(cosmo, kb, z, st, st.grid.n_growth)
    p_lin_m = p_lin * r * r
    p_mm_m = p_mm * r * r
    a = col(cosmo.a_mod, 1)
    return {
        "linear_power": p_lin_m,
        "power_mm": p_mm_m + (a - 1.0) * (p_mm_m - p_lin_m),
        "power_gm": p_gm * r,
        "power_mg": p_gm * r,
        "power_gg": p_gg,
    }
