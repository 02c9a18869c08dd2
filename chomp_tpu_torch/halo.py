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


def _switch_lnm(moment_fn, st):
    """lnM where a monotone HOD moment crosses 1, (B,) in float64:
    interpolation seed off the static mass grid + 4 Newton steps on the
    closed form (derivative by ``torch.func``), each step clamped to
    +-20 e-folds; the result is clamped into the mass range.

    The solve runs in float64 whatever the pipeline's dtype
    (``moment_fn`` takes float64 masses: a float64 copy of the HOD).
    Where a moment reaches 1 at a step or an onset (Poisson's M_min,
    Kravtsov's and Mandelbaum's centrals) the Newton steps of the JAX
    package do not settle: a float64 iterate that lands one ulp below the
    onset has no slope and jumps 20 e-folds, so a float32 solve would
    end elsewhere than the float64 one, with another Scranton select
    over a whole mass range.  The moment is floored at 1e-300 before
    its log, as in the JAX package."""
    ln_m = st.mass_ln_m64[None, :]
    lnv = torch.log(torch.clamp_min(moment_fn(torch.exp(ln_m)), 1e-300))
    seed = interp(torch.zeros(lnv.shape[0], dtype=torch.float64,
                              device=ln_m.device), lnv, ln_m)

    def g(lnm):
        v = torch.log(torch.clamp_min(moment_fn(torch.exp(lnm)), 1e-300))
        return v.sum(), v

    for _ in range(4):
        dv, (_, val) = torch.func.grad_and_value(g, has_aux=True)(seed)
        seed = seed - torch.clamp(
            val / torch.where(torch.abs(dv) > 1e-30, dv, 1e-30), -20.0, 20.0)
    return torch.clamp(seed, ln_m[:, 0], ln_m[:, -1])


def build_halo_model(cosmo: CosmoParams, halo: HaloParams, hod, z, st,
                     mass_tables: MassTables | None = None) -> HaloModel:
    """Mass tables + HOD moments + n_g at redshift ``z`` ((B|1,)); a
    prebuilt ``mass_tables`` (of the same cosmologies and z) is used as
    is."""
    t = (mass_tables if mass_tables is not None
         else build_mass_tables(cosmo, halo, z, st))
    n_first = hod.first_moment(t.m)
    n_second = hod.second_moment(t.m)
    lo, hi = t.ln_m[:, 0], t.ln_m[:, -1]
    if st.grid.scranton_switch:
        hod64 = hod.to(dtype=torch.float64)
        sw1 = _switch_lnm(hod64.first_moment, st).to(lo).expand_as(lo)
        sw2 = _switch_lnm(hod64.second_moment, st).to(lo).expand_as(lo)
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


def build_halo_models(cosmo: CosmoParams, halo: HaloParams, hods, z, st
                      ) -> list[HaloModel]:
    """Halo models of several galaxy samples (HODs) on ONE mass-table
    build: only the HOD moments, switch masses and galaxy packs are per
    sample."""
    t = build_mass_tables(cosmo, halo, z, st)
    return [build_halo_model(cosmo, halo, h, z, st, mass_tables=t)
            for h in hods]


def _mu(c):
    return torch.log(1.0 + c) - c / (1.0 + c)


def _mat_nodes(cosmo: CosmoParams, halo: HaloParams, t: MassTables, mstar):
    """Kernel A's ``mat`` (B, nM, 4): the matter profile with the feedback
    hooks (c x bary_c, k x nu^(bary_eta/2), folded into r_s) at the mass
    nodes, 1/mu(c), the GL weights and the mass-function factors."""
    c_m = profiles.concentration(halo, t.m, mstar, t.z) * col(cosmo.bary_c, 1)
    rs_m = (profiles.virial_radius(cosmo, halo, t.m, t.z) / c_m
            * torch.sqrt(t.nu) ** col(cosmo.bary_eta, 1))
    mu_m = _mu(c_m)
    f_dnu = t.f_nu * t.dnu_dlnm
    return torch.stack([
        rs_m, c_m,
        t.w_lnm * f_dnu * t.bias / mu_m,
        t.w_lnm * f_dnu * t.m / col(cosmo.rho_bar, 1) / (mu_m * mu_m),
    ], dim=-1).contiguous()


def _galaxy_profile(halo: HaloParams, cosmo: CosmoParams, m, mstar, z):
    """(r_vir, c, mu(c)) of the unmodified NFW galaxy profile at ``m``."""
    c_g = profiles.concentration(halo, m, mstar, z)
    return profiles.virial_radius(cosmo, halo, m, z), c_g, _mu(c_g)


def _gal_nodes(cosmo: CosmoParams, halo: HaloParams, model: HaloModel):
    """Kernel A's ``gal`` (B, nG, 9) of one galaxy sample: the matter
    profile with the feedback hooks and the galaxy profile at the pack's
    nodes, the HOD and mass-function factors and the Scranton y / y^2
    select folded into the weights."""
    t, g = model.mass, model.gal
    rv_g, c_g, mu_g = _galaxy_profile(halo, cosmo, g.m, model.m_star, t.z)
    rho = col(cosmo.rho_bar, 1)
    n_g = col(model.n_g, 1)
    c_gm = c_g * col(cosmo.bary_c, 1)
    rs_gm = rv_g / c_gm * torch.sqrt(g.nu) ** col(cosmo.bary_eta, 1)
    mu_gm = _mu(c_gm)
    zero = torch.zeros_like(mu_g)
    w_gg = g.w_lnm * g.dndlnm * g.n_second / n_g**2
    p1_gg = g.ln_m < col(model.ln_m_sw2, 1)
    w_gm = g.w_lnm * g.dndlnm * g.m * g.n_first / (n_g * rho)
    p1_gm = g.ln_m < col(model.ln_m_sw1, 1)
    return torch.stack([
        rs_gm, c_gm, rv_g / c_g, c_g,
        g.w_lnm * g.dndlnm * g.n_first * g.bias / n_g / mu_g,
        torch.where(p1_gg, w_gg / mu_g, zero),
        torch.where(p1_gg, zero, w_gg / (mu_g * mu_g)),
        torch.where(p1_gm, w_gm / mu_gm, zero),
        torch.where(p1_gm, zero, w_gm / (mu_gm * mu_g)),
    ], dim=-1).contiguous()


def contraction_nodes(cosmo: CosmoParams, halo: HaloParams,
                      model: HaloModel):
    """Kernel A's node arrays: ``mat`` (B, nM, 4) and ``gal`` (B, nG, 9)
    (layout in :mod:`chomp_tpu_torch.ops.halo_contract`).  The matter
    profile carries the feedback hooks (c x bary_c, k x nu^(bary_eta/2),
    folded into r_s); 1/mu(c), the GL weights, the mass-function and
    HOD factors and the Scranton y / y^2 select go into the weights."""
    return (_mat_nodes(cosmo, halo, model.mass, model.m_star),
            _gal_nodes(cosmo, halo, model))


def contractions(cosmo: CosmoParams, halo: HaloParams, model: HaloModel,
                 k, st):
    """(h_m, h_g, pp_mm, pp_gg, pp_gm), each (B, nk), at ``k`` (nk,), or
    (B, nk) a k row per cosmology row, through kernel A."""
    mat, gal = contraction_nodes(cosmo, halo, model)
    return halo_contract(k.contiguous(), mat, gal, st.cheb).unbind(1)


def _linear(cosmo: CosmoParams, z, k, st):
    """(P_lin of the cb sector, r = D_cbnu / D_cb) at redshift ``z`` and
    ``k`` (nk,) or (B, nk), (B, nk) each."""
    kb = k[None, :] if k.dim() == 1 else k
    return (linear.linear_power(cosmo, kb, z, st, species="cb"),
            neutrino.m_over_cb(cosmo, kb, z, st, st.grid.n_growth))


def _spectra(cosmo: CosmoParams, p_lin, r, ints):
    """The halo-model spectra dict (keys ``linear_power, power_mm,
    power_gm, power_mg, power_gg``, (B, nk)) from kernel A's five
    integrals ``ints`` (B, 5, nk) and :func:`_linear`'s ``p_lin``,
    ``r``."""
    h_m, h_g, pp_mm, pp_gg, pp_gm = ints.unbind(1)
    p_mm = pp_mm + p_lin * h_m * h_m
    p_gg = pp_gg + p_lin * h_g * h_g
    p_gm = pp_gm + p_lin * h_m * h_g
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


def powers_and_two_halo(cosmo: CosmoParams, halo: HaloParams,
                        model: HaloModel, k, st):
    """(:func:`powers`, (h_m, h_g)): the spectra and the two-halo
    integrals of the same kernel A launch, (B, nk) each (the non-Limber
    RSD term reads h_m and h_g)."""
    mat, gal = contraction_nodes(cosmo, halo, model)
    ints = halo_contract(k.contiguous(), mat, gal, st.cheb)
    return (_spectra(cosmo, *_linear(cosmo, model.mass.z, k, st), ints),
            (ints[:, 0], ints[:, 1]))


def powers(cosmo: CosmoParams, halo: HaloParams, model: HaloModel, k, st):
    """All halo-model spectra at ``k`` (nk,), or (B, nk) a k row per
    cosmology row (differentiable in it: kernel A's backward gives
    grad_k): dict with keys ``linear_power, power_mm, power_gm, power_mg,
    power_gg``, (B, nk)."""
    return powers_and_two_halo(cosmo, halo, model, k, st)[0]


def _cross_gal_pack(cosmo: CosmoParams, halo: HaloParams,
                    model_a: HaloModel, model_b: HaloModel, st):
    """(ln_m, w_lnm, m, dndlnm, sw), (B, nG) each and sw (B,): the GL pack
    of the cross-sample 1-halo integral of two galaxy samples on one
    mass-table build, with panel edges at both HODs' breakpoints and at
    the Newton-solved mass where <N_A><N_B> crosses 1 (the Scranton
    criterion on the independent-occupation cross moment)."""
    t = model_a.mass
    hod_a, hod_b = model_a.hod, model_b.hod
    lo, hi = t.ln_m[:, 0], t.ln_m[:, -1]

    hod_a64, hod_b64 = (h.to(dtype=torch.float64) for h in (hod_a, hod_b))

    def prod_moment(m):
        return hod_a64.first_moment(m) * hod_b64.first_moment(m)

    sw = (_switch_lnm(prod_moment, st).to(lo).expand_as(lo)
          if st.grid.scranton_switch else lo.clone())
    marks = torch.sort(torch.stack(
        [torch.clamp(b.expand_as(lo), lo, hi) for b in
         (*hod_a.breakpoints(), *hod_b.breakpoints(), sw)], dim=-1),
        dim=-1).values
    n_per = max(st.grid.n_mass // (marks.shape[-1] + 1), 64)
    edges = torch.cat([lo[:, None], marks, hi[:, None]], dim=-1)
    pack = node_pack(cosmo, halo, t, edges[:, :-1], edges[:, 1:], n_per, st)
    return pack.ln_m, pack.w_lnm, torch.exp(pack.ln_m), pack.dndlnm, sw


def _cross_nodes(cosmo: CosmoParams, halo: HaloParams, model_a: HaloModel,
                 model_b: HaloModel, st):
    """Kernel A's ``gal`` (B, nG, 9) whose pp_gg output is the cross
    1-halo term sum_M w <N_A><N_B> y^(1|2) / (n_A n_B): the galaxy
    profile in both profile slots (one profile a node), the cross
    weights in the gg columns, zeros in the h_g and gm columns."""
    t = model_a.mass
    ln_g, w_g, m_g, dndlnm, sw = _cross_gal_pack(cosmo, halo, model_a,
                                                 model_b, st)
    rv, c, mu = _galaxy_profile(halo, cosmo, m_g, model_a.m_star, t.z)
    rs = rv / c
    w = (w_g * dndlnm * model_a.hod.first_moment(m_g)
         * model_b.hod.first_moment(m_g)
         / col(model_a.n_g * model_b.n_g, 1))
    p1 = ln_g < col(sw, 1)
    zero = torch.zeros_like(w)
    return torch.stack([rs, c, rs, c, zero,
                        torch.where(p1, w / mu, zero),
                        torch.where(p1, zero, w / (mu * mu)),
                        zero, zero], dim=-1).contiguous()


def fold_rows(mat, gals):
    """Kernel A's inputs for several ``gal`` packs that share ``mat`` (B,
    nM, 4): the packs of one node count fold into the batch as rows b n +
    i (row b's mat repeated n times), so each distinct node count is one
    launch.  Returns [(pack indices, mat rows (B n, nM, 4), gal rows (B n,
    nG, 9))], one entry a launch."""
    b = mat.shape[0]
    by_ng = {}
    for i, g in enumerate(gals):
        by_ng.setdefault(g.shape[1], []).append(i)
    out = []
    for idx in by_ng.values():
        gal = torch.stack([gals[i] for i in idx], dim=1)
        out.append((idx, mat.repeat_interleave(len(idx), dim=0),
                    gal.reshape(b * len(idx), *gal.shape[2:])))
    return out


def tomographic_nodes(cosmo: CosmoParams, halo: HaloParams, models, st,
                      with_cross: bool = True):
    """(mat (B, nM, 4), gal packs, cross pairs) of
    :func:`tomographic_powers`: the one mass pack, every sample's galaxy
    pack and then, with ``with_cross``, the cross pack of each pair i < j
    (:func:`_cross_nodes`), in the order of the pairs."""
    mat = _mat_nodes(cosmo, halo, models[0].mass, models[0].m_star)
    gals = [_gal_nodes(cosmo, halo, m) for m in models]
    n = len(models)
    pairs = ([(i, j) for i in range(n) for j in range(i + 1, n)]
             if with_cross else [])
    gals += [_cross_nodes(cosmo, halo, models[i], models[j], st)
             for i, j in pairs]
    return mat, gals, pairs


def tomographic_powers(cosmo: CosmoParams, halo: HaloParams, models, k, st,
                       with_cross: bool = True):
    """All spectra of several galaxy samples on one mass-table build
    (:func:`build_halo_models`) at the static ``k`` (nk,): "power_mm"
    (from sample 0's row), ("power_gm", i), ("power_gg", i, i) and, with
    ``with_cross``, ("power_gg", i, j) for i < j, each (B, nk).  The
    cross 1-halo term assumes independent occupations, <N_A N_B> =
    <N_A><N_B>, with the Scranton y / y^2 switch where that product
    crosses 1.

    Every sample's galaxy pack, and each cross pack, folds into the
    batch as rows b L + i over the one mass pack (:func:`fold_rows`), so
    the whole set takes one kernel A launch (one per distinct galaxy node
    count: Zheng HODs all have the same)."""
    return tomographic_powers_and_two_halo(cosmo, halo, models, k, st,
                                           with_cross)[0]


def tomographic_powers_and_two_halo(cosmo: CosmoParams, halo: HaloParams,
                                    models, k, st, with_cross: bool = True):
    """(:func:`tomographic_powers`, (h_m, [h_g of each sample])): the
    spectra and the two-halo integrals of the same kernel A launch."""
    mat, gals, pairs = tomographic_nodes(cosmo, halo, models, st,
                                         with_cross)
    b = mat.shape[0]
    ints = [None] * len(gals)
    for idx, mat_r, gal_r in fold_rows(mat, gals):
        out = halo_contract(k.contiguous(), mat_r, gal_r, st.cheb)
        out = out.reshape(b, len(idx), *out.shape[1:])
        for j, i in enumerate(idx):
            ints[i] = out[:, j]
    p_lin, r = _linear(cosmo, models[0].mass.z, k, st)
    n = len(models)
    out = {}
    for i in range(n):
        ps = _spectra(cosmo, p_lin, r, ints[i])
        if i == 0:
            out["power_mm"] = ps["power_mm"]
        out[("power_gg", i, i)] = ps["power_gg"]
        out[("power_gm", i)] = ps["power_gm"]
    for (i, j), cross in zip(pairs, ints[n:]):
        out[("power_gg", i, j)] = (cross[:, 3]
                                   + p_lin * ints[i][:, 1] * ints[j][:, 1])
    return out, (ints[0][:, 0], [ints[i][:, 1] for i in range(n)])


def power_gg_cross(cosmo: CosmoParams, halo: HaloParams, model_a: HaloModel,
                   model_b: HaloModel, k, st):
    """P_gg between two galaxy samples on one mass-table build, (B, nk):
    :func:`tomographic_powers`' ("power_gg", 0, 1) of the pair, whose
    three packs go through one kernel A launch."""
    return tomographic_powers(cosmo, halo, [model_a, model_b], k,
                              st)[("power_gg", 0, 1)]


# ---------------------------------------------------------------------------
# The plain mass integrals of the covariance stack.
# ---------------------------------------------------------------------------

def _k_col(k):
    """A static k vector (nk,) or per-row (B, nk) as (B|1, nk, 1)."""
    k = torch.atleast_1d(k)
    return (k[None, :] if k.dim() == 1 else k)[..., None]


def _y_matrix(cosmo: CosmoParams, halo: HaloParams, model: HaloModel, k):
    """y(k_i, M_j) at the mass-table nodes, no feedback hooks: (B, nk,
    nM)."""
    return profiles.y_nfw(cosmo, halo, _k_col(k), model.mass.m[:, None, :],
                          model.m_star, model.mass.z)


def _y_gal(cosmo: CosmoParams, halo: HaloParams, model: HaloModel, k):
    """y(k_i, M_j) at the galaxy-pack nodes: (B, nk, nG)."""
    return profiles.y_nfw(cosmo, halo, _k_col(k), model.gal.m[:, None, :],
                          model.m_star, model.mass.z)


def _bary_scales(cosmo: CosmoParams, nu_sq):
    """(c_scale (B,), k_scale (B, 1, N)): the matter profile's feedback
    hooks at nodes of squared peak height ``nu_sq`` (B, N)."""
    return cosmo.bary_c, torch.sqrt(nu_sq)[:, None, :] ** col(
        cosmo.bary_eta, 2)


def _y_matter(cosmo: CosmoParams, halo: HaloParams, model: HaloModel, k):
    """Matter-profile y(k_i, M_j) at the mass-table nodes with the
    feedback hooks: (B, nk, nM)."""
    c_s, k_s = _bary_scales(cosmo, model.mass.nu)
    return profiles.y_nfw(cosmo, halo, _k_col(k), model.mass.m[:, None, :],
                          model.m_star, model.mass.z, c_scale=c_s,
                          k_scale=k_s)


def _y_gal_matter(cosmo: CosmoParams, halo: HaloParams, model: HaloModel,
                  k):
    """Matter-profile y at the galaxy-pack nodes with the feedback hooks
    (the matter factor of the 1-halo gm integrand): (B, nk, nG)."""
    c_s, k_s = _bary_scales(cosmo, model.gal.nu)
    return profiles.y_nfw(cosmo, halo, _k_col(k), model.gal.m[:, None, :],
                          model.m_star, model.mass.z, c_scale=c_s,
                          k_scale=k_s)


def _contract(y, w):
    """sum_M y[b, k, M] w[b, M] -> (B, nk)."""
    return torch.einsum("bkm,bm->bk", y, w)


def two_halo_integrals(cosmo: CosmoParams, halo: HaloParams,
                       model: HaloModel, k):
    """(h_m, h_g)(k), (B, nk) each: the bias-weighted halo integrals, by
    plain torch contractions (kernel A's first two outputs)."""
    t, g = model.mass, model.gal
    h_m = _contract(_y_matter(cosmo, halo, model, k),
                    t.w_lnm * t.f_nu * t.dnu_dlnm * t.bias)
    h_g = _contract(_y_gal(cosmo, halo, model, k),
                    g.w_lnm * g.dndlnm * g.n_first * g.bias) / col(
        model.n_g, 1)
    return h_m, h_g


def one_halo_integrals(cosmo: CosmoParams, halo: HaloParams,
                       model: HaloModel, k, st=None):
    """(pp_mm, pp_gg, pp_gm)(k), (B, nk) each: the 1-halo terms with the
    Scranton y / y^2 selects at the switch masses, by plain torch
    contractions (kernel A's last three outputs).  ``st`` is accepted for
    the JAX signature's (with_bao, grid) and unused."""
    t, g = model.mass, model.gal
    y = _y_matter(cosmo, halo, model, k)
    pp_mm = _contract(y * y, t.w_lnm * t.f_nu * t.dnu_dlnm * t.m
                      / col(cosmo.rho_bar, 1))
    y_g = _y_gal(cosmo, halo, model, k)
    below2 = (g.ln_m < col(model.ln_m_sw2, 1))[:, None, :]
    pp_gg = _contract(torch.where(below2, y_g, y_g * y_g),
                      g.w_lnm * g.dndlnm * g.n_second) / col(
        model.n_g, 1) ** 2
    y_gm_m = _y_gal_matter(cosmo, halo, model, k)
    below1 = (g.ln_m < col(model.ln_m_sw1, 1))[:, None, :]
    pp_gm = _contract(torch.where(below1, y_gm_m, y_gm_m * y_g),
                      g.w_lnm * g.dndlnm * g.m * g.n_first) / col(
        model.n_g * cosmo.rho_bar, 1)
    return pp_mm, pp_gg, pp_gm


def linear_power(cosmo: CosmoParams, model: HaloModel, k, st):
    """P_lin(k) of the halo sector (the cb spectrum at m_nu > 0) at the
    model's redshift: ``k`` (nk,) or (B, nk) -> (B, nk)."""
    k = torch.atleast_1d(k)
    return linear.linear_power(cosmo, k[None, :] if k.dim() == 1 else k,
                               model.mass.z, st, species="cb")


def galaxy_bias_avg(model: HaloModel):
    """Mean galaxy bias <b_g> = (1/n_g) ∫ dn/dlnM <N> b dlnM, (B,)."""
    g = model.gal
    return torch.sum(g.w_lnm * g.dndlnm * g.n_first * g.bias,
                     dim=-1) / model.n_g


def union_gal_pack(cosmo: CosmoParams, halo: HaloParams, models, st):
    """(ln_m, w_lnm, m, dndlnm, bias), (B, nU) each: the GL pack with
    panel edges at EVERY sample's HOD breakpoints (no Scranton edges),
    the shared rule of mass integrals mixing several samples' occupation
    moments.  The models share one mass-table build."""
    t = models[0].mass
    lo, hi = t.ln_m[:, 0], t.ln_m[:, -1]
    bps = [b for mdl in models for b in mdl.hod.breakpoints()]
    parts = [lo[:, None]]
    if bps:
        parts.append(torch.sort(torch.stack(
            [torch.clamp(b.expand_as(lo), lo, hi) for b in bps], dim=-1),
            dim=-1).values)
    parts.append(hi[:, None])
    edges = torch.cat(parts, dim=-1)
    n_per = max(st.grid.n_mass // (edges.shape[-1] - 1), 64)
    pack = node_pack(cosmo, halo, t, edges[:, :-1], edges[:, 1:], n_per, st)
    return (pack.ln_m, pack.w_lnm, torch.exp(pack.ln_m), pack.dndlnm,
            pack.bias)
