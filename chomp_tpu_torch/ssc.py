"""Super-sample covariance (SSC), flat sky: the response of every 3x2pt
probe to survey-scale background modes.

PyTorch counterpart of the flat half of the JAX package's ``ssc.py`` (its
module docstring has the physics: Takada & Hu 2013, Krause & Eifler
2017, Lacasa 2018).  In the separable approximation

    Cov_SSC[C_A(l1), C_B(l2)] = ∫ dchi W_A1 W_A2 W_B1 W_B2 / chi^4
        (dP_A/ddelta_b)(k1) (dP_B/ddelta_b)(k2) sigma_b^2(chi),

with the halo-model responses of :func:`power_response_parts` (growth
and dilation of the 2-halo term, the bias-weighted 1-halo integrals and
the number-count response) and the footprint variance
:func:`sigma_b2_flat`.  The projection shares the connected term's
strided ln-chi lattice and static 2-tap queries
(:func:`covariance._lattice_projection_weights`): rank one per node, three
einsums per block.  The responses' 2-halo integrals and the halo spectra
of the counts term come from one kernel A launch per galaxy sample (one
for every sample of a tomographic builder, :func:`_prime_responses`);
the bias-weighted 1-halo integrals use the unmodified profile (no
feedback hooks), as the JAX package does, so they are plain torch
contractions.  The curved sky (``sigma_b2_curved``,
``curved_ssc_covariance``) and exact-z anchors are the next slice's
(ROADMAP item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from chomp_tpu_torch import halo, linear
from chomp_tpu_torch.covariance import (_Memo, _const, _edges_key, _k_tri,
                                        _lattice_projection_weights,
                                        _log_ell_weights, _mask_key,
                                        _measured_bessel, _own_memo,
                                        _tri_query_weights, deferred,
                                        resolve_statics)
from chomp_tpu_torch.params import GridSpec, col

__all__ = ["response_one_halo_integrals", "power_responses",
           "power_response_parts", "sigma_b2_flat", "sigma_b2_curved",
           "sigma_b2_fn", "projected_ssc", "ssc_covariance",
           "curved_ssc_covariance"]


def response_one_halo_integrals(cosmo, halo_p, model, k,
                                with_bao: bool | None = None,
                                grid: GridSpec | None = None):
    """Bias-weighted 1-halo integrals (I^b_mm, I^b_gg, I^b_gm)(k), (B, nk)
    each, with the 1-halo terms' Scranton selects (the unmodified NFW
    profile at both node sets, as in the JAX package)."""
    t, g = model.mass, model.gal
    y = halo._y_matrix(cosmo, halo_p, model, k)
    i_mm = torch.einsum("bkm,bm->bk", y * y, t.w_lnm * t.f_nu * t.dnu_dlnm
                        * t.bias * t.m / col(cosmo.rho_bar, 1))
    y_g = halo._y_gal(cosmo, halo_p, model, k)
    below2 = (g.ln_m < col(model.ln_m_sw2, 1))[:, None, :]
    i_gg = torch.einsum("bkm,bm->bk", torch.where(below2, y_g, y_g * y_g),
                        g.w_lnm * g.dndlnm * g.bias * g.n_second) / col(
        model.n_g, 1) ** 2
    below1 = (g.ln_m < col(model.ln_m_sw1, 1))[:, None, :]
    i_gm = torch.einsum("bkm,bm->bk", torch.where(below1, y_g, y_g * y_g),
                        g.w_lnm * g.dndlnm * g.bias * g.m * g.n_first) / col(
        model.n_g * cosmo.rho_bar, 1)
    return i_mm, i_gg, i_gm


def _dln_k3p_dlnk(cosmo, k, st):
    """dln(k^3 P_lin)/dln k = 3 + n_s + 2 dln T/dln k, (B, nk): the
    transfer's log-derivative by autograd, kept in the graph when the
    caller differentiates (``create_graph``)."""
    outer = torch.is_grad_enabled() and any(
        v.requires_grad for v in cosmo.fields().values())
    lnk = torch.log(torch.atleast_1d(k)).detach()
    with torch.enable_grad():
        u = lnk.expand(cosmo.batch, -1).clone().requires_grad_(True)
        ln_t = torch.log(linear.transfer(cosmo, torch.exp(u), st.with_bao))
        (dlnt,) = torch.autograd.grad(ln_t.sum(), u, create_graph=outer)
    if not outer:
        dlnt = dlnt.detach()
    return 3.0 + col(cosmo.n_s, 1) + 2.0 * dlnt


def _parts(cosmo, p_lin, h_m, h_g, ones, ps, b_g, pref, local_counts):
    i_mm, i_gg, i_gm = ones
    pos = {"mm": pref * h_m * h_m * p_lin + i_mm,
           "gm": pref * h_m * h_g * p_lin + i_gm,
           "gg": pref * h_g * h_g * p_lin + i_gg}
    zero = torch.zeros_like(pos["mm"])
    if local_counts:
        cnt = {"mm": zero, "gm": col(b_g, 1) * ps["power_gm"],
               "gg": 2.0 * col(b_g, 1) * ps["power_gg"]}
    else:
        cnt = {"mm": zero, "gm": zero, "gg": zero}
    return pos, cnt


def power_response_parts(cosmo, halo_p, model, k,
                         with_bao: bool | None = None,
                         grid: GridSpec | None = None,
                         local_counts: bool = True, *, st=None):
    """The response split R_ab = pos_ab - cnt_ab (dicts keyed "mm", "gm",
    "gg", (B, nk) each), both parts positive and log-smooth: pos = (68/21
    - dln k^3 P/dln k / 3) h_a h_b P_lin + I^b_ab, cnt = the number-count
    response (delta_a,g + delta_b,g) <b_g> P_ab (zero for mm or without
    ``local_counts``).  h_m, h_g and the spectra come from one kernel A
    launch at ``k``."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    k = torch.atleast_1d(k)
    ps, (h_m, h_g) = halo.powers_and_two_halo(cosmo, halo_p, model, k, st)
    return _parts(cosmo, halo.linear_power(cosmo, model, k, st), h_m, h_g,
                  response_one_halo_integrals(cosmo, halo_p, model, k),
                  ps, halo.galaxy_bias_avg(model),
                  68.0 / 21.0 - _dln_k3p_dlnk(cosmo, k, st) / 3.0,
                  local_counts)


def power_responses(cosmo, halo_p, model, k, with_bao: bool | None = None,
                    grid: GridSpec | None = None, local_counts: bool = True,
                    *, st=None):
    """dP_ab/ddelta_b(k) for ab in {mm, gm, gg} at the model's redshift."""
    pos, cnt = power_response_parts(cosmo, halo_p, model, k, with_bao, grid,
                                    local_counts, st=st)
    return {ab: pos[ab] - cnt[ab] for ab in ("mm", "gm", "gg")}


def _response_key(model, n_k_ssc, local_counts):
    return ("response", id(model), n_k_ssc, bool(local_counts))


def _k_ssc(n_k_ssc, st):
    ln_k, dln = _k_tri(n_k_ssc, st)
    return ln_k, dln, torch.as_tensor(np.exp(ln_k), dtype=st.dtype,
                                      device=st.device)


def _prime_responses(cosmo, halo_p, model, st, memo: _Memo,
                     n_k_ssc: int = 128, local_counts: bool = True):
    """Fill ``memo`` with the response parts of ``model`` (one HaloModel,
    or one per lens bin on one mass-table build) at the static n_k_ssc
    grid: every sample's 2-halo integrals and spectra by ONE kernel A
    launch (:func:`halo.tomographic_powers_and_two_halo`, the samples
    folded into rows)."""
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    _, _, kk = _k_ssc(n_k_ssc, st)
    ps, (h_m, h_gs) = halo.tomographic_powers_and_two_halo(
        cosmo, halo_p, models, kk, st, with_cross=False)
    p_lin = halo.linear_power(cosmo, models[0], kk, st)
    pref = 68.0 / 21.0 - _dln_k3p_dlnk(cosmo, kk, st) / 3.0
    for i, m in enumerate(models):
        spectra = {"power_gm": ps[("power_gm", i)],
                   "power_gg": ps[("power_gg", i, i)]}
        memo.get(_response_key(m, n_k_ssc, local_counts),
                 lambda m=m, i=i, spectra=spectra: _parts(
                     cosmo, p_lin, h_m, h_gs[i],
                     response_one_halo_integrals(cosmo, halo_p, m, kk),
                     spectra, halo.galaxy_bias_avg(m), pref, local_counts))


def _flat_q_grid(mask, n_q: int):
    """Static linear q grid to 60x the coupling width and its trapezoid
    weights times |W2~(q)|^2 q / (2 pi A2^2) (numpy)."""
    cw = float(mask.coupling_width)
    q = np.linspace(cw * 1e-4, 60.0 * cw, n_q)
    wq = np.full(n_q, q[1] - q[0])
    wq[0] *= 0.5
    wq[-1] *= 0.5
    return q, wq * mask.wtilde2_sq(q) * q / (2.0 * np.pi * mask.area2**2)


def _as_disc(mask):
    from chomp_tpu_torch.mask import DiscMask, UniformMask

    if isinstance(mask, (int, float)):
        return DiscMask(float(np.sqrt(float(mask) / np.pi)))
    if isinstance(mask, UniformMask):
        return DiscMask(float(np.sqrt(mask.omega_s_sr / np.pi)))
    return mask


def sigma_b2_flat(cosmo, mask, chi, growth, with_bao: bool | None = None,
                  grid: GridSpec | None = None, n_q: int = 3072, *,
                  st=None):
    """sigma_b^2 at comoving distances ``chi`` (B|1, m) for a flat-sky
    mask (UniformMask: the equal-area disc), with ``growth`` = D(z(chi))
    (B, m): (1/A2^2) ∫ q dq/2pi |W2~(q)|^2 P_lin(q/chi, 0) D^2 / chi^2."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    q, w_eff = _flat_q_grid(_as_disc(mask), n_q)
    t = dict(dtype=st.dtype, device=st.device)
    chi = torch.as_tensor(chi, **t)
    if chi.dim() < 2:
        chi = chi.reshape(1, -1)
    kq = torch.as_tensor(q, **t) / chi[..., None]
    p0 = linear.linear_power(cosmo, kq, torch.zeros(1, **t), st)
    s = p0 @ torch.as_tensor(w_eff, **t)
    return s * growth**2 / chi**2


def sigma_b2_curved(*args, **kwargs):
    """The curved-sky footprint variance: the next covariance slice."""
    raise deferred("sigma_b2_curved (the curved-sky footprint variance)")


def sigma_b2_fn(cosmo, mask, geometry: str = "flat",
                with_bao: bool | None = None, grid: GridSpec | None = None,
                *, st=None):
    """(chi, growth) -> sigma_b^2 of ``mask`` (a bare solid angle: the
    equal-area disc); ``geometry="curved"`` is the next slice's."""
    if geometry == "curved":
        raise deferred("geometry='curved' (the curved-sky SSC)")
    st = resolve_statics(cosmo, st, grid, with_bao)
    mask = _as_disc(mask)
    return lambda chi, g: sigma_b2_flat(cosmo, mask, chi, g, st=st)


def _pair_kind(ta: str, tb: str) -> str:
    return ("mm", "gm", "gg")[(ta == "g") + (tb == "g")]


def _ln_floor(x):
    return torch.log(torch.clamp_min(x, torch.finfo(x.dtype).tiny))


def _projected_ssc(cosmo, halo_p, model, ells_i, ells_j, windows, tracers,
                   sigma_fn, with_bao: bool | None = None,
                   grid: GridSpec | None = None, n_k_ssc: int = 128,
                   u_stride: int = 4, exact_z_anchors: int | None = None,
                   local_counts: bool = True, *, st=None,
                   memo: _Memo, sigma_key=None):
    """Cov_SSC(l1, l2), (B, n_i, n_j), between the pair A = (windows[0] x
    windows[1], tracers[0:2]) at ``ells_i`` and B = (windows[2] x
    windows[3], tracers[2:4]) at ``ells_j`` (static numpy grids).  Each
    side's response is kept as its two positive parts, each
    log-magnitude interpolated by the static 2-tap rows and subtracted at
    the query points; ``model`` is one HaloModel or a (model_A, model_B)
    pair; ``sigma_fn(chi, growth)`` from :func:`sigma_b2_fn`."""
    if exact_z_anchors:
        raise deferred("exact_z_anchors of the super-sample term")
    st = resolve_statics(cosmo, st, grid, with_bao)
    ells_np_i = np.asarray(ells_i, dtype=np.float64)
    ells_np_j = np.asarray(ells_j, dtype=np.float64)
    model_a, model_b = model if isinstance(model, tuple) else (model, model)
    kind_i = _pair_kind(tracers[0], tracers[1])
    kind_j = _pair_kind(tracers[2], tracers[3])
    ln_k_np, dln, kk = _k_ssc(n_k_ssc, st)
    rng, u_np, base, _, growth = _lattice_projection_weights(
        cosmo, windows, st, u_stride, memo, power=4)
    t = dict(dtype=st.dtype, device=st.device)

    def query(ells_np):
        return memo.get(("w_q", rng, tuple(ells_np.tolist()), n_k_ssc),
                        lambda: torch.as_tensor(_tri_query_weights(
                            ells_np, u_np, ln_k_np[0], dln, n_k_ssc), **t))

    w_i, w_j = query(ells_np_i), query(ells_np_j)
    chi = _const(memo, ("chi_nodes", rng), lambda: np.exp(u_np), t)[None, :]
    # A builder names its footprint by ``sigma_key``: sigma_b^2 and the
    # weights are then memoized per node range for the call's blocks.
    if sigma_key is None:
        sigma2 = sigma_fn(chi, growth)
    else:
        sigma2 = memo.get(("sigma_b2", sigma_key, id(cosmo), rng),
                          lambda: sigma_fn(chi, growth))

    def parts(mdl):
        return memo.get(_response_key(mdl, n_k_ssc, local_counts),
                        lambda: power_response_parts(
                            cosmo, halo_p, mdl, kk,
                            local_counts=local_counts, st=st))

    def resp_query(w_side, ells_np, mdl, kind):
        """pos - cnt at the side's static queries, (B, m, n_ell),
        memoized per node range, ells, model and pair kind."""
        def make():
            m, a, i = w_side.shape
            w2 = w_side.reshape(m * a, i)
            pos, cnt = (p[kind] for p in parts(mdl))
            return (torch.exp((w2 @ _ln_floor(pos).T).T.reshape(-1, m, a))
                    - torch.exp((w2 @ _ln_floor(cnt).T).T.reshape(-1, m, a)))

        return memo.get(("resp_q", rng, len(ells_np), float(ells_np[0]),
                         float(ells_np[-1]), n_k_ssc, id(mdl), kind,
                         bool(local_counts)), make)

    def weight():
        d_a = growth / col(model_a.mass.growth, 1)
        d_b = growth / col(model_b.mass.growth, 1)
        return base * sigma2 * (d_a**2 * d_b**2)

    wgt = (weight() if sigma_key is None else memo.get(
        ("ssc_weight", id(cosmo), tuple(map(id, windows)), u_stride,
         sigma_key, id(model_a.mass.growth), id(model_b.mass.growth)),
        weight))
    r_q_i = resp_query(w_i, ells_np_i, model_a, kind_i)
    r_q_j = resp_query(w_j, ells_np_j, model_b, kind_j)
    return (r_q_i * wgt[:, :, None]).mT @ r_q_j


projected_ssc = _own_memo(_projected_ssc)


def _pair_norm_factor(mask, edges_rad, geometry: str):
    """Per-side normalization Omega_bin A2 / D_i of a pair-count
    normalized estimator on a footprint (1 for a bare solid angle or a
    UniformMask), numpy."""
    from chomp_tpu_torch.mask import UniformMask, pair_normalization

    if geometry == "curved":
        raise deferred("the curved-sky SSC normalization")
    if isinstance(mask, (int, float)) or isinstance(mask, UniformMask):
        return np.ones(len(edges_rad) - 1)
    omega_bin = np.pi * (edges_rad[1:] ** 2 - edges_rad[:-1] ** 2)
    d_i = pair_normalization(mask, edges_rad)
    return omega_bin * mask.area2 / np.maximum(d_i, 1e-300)


def _ssc_covariance(cosmo, halo_p, model, dist, theta_edges_deg, mask,
                    windows=None, tracers=None, mu_i: int = 0, mu_j: int = 0,
                    theta_edges_deg_j=None, with_bao: bool | None = None,
                    grid: GridSpec | None = None, n_ell_cov: int = 96,
                    ell_lo: float = 1.0, ell_hi: float = 1.0e5,
                    n_k_ssc: int = 128, u_stride: int = 4,
                    exact_z_anchors: int | None = None,
                    local_counts: bool = True, *, st=None,
                    memo: _Memo):
    """Flat-sky super-sample covariance block, (B, nbi, nbj), with
    :func:`covariance.nongaussian_covariance`'s block interface; ``mask``
    is a mask object or a bare survey solid angle in sr (the equal-area
    disc)."""
    from chomp_tpu_torch.projection import WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    if windows is None:
        windows = (WindowGalaxy(dist=dist),) * 4
    if tracers is None:
        tracers = ("g",) * 4
    ells_np, w_np = _log_ell_weights(n_ell_cov, ell_lo, ell_hi)
    t = dict(dtype=st.dtype, device=st.device)
    edges_i = np.radians(np.asarray(theta_edges_deg))
    edges_j = np.radians(np.asarray(
        theta_edges_deg if theta_edges_deg_j is None else theta_edges_deg_j))
    b_i = _measured_bessel(memo, ells_np, w_np, edges_i, mu_i, t)
    b_j = _measured_bessel(memo, ells_np, w_np, edges_j, mu_j, t)
    sfn = sigma_b2_fn(cosmo, mask, "flat", st=st)
    cov_ll = _projected_ssc(cosmo, halo_p, model, ells_np, ells_np, windows,
                            tracers, sfn, n_k_ssc=n_k_ssc, u_stride=u_stride,
                            local_counts=local_counts, st=st, memo=memo,
                            sigma_key=_mask_key(mask),
                            exact_z_anchors=exact_z_anchors)
    core = b_i @ cov_ll @ b_j.T
    return core * _const(
        memo, ("pair_norm", _mask_key(mask), _edges_key(edges_i),
               _edges_key(edges_j)),
        lambda: np.outer(_pair_norm_factor(mask, edges_i, "flat"),
                         _pair_norm_factor(mask, edges_j, "flat")), t)


ssc_covariance = _own_memo(_ssc_covariance)


def curved_ssc_covariance(*args, **kwargs):
    """The curved-sky SSC block: the next covariance slice."""
    raise deferred("curved_ssc_covariance (the curved-sky SSC block)")
