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
contractions.  On the sphere, :func:`sigma_b2_curved` sums the Limber
shell power against the mask's per-l power (static numpy Legendre
coefficients of xi_W2, cached per mask) and
:func:`curved_ssc_covariance` maps the projection's ln-l table onto
exact sphere bin factors.  ``exact_z_anchors`` = J mixes each side's two
positive response parts over J Chebyshev anchors: the anchors' halo
models live on B x J rows, so every sample's anchor responses at a span
take ONE kernel A launch, and a tomographic builder primes the spans of
all its blocks at once (B x S x J rows, :func:`_prime_anchor_parts`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import halo, linear
from chomp_tpu_torch.covariance import (_Memo, _anchor_models,
                                        _anchor_samples, _anchor_span,
                                        _const,
                                        _edges_key, _k_tri,
                                        _lattice_projection_weights,
                                        _log_ell_weights, _mask_key,
                                        _measured_bessel, _own_memo,
                                        _tri_query_weights, resolve_statics)
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
    if all(_response_key(m, n_k_ssc, local_counts) in memo for m in models):
        return
    _, _, kk = _k_ssc(n_k_ssc, st)
    for m, parts in zip(models, _response_parts_of(cosmo, halo_p, models,
                                                   kk, st, local_counts)):
        memo.get(_response_key(m, n_k_ssc, local_counts),
                 lambda parts=parts: parts)


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


@lru_cache(maxsize=32)
def _mask_cl_coeffs(mask, lmax: int):
    """Legendre coefficients c_l of xi_W2(mu) = sum_l c_l P_l(mu) by
    Gauss-Legendre quadrature (numpy, cached per mask), tiny negative
    ones (quadrature noise around zero) clipped."""
    from chomp_tpu_torch.curved import _legendre_all
    from chomp_tpu_torch.grids import gauss_legendre

    x, wq = gauss_legendre(max(2 * lmax, 512))
    xi = np.asarray(mask.xi_w2(x), dtype=float)
    p = _legendre_all(lmax, x)
    c = (np.arange(lmax + 1) + 0.5) * (p @ (wq * xi))
    return np.maximum(c, 0.0)


#: Elements of one P_lin evaluation of :func:`sigma_b2_curved`: the
#: (B, nodes, l) query is evaluated in node chunks of at most this size.
_CURVED_CHUNK = 1 << 24


def sigma_b2_curved(cosmo, mask, chi, growth, with_bao: bool | None = None,
                    grid: GridSpec | None = None, lmax: int | None = None,
                    *, st=None):
    """sigma_b^2 at distances ``chi`` (B|1, m) for a curved-sky mask (any
    object with xi_w2 / area2 / coupling_ell), ``growth`` (B, m): (4 pi /
    A2^2) sum_l c_l P_lin((l + 1/2)/chi, 0) D^2 / chi^2.  The query runs
    in chunks of nodes so that no (B, m, l) intermediate exceeds
    ``_CURVED_CHUNK`` elements."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    if lmax is None:
        lmax = int(min(max(256.0, 24.0 * max(mask.coupling_ell, 1.0)),
                       3072.0))
    t = dict(dtype=st.dtype, device=st.device)
    c_l = _mask_cl_coeffs(mask, lmax)
    chi = torch.as_tensor(chi, **t)
    if chi.dim() < 2:
        chi = chi.reshape(1, -1)
    ell = torch.as_tensor(np.arange(lmax + 1, dtype=float) + 0.5, **t)
    w_eff = torch.as_tensor(4.0 * np.pi * c_l / mask.area2**2, **t)
    z0 = torch.zeros(1, **t)
    step = max(1, _CURVED_CHUNK // (max(cosmo.batch, chi.shape[0])
                                    * (lmax + 1)))
    parts = []
    for m0 in range(0, chi.shape[1], step):
        kq = ell / chi[:, m0:m0 + step, None]
        parts.append(linear.linear_power(cosmo, kq, z0, st) @ w_eff)
    s = torch.cat(parts, dim=-1)
    return s * growth**2 / chi**2


def _as_cap(mask):
    from chomp_tpu_torch.curved import SphericalCapMask

    if isinstance(mask, (int, float)):
        omega = float(mask)
        return SphericalCapMask(float(np.arccos(np.clip(
            1.0 - omega / (2.0 * np.pi), -1.0, 1.0))))
    return mask


def sigma_b2_fn(cosmo, mask, geometry: str = "flat",
                with_bao: bool | None = None, grid: GridSpec | None = None,
                *, st=None):
    """(chi, growth) -> sigma_b^2 of ``mask``, flat or ``geometry=
    "curved"``; a bare solid angle becomes the equal-area disc (flat) or
    polar cap (curved)."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    if geometry == "curved":
        mask = _as_cap(mask)
        return lambda chi, g: sigma_b2_curved(cosmo, mask, chi, g, st=st)
    mask = _as_disc(mask)
    return lambda chi, g: sigma_b2_flat(cosmo, mask, chi, g, st=st)


def _pair_kind(ta: str, tb: str) -> str:
    return ("mm", "gm", "gg")[(ta == "g") + (tb == "g")]


def _ln_floor(x):
    return torch.log(torch.clamp_min(x, torch.finfo(x.dtype).tiny))


def _anchor_lag(z, span, n_anchor):
    """Barycentric Lagrange rows (B, m, J) at z clipped into the anchor
    span."""
    from chomp_tpu_torch.limber_fft import _barycentric_rows, _cheb_nodes

    z_nodes, w_bary = _cheb_nodes(span[0], span[1], int(n_anchor))
    return _barycentric_rows(torch.clamp(z, span[0], span[1]), z_nodes,
                             w_bary)


def _anchor_key(distinct, span, n_anchor, n_k_ssc, local_counts):
    return ("anchor_parts", tuple(map(id, distinct)), span, int(n_anchor),
            n_k_ssc, bool(local_counts))


def _anchor_parts_at(cosmo, halo_p, distinct, spans, n_anchor, n_k_ssc,
                     local_counts, st, memo):
    """{span: (distinct, [(pos, cnt) of each sample])} at the J anchors of
    each span of ``spans``, each part divided by D_j^2, (B, J, n_k_ssc):
    the samples rebuilt at every anchor on ONE mass-table build over
    B x S x J rows, so all their responses take one kernel A launch."""
    rows, hp, rebuilt = _anchor_models(cosmo, halo_p, distinct, spans,
                                       n_anchor, st, memo)
    _, _, kk = _k_ssc(n_k_ssc, st)
    parts = _response_parts_of(rows, hp, rebuilt, kk, st, local_counts)
    b, n_s, j = cosmo.batch, len(spans), int(n_anchor)
    d2 = rebuilt[0].mass.growth.reshape(b, n_s, j, 1) ** 2

    def at(v, s):
        return v.reshape(b, n_s, j, -1)[:, s] / d2[:, s]

    return {span: (distinct, [({k: at(v, s) for k, v in pos.items()},
                               {k: at(v, s) for k, v in cnt.items()})
                              for pos, cnt in parts])
            for s, span in enumerate(spans)}


#: Rows (cosmology x span x anchor) of one kernel A launch of
#: :func:`_prime_anchor_parts`: each row carries its own halo model, and
#: the 1-halo response integrals a (n_k_ssc, n_mass) profile table.
_ANCHOR_ROWS = 4096


def _prime_anchor_parts(cosmo, halo_p, model, spans, n_anchor, st,
                        memo: _Memo, n_k_ssc: int = 128,
                        local_counts: bool = True):
    """Fill ``memo`` with the anchor response parts of every sample of
    ``model`` (or of the builder's registered samples) at every span of
    ``spans`` that it lacks: one kernel A launch per chunk of at most
    ``_ANCHOR_ROWS`` rows (one launch unless B x S x J exceeds it)."""
    distinct = _anchor_samples(model, memo)
    todo = [sp for sp in spans if _anchor_key(distinct, sp, n_anchor,
                                              n_k_ssc, local_counts)
            not in memo]
    step = max(1, _ANCHOR_ROWS // (cosmo.batch * int(n_anchor)))
    for s0 in range(0, len(todo), step):
        got = _anchor_parts_at(cosmo, halo_p, distinct, tuple(todo[s0:s0
                                                                 + step]),
                               n_anchor, n_k_ssc, local_counts, st, memo)
        for span, val in got.items():
            memo.get(_anchor_key(distinct, span, n_anchor, n_k_ssc,
                                 local_counts), lambda val=val: val)


def _anchor_parts(cosmo, halo_p, model, mdl, kind, span, n_anchor, n_k_ssc,
                  local_counts, st, memo):
    """(pos, cnt) of sample ``mdl``'s ``kind`` response at the J anchors of
    ``span``, each divided by D_j^2: (B, J, n_k_ssc).  Every sample of
    ``model`` (one HaloModel or a tuple of them on one mass-table build),
    or of the builder where it registered its samples
    (:func:`covariance._anchor_samples`), is rebuilt at the anchors on ONE
    mass-table build over B x J rows, so their responses take one kernel A
    launch; memoized per span (a tomographic builder primes every span at
    once, :func:`_prime_anchor_parts`)."""
    distinct = _anchor_samples(model, memo)
    got = memo.get(_anchor_key(distinct, span, n_anchor, n_k_ssc,
                               local_counts),
                   lambda: _anchor_parts_at(
                       cosmo, halo_p, distinct, (span,), n_anchor, n_k_ssc,
                       local_counts, st, memo)[span])
    i = next(n for n, d in enumerate(got[0]) if d is mdl)
    pos, cnt = got[1][i]
    return pos[kind], cnt[kind]


def _response_parts_of(cosmo, halo_p, models, kk, st, local_counts):
    """[(pos, cnt)] of each model of ``models`` (one mass-table build) at
    ``kk``: every sample's 2-halo integrals and spectra by ONE kernel A
    launch (:func:`halo.tomographic_powers_and_two_halo`)."""
    ps, (h_m, h_gs) = halo.tomographic_powers_and_two_halo(
        cosmo, halo_p, models, kk, st, with_cross=False)
    p_lin = halo.linear_power(cosmo, models[0], kk, st)
    pref = 68.0 / 21.0 - _dln_k3p_dlnk(cosmo, kk, st) / 3.0
    out = []
    for i, m in enumerate(models):
        spectra = {"power_gm": ps[("power_gm", i)],
                   "power_gg": ps[("power_gg", i, i)]}
        out.append(_parts(cosmo, p_lin, h_m, h_gs[i],
                          response_one_halo_integrals(cosmo, halo_p, m, kk),
                          spectra, halo.galaxy_bias_avg(m), pref,
                          local_counts))
    return out


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
    st = resolve_statics(cosmo, st, grid, with_bao)
    ells_np_i = np.asarray(ells_i, dtype=np.float64)
    ells_np_j = np.asarray(ells_j, dtype=np.float64)
    model_a, model_b = model if isinstance(model, tuple) else (model, model)
    kind_i = _pair_kind(tracers[0], tracers[1])
    kind_j = _pair_kind(tracers[2], tracers[3])
    ln_k_np, dln, kk = _k_ssc(n_k_ssc, st)
    rng, u_np, base, z_nodes, growth = _lattice_projection_weights(
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

    if exact_z_anchors:
        span = _anchor_span(windows)
        lag = memo.get(("ssc_lag", id(cosmo), tuple(map(id, windows)),
                        u_stride, span, int(exact_z_anchors)),
                       lambda: _anchor_lag(z_nodes, span, exact_z_anchors))
        d2 = growth**2

        def mixed_query(w_side, ells_np, mdl, kind):
            def make():
                pos_j, cnt_j = _anchor_parts(
                    cosmo, halo_p, model, mdl, kind, span, exact_z_anchors,
                    n_k_ssc, local_counts, st, memo)
                out = []
                for tab in (pos_j, cnt_j):
                    mix = (torch.einsum("bmj,bji->bmi", lag, tab)
                           * d2[..., None])
                    ln_q = torch.einsum("mai,bmi->bma", w_side,
                                        _ln_floor(mix))
                    out.append(torch.exp(ln_q))
                return out[0] - out[1]

            return memo.get(("resp_q_anchor", rng, len(ells_np),
                             float(ells_np[0]), float(ells_np[-1]), n_k_ssc,
                             id(mdl), kind, bool(local_counts), span,
                             int(exact_z_anchors)), make)

        wgt = base * sigma2
        r_q_i = mixed_query(w_i, ells_np_i, model_a, kind_i)
        r_q_j = mixed_query(w_j, ells_np_j, model_b, kind_j)
        return (r_q_i * wgt[:, :, None]).mT @ r_q_j

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
    UniformMask), numpy: flat annuli and pair counts, or ``geometry=
    "curved"`` spherical ones."""
    from chomp_tpu_torch.mask import UniformMask, pair_normalization

    if isinstance(mask, (int, float)):
        return np.ones(len(edges_rad) - 1)
    if geometry == "curved":
        from chomp_tpu_torch.curved import curved_pair_normalization

        omega_bin = 2.0 * np.pi * (np.cos(edges_rad[:-1])
                                   - np.cos(edges_rad[1:]))
        d_i = curved_pair_normalization(mask, edges_rad)
    else:
        if isinstance(mask, UniformMask):
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
                            sigma_key=("flat",) + _mask_key(mask),
                            exact_z_anchors=exact_z_anchors)
    core = b_i @ cov_ll @ b_j.T
    return core * _const(
        memo, ("pair_norm", _mask_key(mask), _edges_key(edges_i),
               _edges_key(edges_j)),
        lambda: np.outer(_pair_norm_factor(mask, edges_i, "flat"),
                         _pair_norm_factor(mask, edges_j, "flat")), t)


ssc_covariance = _own_memo(_ssc_covariance)


def _curved_ssc_covariance(cosmo, halo_p, model, dist, theta_edges_deg,
                           mask, windows=None, tracers=None, mu_i=0, mu_j=0,
                           theta_edges_deg_j=None, ell_max: int = 2048,
                           n_ell_tbl: int = 96, with_bao: bool | None = None,
                           grid: GridSpec | None = None, n_k_ssc: int = 128,
                           u_stride: int = 4,
                           exact_z_anchors: int | None = None,
                           local_counts: bool = True, *, st=None,
                           memo: _Memo):
    """Curved-sky super-sample block, (B, nbi, nbj): Cov(l, l') by the
    lattice projection on a uniform-ln-l table with the curved sigma_b^2
    (:func:`sigma_b2_curved`), mapped onto the integer multipoles by a
    static Catmull-Rom matrix and summed against the bin factors of the
    estimator codes {0, 2, "xip", "xim"}; ``mask`` a curved mask or a bare
    solid angle (the polar cap)."""
    from chomp_tpu_torch.curved import _table_matrix
    from chomp_tpu_torch.projection import WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    if windows is None:
        windows = (WindowGalaxy(dist=dist),) * 4
    if tracers is None:
        tracers = ("g",) * 4
    t = dict(dtype=st.dtype, device=st.device)
    edges_i = np.radians(np.asarray(theta_edges_deg, dtype=float))
    edges_j = np.radians(np.asarray(
        theta_edges_deg if theta_edges_deg_j is None
        else theta_edges_deg_j, dtype=float))
    ells_tbl = np.exp(np.linspace(0.0, np.log(ell_max), n_ell_tbl))
    sfn = sigma_b2_fn(cosmo, mask, "curved", st=st)
    cov_tbl = _projected_ssc(cosmo, halo_p, model, ells_tbl, ells_tbl,
                             windows, tracers, sfn, n_k_ssc=n_k_ssc,
                             u_stride=u_stride,
                             exact_z_anchors=exact_z_anchors,
                             local_counts=local_counts, st=st, memo=memo,
                             sigma_key=("curved",) + _mask_key(mask))
    m_i = _table_matrix(memo, mu_i, ell_max, n_ell_tbl, edges_i, t)
    m_j = _table_matrix(memo, mu_j, ell_max, n_ell_tbl, edges_j, t)
    return (m_i @ cov_tbl @ m_j.T) * _const(
        memo, ("pair_norm_curved", _mask_key(mask), _edges_key(edges_i),
               _edges_key(edges_j)),
        lambda: np.outer(_pair_norm_factor(mask, edges_i, "curved"),
                         _pair_norm_factor(mask, edges_j, "curved")), t)


curved_ssc_covariance = _own_memo(_curved_ssc_covariance)
