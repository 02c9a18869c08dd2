"""Halo-model trispectrum T̄(k1, k2) for power-spectrum covariances.

PyTorch counterpart of the JAX package's ``trispectrum.py``: the
angle-averaged parallelogram trispectrum T̄(k1, k2) = <T(k1, -k1, k2,
-k2)>_mu in the Cooray-Hu 2001 halo decomposition, with the tree-level
PT pieces (the F2 snake and the P13-kernel star terms of
:func:`t_pt_parallelogram`, the bispectrum of :func:`b_pt_avg`) and
mixed tracers per leg (:func:`trispectrum_parallelogram_tracers`).  The
mass integrals are float64 contractions in plain torch: the JAX package
computes them outside any Pallas kernel.

Shapes: ``k1`` and ``k2`` are static k tensors without a batch axis that
broadcast against each other; the result is (B, *broadcast shape).  The
covariance's T̄ table passes ``k1`` (n, 1) and ``k2`` (1, n): the mass
integrals then contract the k1 and k2 legs as one matrix product per
integral, (B, n, M) x (B, n, M) -> (B, n, n), instead of an (n^2, M)
y matrix per leg.
"""

from __future__ import annotations

import torch

from chomp_tpu_torch import linear, profiles
from chomp_tpu_torch.params import CosmoParams, HaloParams, col


def f2_scalar(a2, b2, ab):
    """F2 kernel from |a|^2, |b|^2, a.b (symmetrized form)."""
    return (5.0 / 7.0 + 0.5 * ab * (1.0 / a2 + 1.0 / b2)
            + (2.0 / 7.0) * ab * ab / (a2 * b2))


def k13_kernel(r):
    """6 <F3(q, -q, k)>_Omega as a function of r = q/k (the 1-loop P13
    bracket B(r) / (504 r^2)); r within 2e-4 of 1 is nudged to 1 + 2e-4,
    as in the JAX package."""
    r_safe = torch.where(torch.abs(r - 1.0) < 2e-4,
                         torch.full_like(r, 1.0 + 2e-4), r)
    r2 = r_safe * r_safe
    log_term = torch.where(
        r_safe < 1.0,
        torch.log1p(r_safe) - torch.log1p(
            -torch.clamp_max(r_safe, 1.0 - 1e-12)),
        torch.log1p(r_safe) - torch.log(torch.clamp_min(r_safe - 1.0,
                                                        1e-12)))
    bracket = (12.0 / r2 - 158.0 + 100.0 * r2 - 42.0 * r2 * r2
               + 3.0 / (r2 * r_safe) * (r2 - 1.0) ** 3 * (7.0 * r2 + 2.0)
               * log_term)
    return bracket / (504.0 * r2)


def _z_rows(z, st):
    """Redshift (B|1,) of the linear spectra (a float for one value)."""
    return torch.as_tensor(z, dtype=st.dtype, device=st.device).reshape(-1)


def _plin(cosmo, k, z, st):
    """P_lin at the static ``k`` (any shape S) -> (B, *S)."""
    return linear.linear_power(cosmo, k[None], z, st)


def _mu_nodes(st):
    return st.gl(st.grid.n_mu)


def _s2(k1e, k2e, mu):
    return torch.clamp_min(k1e**2 + k2e**2 + 2.0 * k1e * k2e * mu, 1e-20)


def _ps_avg(cosmo, k1, k2, z, st):
    """<P_lin(|k1 + k2|)>_mu, (B, *S)."""
    mu, w_mu = _mu_nodes(st)
    s = torch.sqrt(_s2(k1[..., None], k2[..., None], mu))
    return 0.5 * torch.sum(_plin(cosmo, s, z, st) * w_mu, dim=-1)


def t_pt_parallelogram(cosmo: CosmoParams, k1, k2, st, z=0.0):
    """Angle-averaged tree-level PT trispectrum T̄_PT(k1, k2) at redshift
    ``z`` (a float or (B|1,)): star + snake terms (the JAX docstring has
    the Wick enumeration).  Returns (B, *broadcast(k1, k2))."""
    z = _z_rows(z, st)
    k1, k2 = torch.broadcast_tensors(k1, k2)
    p1 = _plin(cosmo, k1, z, st)
    p2 = _plin(cosmo, k2, z, st)
    star = (2.0 * p1 * p1 * p2 * k13_kernel(k1 / k2)
            + 2.0 * p2 * p2 * p1 * k13_kernel(k2 / k1))
    mu, w_mu = _mu_nodes(st)
    k1e, k2e = k1[..., None], k2[..., None]
    s2 = _s2(k1e, k2e, mu)
    ps = _plin(cosmo, torch.sqrt(s2), z, st)
    f2_1 = f2_scalar(k1e**2, s2, -(k1e**2 + k1e * k2e * mu))
    f2_2 = f2_scalar(k2e**2, s2, -(k2e**2 + k1e * k2e * mu))
    p1e, p2e = p1[..., None], p2[..., None]
    snake_integrand = ps * (16.0 * f2_1 * f2_2 * p1e * p2e
                            + 8.0 * f2_1 * f2_1 * p1e**2
                            + 8.0 * f2_2 * f2_2 * p2e**2)
    return star + 0.5 * torch.sum(snake_integrand * w_mu, dim=-1)


def b_pt_avg(cosmo: CosmoParams, k1, k2, st, z=0.0):
    """<B_PT(k1, k2, -S)>_mu at redshift ``z``, with B_PT(q1, q2, q3) =
    2 F2(q1, q2) P1 P2 + cyc.: (B, *broadcast(k1, k2))."""
    z = _z_rows(z, st)
    k1, k2 = torch.broadcast_tensors(k1, k2)
    p1 = _plin(cosmo, k1, z, st)[..., None]
    p2 = _plin(cosmo, k2, z, st)[..., None]
    mu, w_mu = _mu_nodes(st)
    k1e, k2e = k1[..., None], k2[..., None]
    k1k2 = k1e * k2e * mu
    s2 = torch.clamp_min(k1e**2 + k2e**2 + 2.0 * k1k2, 1e-20)
    ps = _plin(cosmo, torch.sqrt(s2), z, st)
    f12 = f2_scalar(k1e**2, k2e**2, k1k2)
    f2s = f2_scalar(k2e**2, s2, -(k2e**2 + k1k2))
    fs1 = f2_scalar(s2, k1e**2, -(k1e**2 + k1k2))
    b = 2.0 * f12 * p1 * p2 + 2.0 * f2s * p2 * ps + 2.0 * fs1 * ps * p1
    return 0.5 * torch.sum(b * w_mu, dim=-1)


def _i_mu_beta(cosmo: CosmoParams, halo: HaloParams, model, y_list,
               mu_exp: int, beta: int):
    """I_mu^beta = ∫ dlnM dn/dlnM (M/rho_bar)^mu b^beta prod(y_i) on the
    mass table; ``y_list``: (B, ..., nM) factors sharing the mass axis."""
    t = model.mass
    weight = t.w_lnm * t.dndlnm * (t.m / col(cosmo.rho_bar, 1)) ** mu_exp
    if beta:
        weight = weight * t.bias
    prod = None
    for y in y_list:
        prod = y if prod is None else prod * y
    w = weight.reshape(weight.shape[0], *([1] * (prod.dim() - 2)), -1)
    return torch.sum(prod * w, dim=-1)


def _outer_axes(k1, k2):
    """(n1, n2) when ``k1`` is (n1, 1) and ``k2`` (1, n2), else None."""
    if (k1.dim() == 2 and k2.dim() == 2 and k1.shape[1] == 1
            and k2.shape[0] == 1):
        return k1.shape[0], k2.shape[1]
    return None


def trispectrum_parallelogram_tracers(cosmo: CosmoParams, halo: HaloParams,
                                      model, k1, k2,
                                      tracers=("m", "m", "m", "m"),
                                      st=None,
                                      terms=("1h", "2h", "3h", "4h")):
    """Mixed-tracer parallelogram trispectrum T̄^{abcd}(k1, k2), (B,
    *broadcast(k1, k2)).

    Legs 0/1 carry (k1, -k1) with tracers[0]/[1], legs 2/3 (k2, -k2)
    with tracers[2]/[3]; "m" is matter (leg factor M/rho_bar), "g" the
    HOD galaxies (p same-halo galaxy legs of one sample contribute
    <(N)_p>/n_g^p).  1h = U^0(0123); 2h = sum_i P(k_i) U^1(i) U^1(rest) +
    <P(S)>_mu [U^1(02) U^1(13) + U^1(03) U^1(12)]; 3h = <B_PT>_mu sum over
    the four opposite pairs of U^1(pair) U^1(k) U^1(l); 4h = prod_i
    U^1(i) T̄_PT.  ``model`` is one HaloModel or four per-leg models on
    one mass-table build (distinct samples by identity; a leg mixing
    samples integrates on :func:`halo.union_gal_pack` with independent-
    occupation product moments; "m" legs ignore their entry)."""
    return _parallelogram_tracers(cosmo, halo, model, k1, k2, tracers, st,
                                  terms, shared={})


def _parallelogram_tracers(cosmo, halo, model, k1, k2, tracers, st, terms,
                           *, shared: dict):
    """:func:`trispectrum_parallelogram_tracers` with ``shared``, a dict
    that one covariance builder call keeps for its tables of the same
    cosmologies and k grid: it shares what does not depend on the
    tracers (the linear and PT pieces at the model's redshift, the y
    matrices of each node set and the union packs of each sample set)."""
    from chomp_tpu_torch.halo import union_gal_pack

    if isinstance(model, (list, tuple)):
        if len(model) != 4:
            raise ValueError(f"per-leg models: need 4, got {len(model)}")
        leg_models = list(model)
        model = leg_models[0]
    else:
        leg_models = [model] * 4
    samples: list = []
    leg_sample: list = [None] * 4
    for i in range(4):
        if tracers[i] != "g":
            continue
        for s, m_s in enumerate(samples):
            if leg_models[i] is m_s:
                leg_sample[i] = s
                break
        else:
            leg_sample[i] = len(samples)
            samples.append(leg_models[i])
    outer = _outer_axes(k1, k2)
    if outer is None:
        k1, k2 = torch.broadcast_tensors(k1, k2)
        shape = k1.shape
        k1, k2 = k1.reshape(-1), k2.reshape(-1)
        kg = {0: k1, 2: k2}
    else:
        shape = outer
        kg = {0: k1[:, 0], 2: k2[0]}
    t = model.mass
    zm = t.z
    rho = col(cosmo.rho_bar, 1)

    packs: dict = {"t": (t.w_lnm, t.dndlnm, t.bias, t.m)}

    def pack(key):
        if key not in packs:
            if key == "u":
                ukey = ("union",) + tuple(map(id, samples))
                if ukey not in shared:
                    _, w_u, m_u, dn_u, b_u = union_gal_pack(cosmo, halo,
                                                            samples, st)
                    shared[ukey] = (w_u, dn_u, b_u, m_u)
                packs["u"] = shared[ukey]
            else:
                g_s = samples[key].gal
                packs[key] = (g_s.w_lnm, g_s.dndlnm, g_s.bias, g_s.m)
        return packs[key]

    def occupation(sample, m_nodes, p):
        """<(N)_p> / n_g^p of ``sample`` at ``m_nodes``, shared."""
        key = ("occupation", id(sample), id(m_nodes), p)
        if key not in shared:
            shared[key] = (sample, m_nodes, sample.hod.nth_moment(m_nodes, p)
                           / col(sample.n_g, 1) ** p)
        return shared[key][2]

    def y(pack_key, group):
        m_nodes = pack(pack_key)[3]
        kq = kg[group]
        # By the k values' storage: the covariance's table passes one k
        # vector as both legs' (k1 (n, 1), k2 (1, n) of the same memory).
        key = ("y", id(m_nodes), kq.data_ptr(), kq.numel(), kq.stride())
        if key not in shared:
            shared[key] = (m_nodes, kq, profiles.y_nfw(
                cosmo, halo, kq[None, :, None], m_nodes[:, None, :],
                model.m_star, zm))
        return shared[key][2]

    u_cache: dict = {}

    def u(leg_idx, beta):
        """U^beta over the legs, shaped to broadcast against (B, *S)."""
        key = (tuple(sorted(leg_idx)), beta)
        if key in u_cache:
            return u_cache[key]
        gal_legs = [i for i in leg_idx if tracers[i] == "g"]
        n_mat = len(leg_idx) - len(gal_legs)
        if gal_legs:
            counts: dict = {}
            for i in gal_legs:
                counts[leg_sample[i]] = counts.get(leg_sample[i], 0) + 1
            pack_key = next(iter(counts)) if len(counts) == 1 else "u"
            w_lnm, dndlnm, bias, m_nodes = pack(pack_key)
            w = w_lnm * dndlnm
            for s, p in counts.items():
                w = w * occupation(samples[s], m_nodes, p)
        else:
            pack_key = "t"
            w = t.w_lnm * t.dndlnm
            m_nodes, bias = t.m, t.bias
        if n_mat:
            w = w * (m_nodes / rho) ** n_mat
        if beta:
            w = w * bias
        a = [y(pack_key, 0) for i in leg_idx if i < 2]
        b = [y(pack_key, 2) for i in leg_idx if i >= 2]
        fa = _prod(a)
        fb = _prod(b)
        if outer is None:
            f = fa if fb is None else (fb if fa is None else fa * fb)
            out = torch.sum(f * w[:, None, :], dim=-1)
        elif fb is None:
            out = torch.einsum("bim,bm->bi", fa, w)[:, :, None]
        elif fa is None:
            out = torch.einsum("bjm,bm->bj", fb, w)[:, None, :]
        else:
            out = torch.einsum("bim,bjm->bij", fa * w[:, None, :], fb)
        u_cache[key] = out
        return out

    if outer is None:
        q1, q2 = k1, k2
    else:
        q1, q2 = kg[0][:, None], kg[2][None, :]
    qb1, qb2 = torch.broadcast_tensors(q1, q2)

    def pt(name, make):
        key = ("pt", name, id(zm))
        if key not in shared:
            shared[key] = (zm, make())
        return shared[key][1]

    p1 = pt("p1", lambda: _plin(cosmo, q1, zm, st))
    p2 = pt("p2", lambda: _plin(cosmo, q2, zm, st))
    p_of = {0: p1, 1: p1, 2: p2, 3: p2}
    opposite_pairs = ((0, 2), (0, 3), (1, 2), (1, 3))

    total = torch.zeros(1, dtype=st.dtype, device=st.device)
    if "1h" in terms:
        total = total + u((0, 1, 2, 3), 0)
    if "2h" in terms:
        t2h_31 = sum(p_of[i] * u((i,), 1)
                     * u(tuple(j for j in range(4) if j != i), 1)
                     for i in range(4))
        t2h_22 = pt("ps_avg", lambda: _ps_avg(cosmo, qb1, qb2, zm, st)) * (
            u((0, 2), 1) * u((1, 3), 1) + u((0, 3), 1) * u((1, 2), 1))
        total = total + t2h_31 + t2h_22
    if "3h" in terms:
        b_avg = pt("b_avg", lambda: b_pt_avg(cosmo, qb1, qb2, st, z=zm))
        t3h = 0.0
        for pair in opposite_pairs:
            rest = tuple(j for j in range(4) if j not in pair)
            t3h = t3h + u(pair, 1) * u((rest[0],), 1) * u((rest[1],), 1)
        total = total + b_avg * t3h
    if "4h" in terms:
        total = total + (u((0,), 1) * u((1,), 1) * u((2,), 1) * u((3,), 1)
                         * pt("t_pt", lambda: t_pt_parallelogram(
                             cosmo, qb1, qb2, st, z=zm)))
    b = cosmo.batch
    return total.expand(b, *qb1.shape).reshape(b, *shape)


def _prod(factors):
    out = None
    for f in factors:
        out = f if out is None else out * f
    return out


def trispectrum_parallelogram(cosmo: CosmoParams, halo: HaloParams, model,
                              k1, k2, st, terms=("1h", "2h", "3h", "4h")):
    """T̄(k1, k2) of the matter field, (B, *broadcast(k1, k2))."""
    return trispectrum_parallelogram_tracers(cosmo, halo, model, k1, k2,
                                             ("m",) * 4, st, terms)


def trispectrum_parallelogram_galaxy(cosmo: CosmoParams, halo: HaloParams,
                                     model, k1, k2, st,
                                     terms=("1h", "2h", "3h", "4h")):
    """T̄_gg(k1, k2) of the galaxy field (HOD factorial-moment weights),
    the trispectrum of the w_gg(theta) covariance."""
    return trispectrum_parallelogram_tracers(cosmo, halo, model, k1, k2,
                                             ("g",) * 4, st, terms)
