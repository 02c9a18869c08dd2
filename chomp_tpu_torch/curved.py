"""Curved-sky w(theta), gamma_t and xi_+- predictions: exact multipole
sums composed into static lattice operators.

PyTorch counterpart of the prediction half of the JAX package's
``curved.py`` (its covariance half is ROADMAP queue 1, item 11):

    w(theta)   = sum_l (2l+1)/(4 pi) C_l        P_l(cos theta),
    gamma_t    = sum_l (2l+1)/(4 pi) C^gE_l     d^l_20(cos theta),
    xi_+-      = sum_l (2l+1)/(4 pi) C^EE_l     d^l_2,+-2(cos theta),

with C^gE = f_l C^gk and C^EE = f_l^2 C^kk, f_l =
sqrt((l+2)(l-1)/(l(l+1))).  The integer-l C's come from Catmull-Rom
interpolation of the lattice convolution C(s) at s = ln(l + 1/2), so
each sum is one static float64 matrix against the convolution output
(:func:`curved_lattice_operator`, built offline in numpy: the Wigner-d
recursions run in Python to lmax ~ 64/theta_min, capped at 2^18), applied
at run time by kernel C exactly as the flat operators are.  The numpy
builders are copied from the JAX module.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _wigner_d_matrix(m: int, n: int, lmax: int, mu):
    """d^ℓ_{mn}(μ) for ℓ = 0..lmax on nodes ``mu`` — (lmax+1, n_mu).

    Three-term upward recursion in ℓ (stable for the small |m|, |n| ≤ 2
    used here; float64):

      ℓ √((ℓ+1)²-m²) √((ℓ+1)²-n²) d^{ℓ+1}
        = (2ℓ+1) [ℓ(ℓ+1)μ - mn] d^ℓ - (ℓ+1) √(ℓ²-m²) √(ℓ²-n²) d^{ℓ-1}

    seeded at ℓ = max(|m|,|n|) with the closed ℓ=2 forms; rows below
    the seed are zero.  Validated against sympy's exact Rotation.d and
    the orthogonality ∫ d d dμ = 2δ/(2ℓ+1) (tests/test_curved.py).
    """
    mu = np.asarray(mu, dtype=float)
    if (m, n) == (0, 0):
        return _legendre_all(lmax, mu)     # a(ℓ=0) = 0 in the general
    out = np.zeros((lmax + 1, mu.size))    # recursion; Bonnet instead
    lmin = max(abs(m), abs(n))
    if lmax < lmin:
        return out
    if (m, n) == (2, 0):
        seed = np.sqrt(6.0) / 4.0 * (1.0 - mu**2)
    elif (m, n) == (2, 2):
        seed = (1.0 + mu) ** 2 / 4.0
    elif (m, n) == (2, -2):
        seed = (1.0 - mu) ** 2 / 4.0
    else:  # pragma: no cover - only the four cases above are used
        raise NotImplementedError((m, n))
    out[lmin] = seed
    prev = np.zeros_like(mu)
    for ell_i in range(lmin, lmax):
        # float coefficients: (ℓ²-m²)(ℓ²-n²) overflows int64 at
        # ℓ ≳ 55000 (object-dtype np.sqrt error), and ℓ reaches 1e5+
        # in the curved prediction operators.
        ell = float(ell_i)
        a = ell * np.sqrt(((ell + 1.0) ** 2 - m * m)
                          * ((ell + 1.0) ** 2 - n * n))
        b = (2 * ell + 1.0) * (ell * (ell + 1.0) * mu - m * n)
        c = (ell + 1.0) * np.sqrt(max(ell * ell - m * m, 0.0)
                                  * max(ell * ell - n * n, 0.0))
        nxt = (b * out[ell_i] - c * prev) / a
        prev = out[ell_i]
        out[ell_i + 1] = nxt
    return out


def _legendre_all(lmax: int, mu):
    """P_ℓ(μ) for ℓ = 0..lmax — (lmax+1, n_mu) Bonnet recursion."""
    mu = np.asarray(mu, dtype=float)
    p = np.zeros((lmax + 1, mu.size))
    p[0] = 1.0
    if lmax >= 1:
        p[1] = mu
    for ell in range(1, lmax):
        p[ell + 1] = ((2 * ell + 1) * mu * p[ell] - ell * p[ell - 1]) \
            / (ell + 1)
    return p


# ---------------------------------------------------------------------------
# Closed-form bin factors
# ---------------------------------------------------------------------------

def _legendre_endpoints(lmax: int, mu):
    """P_ℓ(μ) at a few endpoint values, ℓ = 0..lmax+1 — (lmax+2, n)."""
    return _legendre_all(lmax + 1, mu)


def legendre_bin_factors(lmax: int, theta_edges_rad):
    """Bin-averaged Legendre P̄^i_ℓ = ∫_bin P_ℓ dμ / Δμ_i — (nb, lmax+1).

    Closed form ∫_a^b P_ℓ dμ = [P_{ℓ+1} - P_{ℓ-1}]_a^b / (2ℓ+1)
    (ℓ = 0 row: 1).  The curved analog of covariance.bin_averaged_j0;
    flat limit P̄_ℓ(bin) → J̄₀ for θ ≪ 1 (tested)."""
    edges = np.asarray(theta_edges_rad, dtype=float)
    mu_e = np.cos(edges)                       # decreasing in θ
    p = _legendre_endpoints(lmax, mu_e)        # (lmax+2, ne)
    ell = np.arange(lmax + 1)
    # ∫ P_ℓ dμ antiderivative at each edge: (lmax+1, ne)
    anti = np.empty((lmax + 1, mu_e.size))
    anti[0] = mu_e
    anti[1:] = (p[2:lmax + 2] - p[0:lmax]) / (2.0 * ell[1:, None] + 1.0)
    dmu = mu_e[:-1] - mu_e[1:]                 # Δμ_i > 0
    val = anti[:, :-1] - anti[:, 1:]           # ∫_{μ_hi}^{μ_lo} = bin
    return (val / dmu[None, :]).T              # (nb, lmax+1)


def legendre_bin_factors_spin2(lmax: int, theta_edges_rad):
    """Bin-averaged tangential kernel d̄^i_ℓ = ∫_bin d^ℓ_{20} dμ / Δμ_i
    — (nb, lmax+1), rows ℓ < 2 zero.  Closed form (module docstring);
    the curved analog of covariance.bin_averaged_j2 (flat limit J̄₂,
    tested)."""
    edges = np.asarray(theta_edges_rad, dtype=float)
    mu_e = np.cos(edges)
    p = _legendre_endpoints(lmax, mu_e)        # rows 0..lmax+1
    ell = np.arange(2, lmax + 1, dtype=float)
    pl = p[2:lmax + 1]                         # P_ℓ
    plm1 = p[1:lmax]                           # P_{ℓ-1}
    plp1 = p[3:lmax + 2]                       # P_{ℓ+1}
    # antiderivative of P²_ℓ: (1-μ²)P'_ℓ + 2μP_ℓ - 2∫P_ℓ,
    # with (1-μ²)P'_ℓ = ℓ(P_{ℓ-1} - μ P_ℓ).
    anti = (ell[:, None] * (plm1 - mu_e[None, :] * pl)
            + 2.0 * mu_e[None, :] * pl
            - 2.0 * (plp1 - plm1) / (2.0 * ell[:, None] + 1.0))
    norm = np.sqrt((ell - 1.0) * ell * (ell + 1.0) * (ell + 2.0))
    anti = anti / norm[:, None]
    dmu = mu_e[:-1] - mu_e[1:]
    val = anti[:, :-1] - anti[:, 1:]
    out = np.zeros((mu_e.size - 1, lmax + 1))
    out[:, 2:] = (val / dmu[None, :]).T
    return out


@lru_cache(maxsize=32)
def _wigner_bin_factors_cached(m: int, n: int, lmax: int, edges_key,
                               nodes_per_osc: float = 3.0):
    """Bin-averaged Wigner-d factors t̄^i_ℓ = ∫_bin d^ℓ_{mn} dμ / Δμ_i
    — (nb, lmax+1) — for the ξ_+/ξ_- families (m, n) = (2, ±2), where
    no convenient endpoint closed form exists (unlike P_ℓ / d^ℓ_{20}
    above).  Per-bin Gauss-Legendre quadrature in μ, accumulated DURING
    the ℓ recursion in chunks so memory stays O(total nodes), not
    O(lmax × nodes): d^ℓ_{mn}(μ) is a degree-ℓ polynomial oscillating
    with period ~2π/ℓ in θ, so the node count scales with
    ℓ_max Δθ_bin.  Validated against the closed-form (0,0)/(2,0)
    factors and the flat J0/J4 limits (tests/test_curved.py)."""
    edges = np.asarray(edges_key, dtype=float)
    nb = len(edges) - 1
    # GL nodes per bin, scaled to the top-ℓ oscillation count.
    nodes, wts, bins = [], [], []
    for b in range(nb):
        dth = edges[b + 1] - edges[b]
        n_nodes = int(min(8192, max(48, nodes_per_osc * lmax * dth
                                    / np.pi)))
        t, wq = np.polynomial.legendre.leggauss(n_nodes)
        th = edges[b] + 0.5 * dth * (t + 1.0)
        # ∫ dμ = ∫ sinθ dθ; normalize by Δμ_b.
        dmu = np.cos(edges[b]) - np.cos(edges[b + 1])
        nodes.append(np.cos(th))
        wts.append(0.5 * dth * wq * np.sin(th) / dmu)
        bins.append(np.full(n_nodes, b))
    mu = np.concatenate(nodes)
    w_all = np.concatenate(wts)
    bin_id = np.concatenate(bins)
    # Recursion keeping two rows; at each ℓ one (nodes,) @ (nodes, nb)
    # contraction accumulates every bin's weighted sum.
    sel = np.zeros((mu.size, nb))
    sel[np.arange(mu.size), bin_id] = 1.0
    selw = sel * w_all[:, None]                   # (nodes, nb)
    out = np.zeros((nb, lmax + 1))
    lmin = max(abs(m), abs(n))
    if lmax < lmin:
        return out
    if (m, n) == (2, 2):
        cur = (1.0 + mu) ** 2 / 4.0
    elif (m, n) == (2, -2):
        cur = (1.0 - mu) ** 2 / 4.0
    elif (m, n) == (2, 0):
        cur = np.sqrt(6.0) / 4.0 * (1.0 - mu**2)
    elif (m, n) == (0, 0):
        cur = np.ones_like(mu)
        out[:, 0] = selw.sum(axis=0)
        if lmax >= 1:
            cur, prev = mu.copy(), cur
            out[:, 1] = mu @ selw
            for ell_i in range(1, lmax):
                nxt = ((2 * ell_i + 1) * mu * cur - ell_i * prev) \
                    / (ell_i + 1)
                prev, cur = cur, nxt
                out[:, ell_i + 1] = cur @ selw
        return out
    else:  # pragma: no cover
        raise NotImplementedError((m, n))
    prev = np.zeros_like(mu)
    out[:, lmin] = cur @ selw
    for ell_i in range(lmin, lmax):
        ell = float(ell_i)
        a = ell * np.sqrt(((ell + 1.0) ** 2 - m * m)
                          * ((ell + 1.0) ** 2 - n * n))
        b_ = (2 * ell + 1.0) * (ell * (ell + 1.0) * mu - m * n)
        c = (ell + 1.0) * np.sqrt(max(ell * ell - m * m, 0.0)
                                  * max(ell * ell - n * n, 0.0))
        nxt = (b_ * cur - c * prev) / a
        prev, cur = cur, nxt
        out[:, ell_i + 1] = cur @ selw
    return out


def wigner_bin_factors(m: int, n: int, lmax: int, theta_edges_rad):
    """Public wrapper over the cached quadrature bin factors."""
    key = tuple(np.asarray(theta_edges_rad, dtype=float).tolist())
    return _wigner_bin_factors_cached(m, n, lmax, key)


def _spin2_kappa_prefactor(lmax: int):
    """√((ℓ+2)(ℓ-1)/(ℓ(ℓ+1))) for ℓ ≥ 2, zero below: converts the
    Limber C^{gκ}_ℓ the pipeline computes into the spin-2 C^{gE}_ℓ
    entering the exact d^ℓ_{20} tangential-shear sum
    (a^E_ℓm = √((ℓ+2)!/(ℓ-2)!)/(ℓ(ℓ+1)) a^κ_ℓm; → 1 at high ℓ,
    -0.2% at ℓ = 20)."""
    ell = np.arange(lmax + 1, dtype=float)
    out = np.zeros(lmax + 1)
    out[2:] = np.sqrt((ell[2:] + 2.0) * (ell[2:] - 1.0)
                      / (ell[2:] * (ell[2:] + 1.0)))
    return out


@lru_cache(maxsize=None)
def curved_lattice_operator(theta_key, grid, mu: float = 0.0,
                            ell_offset: float = 0.5,
                            lmax: int | None = None,
                            taper_frac: float = 0.15,
                            bin_average: bool = False,
                            kappa_prefactor: bool = True,
                            stat: str | None = None):
    """(j_lo, j_hi, A): the exact curved-sky multipole sum
    w(θ) = Σ_ℓ ((2ℓ+1)/4π) C_ℓ P_ℓ(cosθ) (``mu=0``) or
    γt(θ) = Σ_ℓ ((2ℓ+1)/4π) C^{gE}_ℓ d^ℓ_{20}(cosθ) (``mu=2``) as ONE
    static float64 matrix against the lattice convolution output — the
    curved analog of limber_fft.wtheta_lattice_operator, at identical
    runtime cost (conv + one matmul, zero gathers).

    The integer-ℓ C's come from Catmull-Rom interpolation of the
    log-lattice C(s) at s = ln(ℓ + ``ell_offset``) (the Limber ℓ+½
    argument), composed offline: A[j, :] = Σ_ℓ B[j, ℓ] S[ℓ, :] with the
    4-tap S rows scatter-accumulated (never densified — ℓ can reach
    1e5+ for sub-arcminute bins).

    ``theta_key``: θ points in degrees, or bin EDGES with
    ``bin_average=True`` (closed-form bin-averaged factors — the same
    ones the curved covariance uses, so prediction and covariance are
    binned identically).  ``lmax`` (default auto ~16/θ_min, capped at
    2^17) with a cosine taper over the top ``taper_frac`` of the range
    suppressing truncation ringing; ``kappa_prefactor`` applies the
    C^{gκ} → C^{gE} ℓ-factor for ``mu=2`` (exact; off reproduces the
    naive d^ℓ_{20} sum).

    ``stat``: "xip" / "xim" override ``mu`` with the shear-shear sums
    ξ_±(θ) = Σ_ℓ ((2ℓ+1)/4π) C^{EE}_ℓ d^ℓ_{2,±2}(cosθ), consuming the
    κκ lattice convolution with C^{EE} = f_ℓ² C^{κκ}
    (f = _spin2_kappa_prefactor, applied SQUARED — two spin-2 legs)."""
    from chomp_tpu_torch.limber_fft import _lattices

    theta_deg = np.asarray(theta_key, dtype=float)
    theta_rad = np.radians(theta_deg)
    if lmax is None:
        # 64/θ_min: γt is an enclosed-mass statistic (sensitive to all
        # ℓ ≳ 1/θ), and the tapered tail converges only ~(ℓθ)^-1/2 —
        # 16/θ left a measured 1% γt shift on doubling at θ = 0.05°,
        # 64/θ is stable at the 1e-3 level (test_curved_predictions).
        lmax = int(min(1 << 18, max(2048, 64.0 / theta_rad.min())))
        if 64.0 / theta_rad.min() > (1 << 18):
            import warnings

            warnings.warn(
                f"curved_lattice_operator: theta_min = "
                f"{theta_deg.min():.2e} deg needs lmax ~ "
                f"{64.0 / theta_rad.min():.0f} for convergence but the "
                f"auto cap is {1 << 18} — the smallest bins will be "
                "truncation-limited.  Pass lmax explicitly, or use the "
                "flat route for sub-arcminute separations (curvature "
                "is negligible there anyway).", stacklevel=3)
    if stat is not None and stat not in ("xip", "xim"):
        raise ValueError("stat must be None, 'xip', or 'xim'")
    if stat is None and mu not in (0.0, 2.0, 0, 2):
        raise ValueError("curved_lattice_operator supports mu in {0, 2}")
    if stat is not None:
        mn = (2, 2) if stat == "xip" else (2, -2)
        if bin_average:
            b = wigner_bin_factors(mn[0], mn[1], lmax, theta_rad)
        else:
            b = _wigner_d_matrix(mn[0], mn[1], lmax,
                                 np.cos(theta_rad)).T
    elif bin_average:
        bf = (legendre_bin_factors if mu == 0
              else legendre_bin_factors_spin2)
        b = bf(lmax, theta_rad)                        # (nb, lmax+1)
    elif mu == 0:
        b = _legendre_all(lmax, np.cos(theta_rad)).T   # (nt, lmax+1)
    else:
        b = _wigner_d_matrix(2, 0, lmax, np.cos(theta_rad)).T
    ell = np.arange(lmax + 1, dtype=float)
    wl = (2.0 * ell + 1.0) / (4.0 * np.pi)
    if stat is not None and kappa_prefactor:
        wl = wl * _spin2_kappa_prefactor(lmax) ** 2
    elif mu == 2 and stat is None and kappa_prefactor:
        wl = wl * _spin2_kappa_prefactor(lmax)
    if taper_frac > 0.0:
        l_t = (1.0 - taper_frac) * lmax
        tap = np.where(ell <= l_t, 1.0, 0.5 * (1.0 + np.cos(
            np.pi * np.clip((ell - l_t) / (lmax - l_t), 0.0, 1.0))))
        wl = wl * tap
    b = b * wl[None, :]

    # Scatter-accumulate B @ S with the 4-tap Catmull-Rom rows of the
    # s = ln(ℓ + offset) interpolation (grids.catmull_rom_weights_np
    # stencil, never built dense: lmax ~ 1e5 × n_out ~ 1e3 won't fit).
    ln_k, ln_chi = _lattices(grid)
    dln = float(grid.lattice_dln)
    s0 = ln_k[0] + ln_chi[0]
    n_out = len(ln_k) + len(ln_chi) - 1
    t = (np.log(ell + ell_offset) - s0) / dln
    i = np.clip(np.floor(t).astype(int), 1, n_out - 3)
    f = t - i
    taps = (0.5 * (-f + 2 * f**2 - f**3),
            0.5 * (2 - 5 * f**2 + 3 * f**3),
            0.5 * (f + 4 * f**2 - 3 * f**3),
            0.5 * (-(f**2) + f**3))
    a = np.zeros((n_out, b.shape[0]))
    for off, wk in zip((-1, 0, 1, 2), taps):
        np.add.at(a, i + off, (b * wk[None, :]).T)
    a = a.T                                             # (nt, n_out)
    used = np.nonzero(np.any(a != 0.0, axis=0))[0]
    j_lo, j_hi = int(used[0]), int(used[-1]) + 1
    return j_lo, j_hi, np.ascontiguousarray(a[:, j_lo:j_hi])


def _operator_tensors(a_np, conv):
    """Kernel C's operands for the float64 operator ``a_np`` against
    ``conv``'s dtype: (a, None) in float64, its hi/lo split in float32."""
    from chomp_tpu_torch.ops.df32 import split_operator

    if conv.dtype == torch.float64:
        return torch.as_tensor(a_np, device=conv.device), None
    return tuple(torch.as_tensor(x, device=conv.device)
                 for x in split_operator(a_np))


def curved_wtheta_fft(cosmo, win_a, win_b, theta_deg, p_lattice, st,
                      mu: float = 0.0, ell_offset: float = 0.5,
                      growth_pivot=1.0, lmax: int | None = None,
                      taper_frac: float = 0.15, bin_average: bool = False,
                      kappa_prefactor: bool = True,
                      stat: str | None = None):
    """Curved-sky w (``mu=0``), gamma_t (``mu=2``) or xi_+- (``stat``)
    from the P lattice ``p_lattice`` (B|1, n_k) with separable growth:
    the direct lattice convolution, then kernel C on
    :func:`curved_lattice_operator`, (B, n_theta)."""
    from chomp_tpu_torch import limber_fft
    from chomp_tpu_torch.ops.df32 import df_contract

    theta_key = tuple(np.asarray(theta_deg, dtype=float).tolist())
    j_lo, j_hi, a_np = curved_lattice_operator(
        theta_key, st.grid, mu, ell_offset, lmax, taper_frac, bin_average,
        kappa_prefactor, stat)
    piv = torch.as_tensor(growth_pivot, dtype=st.dtype, device=st.device)
    g = limber_fft._lattice_g_rows(cosmo, [(win_a, win_b)], st, piv)
    p = p_lattice.expand(g.shape[0], -1)[:, None]
    conv = limber_fft._conv_direct_rows(p, g, j_lo, j_hi)[:, 0].contiguous()
    return df_contract(conv, *_operator_tensors(a_np, conv))


def curved_wtheta_from_anchors(cosmo, anchors, win_a, win_b, theta_deg,
                               kind: str, st, mu: float = 0.0,
                               ell_offset: float = 0.5,
                               lmax: int | None = None,
                               taper_frac: float = 0.15,
                               bin_average: bool = False,
                               kappa_prefactor: bool = True,
                               stat: str | None = None):
    """Exact-z curved-sky w / gamma_t / xi_+- from prebuilt Chebyshev
    anchor spectra (``limber_fft.exact_z_anchor_spectra``): the anchored
    convolution, then kernel C on :func:`curved_lattice_operator`."""
    from chomp_tpu_torch import limber_fft
    from chomp_tpu_torch.ops.df32 import df_contract

    theta_key = tuple(np.asarray(theta_deg, dtype=float).tolist())
    j_lo, j_hi, a_np = curved_lattice_operator(
        theta_key, st.grid, mu, ell_offset, lmax, taper_frac, bin_average,
        kappa_prefactor, stat)
    conv = limber_fft.exact_z_conv_rows(cosmo, anchors, [(win_a, win_b, kind)],
                                        st, j_lo, j_hi)[:, 0].contiguous()
    return df_contract(conv, *_operator_tensors(a_np, conv))
