"""Curved-sky w(theta), gamma_t and xi_+- predictions and their masked-sphere
covariances.

PyTorch counterpart of the JAX package's ``curved.py``.  Predictions:

    w(theta)   = sum_l (2l+1)/(4 pi) C_l        P_l(cos theta),
    gamma_t    = sum_l (2l+1)/(4 pi) C^gE_l     d^l_20(cos theta),
    xi_+-      = sum_l (2l+1)/(4 pi) C^EE_l     d^l_2,+-2(cos theta),

with C^gE = f_l C^gk and C^EE = f_l^2 C^kk, f_l =
sqrt((l+2)(l-1)/(l(l+1))).  The integer-l C's come from Catmull-Rom
interpolation of the lattice convolution C(s) at s = ln(l + 1/2), so
each sum is one static float64 matrix against the convolution output
(:func:`curved_lattice_operator`, built offline in numpy: the Wigner-d
recursions run in Python to lmax ~ 64/theta_min, capped at 2^18), applied
at run time by kernel C exactly as the flat operators are.

Covariances (the JAX module docstring has the derivation): the masks
(:class:`SphericalCapMask`, :class:`UniformSphereMask`,
:class:`ProfileCurvedMask`, :class:`PixelSphereMask` with its HEALPix
ingestion), the spherical pair counts, the Ξ coupling matrices (one
Gauss-Legendre quadrature in theta over products of Wigner-d rows,
cached per mask) and the bin factors are static numpy, copied from the
JAX module and built once per mask; the cosmology batch's C_ell (kernel
A on the k lattice) contract against them in float64 matmuls on the
card: :func:`curved_gaussian_block`, :func:`curved_nongaussian_covariance`
(the flat engine's T_proj on a ln-l table, Catmull-Rom onto the integer
multipoles) and the joint, 3x2pt and tomographic builders;
:func:`curved_bmode_null` is the B-mode null test.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch.covariance import (_apply_psd_guard, _cl_zero, _const,
                                        _edges_key, _lattice_cl_callables,
                                        _mask_key, _Memo, _own_memo, _plus,
                                        _prime_block_anchors,
                                        _projected_trispectrum,
                                        _share_anchor_samples,
                                        _stack_blocks,
                                        _tomographic_lattice_cl_callables,
                                        _tomographic_ng_block_fn,
                                        _tomographic_noise_lists,
                                        _tomographic_pair_fn,
                                        resolve_statics, tomographic_probes)
from chomp_tpu_torch.grids import catmull_rom_weights_np, gauss_legendre

__all__ = [
    "SphericalCapMask", "ProfileCurvedMask", "PixelSphereMask",
    "UniformSphereMask", "legendre_bin_factors", "legendre_bin_factors_spin2",
    "wigner_bin_factors", "curved_pair_normalization",
    "curved_gaussian_block", "curved_gaussian_covariance",
    "curved_joint_wtheta_gammat_covariance", "curved_joint_3x2pt_covariance",
    "curved_tomographic_3x2pt_covariance", "curved_nongaussian_covariance",
    "curved_bmode_null", "curved_lattice_operator", "curved_wtheta_fft",
    "curved_wtheta_from_anchors",
]


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
        t, wq = gauss_legendre(n_nodes)
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


# ---------------------------------------------------------------------------
# Curved masks
# ---------------------------------------------------------------------------

def _cap_overlap(alpha: float, theta):
    """Solid angle of the overlap of two spherical caps of radius
    ``alpha`` whose centers are separated by ``theta`` (vectorized):
    Ω(θ) = 2 ∫₀^α φ_half(u) sin u du with φ_half the azimuthal
    half-width of cap 2 at colatitude u from cap 1's center.  Exact to
    quadrature; Ω(0) = 2π(1-cos α), Ω(θ ≥ 2α) = 0."""
    theta = np.atleast_1d(np.asarray(theta, dtype=float))
    n_u = 512
    # Gauss-Legendre in u over [0, alpha]
    x, wq = gauss_legendre(n_u)
    u = 0.5 * alpha * (x + 1.0)
    wu = 0.5 * alpha * wq
    cu, su = np.cos(u), np.sin(u)
    ct, st = np.cos(theta), np.sin(theta)
    with np.errstate(divide="ignore", invalid="ignore"):
        carg = (np.cos(alpha) - cu[None, :] * ct[:, None]) \
            / np.maximum(su[None, :] * st[:, None], 1e-300)
    phi_half = np.arccos(np.clip(carg, -1.0, 1.0))
    # θ = 0 column: φ_half = π wherever u ≤ α (carg -> -inf clipped).
    omega = 2.0 * np.sum(phi_half * (su * wu)[None, :], axis=1)
    return np.where(theta >= 2.0 * alpha, 0.0, omega)


@dataclasses.dataclass(frozen=True)
class SphericalCapMask:
    """Binary polar cap of angular radius ``radius_rad`` — the curved
    analog of mask.DiscMask (every ingredient from the exact spherical
    cap-overlap integral).  Small radius reproduces the flat disc
    treatment (tested)."""

    radius_rad: float

    @property
    def area2(self) -> float:
        """A₂ = ∫ W² dΩ (binary: the cap solid angle)."""
        return float(2.0 * np.pi * (1.0 - np.cos(self.radius_rad)))

    @property
    def area4(self) -> float:
        return self.area2

    def pair_function(self, theta):
        """R̄(θ) = ∫ W(x̂)W(ŷ) azimuth-avg at separation θ: the
        two-cap overlap solid angle."""
        return _cap_overlap(self.radius_rad, theta)

    pair_function2 = pair_function      # binary: W² = W

    def xi_w2(self, mu):
        """ξ_{W²}(μ) = R̄₂(θ)/(4π), θ = arccos μ — the correlation
        function of the W² map entering every coupling kernel."""
        theta = np.arccos(np.clip(np.asarray(mu, dtype=float), -1.0, 1.0))
        return _cap_overlap(self.radius_rad, theta) / (4.0 * np.pi)

    @property
    def coupling_ell(self) -> float:
        """Characteristic multipole width of the coupling kernel."""
        return np.pi / self.radius_rad


@dataclasses.dataclass(frozen=True)
class UniformSphereMask:
    """W ≡ 1 over the full sphere — the degenerate no-mask case;
    curved_gaussian_block then reduces to the exact full-sky
    Σ_ℓ (2ℓ+1) P̄_i P̄_j 2Ct²/(16π²) formula (tested)."""

    @property
    def area2(self) -> float:
        return float(4.0 * np.pi)

    @property
    def area4(self) -> float:
        return float(4.0 * np.pi)

    def pair_function(self, theta):
        return np.full_like(np.atleast_1d(np.asarray(theta, float)),
                            4.0 * np.pi)

    pair_function2 = pair_function

    def xi_w2(self, mu):
        return np.ones_like(np.atleast_1d(np.asarray(mu, float)))

    @property
    def coupling_ell(self) -> float:
        return 0.0


class ProfileCurvedMask:
    """Azimuthally symmetric curved mask from a radial weight profile
    W(θ) in [0, 1] given on ``theta_nodes_rad`` (linearly interpolated,
    0 beyond the last node) — tapered caps, ring footprints, etc.

    Ingredients via the Legendre route: g_L = ∫ V P_L dμ for
    V ∈ {W, W²} by Gauss-Legendre quadrature, then
    ξ_V(μ) = ¼ Σ_L (2L+1) g_L² P_L(μ) and R̄ = 4π ξ.  ``lmax_mask``
    bounds the mask band-limit (profiles with a hard edge converge in
    the L² sense; the Parseval row-sum identity is restored exactly by
    rescaling ξ_{W²}(1) to ⟨W⁴⟩ — same spirit as the flat PixelMask's
    count-corrected shells)."""

    def __init__(self, theta_nodes_rad, w_values, lmax_mask: int = 512):
        th = np.asarray(theta_nodes_rad, dtype=float)
        wv = np.asarray(w_values, dtype=float)
        if th.ndim != 1 or th.shape != wv.shape:
            raise ValueError("theta_nodes_rad / w_values shape mismatch")
        self._theta = th
        self._w = wv
        x, wq = gauss_legendre(max(4 * lmax_mask, 2048))
        theta_q = np.arccos(x)                  # μ-quadrature nodes
        wprof = np.interp(theta_q, th, wv, left=wv[0], right=0.0)
        p = _legendre_all(lmax_mask, x)
        self._g_w = p @ (wq * wprof)            # ∫ W P_L dμ
        self._g_w2 = p @ (wq * wprof**2)
        self._g_w4 = float(np.sum(wq * wprof**4))
        self.area2 = float(2.0 * np.pi * np.sum(wq * wprof**2))
        self.area4 = float(2.0 * np.pi * self._g_w4)
        self._lmax_mask = lmax_mask
        twol = 2.0 * np.arange(lmax_mask + 1) + 1.0
        self._xi_w_c = 0.25 * twol * self._g_w**2
        self._xi_w2_c = 0.25 * twol * self._g_w2**2
        # Parseval repair for the truncated series (hard-edge Gibbs):
        # ξ_{W²}(1) must equal <W⁴> = A₄/4π exactly for the delta-limit
        # row sum to hold.
        xi1 = float(np.sum(self._xi_w2_c))
        target = self.area4 / (4.0 * np.pi)
        self._xi_w2_scale = target / xi1 if xi1 > 0 else 1.0
        self._hash = hash((th.tobytes(), wv.tobytes(), lmax_mask))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, ProfileCurvedMask)
                and self._hash == other._hash)

    def _xi(self, mu, coeff):
        mu = np.clip(np.atleast_1d(np.asarray(mu, float)), -1.0, 1.0)
        p = _legendre_all(self._lmax_mask, mu)
        return coeff @ p

    def xi_w2(self, mu):
        return self._xi_w2_scale * self._xi(mu, self._xi_w2_c)

    def pair_function(self, theta):
        mu = np.cos(np.atleast_1d(np.asarray(theta, float)))
        return 4.0 * np.pi * self._xi(mu, self._xi_w_c)

    def pair_function2(self, theta):
        mu = np.cos(np.atleast_1d(np.asarray(theta, float)))
        return 4.0 * np.pi * self.xi_w2(mu)

    @property
    def coupling_ell(self) -> float:
        support = self._theta[self._w > 1e-12]
        width = float(support.max()) if support.size else np.pi
        return np.pi / max(width, 1e-6)


class PixelSphereMask:
    """General curved-sky footprint from a pixel weight map W in [0, 1]
    on an iso-latitude grid — the sphere analog of mask.PixelMask
    (arbitrary shapes, holes, weights; NO azimuthal symmetry required,
    unlike SphericalCapMask / ProfileCurvedMask).

    Grid convention: ``w_map[r, c]`` lives at colatitude
    θ_r = (r+½)π/n_ring, azimuth φ_c = 2πc/n_phi, pixel solid angle
    Ω_r = sinθ_r Δθ Δφ.  Every covariance ingredient reduces to the
    azimuthally averaged pair functions, computed as exact pair sums
    over the grid,

        P_V[bin] = Σ_{pq} V_p V_q Ω_p Ω_q [θ_pq ∈ bin],  V ∈ {W, W²},

    ring-pair by ring-pair with ONE circular FFT cross-correlation in
    relative azimuth per ring (iso-latitude ⇒ the separation depends
    on Δφ only; O(n_ring² n_phi) total, seconds at 256×512).  The
    continuum pair function is the RATIO estimator

        R̄_V(θ) = 4π · P_V[bin] / P_1[bin]

    with P_1 the same histogram for W ≡ 1 over the FULL sphere (closed
    form per (ring, ring′, Δφ): Ω_r Ω_r′ per azimuth offset — no FFT):
    pixelization discreteness cancels exactly, so uniform weights
    reproduce UniformSphereMask to machine precision — the curved
    analog of the flat PixelMask's count-corrected shells.  The θ = 0
    anchors are exact (R̄(0) = A₂, R̄₂(0) = A₄, so ξ_{W²}(1) = A₄/4π
    and the delta-limit Parseval row sum holds by construction).

    Resolution bounds the representable mask band-limit at
    ~min(n_ring, n_phi/2); sub-pixel features are smoothed.  Hashes by
    map content so the Ξ-matrix cache works."""

    def __init__(self, w_map, n_sep_bins: int | None = None):
        w = np.asarray(w_map, dtype=float)
        if w.ndim != 2:
            raise ValueError(
                "PixelSphereMask needs a 2-D (n_ring, n_phi) weight map")
        n_ring, n_phi = w.shape
        if n_sep_bins is None:
            # Separation bins ~2 pixel spacings: finer bins sample the
            # sphere non-uniformly within a bin (same-ring neighbors
            # dominate sub-pixel separations near the poles) and bias
            # the ratio estimator catastrophically — measured ≲3%
            # against the analytic cap at n_ring/2, ±30% at 2·n_ring.
            n_sep_bins = max(64, n_ring // 2)
        dth = np.pi / n_ring
        dph = 2.0 * np.pi / n_phi
        theta_r = (np.arange(n_ring) + 0.5) * dth
        omega_r = np.sin(theta_r) * dth * dph
        self.n_ring, self.n_phi = n_ring, n_phi
        self.area2 = float(np.sum(w**2 * omega_r[:, None]))
        self.area4 = float(np.sum(w**4 * omega_r[:, None]))
        if self.area2 <= 0.0:
            raise ValueError("PixelSphereMask: empty weight map")
        ct, st = np.cos(theta_r), np.sin(theta_r)
        cdphi = np.cos(np.arange(n_phi) * dph)
        f_w = np.fft.fft(w * omega_r[:, None], axis=1)
        f_w2 = np.fft.fft(w**2 * omega_r[:, None], axis=1)
        h_w = np.zeros(n_sep_bins)
        h_w2 = np.zeros(n_sep_bins)
        h_1 = np.zeros(n_sep_bins)
        scale = n_sep_bins / np.pi
        for r in range(n_ring):
            mu_sep = np.clip(ct[r] * ct[:, None]
                             + st[r] * st[:, None] * cdphi[None, :],
                             -1.0, 1.0)
            idx = np.minimum((np.arccos(mu_sep) * scale).astype(int),
                             n_sep_bins - 1).ravel()
            # Circular correlation over relative azimuth (k ↔ n-k both
            # carry the same cos Δφ, so the binning is convention-free).
            c_w = np.real(np.fft.ifft(f_w[r][None, :] * np.conj(f_w),
                                      axis=1)).ravel()
            c_w2 = np.real(np.fft.ifft(f_w2[r][None, :] * np.conj(f_w2),
                                       axis=1)).ravel()
            # n_phi ordered pixel pairs share each azimuth offset k.
            c_1 = np.broadcast_to(
                (n_phi * omega_r[r] * omega_r)[:, None],
                (n_ring, n_phi)).ravel()
            h_w += np.bincount(idx, weights=c_w, minlength=n_sep_bins)
            h_w2 += np.bincount(idx, weights=c_w2, minlength=n_sep_bins)
            h_1 += np.bincount(idx, weights=c_1, minlength=n_sep_bins)
        centers = (np.arange(n_sep_bins) + 0.5) * np.pi / n_sep_bins
        with np.errstate(invalid="ignore", divide="ignore"):
            r_w = np.where(h_1 > 0, 4.0 * np.pi * h_w / h_1, 0.0)
            r_w2 = np.where(h_1 > 0, 4.0 * np.pi * h_w2 / h_1, 0.0)
        # Exact θ = 0 anchors (continuum limits; the first-bin ratios
        # land within O(pixel) of these already).
        self._nodes = np.concatenate(([0.0], centers, [np.pi]))
        self._r_w = np.concatenate(([self.area2], r_w, [r_w[-1]]))
        self._r_w2 = np.concatenate(([self.area4], r_w2, [r_w2[-1]]))
        self._hash = hash((w.tobytes(), n_sep_bins))

    @classmethod
    def from_healpix(cls, hp_map, n_ring: int | None = None,
                     n_sep_bins: int | None = None,
                     order: str = "RING"):
        """Build from a HEALPix weight map (the standard survey-mask
        format; chomp_tpu_torch.healpix — no healpy needed).  ``order``:
        "RING" (default) or "NESTED" (reordered on ingestion).
        The map is resampled onto the iso-latitude grid by pixel-center
        lookup at ``n_ring`` rings (default ~4·nside capped at 512 —
        at the cap, masks finer than ~0.35° pixels are smoothed)."""
        from chomp_tpu_torch.healpix import ang2pix_ring
        from chomp_tpu_torch.healpix import npix as hp_npix

        m = np.asarray(hp_map, dtype=float)
        nside = int(round(np.sqrt(m.size / 12.0)))
        if m.ndim != 1 or hp_npix(nside) != m.size:
            raise ValueError(
                f"from_healpix: size {m.size} is not 12*nside^2")
        if order.upper() in ("NESTED", "NEST"):
            from chomp_tpu_torch.healpix import reorder_nest_to_ring

            m = reorder_nest_to_ring(m)
        elif order.upper() != "RING":
            raise ValueError(f"order must be RING or NESTED, got "
                             f"{order!r}")
        if n_ring is None:
            n_ring = int(min(512, max(64, 4 * nside)))
        n_phi = 2 * n_ring
        th = (np.arange(n_ring) + 0.5) * np.pi / n_ring
        ph = np.arange(n_phi) * 2.0 * np.pi / n_phi
        pix = ang2pix_ring(nside, th[:, None], ph[None, :])
        return cls(m[pix], n_sep_bins)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, PixelSphereMask)
                and self._hash == other._hash)

    def pair_function(self, theta):
        return np.interp(np.atleast_1d(np.asarray(theta, float)),
                         self._nodes, self._r_w)

    def pair_function2(self, theta):
        return np.interp(np.atleast_1d(np.asarray(theta, float)),
                         self._nodes, self._r_w2)

    def xi_w2(self, mu):
        theta = np.arccos(np.clip(
            np.atleast_1d(np.asarray(mu, float)), -1.0, 1.0))
        return self.pair_function2(theta) / (4.0 * np.pi)

    @property
    def coupling_ell(self) -> float:
        """π over the cap-equivalent radius (exact cap inversion of
        A₂, valid up to fsky → 1 where it tends to π/π = 1)."""
        radius = np.arccos(np.clip(
            1.0 - self.area2 / (2.0 * np.pi), -1.0, 1.0))
        return float(np.pi / max(radius, 1e-6))


def curved_pair_normalization(mask, theta_edges_rad, n_theta: int = 512,
                              squared: bool = False):
    """D_i = 2π ∫_bin R̄(θ) sinθ dθ per bin (static numpy) — the
    spherical pair counts normalizing the estimator.  ``squared=True``
    uses the W² pair function (exact noise closure)."""
    pf = mask.pair_function2 if squared else mask.pair_function
    edges = np.asarray(theta_edges_rad, dtype=float)
    d = np.empty(len(edges) - 1)
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        th = np.linspace(lo, hi, n_theta)
        d[i] = 2.0 * np.pi * np.trapezoid(np.sin(th) * pf(th), th)
    return d


# ---------------------------------------------------------------------------
# Coupling matrices (static, cached per mask geometry)
# ---------------------------------------------------------------------------

def _xi_matrices_impl(mask, ell_split: int, kinds: tuple,
                      weight: str = "W2"):
    """The requested Ξ matrices on ℓ, ℓ' ≤ ell_split (module
    docstring), via one Gauss-Legendre quadrature shared by all
    kernels.  The quadrature runs in θ (μ = cosθ, dμ = sinθ dθ):
    cap-overlap correlation functions are LINEAR in θ near zero
    separation, i.e. √(1-μ)-singular in μ, which stalls a μ-space
    rule at the ~0.5% level (measured via the Parseval row sum);
    in θ the integrand is piecewise smooth.  Node count: ≥4 per
    half-oscillation of P_ℓ P_ℓ' at ℓ = ell_split.

    ``weight``: "W2" (default) integrates against ξ_{W²} — the
    COVARIANCE kernels; "W" integrates against ξ_W =
    pair_function/4π — the coupling of pseudo-spectrum MEANS (the
    E→B leakage bias of the B-mode null test).  Binary masks:
    identical."""
    n = 4 * ell_split + 1024
    t, wq = gauss_legendre(n)
    theta = 0.5 * np.pi * (t + 1.0)
    x = np.cos(theta)
    if weight == "W2":
        xi = np.asarray(mask.xi_w2(x), dtype=float)
    elif weight == "W":
        xi = np.asarray(mask.pair_function(theta),
                        dtype=float) / (4.0 * np.pi)
    else:
        raise ValueError(f"weight must be 'W2' or 'W', got {weight!r}")
    wxi = 0.5 * np.pi * wq * np.sin(theta) * xi
    out = {}
    if "0" in kinds:
        p = _legendre_all(ell_split, x)
        out["0"] = 0.5 * ((p * wxi[None, :]) @ p.T)
    if "2" in kinds:
        d20 = _wigner_d_matrix(2, 0, ell_split, x)
        out["2"] = 0.5 * ((d20 * wxi[None, :]) @ d20.T)
    if "P" in kinds or "Q" in kinds:
        d22 = _wigner_d_matrix(2, 2, ell_split, x)
        q = 0.5 * ((d22 * wxi[None, :]) @ d22.T)
        if "Q" in kinds:
            # Unprojected Σ (2L+1) C^{W²}_L (3j(2,-2,0))² / 4π =
            # Ξ⁺ + Ξ⁻.  For the γt estimator this double-counts the
            # parity-odd channel (measured 1.7x above the flat-limit
            # ½(K₀+K₄) kernel on a small cap) — but it IS the ξ_± AUTO
            # kernel: the exact identities ξ̂_± = Σ t^{2,±2} (P̃EE ±
            # P̃BB) give Cov(±,±) = 2(Et Et' + Bt Bt')(Ξ⁺ + Ξ⁻) under
            # channel-diagonal NKA (Cov(P̃EE, P̃EE) = 2[EtEt'Ξ⁺ +
            # BtBt'Ξ⁻], Cov(P̃BB, P̃BB) the mirror, Cov(P̃EE, P̃BB) ≈ 0
            # — the even·odd projector product vanishes on the NKA
            # diagonal).  Sphere-MC-validated via the ξ± referee.
            out["Q"] = q
        if "P" in kinds:
            # Even-parity (pseudo-E) projection: the gamma_t auto
            # kernel.  Measured flat limit on a small cap:
            # 0.998 ± 0.009 of the flat module's MC-validated
            # ½(K₀+K₄) = <|W̃₂|² cos²2φ> kernel.  Directly validated
            # on the SPHERE by the spin-2 SHT Monte Carlo
            # (tests/test_curved.py::test_curved_spin2_mc_referee):
            # gt-auto diagonal within +2..24% of MC (conservative) on
            # a 25° cap AND a non-azimuthal two-cap footprint, even at
            # footprint-scale bins — far tighter than the flat
            # module's ~1.6x there (sphere kernels carry the exact
            # curved bin geometry the flat wedge coupling misses).
            d2m2 = _wigner_d_matrix(2, -2, ell_split, x)
            out["P"] = 0.5 * (q + 0.5 * ((d2m2 * wxi[None, :])
                                         @ d2m2.T))
    if "M" in kinds:
        # Ξ⁺ - Ξ⁻ = ½ ∫ d^ℓ_{2,-2} d^ℓ'_{2,-2} ξ_{W²} dμ — the
        # ξ_+ x ξ_- cross kernel: Cov(+,-) = 2(Et Et' - Bt Bt')
        # (Ξ⁺ - Ξ⁻), whose pure-noise part cancels EXACTLY in the
        # EE - BB channel assembly (the classic tangential/cross
        # shot-noise decorrelation; the flat module needs a
        # Weber-Schafheitlin constant for the same physics).
        d2m2 = _wigner_d_matrix(2, -2, ell_split, x)
        out["M"] = 0.5 * ((d2m2 * wxi[None, :]) @ d2m2.T)
    return out


@lru_cache(maxsize=8)
def _xi_matrices_cached(mask, ell_split: int, kinds: tuple,
                        weight: str = "W2"):
    return _xi_matrices_impl(mask, ell_split, kinds, weight)


def _xi_matrices(mask, ell_split: int, kinds: tuple,
                 weight: str = "W2"):
    try:
        return _xi_matrices_cached(mask, ell_split, kinds, weight)
    except TypeError:        # unhashable user mask: compute directly
        return _xi_matrices_impl(mask, ell_split, kinds, weight)


# ---------------------------------------------------------------------------
# Covariance blocks
# ---------------------------------------------------------------------------

def _auto_ell_split(mask, ell_max: int) -> int:
    """Dense-coupling extent: the delta limit errs by O(L_mask/ℓ), so
    carry the full matrices out to ~24 kernel widths (beyond which the
    correction is sub-0.5% of the local delta term), capped at
    ell_max."""
    width = mask.coupling_ell
    if width <= 0.0:
        return 0
    return int(min(ell_max, max(64, 24.0 * width)))


def _curved_bin_factors(mu, ell_max: int, edges_rad):
    """Bin factors for an estimator code: 0 (P_ℓ), 2 (d^ℓ_{20}),
    "xip" (d^ℓ_{22}), "xim" (d^ℓ_{2,-2})."""
    if mu == 0:
        return legendre_bin_factors(ell_max, edges_rad)
    if mu == 2:
        return legendre_bin_factors_spin2(ell_max, edges_rad)
    if mu == "xip":
        return wigner_bin_factors(2, 2, ell_max, edges_rad)
    if mu == "xim":
        return wigner_bin_factors(2, -2, ell_max, edges_rad)
    raise ValueError(f"unsupported estimator code mu={mu!r}")


# Ξ kernel per estimator-code pair (module docstring + _xi_matrices):
# the ξ± autos use the unprojected Q = Ξ⁺+Ξ⁻ (exact pseudo-E/B
# channel assembly — the caller sums EE and BB channel blocks); the
# (+,-) cross uses M = Ξ⁺-Ξ⁻; mixed scalar/spin-2 pairs use the
# single-leg 3j(000)·3j(2,-2,0) kernel "2"; (γt, ξ±) uses "2" as well
# (one mixed pairing — the flat-moment-rule analog K₂; documented NKA
# choice, the cross blocks are small).
_XI_KIND = {
    (0, 0): "0", (0, 2): "2", (2, 2): "P",
    (0, "xip"): "2", (0, "xim"): "2",
    (2, "xip"): "2", (2, "xim"): "2",
    ("xip", "xip"): "Q", ("xim", "xim"): "Q", ("xip", "xim"): "M",
}


def _xi_kind(mu_i, mu_j):
    k = _XI_KIND.get((mu_i, mu_j))
    if k is None:
        k = _XI_KIND.get((mu_j, mu_i))
    if k is None:
        raise ValueError(f"unsupported estimator pair ({mu_i}, {mu_j})")
    return k


# ---------------------------------------------------------------------------
# Covariance blocks (the cosmology batch on the card; geometry static numpy)
# ---------------------------------------------------------------------------

def _geom(memo, key, make, t):
    """A static numpy array of the curved geometry as a tensor of ``t``,
    made and copied to the device once per builder call."""
    return _const(memo, ("curved",) + key, make, t)


def _norm(memo, mask, edges_rad, squared: bool = False):
    """:func:`curved_pair_normalization` (numpy), once per call."""
    return memo.get(("curved_norm", _mask_key(mask), _edges_key(edges_rad),
                     squared),
                    lambda: curved_pair_normalization(mask, edges_rad,
                                                      squared=squared))


def _noise_closure(memo, mask, edges_i, edges_j):
    """2 N² D₂_ovl / (D_i D_j) without the N²: the W² pair counts of every
    annulus overlap over the pair counts (numpy), once per call."""
    def make():
        lo_i, hi_i = edges_i[:-1], edges_i[1:]
        lo_j, hi_j = edges_j[:-1], edges_j[1:]
        d2_ovl = np.zeros((len(lo_i), len(lo_j)))
        for ii in range(len(lo_i)):
            for jj in range(len(lo_j)):
                lo = max(lo_i[ii], lo_j[jj])
                hi = min(hi_i[ii], hi_j[jj])
                if hi > lo:
                    d2_ovl[ii, jj] = curved_pair_normalization(
                        mask, np.array([lo, hi]), squared=True)[0]
        return d2_ovl / np.outer(_norm(memo, mask, edges_i),
                                 _norm(memo, mask, edges_j))

    return memo.get(("curved_closure", _mask_key(mask), _edges_key(edges_i),
                     _edges_key(edges_j)), make)


def _bins(memo, mu, ell_max, edges_rad, t):
    return _geom(memo, ("bins", mu, ell_max, _edges_key(edges_rad)),
                 lambda: _curved_bin_factors(mu, ell_max, edges_rad), t)


#: Every Ξ kind: a builder's blocks share one quadrature per mask.
_XI_KINDS = ("0", "2", "P", "Q", "M")


def _xi_tensor(memo, mask, ell_split, kind, t, weight="W2"):
    """The Ξ matrix of ``kind`` (numpy, every kind made at once and cached
    per mask by :func:`_xi_matrices`) on the device of ``t``, once per
    call."""
    return _geom(memo, ("xi", _mask_key(mask), ell_split, kind, weight),
                 lambda: _xi_matrices(mask, ell_split, _XI_KINDS,
                                      weight)[kind], t)


def _curved_gaussian_block(cl_ac, cl_bd, cl_ad, cl_bc, theta_edges_deg_i,
                           theta_edges_deg_j, mask, mu_i=0, mu_j=0,
                           noise_ac: float = 0.0, noise_bd: float = 0.0,
                           noise_ad: float = 0.0, noise_bc: float = 0.0,
                           ell_max: int = 4096,
                           ell_split: int | None = None,
                           nn_quadrature: bool = False, *, memo):
    """Curved-sky Gaussian block Cov[w^(ab)_i, w^(cd)_j] on a masked
    sphere, (B, nbi, nbj): the curved analog of
    :func:`covariance.gaussian_block` (the JAX docstring has the
    derivation).  ``cl_xy(ells_np)`` get the integer grid 0..ell_max and
    give (B|1, ell_max + 1); ``mu_i``, ``mu_j`` in {0, 2, "xip", "xim"}
    select the P_l / d^l_20 / d^l_22 / d^l_2-2 bin factors and the Ξ
    kernel; the delta limit runs to ell_max and the dense coupled
    correction to ``ell_split`` (default :func:`_auto_ell_split`).  The
    pure noise x noise term uses the pair-count-exact closure 2 N² D₂_ovl
    / (D_i D_j); ``nn_quadrature`` keeps it in the truncated sum (only for
    channel differences where it cancels).  The geometry (bin factors,
    pair counts, Ξ, the closure) is static numpy, made once per call."""
    noise_ac, noise_bd = float(noise_ac), float(noise_bd)
    noise_ad, noise_bc = float(noise_ad), float(noise_bc)
    edges_i = np.radians(np.asarray(theta_edges_deg_i, dtype=float))
    edges_j = np.radians(np.asarray(theta_edges_deg_j, dtype=float))
    ells_np = np.arange(0, ell_max + 1)
    kind = _xi_kind(mu_i, mu_j)
    ct_ac = _plus(cl_ac(ells_np), noise_ac)
    ct_bd = _plus(cl_bd(ells_np), noise_bd)
    ct_ad = _plus(cl_ad(ells_np), noise_ad)
    ct_bc = _plus(cl_bc(ells_np), noise_bc)
    t = dict(dtype=ct_ac.dtype, device=ct_ac.device)
    nn = noise_ac * noise_bd + noise_ad * noise_bc
    if nn_quadrature:
        nn = 0.0
    if nn != 0.0 and mu_i != mu_j:
        raise ValueError(
            "curved_gaussian_block: pure noise x noise with mu_i != "
            "mu_j is not closable analytically — split the noisy "
            "pairing out (same restriction as gaussian_block), or use "
            "nn_quadrature=True inside an exact channel-difference "
            "assembly.")
    b_i = _bins(memo, mu_i, ell_max, edges_i, t)
    b_j = _bins(memo, mu_j, ell_max, edges_j, t)
    dmu_i = np.cos(edges_i[:-1]) - np.cos(edges_i[1:])
    dmu_j = np.cos(edges_j[:-1]) - np.cos(edges_j[1:])
    d_i = _norm(memo, mask, edges_i)
    d_j = _norm(memo, mask, edges_j)

    gkey = (_mask_key(mask), _edges_key(edges_i), _edges_key(edges_j))
    pref = _geom(memo, ("pref",) + gkey, lambda: mask.area4 * np.outer(
        2.0 * np.pi * dmu_i, 2.0 * np.pi * dmu_j) / np.outer(d_i, d_j), t)
    twol_np = 2.0 * ells_np + 1.0
    twol = _geom(memo, ("twol", ell_max), lambda: twol_np / (4.0 * np.pi),
                 t)
    integrand = _plus(ct_ac * ct_bd + ct_ad * ct_bc, -nn)
    g = twol * integrand
    cov = pref * ((b_i * g[:, None, :]) @ b_j.T)

    if ell_split is None:
        ell_split = _auto_ell_split(mask, ell_max)
    ell_split = min(int(ell_split), ell_max)
    if ell_split >= 2:
        nl = ell_split + 1
        xi = _xi_tensor(memo, mask, ell_split, kind, t)
        skey = (ell_split,) + gkey + (mu_i, mu_j)
        m_i = _geom(memo, ("m_i", ell_max) + skey, lambda: (
            _curved_bin_factors(mu_i, ell_max, edges_i)[:, :nl]
            * dmu_i[:, None] * twol_np[:nl]), t)
        m_j = _geom(memo, ("m_j", ell_max) + skey, lambda: (
            _curved_bin_factors(mu_j, ell_max, edges_j)[:, :nl]
            * dmu_j[:, None] * twol_np[:nl]), t)
        inv_dd = _geom(memo, ("inv_dd",) + gkey,
                       lambda: (2.0 * np.pi) ** 2 / np.outer(d_i, d_j), t)

        def quad(vl, vr):
            return ((m_i * vl[:, None, :nl]) @ xi) @ (
                m_j * vr[:, None, :nl]).mT

        coupled = 0.5 * (quad(ct_ac, ct_bd) + quad(ct_bd, ct_ac)
                         + quad(ct_ad, ct_bc) + quad(ct_bc, ct_ad))
        if nn != 0.0:
            ones = torch.ones(1, nl, **t)
            coupled = coupled - nn * quad(ones, ones)
        coupled = coupled * inv_dd
        g_low = twol[:nl] * integrand[:, :nl]
        delta_low = pref * ((b_i[:, :nl] * g_low[:, None, :])
                            @ b_j[:, :nl].T)
        cov = cov + coupled - delta_low

    if nn != 0.0 and mu_i == mu_j:
        cov = cov + nn * _geom(
            memo, ("closure",) + gkey,
            lambda: _noise_closure(memo, mask, edges_i, edges_j), t)
    return cov


def _curved_gaussian_covariance(cl_fn, theta_edges_deg, n2d, mask,
                                ell_max: int = 4096,
                                ell_split: int | None = None, *, memo):
    """Gaussian + shot-noise covariance of w(theta) bins on a masked
    sphere, (B, nb, nb): ``cl_fn(ells_np) -> C_l``, shot noise 1/n2d."""
    noise = 1.0 / float(n2d)
    return _curved_gaussian_block(
        cl_fn, cl_fn, cl_fn, cl_fn, theta_edges_deg, theta_edges_deg, mask,
        0, 0, noise, noise, noise, noise, ell_max=ell_max,
        ell_split=ell_split, memo=memo)


def _table_matrix(memo, mu, ell_max, n_ell_tbl, edges_rad, t):
    """(b̄ (2l+1)/4pi) @ Catmull-Rom rows, (nb, n_ell_tbl): the static map
    from a uniform-ln-l table onto the binned integer-l sum (l >= 1)."""
    from chomp_tpu_torch.grids import catmull_rom_weights_np

    def make():
        ln_tbl = np.linspace(0.0, np.log(ell_max), n_ell_tbl)
        ells = np.arange(ell_max + 1)
        pos = np.log(np.maximum(ells, 1.0)) / (ln_tbl[1] - ln_tbl[0])
        w_int = catmull_rom_weights_np(n_ell_tbl, pos)
        meas = (2.0 * ells + 1.0) / (4.0 * np.pi)
        meas[0] = 0.0
        return (_curved_bin_factors(mu, ell_max, edges_rad)
                * meas[None, :]) @ w_int

    return _geom(memo, ("table_matrix", mu, ell_max, n_ell_tbl,
                        _edges_key(edges_rad)), make, t)


def _curved_nongaussian_covariance(cosmo, halo_p, model, dist,
                                   theta_edges_deg, mask, mu_i=0, mu_j=0,
                                   ell_max: int = 2048,
                                   n_ell_tbl: int = 96, windows=None,
                                   tracers=None, with_bao=None, grid=None,
                                   theta_edges_deg_j=None, *, st=None,
                                   memo, **tri_kwargs):
    """Connected (trispectrum) block with exact curved-sky bin factors,
    (B, nbi, nbj): T_proj on a uniform-ln-l table of ``n_ell_tbl`` nodes
    over [1, ell_max] (:func:`covariance.projected_trispectrum`, its knobs
    in ``tri_kwargs``), mapped onto the integer multipoles by a static
    Catmull-Rom matrix and summed against the Legendre / Wigner bin
    factors of the codes ``mu_i``, ``mu_j``, over Omega_eff = A2^2 / A4
    (``mask`` may be a float Omega in sr)."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    t = dict(dtype=st.dtype, device=st.device)
    omega_eff = (float(mask) if isinstance(mask, (int, float))
                 else mask.area2**2 / mask.area4)
    edges_i = np.radians(np.asarray(theta_edges_deg, dtype=float))
    edges_j = np.radians(np.asarray(
        theta_edges_deg if theta_edges_deg_j is None
        else theta_edges_deg_j, dtype=float))
    ln_tbl = np.linspace(0.0, np.log(ell_max), n_ell_tbl)
    t_proj = _projected_trispectrum(cosmo, halo_p, model, dist,
                                    np.exp(ln_tbl), windows=windows,
                                    tracers=tracers, st=st, memo=memo,
                                    **tri_kwargs)
    m_i = _table_matrix(memo, mu_i, ell_max, n_ell_tbl, edges_i, t)
    m_j = _table_matrix(memo, mu_j, ell_max, n_ell_tbl, edges_j, t)
    return (m_i @ t_proj @ m_j.T) / omega_eff


def _curved_adders(cosmo, halo_p, model, dist_lens, edges, mask, ell_max,
                   st, memo, include_nongaussian, include_ssc, ssc_kwargs,
                   ng_kwargs):
    """The connected and super-sample engines of the curved joint
    builders: (windows, tracers, mu_i, mu_j) -> (B, nb, nb)."""
    adders = []
    if include_nongaussian:
        adders.append(lambda ws, ts, mi, mj: _curved_nongaussian_covariance(
            cosmo, halo_p, model, dist_lens, edges, mask, windows=ws,
            tracers=ts, mu_i=mi, mu_j=mj, ell_max=ell_max, st=st, memo=memo,
            **ng_kwargs))
    if include_ssc:
        from chomp_tpu_torch.ssc import _curved_ssc_covariance

        skw = dict(ell_max=ell_max, **(ssc_kwargs or {}))
        adders.append(lambda ws, ts, mi, mj: _curved_ssc_covariance(
            cosmo, halo_p, model, dist_lens, edges, mask, windows=ws,
            tracers=ts, mu_i=mi, mu_j=mj, st=st, memo=memo, **skw))
    return adders


def curved_joint_wtheta_gammat_covariance(
        cosmo, halo_p, model, dist_lens, dist_src, theta_edges_deg,
        n2d_lens, shape_noise, mask, ell_max: int = 4096,
        ell_split: int | None = None, with_bao: bool | None = None,
        grid=None, include_nongaussian: bool = False,
        include_ssc: bool = False, ssc_kwargs: dict | None = None,
        psd_guard: str | None = None, *, st=None, **ng_kwargs):
    """Joint [w_gg, gamma_t] covariance on a masked sphere, (B, 2 nb,
    2 nb): the three C_ell from ONE halo evaluation on the k lattice
    (one kernel A launch) against the static curved geometry;
    ``include_nongaussian`` adds :func:`curved_nongaussian_covariance`
    (``ng_kwargs`` forwarded), ``include_ssc``
    :func:`ssc.curved_ssc_covariance` (``ssc_kwargs``), ``psd_guard="clip"``
    :func:`covariance.psd_clip`.  ``st`` as in the flat builders."""
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    cl_gg, cl_gk, cl_kk = _lattice_cl_callables(
        cosmo, halo_p, model, dist_lens, dist_src, st=st, memo=memo)
    edges = theta_edges_deg
    n_g = 1.0 / float(n2d_lens)
    kw = dict(ell_max=ell_max, ell_split=ell_split, memo=memo)
    blocks = {
        "ww": _curved_gaussian_block(cl_gg, cl_gg, cl_gg, cl_gg, edges,
                                     edges, mask, 0, 0, n_g, n_g, n_g, n_g,
                                     **kw),
        "wg": _curved_gaussian_block(cl_gg, cl_gk, cl_gk, cl_gg, edges,
                                     edges, mask, 0, 2, n_g, 0.0, 0.0, n_g,
                                     **kw),
        "gg": _curved_gaussian_block(cl_gg, cl_kk, cl_gk, cl_gk, edges,
                                     edges, mask, 2, 2, n_g,
                                     float(shape_noise), 0.0, 0.0, **kw)}
    win_g = WindowGalaxy(dist=dist_lens)
    win_k = WindowConvergence(dist=dist_src)
    combos = {"ww": ((win_g,) * 4, ("g",) * 4, 0, 0),
              "wg": ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"),
                     0, 2),
              "gg": ((win_g, win_k, win_g, win_k), ("g", "m", "g", "m"),
                     2, 2)}
    for add in _curved_adders(cosmo, halo_p, model, dist_lens, edges, mask,
                              ell_max, st, memo, include_nongaussian,
                              include_ssc, ssc_kwargs, ng_kwargs):
        for key, combo in combos.items():
            blocks[key] = blocks[key] + add(*combo)
    c = blocks
    return _apply_psd_guard(_stack_blocks(
        [[c["ww"], c["wg"]], [c["wg"].mT, c["gg"]]], cosmo.batch),
        psd_guard)


def curved_joint_3x2pt_covariance(
        cosmo, halo_p, model, dist_lens, dist_src, theta_edges_deg,
        n2d_lens, shape_noise, mask, ell_max: int = 4096,
        ell_split: int | None = None, with_bao: bool | None = None,
        grid=None, include_nongaussian: bool = False,
        include_ssc: bool = False, ssc_kwargs: dict | None = None,
        psd_guard: str | None = None, *, st=None, **ng_kwargs):
    """Joint [w_gg, gamma_t, xi_+, xi_-] covariance on a masked sphere,
    (B, 4 nb, 4 nb): E-only shear with white ``shape_noise`` per component
    in E and B, the xi_+- autos summing the pseudo-EE and pseudo-BB
    channel blocks (kernel Q), the (+, -) cross differencing them (kernel
    M, ``nn_quadrature``), the other knobs as in
    :func:`curved_joint_wtheta_gammat_covariance`.  ``psd_guard="clip"``
    clips the assembled matrix, as the documented contract says (the JAX
    function takes the argument and returns the raw matrix)."""
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    cl_gg, cl_gk, cl_kk = _lattice_cl_callables(
        cosmo, halo_p, model, dist_lens, dist_src, st=st, memo=memo)
    cl_zero = _cl_zero(st)
    edges = theta_edges_deg
    n_g = 1.0 / float(n2d_lens)
    ns = float(shape_noise)
    kw = dict(ell_max=ell_max, ell_split=ell_split, memo=memo)

    def blk(ac, bd, ad, bc, mi, mj, nac, nbd, nad, nbc, **extra):
        return _curved_gaussian_block(ac, bd, ad, bc, edges, edges, mask,
                                      mi, mj, nac, nbd, nad, nbc, **kw,
                                      **extra)

    def shear_auto(code):
        return (blk(cl_kk, cl_kk, cl_kk, cl_kk, code, code, ns, ns, ns, ns)
                + blk(cl_zero, cl_zero, cl_zero, cl_zero, code, code, ns,
                      ns, ns, ns))

    c = {"ww": blk(cl_gg, cl_gg, cl_gg, cl_gg, 0, 0, n_g, n_g, n_g, n_g),
         "wg": blk(cl_gg, cl_gk, cl_gk, cl_gg, 0, 2, n_g, 0.0, 0.0, n_g),
         "wp": blk(cl_gk, cl_gk, cl_gk, cl_gk, 0, "xip", 0.0, 0.0, 0.0,
                   0.0),
         "wm": blk(cl_gk, cl_gk, cl_gk, cl_gk, 0, "xim", 0.0, 0.0, 0.0,
                   0.0),
         "gg": blk(cl_gg, cl_kk, cl_gk, cl_gk, 2, 2, n_g, ns, 0.0, 0.0),
         "gp": blk(cl_gk, cl_kk, cl_gk, cl_kk, 2, "xip", 0.0, ns, 0.0, ns),
         "gm": blk(cl_gk, cl_kk, cl_gk, cl_kk, 2, "xim", 0.0, ns, 0.0, ns),
         "pp": shear_auto("xip"), "mm": shear_auto("xim"),
         "pm": (blk(cl_kk, cl_kk, cl_kk, cl_kk, "xip", "xim", ns, ns, ns,
                    ns, nn_quadrature=True)
                - blk(cl_zero, cl_zero, cl_zero, cl_zero, "xip", "xim", ns,
                      ns, ns, ns, nn_quadrature=True))}
    win_g = WindowGalaxy(dist=dist_lens)
    win_k = WindowConvergence(dist=dist_src)
    g4, k4, m4 = (win_g,) * 4, (win_k,) * 4, ("m",) * 4
    gk2 = (win_g, win_g, win_k, win_k)
    combos = {
        "ww": (g4, ("g",) * 4, 0, 0),
        "wg": ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"), 0, 2),
        "wp": (gk2, ("g", "g", "m", "m"), 0, "xip"),
        "wm": (gk2, ("g", "g", "m", "m"), 0, "xim"),
        "gg": ((win_g, win_k, win_g, win_k), ("g", "m", "g", "m"), 2, 2),
        "gp": ((win_g, win_k, win_k, win_k), ("g", "m", "m", "m"), 2,
               "xip"),
        "gm": ((win_g, win_k, win_k, win_k), ("g", "m", "m", "m"), 2,
               "xim"),
        "pp": (k4, m4, "xip", "xip"),
        "pm": (k4, m4, "xip", "xim"),
        "mm": (k4, m4, "xim", "xim")}
    for add in _curved_adders(cosmo, halo_p, model, dist_lens, edges, mask,
                              ell_max, st, memo, include_nongaussian,
                              include_ssc, ssc_kwargs, ng_kwargs):
        for key, combo in combos.items():
            c[key] = c[key] + add(*combo)
    rows = [[c["ww"], c["wg"], c["wp"], c["wm"]],
            [c["wg"].mT, c["gg"], c["gp"], c["gm"]],
            [c["wp"].mT, c["gp"].mT, c["pp"], c["pm"]],
            [c["wm"].mT, c["gm"].mT, c["pm"].mT, c["mm"]]]
    return _apply_psd_guard(_stack_blocks(rows, cosmo.batch), psd_guard)


def _curved_probe_code(mu, channels):
    """A :func:`covariance.tomographic_probes` entry's curved bin-factor
    code: mu 2 -> 2 (gamma_t), mu 4 -> "xim", mu 0 with B channels ->
    "xip", else 0 (w, and the kappa_CMB crosses)."""
    if mu == 2:
        return 2
    if mu == 4:
        return "xim"
    has_b = any(t[0] == "B" for (pr, _s) in channels for t in pr)
    return "xip" if has_b else 0


def curved_tomographic_3x2pt_covariance(
        cosmo, halo_p, model, lens_dists, src_dists, theta_edges_deg,
        n2d_lens_list, shape_noise_list, mask, ell_max: int = 4096,
        ell_split: int | None = None, with_bao: bool | None = None,
        grid=None, include_nongaussian=False, nuisance=None,
        include_magnification: bool = False, include_ssc=False,
        ssc_kwargs: dict | None = None, cmb_lensing=None,
        matter_power: str = "halo", psd_guard: str | None = None, *,
        st=None, **ng_kwargs):
    """Covariance of the tomographic 3x2pt data vector on a masked
    sphere, (B, n_probe nb, n_probe nb) in
    :func:`covariance.tomographic_probes` order: every Gaussian block by
    :func:`curved_gaussian_block` from ONE lattice halo evaluation, the
    E/B bookkeeping of the flat builder (the xi_+ x xi_- blocks with a
    shared noise constant use ``nn_quadrature`` so it cancels between
    channels), ``include_nongaussian`` / ``include_ssc`` (False, "autos",
    True) through :func:`curved_nongaussian_covariance` and
    :func:`ssc.curved_ssc_covariance` with the flat builder's leg, per-bin
    model and nuisance treatment; ``cmb_lensing`` appends the w_{g_i
    kappa_CMB} probes (code 0), the N_L white floor riding the noise
    closure."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    n_lens, n_src = len(lens_dists), len(src_dists)
    cmb = None
    if cmb_lensing is not None and cmb_lensing is not False:
        from chomp_tpu_torch.cmblens import as_cmb_spec

        cmb = as_cmb_spec(cmb_lensing)
    cls = _tomographic_lattice_cl_callables(
        cosmo, halo_p, model, lens_dists, src_dists, nuisance=nuisance,
        include_magnification=include_magnification, cmb=cmb,
        matter_power=matter_power, st=st, memo=memo)
    n2d, sn = _tomographic_noise_lists(n2d_lens_list, shape_noise_list,
                                       n_lens, n_src)
    edges = theta_edges_deg
    nb = len(np.asarray(edges)) - 1
    cl_zero = _cl_zero(st)
    pair = _tomographic_pair_fn(cls, n2d, sn, cl_zero,
                                nl_inf=(cmb.nl_inf if cmb else 0.0))
    probes = tomographic_probes(n_lens, n_src, cmb_lensing=cmb is not None)
    _share_anchor_samples(model, memo)
    ng = (_tomographic_ng_block_fn(
        cosmo, halo_p, model, lens_dists, src_dists, edges, None, st, None,
        dict(ell_max=ell_max, **ng_kwargs), memo, curved_mask=mask,
        nuisance=nuisance, cmb=cmb) if include_nongaussian else None)
    skw = dict(ssc_kwargs or {})
    if include_ssc and not skw.get("exact_z_anchors"):
        from chomp_tpu_torch.ssc import _prime_responses

        _prime_responses(cosmo, halo_p, model, st, memo,
                         **{k: v for k, v in skw.items()
                            if k in ("n_k_ssc", "local_counts")})
    sscf = (_tomographic_ng_block_fn(
        cosmo, halo_p, model, lens_dists, src_dists, edges, None, st, None,
        dict(ell_max=ell_max, **skw), memo, curved_mask=mask,
        nuisance=nuisance, engine="ssc", cmb=cmb) if include_ssc else None)
    _prime_block_anchors(cosmo, halo_p, model, sscf, probes, include_ssc,
                         skw, st, memo)
    codes = [_curved_probe_code(mu, ch) for (_n, mu, ch) in probes]
    n_probe = len(probes)
    blocks = [[None] * n_probe for _ in range(n_probe)]
    for pa in range(n_probe):
        ch_a = probes[pa][2]
        for pb in range(pa, n_probe):
            ch_b = probes[pb][2]
            acc = None
            for (a, b), s_a in ch_a:
                for (c, d), s_b in ch_b:
                    cl_ac, n_ac = pair(a, c)
                    cl_bd, n_bd = pair(b, d)
                    cl_ad, n_ad = pair(a, d)
                    cl_bc, n_bc = pair(b, c)
                    nn = n_ac * n_bd + n_ad * n_bc
                    if (cl_ac is cl_zero and cl_bd is cl_zero
                            and cl_ad is cl_zero and cl_bc is cl_zero
                            and nn == 0.0):
                        continue
                    extra = ({"nn_quadrature": True}
                             if (codes[pa] != codes[pb] and nn != 0.0)
                             else {})
                    blk = s_a * s_b * _curved_gaussian_block(
                        cl_ac, cl_bd, cl_ad, cl_bc, edges, edges, mask,
                        codes[pa], codes[pb], n_ac, n_bd, n_ad, n_bc,
                        ell_max=ell_max, ell_split=ell_split, memo=memo,
                        **extra)
                    acc = blk if acc is None else acc + blk
            if acc is None:
                acc = torch.zeros(1, nb, nb, dtype=st.dtype,
                                  device=st.device)
            if ng is not None and (include_nongaussian != "autos"
                                   or pb == pa):
                c_ng = ng(probes[pa], probes[pb])
                if c_ng is not None:
                    acc = acc + c_ng
            if sscf is not None and (include_ssc != "autos" or pb == pa):
                c_s = sscf(probes[pa], probes[pb])
                if c_s is not None:
                    acc = acc + c_s
            blocks[pa][pb] = acc
            if pb != pa:
                blocks[pb][pa] = acc.mT
    return _apply_psd_guard(_stack_blocks(blocks, cosmo.batch), psd_guard)


def curved_bmode_null(cl_ee, theta_edges_deg, mask,
                      shape_noise: float = 0.0, ell_max: int = 2048,
                      ell_split: int | None = None):
    """B-mode null test on a masked sphere: ``(mean_leakage (B, nb),
    noise_bias (nb,), cov (B, nb, nb))`` of the binned pseudo-B xi_+
    statistic for an E-only sky with white ``shape_noise`` per component
    (the JAX docstring has the derivation): the exact E -> B leakage mean
    through Ξ⁻ of the mask's own correlation (weight "W"), the closed-form
    noise floor, and the covariance of the leaked channel as a Gaussian
    field with the mask-deconvolved effective spectrum.  ``cl_ee(ells_np)``
    gives (B|1, ell_max + 1) at the integer grid; both l sums truncate at
    ``ell_split``."""
    ns = float(shape_noise)
    edges = np.radians(np.asarray(theta_edges_deg, dtype=float))
    ells_np = np.arange(0, ell_max + 1)
    twol = 2.0 * ells_np + 1.0
    b22 = wigner_bin_factors(2, 2, ell_max, edges)
    dmu = np.cos(edges[:-1]) - np.cos(edges[1:])
    d_i = curved_pair_normalization(mask, edges)
    et = cl_ee(ells_np)
    t = dict(dtype=et.dtype, device=et.device)
    if ell_split is None:
        ell_split = _auto_ell_split(mask, ell_max)
    ell_split = min(int(ell_split), ell_max)
    nl = ell_split + 1
    t_rows = b22 * dmu[:, None]
    xis = _xi_matrices(mask, ell_split, ("Q", "M"), weight="W")
    xi_minus_w = 0.5 * (xis["Q"] - xis["M"])
    tw = torch.as_tensor(twol[:nl], **t)
    pbb = tw * (et[:, :nl] @ torch.as_tensor(
        xi_minus_w * twol[:nl][None, :], **t).T)
    mean_leak = pbb @ torch.as_tensor(
        (2.0 * np.pi / d_i)[:, None] * t_rows[:, :nl], **t).T
    area2 = mask.area2
    noise_bias = torch.as_tensor(
        ns * (2.0 * np.pi / d_i) * (t_rows * twol).sum(axis=1)
        * area2 / (4.0 * np.pi), **t)
    cb_eff = torch.zeros(pbb.shape[0], ell_max + 1, **t)
    cb_eff[:, :nl] = pbb / (tw * (area2 / (4.0 * np.pi)))

    def cl_beff(ells_static):
        assert len(np.asarray(ells_static)) == ell_max + 1
        return cb_eff

    cov = _curved_gaussian_block(
        cl_beff, cl_beff, cl_beff, cl_beff, theta_edges_deg,
        theta_edges_deg, mask, "xip", "xip", ns, ns, ns, ns,
        ell_max=ell_max, ell_split=ell_split, memo=_Memo())
    return mean_leak, noise_bias, cov


curved_gaussian_block = _own_memo(_curved_gaussian_block)
curved_gaussian_covariance = _own_memo(_curved_gaussian_covariance)


def curved_nongaussian_covariance(cosmo, halo_p, model, dist,
                                  theta_edges_deg, mask, mu_i=0, mu_j=0,
                                  ell_max: int = 2048, n_ell_tbl: int = 96,
                                  windows=None, tracers=None, with_bao=None,
                                  grid=None, theta_edges_deg_j=None, *,
                                  st=None, **tri_kwargs):
    return _curved_nongaussian_covariance(
        cosmo, halo_p, model, dist, theta_edges_deg, mask, mu_i, mu_j,
        ell_max, n_ell_tbl, windows, tracers, with_bao, grid,
        theta_edges_deg_j, st=st, memo=_Memo(), **tri_kwargs)


curved_nongaussian_covariance.__doc__ = _curved_nongaussian_covariance.__doc__
