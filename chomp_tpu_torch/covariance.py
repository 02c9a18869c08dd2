"""Covariance of w(theta) / gamma_t / xi_+- bins: Gaussian + shot noise +
connected trispectrum (+ the super-sample term of :mod:`ssc`).

PyTorch counterpart of the JAX package's ``covariance.py`` on the flat
sky with separable growth (its module docstring has the formulas).  Every
block carries the cosmology batch: a builder returns (B, N, N), float64
on the card as the JAX package runs it.

- The Gaussian blocks contract the closed-form bin-averaged Bessel
  factors Jbar^mu (mu = 0, 2, 4) with the C_ell of the lattice route at
  a static log-ell grid (``n_ell_cov_g``): one matmul per block, with the
  pure noise x noise terms added in closed form (annulus-overlap and
  Weber-Schafheitlin closures) and the masked-footprint treatment of
  :mod:`mask`.  The C_ell come from ONE halo evaluation on the k lattice
  (kernel A, one launch per galaxy node count).
- The connected blocks project the halo-model trispectrum T̄(k, k') of
  :mod:`trispectrum` over chi on a strided slice of the static ln-chi
  lattice: every query ln k = ln(l + 1/2) - u_m is static, so the
  sign-aware log-bilinear interpolation of T̄ is a static 2-tap weight
  tensor W[m, a, i] and the projection is three einsums (the table route,
  ``method="table"``, is kept as the referee).
- Exact redshift evolution: ``exact_z=True`` rebuilds the halo model and
  T̄ at every projection node (the table route's GL nodes, or the
  lattice nodes with ``method="lattice"``), the nodes folded into the
  batch as rows and taken in chunks of ``_NODE_ROWS`` rows;
  ``exact_z_anchors`` = J expands T̄/D^6 over J Chebyshev anchors in z
  (one halo build over B x J rows for every sample of the builder) and
  mixes them per lattice node.
- The kappa_CMB probes ride the tomographic builders: gK, kK and KK
  callables (KK with the reconstruction noise's decaying part), the
  white N_L floor in the noise closure, and a matter leg through the
  single-plane window in the connected and super-sample blocks.
- :func:`psd_clip` projects an assembled matrix onto the PSD cone with a
  detached correction (gradients flow through the raw matrix).

The builders take the JAX signatures' arguments; ``with_bao`` and
``grid`` (None: those of ``st``) come with a keyword-only ``st``, the
:class:`~chomp_tpu_torch.grids.Statics` the halo models were built on
(built from ``grid`` on the cosmology's device and dtype when None).
Each builder call keeps a :class:`_Memo` that its blocks share (the
C_ell, the lattice windows, the T̄ tables, the responses and sigma_b^2
that the JAX package leaves to XLA's common-subexpression elimination);
a public block function called on its own makes its own.  The curved
sky's blocks and builders are in :mod:`curved` (they share the engines
here).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import background, limber_fft, special, trispectrum
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.params import DEFAULT_GRID, GridSpec, col

#: Rows (cosmology x projection node) of one chunk of the per-node
#: exact-z rebuilds: each row carries its own halo model and T̄ table
#: (a few MB in float64 at n_k_tri 96).
_NODE_ROWS = 512


class _Memo:
    """One builder call's cache, keyed by hashable tuples (objects by
    their ``id``: they live for the call)."""

    def __init__(self):
        self._d = {}

    def get(self, key, make):
        if key not in self._d:
            self._d[key] = make()
        return self._d[key]

    def __contains__(self, key):
        return key in self._d


def _own_memo(impl):
    """The public form of ``impl``: its arguments without the keyword-only
    ``memo`` and those after it, and a new :class:`_Memo` for each call,
    so that nothing cached (some entries are keyed by object identity)
    outlives the call.  The builders call ``impl`` with their own memo."""
    sig = inspect.signature(impl)
    params = list(sig.parameters.values())
    cut = [p.name for p in params].index("memo")
    public_sig = sig.replace(parameters=params[:cut])

    def public(*args, **kwargs):
        public_sig.bind(*args, **kwargs)
        return impl(*args, memo=_Memo(), **kwargs)

    public.__name__ = public.__qualname__ = impl.__name__.lstrip("_")
    public.__doc__, public.__module__ = impl.__doc__, impl.__module__
    public.__signature__ = public_sig
    return public


def _const(memo: _Memo, key, make, t):
    """A static numpy array as a tensor of ``t`` (device, dtype), made and
    copied to the device once per memo: ``key`` names every input of
    ``make()``."""
    return memo.get(("const", key, str(t["device"]), t["dtype"]),
                    lambda: torch.as_tensor(make(), **t))


def _edges_key(edges):
    return tuple(np.asarray(edges, dtype=float).tolist())


def _mask_key(mask):
    """A memo key of a footprint: a bare solid angle by its value, a mask
    by its hash (the dataclasses by their fields, PixelMask by its map),
    an unhashable one by identity."""
    if isinstance(mask, (int, float)):
        return ("omega", float(mask))
    try:
        return ("mask", type(mask).__name__, hash(mask))
    except TypeError:
        return ("mask_id", id(mask))


def resolve_statics(cosmo, st=None, grid: GridSpec | None = None,
                    with_bao: bool | None = None) -> Statics:
    """``st`` checked against ``grid`` / ``with_bao``, or new statics of
    ``grid`` (DEFAULT_GRID) on the cosmology's device and dtype."""
    if st is None:
        ref = cosmo.omega_m0
        return Statics(grid if grid is not None else DEFAULT_GRID,
                       device=ref.device, dtype=ref.dtype,
                       with_bao=bool(with_bao))
    if grid is not None and grid != st.grid:
        raise ValueError("grid differs from st.grid: pass one of them")
    if with_bao is not None and bool(with_bao) != st.with_bao:
        raise ValueError("with_bao differs from st.with_bao: pass one of "
                         "them")
    return st


# ---------------------------------------------------------------------------
# Bin-averaged Bessel factors and the static ell grids.
# ---------------------------------------------------------------------------

def theta_bin_edges_deg(grid: GridSpec = DEFAULT_GRID, n_bins: int = 16):
    """Log-spaced bin edges over the grid's theta range (numpy)."""
    return np.logspace(np.log10(grid.theta_min_deg),
                       np.log10(grid.theta_max_deg), n_bins + 1)


def _ells_edges(ells, edges_rad):
    """(ells (n,), lo (nb, 1), hi (nb, 1)) as tensors; numpy ells become
    float64 CPU tensors."""
    if not torch.is_tensor(ells):
        ells = torch.as_tensor(np.asarray(ells, dtype=np.float64))
    e = torch.as_tensor(np.asarray(edges_rad, dtype=np.float64),
                        dtype=ells.dtype, device=ells.device)
    return ells, e[:-1, None], e[1:, None]


def bin_averaged_j0(ells, edges_rad):
    """Jbar_i(l) = 2 [x J1(x)] / (l^2 (th+^2 - th-^2)): (n_bins, n_ell)."""
    ells, lo, hi = _ells_edges(ells, edges_rad)
    x_hi, x_lo = hi * ells, lo * ells
    num = 2.0 * (x_hi * special.j1(x_hi) - x_lo * special.j1(x_lo))
    return num / (ells**2 * (hi * hi - lo * lo))


def bin_averaged_j2(ells, edges_rad):
    """Jbar^2_i(l) of gamma_t bins: the antiderivative -x J1 - 2 J0, and
    below x = 1 the exact series of ∫_0^x t J2 dt (the closed form
    cancels catastrophically there)."""
    ells, lo, hi = _ells_edges(ells, edges_rad)
    x_hi, x_lo = hi * ells, lo * ells

    def anti(x):
        return -x * special.j1(x) - 2.0 * special.j0(x)

    def anti_series(x):
        x2 = x * x
        return x2 * x2 * (1.0 / 32.0 + x2 * (
            -1.0 / 576.0 + x2 * (1.0 / 24576.0 + x2 * (
                -1.0 / 1843200.0 + x2 / 212336640.0))))

    num = 2.0 * torch.where(x_hi < 1.0,
                            anti_series(x_hi) - anti_series(x_lo),
                            anti(x_hi) - anti(x_lo))
    return num / (ells**2 * (hi * hi - lo * lo))


def bin_averaged_j4(ells, edges_rad):
    """Jbar^4_i(l) of xi_- bins: the antiderivative x J1 + 8 J0 - 24 J1/x,
    and below x = 2 the 6-term series of ∫_0^x t J4 dt."""
    ells, lo, hi = _ells_edges(ells, edges_rad)
    x_hi, x_lo = hi * ells, lo * ells

    def anti(x):
        x_safe = torch.clamp_min(x, 1e-30)
        return (x * special.j1(x) + 8.0 * special.j0(x)
                - 24.0 * special.j1(x_safe) / x_safe)

    def anti_series(x):
        x2 = x * x
        x6 = x2 * x2 * x2
        return x6 * (1.0 / 2304.0 + x2 * (
            -1.0 / 61440.0 + x2 * (1.0 / 3686400.0 + x2 * (
                -1.0 / 371589120.0 + x2 * (
                    1.0 / 55490592768.0 - x2 / 11415747624960.0)))))

    num = 2.0 * torch.where(x_hi < 2.0,
                            anti_series(x_hi) - anti_series(x_lo),
                            anti(x_hi) - anti(x_lo))
    return num / (ells**2 * (hi * hi - lo * lo))


def bin_averaged_bessel(ells, edges_rad, mu: int):
    """Jbar^mu: mu = 0 (w / xi_+), 2 (gamma_t), 4 (xi_-)."""
    if mu == 0:
        return bin_averaged_j0(ells, edges_rad)
    if mu == 2:
        return bin_averaged_j2(ells, edges_rad)
    if mu == 4:
        return bin_averaged_j4(ells, edges_rad)
    raise ValueError(f"unsupported Bessel order mu={mu}")


def _bessel(memo, ells_np, edges_rad, mu, t):
    """Memoized :func:`bin_averaged_bessel` on the device of ``t``."""
    key = ("bessel", len(ells_np), float(ells_np[0]), float(ells_np[-1]),
           tuple(np.asarray(edges_rad, dtype=float).tolist()), mu,
           str(t["device"]), t["dtype"])
    return memo.get(key, lambda: bin_averaged_bessel(
        torch.as_tensor(ells_np, **t), edges_rad, mu))


def xipm_mixed_noise_constant(edges_i_rad, edges_j_rad):
    """Exact ∫_0^∞ l dl Jbar^0_i(l) Jbar^4_j(l), (nbi, nbj) numpy: the
    xi_+ x xi_- pure-noise term (Weber-Schafheitlin smooth part plus the
    equal-order annulus-overlap closure of its delta)."""
    edges_i = np.asarray(edges_i_rad, dtype=float)
    edges_j = np.asarray(edges_j_rad, dtype=float)
    t_lo, t_hi = edges_i[:-1] ** 2, edges_i[1:] ** 2
    s_lo, s_hi = edges_j[:-1] ** 2, edges_j[1:] ** 2
    a_i = t_hi - t_lo
    a_j = s_hi - s_lo

    def p_anti(t, s):
        return 2.0 * t * np.log(s) + 3.0 * t * t / s

    out = np.zeros((len(a_i), len(a_j)))
    for ii in range(len(a_i)):
        tl, th = t_lo[ii], t_hi[ii]
        for jj in range(len(a_j)):
            sl, sh = s_lo[jj], s_hi[jj]
            acc = 0.0
            lo1, hi1 = max(sl, tl), min(sh, th)
            if hi1 > lo1:
                acc -= (hi1 - lo1) + (p_anti(tl, hi1) - p_anti(tl, lo1))
            lo2, hi2 = max(sl, th), sh
            if hi2 > lo2:
                acc += (p_anti(th, hi2) - p_anti(th, lo2)
                        - (p_anti(tl, hi2) - p_anti(tl, lo2)))
            out[ii, jj] = 2.0 * acc / (a_i[ii] * a_j[jj])
    out += 2.0 * ovl_closure(edges_i, edges_j) / np.outer(a_i, a_j)
    return out


def _log_ell_weights(n: int, lo: float, hi: float):
    """Trapezoid rule in ln l on a dense log grid (numpy; copies of a
    cached pair)."""
    ells, w = _log_ell_rule(n, lo, hi)
    return ells.copy(), w.copy()


@lru_cache(maxsize=64)
def _log_ell_rule(n: int, lo: float, hi: float):
    lnl = np.linspace(np.log(lo), np.log(hi), n)
    w = np.full(n, lnl[1] - lnl[0])
    w[0] *= 0.5
    w[-1] *= 0.5
    return np.exp(lnl), w


def ovl_closure(edges_i, edges_j):
    """(theta_ovl+^2 - theta_ovl-^2)_+ of every annulus pair (numpy)."""
    lo_i, hi_i = edges_i[:-1], edges_i[1:]
    lo_j, hi_j = edges_j[:-1], edges_j[1:]
    return np.maximum(
        np.minimum(hi_i[:, None], hi_j[None, :]) ** 2
        - np.maximum(lo_i[:, None], lo_j[None, :]) ** 2, 0.0)


# ---------------------------------------------------------------------------
# Gaussian blocks.
# ---------------------------------------------------------------------------

def gaussian_covariance(cl_fn, theta_edges_deg, n2d, omega_s_sr,
                        n_ell_cov: int = 4096, ell_lo: float = 1.0,
                        ell_hi: float = 1.0e6):
    """Gaussian + shot-noise covariance of w(theta) bins, (B, nb, nb);
    ``cl_fn(ells_np) -> C_l`` (B|1, n_ell) at the static numpy ells."""
    ells_np, w_np = _log_ell_weights(n_ell_cov, ell_lo, ell_hi)
    cl = cl_fn(ells_np)
    t = dict(dtype=cl.dtype, device=cl.device)
    ells = torch.as_tensor(ells_np, **t)
    w = torch.as_tensor(w_np, **t)
    edges_rad = np.radians(np.asarray(theta_edges_deg))
    b = bin_averaged_j0(ells, edges_rad)
    g = (2.0 / omega_s_sr) * ells**2 * w / (2.0 * math.pi) * (
        cl * cl + 2.0 * cl / n2d)
    cov = (b * g[:, None, :]) @ b.T
    lo, hi = edges_rad[:-1], edges_rad[1:]
    diag = (2.0 / omega_s_sr) / (np.pi * n2d**2 * (hi * hi - lo * lo))
    return cov + torch.diag(torch.as_tensor(diag, **t))


#: MC-calibrated residual factors f(x) = c0 - a x^2 of the spin-2 wedge
#: (the JAX package's values, fitted by its tools/calibrate_spin2_wedge.py).
_WEDGE_FIT = {"gt": (0.897, 0.180), "xip": (0.957, 0.093)}


def spin2_wedge_factors(mask, theta_edges_deg, probe: str):
    """Per-bin factors f_i = c0 - a x_i^2 (clipped to [0.5, 1]), x =
    theta_center / sqrt(A2/pi), for ``probe`` "gt" or "xip" (numpy)."""
    if probe not in _WEDGE_FIT:
        raise ValueError(f"spin2_wedge_factors: probe must be one of "
                         f"{sorted(_WEDGE_FIT)}, got {probe!r}")
    c0, a = _WEDGE_FIT[probe]
    edges = np.radians(np.asarray(theta_edges_deg, dtype=float))
    centers = 0.5 * (edges[:-1] + edges[1:])
    xs = centers / np.sqrt(mask.area2 / np.pi)
    return np.clip(c0 - a * xs**2, 0.5, 1.0)


def _weighted_bin_bessel(mask, edges_rad, mu, ells_np, n_gl: int = 64):
    """sqrt(R̄₂₂/A₄)-weighted bin-averaged Bessel factors, (nb, n_ell)
    numpy: the exact short-kernel replacement of Jbar on a masked survey
    (the beyond-NKA branch of :func:`gaussian_block`)."""
    from numpy.polynomial.legendre import leggauss
    from scipy.special import jv

    pf = getattr(mask, "pair_function2", mask.pair_function)
    edges = np.asarray(edges_rad, dtype=float)
    xg, wg = leggauss(n_gl)
    out = np.empty((len(edges) - 1, len(ells_np)))
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        th = 0.5 * (hi - lo) * xg + 0.5 * (hi + lo)
        wq = 0.5 * (hi - lo) * wg * th * np.sqrt(
            np.maximum(pf(th), 0.0) / mask.area4)
        out[i] = (2.0 / (hi * hi - lo * lo)) * (
            jv(mu, np.asarray(ells_np)[None, :] * th[:, None])
            * wq[:, None]).sum(axis=0)
    return out


def _gaussian_block(cl_ac, cl_bd, cl_ad, cl_bc, theta_edges_deg_i,
                    theta_edges_deg_j, omega_s_sr, mu_i: int = 0,
                    mu_j: int = 0, noise_ac: float = 0.0,
                    noise_bd: float = 0.0, noise_ad: float = 0.0,
                    noise_bc: float = 0.0, n_ell_cov: int = 4096,
                    ell_lo: float = 1.0, ell_hi: float = 1.0e6,
                    mask=None, beyond_nka: bool = False,
                    field_spins=None, wedge_probe: str | None = None, *,
                    memo: _Memo):
    """Generic Gaussian block Cov[w^(ab)_i, w^(cd)_j] = (1/Omega_s) ∫ l
    dl/2pi Jbar^{mu_i}_i Jbar^{mu_j}_j [Ct_ac Ct_bd + Ct_ad Ct_bc], (B,
    nbi, nbj), Ct = C + N.  ``cl_xy(ells_np)`` give (B|1, n_ell) C_ell;
    the noise levels are floats (or 0-d tensors, read once).

    The pure noise x noise constant is integrated in closed form: the
    annulus-overlap closure for mu_i == mu_j, the Weber-Schafheitlin
    constant for {0, 4}; other orders with a noise x noise term raise, as
    in the JAX package.  ``mask`` replaces 1/Omega_s by the pair-count
    normalization A4 A_i A_j / (D_i D_j) and adds the low-ell mode
    coupling; ``beyond_nka`` (needs ``mask``) the weighted delta factors,
    the field-phase damping of ``field_spins`` and the ``wedge_probe``
    residual factor (the JAX docstring has the derivations).  As in the
    JAX package, the wedge factor scales the whole quadrature part, its
    signal x noise terms included, which the noise-free Monte Carlo
    calibration of the factors did not measure: noise-dominated spin-2
    blocks may come out below the calibrated ~15%."""
    if beyond_nka and mask is None:
        raise ValueError("gaussian_block: beyond_nka=True needs a mask (the "
                         "refinements are survey-geometry corrections)")
    noise_ac, noise_bd = float(noise_ac), float(noise_bd)
    noise_ad, noise_bc = float(noise_ad), float(noise_bc)
    ells_np, w_np = _log_ell_weights(n_ell_cov, ell_lo, ell_hi)
    ct_ac = _plus(cl_ac(ells_np), noise_ac)
    ct_bd = _plus(cl_bd(ells_np), noise_bd)
    ct_ad = _plus(cl_ad(ells_np), noise_ad)
    ct_bc = _plus(cl_bc(ells_np), noise_bc)
    t = dict(dtype=ct_ac.dtype, device=ct_ac.device)
    ells, w, meas = memo.get(
        ("ell_rule", n_ell_cov, ell_lo, ell_hi, str(t["device"]),
         t["dtype"]), lambda: _ell_rule(ells_np, w_np, t))
    edges_i = np.radians(np.asarray(theta_edges_deg_i))
    edges_j = np.radians(np.asarray(theta_edges_deg_j))
    b_i = _bessel(memo, ells_np, edges_i, mu_i, t)
    b_j = _bessel(memo, ells_np, edges_j, mu_j, t)
    nn = noise_ac * noise_bd + noise_ad * noise_bc
    if nn != 0.0 and mu_i != mu_j and {mu_i, mu_j} != {0, 4}:
        raise ValueError(
            "gaussian_block: a pure noise x noise term is present "
            f"(nn={nn}) but mu_i={mu_i} != mu_j={mu_j}, where neither "
            "the equal-order Bessel closure nor the {0, 4} "
            "Weber-Schafheitlin constant applies — this block (e.g. "
            "w x gamma_t with the SAME sample as lens and source) is "
            "not supported; split the noisy pairing out explicitly.")
    integrand = _plus(ct_ac * ct_bd + ct_ad * ct_bc, -nn)
    if mask is None:
        pref = 1.0 / omega_s_sr
    else:
        from chomp_tpu_torch.mask import pair_normalization

        ann_i = np.pi * (edges_i[1:] ** 2 - edges_i[:-1] ** 2)
        ann_j = np.pi * (edges_j[1:] ** 2 - edges_j[:-1] ** 2)
        d_i = pair_normalization(mask, edges_i)
        d_j = pair_normalization(mask, edges_j)
        pref0_np = np.outer(ann_i, ann_j) / np.outer(d_i, d_j)
        pref = torch.as_tensor(mask.area4 * pref0_np, **t)
    g = meas * integrand
    if mask is not None and beyond_nka:
        bw_i = torch.as_tensor(_weighted_bin_bessel(mask, edges_i, mu_i,
                                                    ells_np), **t)
        bw_j = torch.as_tensor(_weighted_bin_bessel(mask, edges_j, mu_j,
                                                    ells_np), **t)
        cov = pref * ((bw_i * g[:, None, :]) @ bw_j.T)
    else:
        cov = pref * ((b_i * g[:, None, :]) @ b_j.T)
    if mask is not None and mask.coupling_width > 0.0:
        from chomp_tpu_torch.mask import _coupling_matrix

        dln = float(np.log(ells_np[1] / ells_np[0]))
        q_star = mask.coupling_width / (4.0 * dln)
        n_low = min(int(np.searchsorted(ells_np, q_star)), n_ell_cov)
        if n_low >= 2:
            n_phi = max(96, int(np.pi / (4.0 * dln)))
            lnq_key = tuple(np.log(ells_np[:n_low]))
            d_m, s_m = abs(mu_i - mu_j), mu_i + mu_j
            if d_m == s_m:
                k_np = _coupling_matrix(mask, lnq_key, n_phi, moment=d_m)
            else:
                k_np = 0.5 * (
                    _coupling_matrix(mask, lnq_key, n_phi, moment=d_m)
                    + _coupling_matrix(mask, lnq_key, n_phi, moment=s_m))
            k_t = torch.as_tensor(k_np, **t)
            wq = torch.as_tensor(ells_np**2 * w_np, **t)

            def m_of(b, vec):
                return b[:, :n_low] * (vec[:, :n_low] * wq[:n_low])[:, None]

            def quad(vec_l, vec_r):
                return m_of(b_i, vec_l) @ k_t @ m_of(b_j, vec_r).mT

            ones = torch.ones_like(ct_ac)
            if beyond_nka and field_spins is not None:
                from chomp_tpu_torch.mask import field_phase_suppression

                e_low = np.asarray(ells_np[:n_low])
                s_cache = {0: torch.ones(n_low, **t)}
                for s in set(int(x) for x in np.ravel(field_spins)):
                    if s != 0:
                        s_cache[s] = torch.as_tensor(
                            field_phase_suppression(mask, e_low, s), **t)
                (s_ac, s_bd), (s_ad, s_bc) = field_spins
                v_ac = ct_ac[:, :n_low] * s_cache[int(s_ac)]
                v_bd = ct_bd[:, :n_low] * s_cache[int(s_bd)]
                v_ad = ct_ad[:, :n_low] * s_cache[int(s_ad)]
                v_bc = ct_bc[:, :n_low] * s_cache[int(s_bc)]
            else:
                v_ac, v_bd, v_ad, v_bc = ct_ac, ct_bd, ct_ad, ct_bc
            coupled = (0.5 * (quad(v_ac, v_bd) + quad(v_bd, v_ac)
                              + quad(v_ad, v_bc) + quad(v_bc, v_ad))
                       - nn * quad(ones, ones)) / (2.0 * math.pi) ** 2
            g_low = (ells[:n_low] ** 2 * w[:n_low] / (2.0 * math.pi)
                     * integrand[:, :n_low])
            dl_i = bw_i if beyond_nka else b_i
            dl_j = bw_j if beyond_nka else b_j
            delta_low = mask.area4 * (
                (dl_i[:, :n_low] * g_low[:, None, :]) @ dl_j[:, :n_low].T)
            cov = cov + torch.as_tensor(pref0_np, **t) * (coupled
                                                          - delta_low)
    if beyond_nka and wedge_probe is not None and mask is not None:
        f_i = np.sqrt(spin2_wedge_factors(mask, theta_edges_deg_i,
                                          wedge_probe))
        f_j = np.sqrt(spin2_wedge_factors(mask, theta_edges_deg_j,
                                          wedge_probe))
        cov = cov * torch.as_tensor(np.outer(f_i, f_j), **t)
    if nn != 0.0 and mu_i == mu_j:
        lo_i, hi_i = edges_i[:-1], edges_i[1:]
        lo_j, hi_j = edges_j[:-1], edges_j[1:]
        a_i = hi_i**2 - lo_i**2
        a_j = hi_j**2 - lo_j**2
        if mask is None:
            cov = cov + nn * _const(
                memo, ("ovl", _edges_key(edges_i), _edges_key(edges_j),
                       float(omega_s_sr)),
                lambda: ovl_closure(edges_i, edges_j)
                / (np.pi * omega_s_sr * a_i[:, None] * a_j[None, :]), t)
        else:
            from chomp_tpu_torch.mask import pair_normalization

            d2_ovl = np.zeros((len(a_i), len(a_j)))
            for ii in range(len(a_i)):
                for jj in range(len(a_j)):
                    lo = max(lo_i[ii], lo_j[jj])
                    hi = min(hi_i[ii], hi_j[jj])
                    if hi > lo:
                        d2_ovl[ii, jj] = pair_normalization(
                            mask, np.array([lo, hi]), squared=True)[0]
            cov = cov + torch.as_tensor(nn * d2_ovl / np.outer(d_i, d_j),
                                        **t)
    if nn != 0.0 and mu_i != mu_j:
        mixed = _const(
            memo, ("xipm", _edges_key(edges_i), _edges_key(edges_j), mu_i),
            lambda: (xipm_mixed_noise_constant(edges_i, edges_j) if mu_i == 0
                     else xipm_mixed_noise_constant(edges_j, edges_i).T), t)
        if mask is None:
            cov = cov + nn * mixed / (2.0 * np.pi * omega_s_sr)
        else:
            cov = cov + pref * (nn * mixed / (2.0 * np.pi))
    return cov


gaussian_block = _own_memo(_gaussian_block)


def _plus(x, c: float):
    """``x + c`` for a nonzero float ``c``, ``x`` itself for 0."""
    return x if c == 0.0 else x + c


def _ell_rule(ells_np, w_np, t):
    """(ells, weights, l^2 dlnl / 2pi) of the log-ell rule as tensors."""
    ells = torch.as_tensor(ells_np, **t)
    w = torch.as_tensor(w_np, **t)
    return ells, w, ells**2 * w / (2.0 * math.pi)


# ---------------------------------------------------------------------------
# The connected (trispectrum) term.
# ---------------------------------------------------------------------------

def _is_seq(model):
    return isinstance(model, (list, tuple))


def _support_span(windows, cache: dict | None = None):
    """(z_lo, z_hi) floats of the static node range: each cosmology row's
    support intersection [max(lower ends, 1e-3), max(min(upper ends),
    lower)] and, for supports that vary over the batch, the union of the
    rows' ranges (the windows vanish outside their own support).
    ``cache`` keeps each window's supports on the host (by identity)."""
    cache = {} if cache is None else cache
    sups = []
    for w in windows:
        if id(w) not in cache:
            cache[id(w)] = (w, tuple(
                torch.as_tensor(x).detach().reshape(-1).double().cpu()
                for x in w.support()))
        sups.append(cache[id(w)][1])
    rows = max(max(lo.numel(), hi.numel()) for lo, hi in sups)
    los = torch.stack([lo.expand(rows) for lo, _ in sups])
    his = torch.stack([hi.expand(rows) for _, hi in sups])
    lo = torch.clamp_min(los.max(dim=0).values, 1e-3)
    hi = torch.maximum(his.min(dim=0).values, lo)
    return float(lo.min()), float(hi.max())


def _z_cuts(windows, st):
    """Per-row (z_cut_lo, z_cut_hi), (B|1,) each: the physical cutoff
    that both projection routes share (the table route integrates over
    it; the lattice route's ramp takes it in chi, :func:`_support_u`)."""
    t = dict(dtype=st.dtype, device=st.device)
    los = [torch.as_tensor(w.support()[0], **t).reshape(-1) for w in windows]
    his = [torch.as_tensor(w.support()[1], **t).reshape(-1) for w in windows]
    lo = torch.tensor([1e-3], **t)
    for x in los:
        lo = torch.maximum(lo, x)
    hi = his[0]
    for x in his[1:]:
        hi = torch.minimum(hi, x)
    return lo, torch.maximum(hi, lo)


def _tri_lattice_indices(windows, grid: GridSpec, u_stride: int,
                         cache: dict | None = None):
    """((lo, hi, step) slice bounds of the strided ln-chi lattice covering
    the windows' support padded x[1/2, 2] in chi through the fiducial
    chi(z), trapezoid u-weights), numpy; ``cache`` as
    :func:`_support_span`'s."""
    _, ln_chi = limber_fft._lattices(grid)
    n_chi = len(ln_chi)
    z_lo, z_hi = _support_span(windows, cache)
    chi_lo = max(0.5 * float(limber_fft.fiducial_chi_np(z_lo)),
                 np.exp(ln_chi[0]))
    chi_hi = min(2.0 * float(limber_fft.fiducial_chi_np(z_hi)),
                 np.exp(ln_chi[-1]))
    lo_idx = int(np.searchsorted(ln_chi, np.log(chi_lo)))
    hi_idx = min(int(np.searchsorted(ln_chi, np.log(chi_hi))) + 1, n_chi)
    hi_idx = max(hi_idx, lo_idx + 2)
    n_sel = len(range(lo_idx, hi_idx, u_stride))
    wu = np.full(n_sel, grid.lattice_dln * u_stride)
    wu[0] *= 0.5
    wu[-1] *= 0.5
    return (lo_idx, hi_idx, u_stride), wu


def _tri_query_weights(ells_np, u_nodes, ln_k0: float, dln: float,
                       n_k_tri: int):
    """Static 2-tap interpolation tensor W[m, a, i] at the fractional
    table positions (ln(ell_a + 1/2) - u_m - ln_k0)/dln, clipped as the
    table route's bilinear (numpy)."""
    s_ell = np.log(np.asarray(ells_np, dtype=np.float64) + 0.5)
    t = (s_ell[None, :] - np.asarray(u_nodes)[:, None] - ln_k0) / dln
    t = np.clip(t, 0.0, n_k_tri - 1.001)
    i = np.floor(t).astype(int)
    f = t - i
    n_m, n_a = t.shape
    w = np.zeros((n_m, n_a, n_k_tri))
    mm, aa = np.meshgrid(np.arange(n_m), np.arange(n_a), indexing="ij")
    w[mm, aa, i] = 1.0 - f
    w[mm, aa, i + 1] = f
    return w


class _Lattice:
    """The cosmology batch on the full ln-chi lattice: chi (1, n), the
    Newton z and z_mid (B, n), D(z) and each window (by identity)."""

    def __init__(self, cosmo, st):
        self.cosmo, self.st = cosmo, st
        self.chi, self.z, self.z_mid = limber_fft._lattice_z(cosmo, st)
        self.growth = background.growth_factor(cosmo, self.z, st,
                                               st.grid.n_growth)
        self._wins = {}

    def window(self, win):
        if id(win) not in self._wins:
            self._wins[id(win)] = (win, limber_fft._window_on_lattice(
                self.cosmo, win, self.z, self.chi, self.st, self.z_mid))
        return self._wins[id(win)][1]


def _lattice(cosmo, st, memo: _Memo) -> _Lattice:
    """The memo's :class:`_Lattice` of ``cosmo``."""
    return memo.get(("lattice", id(cosmo)), lambda: _Lattice(cosmo, st))


def _chi_of(cosmo, z, st):
    """chi(z) of per-row redshifts (B|1,) -> (B,)."""
    return background.comoving_distance(cosmo, z.reshape(-1, 1), st,
                                        st.grid.n_dist)[:, 0]


def _lattice_projection_weights(cosmo, windows, st, u_stride: int,
                                memo: _Memo, power: int):
    """(node slice, u nodes (numpy), W_a W_b W_c W_d / chi^power * chi *
    wu * ramp (B, m), z (B, m), D(z) (B, m)): the strided lattice nodes of
    the windows with the fractional-cell edge ramp at the shared z cut —
    the per-node weight of the cNG (power 6) and SSC (power 4)
    projections, before their growth and sigma_b^2 factors.  The nodes,
    windows and ramp are memoized per window set (a block's connected
    and SSC terms share them)."""
    key = (id(cosmo), tuple(map(id, windows)), u_stride)

    def make():
        rng, u_np, w_prod, chi, wu, ramp, z, growth = memo.get(
            ("projection_nodes",) + key,
            lambda: _projection_nodes(cosmo, windows, st, u_stride, memo))
        return rng, u_np, w_prod / chi**power * chi * wu * ramp, z, growth

    return memo.get(("projection_weights", power) + key, make)


def _support_u(cosmo, windows, st, memo):
    """(ln chi(z_cut_lo), ln chi(z_cut_hi)), (B, 1) each, of the shared z
    cut (:func:`_z_cuts`): chi is monotone in z, so the chi of a max /
    min of redshifts is the max / min of their chi; each window's
    support ends are evaluated once (memoized by identity)."""
    def chi_ends(w):
        def make():
            t = dict(dtype=st.dtype, device=st.device)
            return (w, *(_chi_of(cosmo, torch.as_tensor(x, **t).reshape(-1),
                                 st) for x in w.support()))
        return memo.get(("support_chi", id(cosmo), id(w)), make)[1:]

    floor = memo.get(("support_chi_floor", id(cosmo)), lambda: _chi_of(
        cosmo, torch.tensor([1e-3], dtype=st.dtype, device=st.device), st))
    ends = [chi_ends(w) for w in windows]
    lo = floor
    for c_lo, _ in ends:
        lo = torch.maximum(lo, c_lo)
    hi = ends[0][1]
    for _, c_hi in ends[1:]:
        hi = torch.minimum(hi, c_hi)
    return torch.log(lo)[:, None], torch.log(torch.maximum(hi, lo))[:, None]


def _projection_nodes(cosmo, windows, st, u_stride, memo):
    (u_lo, u_hi, u_step), wu = _tri_lattice_indices(
        windows, st.grid, u_stride, memo.get(("supports",), dict))
    _, ln_chi_full = limber_fft._lattices(st.grid)
    sel = slice(u_lo, u_hi, u_step)
    lat = _lattice(cosmo, st, memo)
    w_prod = None
    for w_ in windows:
        v = lat.window(w_)[:, sel]
        w_prod = v if w_prod is None else w_prod * v
    chi = lat.chi[:, sel]
    t = dict(dtype=st.dtype, device=st.device)
    du = st.grid.lattice_dln * u_step
    u_np = ln_chi_full[sel]
    u_nodes = _const(memo, ("u_nodes", u_lo, u_hi, u_step), lambda: u_np, t)
    u_cut_lo, u_cut_hi = _support_u(cosmo, windows, st, memo)
    ramp = (torch.clamp((u_nodes - u_cut_lo) / du + 0.5, 0.0, 1.0)
            * torch.clamp((u_cut_hi - u_nodes) / du + 0.5, 0.0, 1.0))
    return ((u_lo, u_hi, u_step), u_np, w_prod, chi,
            _const(memo, ("wu", u_lo, u_hi, u_step), lambda: wu, t), ramp,
            lat.z[:, sel], lat.growth[:, sel])


def _model_key(model, tracers):
    """Identity key of a T̄ table's models: the galaxy legs' samples and
    the shared mass tables."""
    if not _is_seq(model):
        return id(model)
    return (id(model[0].mass),) + tuple(
        id(m) if tr == "g" else None for m, tr in zip(model, tracers))


def _k_tri(n_k_tri: int, st):
    ln_k = np.linspace(np.log(st.grid.k_table_min),
                       np.log(st.grid.k_table_max), n_k_tri)
    return ln_k, float(ln_k[1] - ln_k[0])


def _tri_table(cosmo, halo_p, model, tracers, n_k_tri: int, st,
               memo: _Memo):
    """(sign, ln max(|T̄|, tiny)) of the T̄ table on the static (n_k_tri)^2
    log-k grid, (B, n, n) each, memoized per tracers and models.  The
    floor is the dtype's smallest normal, as in the JAX package."""
    def make():
        kk = memo.get(("k_tri", n_k_tri, str(st.device), st.dtype),
                      lambda: torch.as_tensor(np.exp(_k_tri(n_k_tri, st)[0]),
                                              dtype=st.dtype,
                                              device=st.device))
        t = trispectrum._parallelogram_tracers(
            cosmo, halo_p, model, kk[:, None], kk[None, :], tracers, st,
            ("1h", "2h", "3h", "4h"),
            shared=memo.get(("tri_shared", id(cosmo), n_k_tri), dict))
        sgn = torch.where(t < 0.0, -1.0, 1.0).to(t.dtype)
        return sgn, torch.log(torch.clamp_min(torch.abs(t),
                                              torch.finfo(t.dtype).tiny))

    return memo.get(("tri", tuple(tracers), _model_key(model, tracers),
                     n_k_tri), make)


def _tri_model_at(cosmo, halo_p, model, z, st):
    """``model`` rebuilt at per-row redshifts ``z`` (R,) for the row
    cosmologies ``cosmo`` / ``halo_p`` (R rows): a single HaloModel
    directly; a per-leg sequence rebuilds each DISTINCT sample once on ONE
    shared mass-table build and keeps the leg -> sample identity."""
    from chomp_tpu_torch import halo as halo_mod
    from chomp_tpu_torch.mass import build_mass_tables

    if not _is_seq(model):
        return halo_mod.build_halo_model(cosmo, halo_p, _hod_rows(model, z),
                                         z, st)
    t = build_mass_tables(cosmo, halo_p, z, st)
    rebuilt, out = [], []
    for m in model:
        for m_old, m_new in rebuilt:
            if m is m_old:
                out.append(m_new)
                break
        else:
            m_new = halo_mod.build_halo_model(cosmo, halo_p,
                                              _hod_rows(m, z), z, st,
                                              mass_tables=t)
            rebuilt.append((m, m_new))
            out.append(m_new)
    return tuple(out)


def _hod_rows(model, z):
    """``model``'s HOD with every per-cosmology field (B,) repeated for
    the R = B J rows of ``z`` (row b J + j); shared fields as they are."""
    from chomp_tpu_torch.limber_fft import _repeat_rows

    hod = model.hod
    b = model.n_g.shape[0]
    return _repeat_rows(hod, b, z.shape[0] // b) if b > 1 else hod


def _node_rows(cosmo, halo_p, z):
    """(row cosmologies, row halo parameters, row z (B J,)) of per-row
    redshifts ``z`` (B, J): row b J + j is cosmology b at z[b, j].  The
    cosmology has B J rows also at B = 1: its batch sizes what is built on
    the rows."""
    from chomp_tpu_torch.limber_fft import _repeat_rows

    cb = cosmo.batched()
    b, j = cb.batch, z.shape[-1]
    z = z.expand(b, j)
    rows = dataclasses.replace(cb, **{
        k: v.repeat_interleave(j, dim=0) for k, v in cb.fields().items()})
    return rows, _repeat_rows(halo_p, b, j), z.reshape(-1)


def _anchor_span(windows):
    """(z_lo, z_hi) floats of the static Chebyshev anchor span: [max(lower
    ends, 1e-3), max(min(upper ends), z_lo + 0.05)], the supports read
    once, detached.  A support that differs between cosmology rows has no
    static value: ValueError, as the JAX code raises for a traced one."""
    los, his = [], []
    for w in windows:
        ends = []
        for x in w.support():
            v = torch.as_tensor(x).detach().reshape(-1).double().cpu()
            if v.numel() > 1 and not bool(torch.all(v == v[0])):
                raise ValueError(
                    "exact_z_anchors needs concrete window supports for "
                    "the static Chebyshev anchor span (one value for every "
                    "cosmology row)")
            ends.append(float(v[0]))
        los.append(ends[0])
        his.append(ends[1])
    z_lo = max(max(los), 1e-3)
    return z_lo, max(min(his), z_lo + 0.05)


def _distinct(model):
    """The distinct samples of ``model`` (one HaloModel or a sequence), in
    order of first appearance, by identity."""
    out = []
    for m in (model if _is_seq(model) else [model]):
        if not any(m is d for d in out):
            out.append(m)
    return out


def _share_anchor_samples(model, memo: _Memo):
    """Register every sample of a builder's ``model`` in ``memo``: each
    block's anchors at one span are then built on ONE set of B x J rows
    for all of them (:func:`_anchor_samples`)."""
    memo.get(("anchor_samples",), lambda: _distinct(model))


def _anchor_samples(model, memo: _Memo):
    """The samples to rebuild at the anchors for ``model``: the builder's
    registered samples where they hold every one of ``model``'s (so every
    block at a span shares one anchor build and one kernel A launch of its
    responses), else ``model``'s own."""
    own = _distinct(model)
    if ("anchor_samples",) in memo:
        every = memo.get(("anchor_samples",), None)
        if all(any(m is d for d in every) for m in own):
            return every
    return own


def _anchor_models(cosmo, halo_p, models, spans, n_anchor: int, st,
                   memo: _Memo):
    """(row cosmologies, row halo parameters, [each of ``models`` rebuilt
    at the J Chebyshev anchors of each span of ``spans``]) over B x S x J
    rows (row (b S + s) J + j: cosmology b at anchor j of span s) on one
    mass-table build, memoized per model set and spans (the connected and
    super-sample terms share it)."""
    from chomp_tpu_torch.limber_fft import _cheb_nodes

    def make():
        z_nodes = np.concatenate([_cheb_nodes(lo, hi, int(n_anchor))[0]
                                  for lo, hi in spans])
        z = torch.as_tensor(z_nodes, dtype=st.dtype, device=st.device)
        rows, hp, z_rows = _node_rows(cosmo, halo_p, z[None, :])
        rebuilt = _tri_model_at(rows, hp, tuple(models), z_rows, st)
        return models, rows, hp, list(rebuilt)

    got = memo.get(("anchor_models", id(cosmo), tuple(map(id, models)),
                    tuple(spans), int(n_anchor)), make)
    return got[1], got[2], got[3]


def _tri_rows(cosmo, halo_p, model, tracers, kk, st):
    """T̄ on the (n_k_tri)^2 grid of every row's own model, (R, n, n)."""
    return trispectrum._parallelogram_tracers(
        cosmo, halo_p, model, kk[:, None], kk[None, :], tracers, st,
        ("1h", "2h", "3h", "4h"), shared={})


def _sign_ln(t):
    """(sign, ln max(|t|, tiny)) of T̄ tables, the dtype's smallest normal
    the floor, as in the JAX package."""
    sgn = torch.where(t < 0.0, -1.0, 1.0).to(t.dtype)
    return sgn, torch.log(torch.clamp_min(torch.abs(t),
                                          torch.finfo(t.dtype).tiny))


def _node_sandwich(w_q, tables, weight):
    """sum_m weight[b, m] sign exp(W[m] ln|T_bm| W[m]^T) with a table per
    row and node: ``w_q`` (m, a, n), ``tables`` (B, m, n, n), ``weight``
    (B, m) -> (B, a, a)."""
    sgn, ln_t = _sign_ln(tables)
    ln_q = w_q @ ln_t @ w_q.mT
    sg_q = w_q @ sgn @ w_q.mT
    mag = torch.exp(ln_q)
    t_q = torch.where(sg_q >= 0.0, mag, -mag)
    return torch.einsum("bm,bmac->bac", weight, t_q)


def _kk_tri(n_k_tri, st, memo):
    return memo.get(("k_tri", n_k_tri, str(st.device), st.dtype),
                    lambda: torch.as_tensor(np.exp(_k_tri(n_k_tri, st)[0]),
                                            dtype=st.dtype,
                                            device=st.device))


def _per_node_tables(cosmo, halo_p, model, tracers, z, n_k_tri, st, memo):
    """T̄ at every (row, node) of ``z`` (B, m) from a halo model rebuilt
    there, in chunks of nodes of at most ``_NODE_ROWS`` rows: yields (m0,
    m1, tables (B, m1 - m0, n, n)) for each chunk."""
    kk = _kk_tri(n_k_tri, st, memo)
    b, m = cosmo.batch, z.shape[-1]
    z = z.expand(b, m)
    step = max(1, _NODE_ROWS // b)
    for m0 in range(0, m, step):
        m1 = min(m, m0 + step)
        rows, hp, z_rows = _node_rows(cosmo, halo_p, z[:, m0:m1])
        model_z = _tri_model_at(rows, hp, model, z_rows, st)
        tb = _tri_rows(rows, hp, model_z, tracers, kk, st)
        yield m0, m1, tb.reshape(b, m1 - m0, n_k_tri, n_k_tri)


def _default_windows(dist, galaxy, windows, tracers):
    from chomp_tpu_torch.projection import WindowGalaxy

    if tracers is None:
        tracers = ("g",) * 4 if galaxy else ("m",) * 4
    if windows is None:
        windows = (WindowGalaxy(dist=dist),) * 4
    return windows, tracers


def _projected_trispectrum(cosmo, halo_p, model, dist, ells_cov,
                           galaxy: bool = True, with_bao: bool | None = None,
                           grid: GridSpec | None = None, n_k_tri: int = 96,
                           n_z_tri: int = 24, exact_z: bool = False,
                           windows=None, tracers=None,
                           method: str | None = None, u_stride: int = 4,
                           exact_z_anchors: int | None = None, *,
                           st: Statics | None = None,
                           memo: _Memo):
    """T^{abcd}_proj(l, l') at the static ``ells_cov``, (B, n_ell, n_ell):
    T̄ on an (n_k_tri)^2 log-k grid, sign-aware log-bilinear in (ln k, ln
    k') at each projection node, contracted over chi with the separable
    D^6(z).  ``windows`` / ``tracers`` assign each leg its radial window
    and tracer (default: four galaxy windows of ``dist``); ``model`` may
    be four per-leg HaloModels on one mass-table build.
    ``method="lattice"`` (default) projects on the strided ln-chi lattice
    (:func:`_projected_trispectrum_lattice`); ``method="table"`` on
    ``n_z_tri`` Gauss-Legendre z nodes with gathered bilinear lookups (the
    referee).  ``exact_z=True`` rebuilds the halo model and T̄ at every
    projection node (default route: the table's); ``exact_z_anchors`` = J
    (lattice route) expands T̄/D^6 over J Chebyshev anchors in z."""
    if exact_z and exact_z_anchors:
        raise ValueError("pass either exact_z=True (per-node rebuilds) "
                         "or exact_z_anchors=J (Chebyshev), not both")
    if exact_z_anchors and method == "table":
        raise ValueError("exact_z_anchors is a lattice-route feature; "
                         "the table route uses exact_z=True instead")
    st = resolve_statics(cosmo, st, grid, with_bao)
    if method is None:
        # The table route for the per-node rebuilds (its n_z_tri GL
        # nodes, not ~200 lattice nodes), the lattice route otherwise.
        method = "table" if exact_z and not exact_z_anchors else "lattice"
    if method == "lattice":
        return _projected_trispectrum_lattice(
            cosmo, halo_p, model, dist, ells_cov, galaxy, n_k_tri, windows,
            tracers, u_stride, st, memo, exact_z, exact_z_anchors)
    if method != "table":
        raise ValueError(f"method must be 'lattice' or 'table', got "
                         f"{method!r}")
    return _projected_trispectrum_table(cosmo, halo_p, model, dist,
                                        ells_cov, galaxy, n_k_tri, n_z_tri,
                                        windows, tracers, st, memo, exact_z)


projected_trispectrum = _own_memo(_projected_trispectrum)


def _projected_trispectrum_table(cosmo, halo_p, model, dist, ells_cov,
                                 galaxy, n_k_tri, n_z_tri, windows,
                                 tracers, st, memo, exact_z=False):
    """The Gauss-Legendre route of :func:`projected_trispectrum`: per z
    node, per-cosmology bilinear lookups of (sign, ln|T̄|) gathered from
    the table at ln k = ln((l + 1/2)/chi); ``exact_z`` takes each node's
    lookups from its own T̄ (no D^6 factor)."""
    from chomp_tpu_torch.params import C_OVER_H0

    t = dict(dtype=st.dtype, device=st.device)
    ells = torch.as_tensor(np.asarray(ells_cov, dtype=np.float64), **t)
    windows, tracers = _default_windows(dist, galaxy, windows, tracers)
    ln_k_np, dln = _k_tri(n_k_tri, st)
    z_lo, z_hi = _z_cuts(windows, st)
    x, w = st.gl_unit(n_z_tri)
    z = z_lo[:, None] + (z_hi - z_lo)[:, None] * x            # (B|1, nz)
    wz = w * (z_hi - z_lo)[:, None]
    chi = background.comoving_distance(cosmo, z, st, st.grid.n_dist)
    model0 = model[0] if _is_seq(model) else model
    d = (background.growth_factor(cosmo, z, st, st.grid.n_growth)
         / col(model0.mass.growth, 1))
    w_prod = None
    for w_ in windows:
        v = w_.window_z(cosmo, z, st)
        w_prod = v if w_prod is None else w_prod * v
    base = w_prod / chi**6 * (C_OVER_H0 / background.ez(cosmo, z)) * wz
    weight = base if exact_z else base * d**6                 # (B, nz)
    lnk1 = torch.log((ells[None, :, None] + 0.5) / chi[:, None, :])
    b = weight.shape[0]
    rows = torch.arange(b, device=st.device)[:, None, None]
    n = n_k_tri

    def bilinear(tbl, lnk):
        tt = torch.clamp((lnk - ln_k_np[0]) / dln, 0.0, n - 1.001)
        i = torch.floor(tt).long()
        f = tt - i
        ia, ib = i[:, :, None], i[:, None, :]
        fa, fb = f[:, :, None], f[:, None, :]
        return ((1 - fa) * (1 - fb) * tbl[rows, ia, ib]
                + fa * (1 - fb) * tbl[rows, ia + 1, ib]
                + (1 - fa) * fb * tbl[rows, ia, ib + 1]
                + fa * fb * tbl[rows, ia + 1, ib + 1])

    def node_term(iz, sgn_b, ln_b):
        lnk_z = lnk1[:, :, iz].expand(b, -1)
        mag = torch.exp(bilinear(ln_b, lnk_z))
        t_ab = torch.where(bilinear(sgn_b, lnk_z) >= 0.0, mag, -mag)
        return weight[:, iz, None, None] * t_ab

    out = torch.zeros(b, len(ells), len(ells), **t)
    if exact_z:
        for m0, m1, tables in _per_node_tables(cosmo, halo_p, model, tracers,
                                               z, n_k_tri, st, memo):
            for iz in range(m0, m1):
                out = out + node_term(iz, *_sign_ln(tables[:, iz - m0]))
        return out
    sgn_tb, ln_tb = _tri_table(cosmo, halo_p, model, tracers, n_k_tri, st,
                               memo)
    sgn_b = sgn_tb.expand(b, n, n)
    ln_b = ln_tb.expand(b, n, n)
    for iz in range(n_z_tri):
        out = out + node_term(iz, sgn_b, ln_b)
    return out


def _projected_trispectrum_lattice(cosmo, halo_p, model, dist, ells_cov,
                                   galaxy, n_k_tri: int, windows, tracers,
                                   u_stride: int, st, memo, exact_z=False,
                                   exact_z_anchors=None):
    """The lattice route: with W[m, a, i] the static 2-tap rows,

        lnT_q[b, m, a, c] = W[m, a, :] ln|T̄_b| W[m, c, :]^T
        T_proj[b, a, c]   = sum_m wgt_bm sign_q exp(lnT_q)

    (the sign sandwich likewise), separable D^6(z) in the weights;
    ``exact_z`` a T̄ of its own at every (row, node), ``exact_z_anchors``
    the Chebyshev mix of the anchors' T̄/D^6 times D^6(z)."""
    ells_np = np.asarray(ells_cov, dtype=np.float64)
    windows, tracers = _default_windows(dist, galaxy, windows, tracers)
    ln_k_np, dln = _k_tri(n_k_tri, st)
    rng, u_np, base, z_nodes, growth = _lattice_projection_weights(
        cosmo, windows, st, u_stride, memo, power=6)
    w_q = memo.get(("w_q", rng, tuple(ells_np.tolist()), n_k_tri),
                   lambda: torch.as_tensor(_tri_query_weights(
                       ells_np, u_np, ln_k_np[0], dln, n_k_tri),
                       dtype=st.dtype, device=st.device))
    if exact_z or exact_z_anchors:
        return _lattice_exact_z(cosmo, halo_p, model, windows, tracers,
                                n_k_tri, st, memo, w_q, base, z_nodes,
                                growth, exact_z_anchors)
    model0 = model[0] if _is_seq(model) else model
    weight = memo.get(
        ("cng_weight", id(cosmo), tuple(map(id, windows)), u_stride,
         id(model0.mass.growth)),
        lambda: base * (growth / col(model0.mass.growth, 1)) ** 6)
    sgn_tbar, ln_tbar = _tri_table(cosmo, halo_p, model, tracers, n_k_tri,
                                   st, memo)
    ln_q = _sandwich(w_q, ln_tbar)
    sg_q = _sandwich(w_q, sgn_tbar)
    mag = torch.exp(ln_q)
    t_q = torch.where(sg_q >= 0.0, mag, -mag)
    b, m, n = t_q.shape[:3]
    return (weight[:, None, :] @ t_q.reshape(b, m, n * n)).reshape(b, n, n)


def _lattice_exact_z(cosmo, halo_p, model, windows, tracers, n_k_tri, st,
                     memo, w_q, base, z, growth, exact_z_anchors):
    """The exact-z lattice projections, (B, a, a): per-node rebuilds
    (``exact_z_anchors`` None) or the J-anchor Chebyshev mix, both summed
    over the nodes in chunks (:func:`_node_sandwich`)."""
    b = cosmo.batch
    n_a = w_q.shape[1]
    out = torch.zeros(b, n_a, n_a, dtype=st.dtype, device=st.device)
    if not exact_z_anchors:
        for m0, m1, tables in _per_node_tables(cosmo, halo_p, model, tracers,
                                               z, n_k_tri, st, memo):
            out = out + _node_sandwich(w_q[m0:m1], tables, base[:, m0:m1])
        return out
    from chomp_tpu_torch.limber_fft import _barycentric_rows, _cheb_nodes

    span = _anchor_span(windows)
    j = int(exact_z_anchors)

    def make_t_j():
        models = _anchor_samples(model, memo)
        rows, hp, rebuilt = _anchor_models(cosmo, halo_p, models, (span,),
                                           j, st, memo)
        by_id = {id(m): r for m, r in zip(models, rebuilt)}
        model_j = (tuple(by_id[id(m)] for m in model) if _is_seq(model)
                   else rebuilt[0])
        t = _tri_rows(rows, hp, model_j, tracers, _kk_tri(n_k_tri, st, memo),
                      st)
        d_j = rebuilt[0].mass.growth.reshape(b, j)
        return t.reshape(b, j, n_k_tri, n_k_tri) / (d_j**6)[..., None, None]

    t_j = memo.get(("tri_anchor", tuple(tracers), _model_key(model, tracers),
                    n_k_tri, span, j), make_t_j)
    z_nodes, w_bary = _cheb_nodes(span[0], span[1], j)
    lag = _barycentric_rows(torch.clamp(z.expand(b, -1), span[0], span[1]),
                            z_nodes, w_bary)                # (B, m, J)
    d6 = growth.expand(b, -1) ** 6
    m = lag.shape[1]
    step = max(1, _NODE_ROWS // b)
    for m0 in range(0, m, step):
        m1 = min(m, m0 + step)
        t_m = (torch.einsum("bmj,bjpq->bmpq", lag[:, m0:m1], t_j)
               * d6[:, m0:m1, None, None])
        out = out + _node_sandwich(w_q[m0:m1], t_m, base[:, m0:m1])
    return out


def _sandwich(w_q, tbl):
    """W[m, a, :] tbl_b W[m, c, :]^T for every node and row: (B, m, a, c)
    from W (m, a, i) and tbl (B, i, j), as two matrix products."""
    m, a, i = w_q.shape
    x = (w_q.reshape(m * a, i) @ tbl).reshape(tbl.shape[0], m, a, -1)
    return x @ w_q.mT


def _pair_prefactor(mask, edges_i, edges_j, t):
    """A4 ann_i ann_j / (D_i D_j) of a masked block, (nbi, nbj)."""
    from chomp_tpu_torch.mask import pair_normalization

    ann_i = np.pi * (edges_i[1:] ** 2 - edges_i[:-1] ** 2)
    ann_j = np.pi * (edges_j[1:] ** 2 - edges_j[:-1] ** 2)
    d_i = pair_normalization(mask, edges_i)
    d_j = pair_normalization(mask, edges_j)
    return torch.as_tensor(mask.area4 * np.outer(ann_i, ann_j)
                           / np.outer(d_i, d_j), **t)


def _nongaussian_covariance(cosmo, halo_p, model, dist, theta_edges_deg,
                            omega_s_sr, galaxy: bool = True,
                            with_bao: bool | None = None,
                            grid: GridSpec | None = None,
                            n_ell_cov: int = 96, ell_lo: float = 1.0,
                            ell_hi: float = 1.0e5, exact_z: bool = False,
                            windows=None, tracers=None, mu_i: int = 0,
                            mu_j: int = 0, theta_edges_deg_j=None,
                            n_k_tri: int = 96, n_z_tri: int = 24,
                            method: str | None = None, u_stride: int = 4,
                            mask=None, exact_z_anchors: int | None = None,
                            *, st: Statics | None = None,
                            memo: _Memo):
    """Connected (trispectrum) covariance block, (B, nbi, nbj):
    (1/Omega_s) Bm_i T_proj Bm_j^T with Bm = Jbar^mu l^2 dlnl/2pi on the
    ``n_ell_cov`` log-ell grid; ``windows`` / ``tracers`` / ``mu_i`` /
    ``mu_j`` (and distinct j-side edges) select the probe pair, ``mask``
    the pair-count normalization.  The discretized term is only
    approximately PSD: the builders' ``psd_guard="clip"`` repairs an
    assembled matrix."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    ells_np, w_np = _log_ell_weights(n_ell_cov, ell_lo, ell_hi)
    t = dict(dtype=st.dtype, device=st.device)
    edges_i = np.radians(np.asarray(theta_edges_deg))
    edges_j = np.radians(np.asarray(
        theta_edges_deg if theta_edges_deg_j is None else theta_edges_deg_j))
    t_proj = _projected_trispectrum(
        cosmo, halo_p, model, dist, ells_np, galaxy, n_k_tri=n_k_tri,
        n_z_tri=n_z_tri, exact_z=exact_z, windows=windows, tracers=tracers,
        method=method, u_stride=u_stride, exact_z_anchors=exact_z_anchors,
        st=st, memo=memo)
    bm_i = _measured_bessel(memo, ells_np, w_np, edges_i, mu_i, t)
    bm_j = _measured_bessel(memo, ells_np, w_np, edges_j, mu_j, t)
    core = bm_i @ t_proj @ bm_j.T
    if mask is None:
        return core / omega_s_sr
    return core * memo.get(
        ("pair_prefactor", _mask_key(mask), _edges_key(edges_i),
         _edges_key(edges_j), str(t["device"]), t["dtype"]),
        lambda: _pair_prefactor(mask, edges_i, edges_j, t))


nongaussian_covariance = _own_memo(_nongaussian_covariance)


def _measured_bessel(memo, ells_np, w_np, edges_rad, mu, t):
    """Jbar^mu l^2 dlnl / 2pi on the log-ell rule, (nb, n_ell), memoized."""
    return memo.get(
        ("measured_bessel", len(ells_np), float(ells_np[0]),
         float(ells_np[-1]), _edges_key(edges_rad), mu, str(t["device"]),
         t["dtype"]),
        lambda: _bessel(memo, ells_np, edges_rad, mu, t) * torch.as_tensor(
            ells_np**2 * w_np / (2.0 * np.pi), **t))


def psd_clip(cov, floor_rel: float = 0.0):
    """Project (nearly) symmetric covariances (..., N, N) onto the PSD cone:
    symmetrize and raise every eigenvalue below ``floor_rel`` x
    max|eigenvalue| to that floor.  The result is V max(lambda, floor)
    V^T, as in the JAX package, formed as sym + V (floor - lambda)_+ V^T:
    only the raised eigenpairs are rebuilt, so a matrix with nothing to
    raise comes back exactly as its symmetric part (a rebuild of the
    whole matrix rounds its small blocks at the scale of its largest
    eigenvalue).  The correction is detached, so gradients flow through
    the raw matrix unchanged."""
    sym = 0.5 * (cov + cov.mT)
    lam, v = torch.linalg.eigh(sym)
    floor = floor_rel * torch.amax(torch.abs(lam), dim=-1, keepdim=True)
    lift = torch.clamp_min(floor - lam, 0.0)
    fixed = sym + (v * lift[..., None, :]) @ v.mT
    fixed = 0.5 * (fixed + fixed.mT)
    return cov + (fixed - cov).detach()


def _apply_psd_guard(cov, psd_guard):
    """None: the matrix as it is; "clip": :func:`psd_clip`."""
    if psd_guard is None:
        return cov
    if psd_guard == "clip":
        return psd_clip(cov)
    raise ValueError(f"psd_guard must be None or 'clip', got "
                     f"{psd_guard!r}")


# ---------------------------------------------------------------------------
# C_ell callables on the lattice.
# ---------------------------------------------------------------------------

def _lattice_cl(cosmo, win_a, win_b, ells_np, p_lattice, growth_pivot, st,
                memo: _Memo, key):
    """:func:`limber_fft.limber_cl_fft` (direct convolution) at the static
    ``ells_np`` on the memo's lattice evaluation, (B, n_ell), memoized
    under ``key`` and the ells."""
    ells_np = np.asarray(ells_np, dtype=np.float64)

    def make():
        lat = _lattice(cosmo, st, memo)
        d = lat.growth / col(growth_pivot, 1)
        g = (lat.window(win_a) * lat.window(win_b) / lat.chi
             * st.grid.lattice_dln) * (d * d)
        p = p_lattice.expand(g.shape[0], -1)
        j_lo, j_hi, w = memo.get(
            ("ells_window", len(ells_np), float(ells_np[0]),
             float(ells_np[-1])),
            lambda: limber_fft._ells_window(ells_np, 0.5, st))
        conv = limber_fft._conv_direct_rows(p[:, None], g[:, None], j_lo,
                                            j_hi)[:, 0]
        return conv @ w.T

    return memo.get(("cl", key, len(ells_np), float(ells_np[0]),
                     float(ells_np[-1])), make)


def _cl_callable(cosmo, win_a, win_b, p_lattice, piv, st, memo, key):
    return lambda ells_np: _lattice_cl(cosmo, win_a, win_b, ells_np,
                                       p_lattice, piv, st, memo, key)


def _lattice_cl_callables(cosmo, halo_p, model, dist_lens, dist_src,
                          with_bao: bool | None = None,
                          grid: GridSpec | None = None, *,
                          st: Statics | None = None,
                          memo: _Memo):
    """(cl_gg, cl_gk, cl_kk) callables of static numpy ells, fed by ONE
    halo evaluation on the k lattice (one kernel A launch)."""
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    win_g = WindowGalaxy(dist=dist_lens)
    win_k = WindowConvergence(dist=dist_src)
    p_lat = limber_fft.p_lattice_halo_all(cosmo, halo_p, model, st)
    piv = model.mass.growth
    tag = id(p_lat)
    return (_cl_callable(cosmo, win_g, win_g, p_lat["power_gg"], piv, st,
                         memo, (tag, "gg")),
            _cl_callable(cosmo, win_g, win_k, p_lat["power_gm"], piv, st,
                         memo, (tag, "gk")),
            _cl_callable(cosmo, win_k, win_k, p_lat["power_mm"], piv, st,
                         memo, (tag, "kk")))


lattice_cl_callables = _own_memo(_lattice_cl_callables)


def _cl_zero(st):
    def cl_zero(ells_np):
        return torch.zeros(1, len(np.asarray(ells_np)), dtype=st.dtype,
                           device=st.device)

    return cl_zero


def _stack_blocks(rows, b):
    """Assemble a square grid of (B|1, nb, nb) blocks into (B, N, N)."""
    n, nb = len(rows), rows[0][0].shape[-1]
    grid = torch.stack([blk.expand(b, nb, nb) for row in rows for blk in row],
                       dim=1)
    return grid.reshape(b, n, n, nb, nb).transpose(2, 3).reshape(
        b, n * nb, n * nb)


# ---------------------------------------------------------------------------
# The builders.
# ---------------------------------------------------------------------------

def joint_wtheta_gammat_covariance(cosmo, halo_p, model, dist_lens,
                                   dist_src, theta_edges_deg, omega_s_sr,
                                   n2d_lens, shape_noise,
                                   with_bao: bool | None = None,
                                   grid: GridSpec | None = None,
                                   include_nongaussian: bool = True,
                                   exact_z: bool = False,
                                   n_k_tri: int = 96, n_z_tri: int = 24,
                                   n_ell_cov_ng: int = 96,
                                   n_ell_cov_g: int = 4096,
                                   cl_method: str = "lattice",
                                   tri_method: str | None = None,
                                   u_stride: int = 4, mask=None,
                                   exact_z_anchors: int | None = None,
                                   include_ssc: bool = False,
                                   ssc_kwargs: dict | None = None,
                                   psd_guard: str | None = None,
                                   beyond_nka: bool = False, *,
                                   st: Statics | None = None):
    """Joint covariance of [w_gg bins, gamma_t bins], (B, 2 nb, 2 nb)
    ordered [ww, w-gt; gt-w, gt-gt]: the Morrison & Schneider 2013
    clustering + g-g lensing program.  ``n2d_lens`` lens galaxies per sr;
    ``shape_noise`` the white shear noise sigma_eps^2 / n2d_src per
    component.  ``include_nongaussian`` adds the connected blocks,
    ``include_ssc`` the super-sample term (:func:`ssc.ssc_covariance`;
    footprint ``mask``, else the equal-area disc of ``omega_s_sr``),
    ``psd_guard="clip"`` :func:`psd_clip`.  ``cl_method`` "lattice"
    (one kernel A launch on the k lattice) or "table" (the cubic-table
    Limber C_ell, one launch on the table's k); ``mask`` / ``beyond_nka``
    the footprint treatment of every block (:func:`gaussian_block`)."""
    from chomp_tpu_torch import projection
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    win_g = WindowGalaxy(dist=dist_lens)
    win_k = WindowConvergence(dist=dist_src)
    if cl_method == "lattice":
        cl_gg, cl_gk, cl_kk = _lattice_cl_callables(
            cosmo, halo_p, model, dist_lens, dist_src, st=st, memo=memo)
    elif cl_method == "table":
        pts = projection.power_tables_halo(
            cosmo, halo_p, model, ("power_gg", "power_gm", "power_mm"), st)

        def table_cl(wa, wb, kind):
            def cl(ells_np):
                return memo.get(
                    ("table_cl", kind, tuple(np.asarray(ells_np).tolist())),
                    lambda: projection.limber_cl(cosmo, wa, wb, ells_np,
                                                 pts[kind], st))
            return cl

        cl_gg = table_cl(win_g, win_g, "power_gg")
        cl_gk = table_cl(win_g, win_k, "power_gm")
        cl_kk = table_cl(win_k, win_k, "power_mm")
    else:
        raise ValueError(f"cl_method must be 'lattice' or 'table', got "
                         f"{cl_method!r}")
    edges = theta_edges_deg
    n_g = 1.0 / n2d_lens
    bnk = dict(n_ell_cov=n_ell_cov_g, mask=mask, beyond_nka=beyond_nka,
               memo=memo)
    cov_ww = _gaussian_block(cl_gg, cl_gg, cl_gg, cl_gg, edges, edges,
                             omega_s_sr, 0, 0, n_g, n_g, n_g, n_g, **bnk)
    cov_wg = _gaussian_block(cl_gg, cl_gk, cl_gk, cl_gg, edges, edges,
                             omega_s_sr, 0, 2, n_g, 0.0, 0.0, n_g, **bnk)
    cov_gg = _gaussian_block(cl_gg, cl_kk, cl_gk, cl_gk, edges, edges,
                             omega_s_sr, 2, 2, n_g, shape_noise, 0.0, 0.0,
                             wedge_probe=("gt" if beyond_nka else None),
                             **bnk)
    combos = (((win_g,) * 4, ("g",) * 4, 0, 0),
              ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"), 0, 2),
              ((win_g, win_k, win_g, win_k), ("g", "m", "g", "m"), 2, 2))
    blocks = [cov_ww, cov_wg, cov_gg]
    for add in _adders(cosmo, halo_p, model, dist_lens, edges, omega_s_sr,
                       st, memo, include_nongaussian, include_ssc,
                       n_ell_cov_ng, n_k_tri, n_z_tri, tri_method, u_stride,
                       mask, ssc_kwargs, exact_z, exact_z_anchors):
        blocks = [blk + add(*combo) for blk, combo in zip(blocks, combos)]
    cov_ww, cov_wg, cov_gg = blocks
    return _apply_psd_guard(_stack_blocks(
        [[cov_ww, cov_wg], [cov_wg.mT, cov_gg]], cosmo.batch), psd_guard)


def _adders(cosmo, halo_p, model, dist_lens, edges, omega_s_sr, st, memo,
            include_nongaussian, include_ssc, n_ell_cov_ng, n_k_tri,
            n_z_tri, tri_method, u_stride, mask, ssc_kwargs, exact_z=False,
            exact_z_anchors=None):
    """The connected and super-sample block engines of the joint
    builders: (windows, tracers, mu_i, mu_j) -> (B, nb, nb); the anchors
    ride both terms, the per-node rebuilds the connected one, as in the
    JAX builders."""
    adders = []
    if include_nongaussian:
        common = dict(n_ell_cov=n_ell_cov_ng, n_k_tri=n_k_tri,
                      n_z_tri=n_z_tri, method=tri_method,
                      u_stride=u_stride, mask=mask, exact_z=exact_z,
                      exact_z_anchors=exact_z_anchors, st=st, memo=memo)
        adders.append(lambda ws, ts, mi, mj: _nongaussian_covariance(
            cosmo, halo_p, model, dist_lens, edges, omega_s_sr,
            windows=ws, tracers=ts, mu_i=mi, mu_j=mj, **common))
    if include_ssc:
        from chomp_tpu_torch.ssc import _ssc_covariance

        skw = dict(u_stride=u_stride, exact_z_anchors=exact_z_anchors,
                   st=st, memo=memo, **(ssc_kwargs or {}))
        fp = mask if mask is not None else omega_s_sr
        adders.append(lambda ws, ts, mi, mj: _ssc_covariance(
            cosmo, halo_p, model, dist_lens, edges, fp, windows=ws,
            tracers=ts, mu_i=mi, mu_j=mj, **skw))
    return adders


def joint_3x2pt_covariance(cosmo, halo_p, model, dist_lens, dist_src,
                           theta_edges_deg, omega_s_sr, n2d_lens,
                           shape_noise, with_bao: bool | None = None,
                           grid: GridSpec | None = None,
                           include_nongaussian: bool = True,
                           exact_z: bool = False, n_k_tri: int = 96,
                           n_z_tri: int = 24, n_ell_cov_ng: int = 96,
                           n_ell_cov_g: int = 4096,
                           cl_method: str = "lattice",
                           tri_method: str | None = None,
                           u_stride: int = 4, mask=None,
                           exact_z_anchors: int | None = None,
                           include_ssc: bool = False,
                           ssc_kwargs: dict | None = None,
                           psd_guard: str | None = None,
                           beyond_nka: bool = False, *,
                           st: Statics | None = None):
    """Joint covariance of the full 3x2pt vector [w_gg, gamma_t, xi_+,
    xi_-], (B, 4 nb, 4 nb).  Shear: E-mode signal, no B modes, white
    noise ``shape_noise`` per component in both E and B, so each shear
    auto block is an EE block plus / minus a pure-noise BB block (the
    xi_+ x xi_- noise cancels exactly).  Lattice C_ell only, as in the
    JAX package; the other knobs as in
    :func:`joint_wtheta_gammat_covariance`."""
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    if cl_method != "lattice":
        raise ValueError("joint_3x2pt_covariance is lattice-only (the "
                         "table referee route lives in "
                         "joint_wtheta_gammat_covariance)")
    win_g = WindowGalaxy(dist=dist_lens)
    win_k = WindowConvergence(dist=dist_src)
    cl_gg, cl_gk, cl_kk = _lattice_cl_callables(
        cosmo, halo_p, model, dist_lens, dist_src, st=st, memo=memo)
    cl_zero = _cl_zero(st)
    edges = theta_edges_deg
    n_g = 1.0 / n2d_lens
    ns = float(shape_noise)
    gk = dict(n_ell_cov=n_ell_cov_g, mask=mask, beyond_nka=beyond_nka,
              memo=memo)

    def blk(ac, bd, ad, bc, mi, mj, nac, nbd, nad, nbc, **extra):
        return _gaussian_block(ac, bd, ad, bc, edges, edges, omega_s_sr,
                               mi, mj, nac, nbd, nad, nbc, **gk, **extra)

    blocks = {
        "ww": blk(cl_gg, cl_gg, cl_gg, cl_gg, 0, 0, n_g, n_g, n_g, n_g),
        "wg": blk(cl_gg, cl_gk, cl_gk, cl_gg, 0, 2, n_g, 0.0, 0.0, n_g),
        "wp": blk(cl_gk, cl_gk, cl_gk, cl_gk, 0, 0, 0.0, 0.0, 0.0, 0.0),
        "wm": blk(cl_gk, cl_gk, cl_gk, cl_gk, 0, 4, 0.0, 0.0, 0.0, 0.0),
        "gg": blk(cl_gg, cl_kk, cl_gk, cl_gk, 2, 2, n_g, ns, 0.0, 0.0,
                  wedge_probe=("gt" if beyond_nka else None)),
        "gp": blk(cl_gk, cl_kk, cl_gk, cl_kk, 2, 0, 0.0, ns, 0.0, ns),
        "gm": blk(cl_gk, cl_kk, cl_gk, cl_kk, 2, 4, 0.0, ns, 0.0, ns),
    }

    def shear_auto(mi, mj, sign, **extra):
        ee = blk(cl_kk, cl_kk, cl_kk, cl_kk, mi, mj, ns, ns, ns, ns,
                 **extra)
        bbn = blk(cl_zero, cl_zero, cl_zero, cl_zero, mi, mj, ns, ns, ns,
                  ns)
        return ee + sign * bbn

    blocks["pp"] = shear_auto(0, 0, +1.0, **(
        {"field_spins": ((4, 4), (0, 0)), "wedge_probe": "xip"}
        if beyond_nka else {}))
    blocks["pm"] = shear_auto(0, 4, -1.0)
    blocks["mm"] = shear_auto(4, 4, +1.0)
    g4, k4, m4 = (win_g,) * 4, (win_k,) * 4, ("m",) * 4
    gk2 = (win_g, win_g, win_k, win_k)
    combos = {
        "ww": (g4, ("g",) * 4, 0, 0),
        "wg": ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"), 0, 2),
        "wp": (gk2, ("g", "g", "m", "m"), 0, 0),
        "wm": (gk2, ("g", "g", "m", "m"), 0, 4),
        "gg": ((win_g, win_k, win_g, win_k), ("g", "m", "g", "m"), 2, 2),
        "gp": ((win_g, win_k, win_k, win_k), ("g", "m", "m", "m"), 2, 0),
        "gm": ((win_g, win_k, win_k, win_k), ("g", "m", "m", "m"), 2, 4),
        "pp": (k4, m4, 0, 0),
        "pm": (k4, m4, 0, 4),
        "mm": (k4, m4, 4, 4),
    }
    for add in _adders(cosmo, halo_p, model, dist_lens, edges, omega_s_sr,
                       st, memo, include_nongaussian, include_ssc,
                       n_ell_cov_ng, n_k_tri, n_z_tri, tri_method, u_stride,
                       mask, ssc_kwargs, exact_z, exact_z_anchors):
        for key, combo in combos.items():
            blocks[key] = blocks[key] + add(*combo)
    c = blocks
    rows = [[c["ww"], c["wg"], c["wp"], c["wm"]],
            [c["wg"].mT, c["gg"], c["gp"], c["gm"]],
            [c["wp"].mT, c["gp"].mT, c["pp"], c["pm"]],
            [c["wm"].mT, c["gm"].mT, c["pm"].mT, c["mm"]]]
    return _apply_psd_guard(_stack_blocks(rows, cosmo.batch), psd_guard)


def _per_bin(x, i):
    """Entry ``i`` of a per-bin nuisance field ((n,) or (B, n))."""
    return x[..., i]


def _bcast(x, nd):
    """A 0-d or per-row (B,) factor shaped against (B, *S), len(S) =
    ``nd``."""
    return col(x, nd) if torch.is_tensor(x) else x


def _tomographic_windows(lens_dists, src_dists, nuisance, memo: _Memo,
                         include_magnification: bool = False):
    """(lens windows, source windows, lens convergence windows or None,
    calibration 1 + m or None): the windows of the tomographic blocks at
    the fiducial nuisance point (photo-z shifted dN/dz, NLA in every
    source window), one set per builder call."""
    from chomp_tpu_torch.projection import (DNdzShifted, WindowConvergence,
                                            WindowConvergenceIA,
                                            WindowGalaxy)

    def make():
        if nuisance is None:
            return ([WindowGalaxy(dist=d) for d in lens_dists],
                    [WindowConvergence(dist=d) for d in src_dists], None,
                    None)
        nu = nuisance
        lens_cur = [DNdzShifted(base=d, dz=_per_bin(nu.dz_lens, i))
                    for i, d in enumerate(lens_dists)]
        wins_g = [WindowGalaxy(dist=d) for d in lens_cur]
        wins_k = [WindowConvergenceIA(
            dist=DNdzShifted(base=d, dz=_per_bin(nu.dz_src, j)),
            a_ia=nu.a_ia, eta_ia=nu.eta_ia, z0_ia=nu.z0_ia)
            for j, d in enumerate(src_dists)]
        wk_lens = [WindowConvergence(dist=d) for d in lens_cur]
        return wins_g, wins_k, wk_lens, 1.0 + nu.m

    got = memo.get(("tomo_windows", tuple(map(id, lens_dists)),
                    tuple(map(id, src_dists)), id(nuisance)), make)
    return got[0], got[1], (got[2] if include_magnification else None), \
        got[3]


def _tomographic_lattice_cl_callables(cosmo, halo_p, model, lens_dists,
                                      src_dists,
                                      with_bao: bool | None = None,
                                      grid: GridSpec | None = None,
                                      nuisance=None,
                                      include_magnification: bool = False,
                                      cmb=None, matter_power: str = "halo",
                                      *, st: Statics | None = None,
                                      memo: _Memo):
    """Every tomographic C_ell callable from ONE halo evaluation on the k
    lattice (one kernel A launch per galaxy node count): ("gg", i, j)
    for lens pairs i <= j, ("gk", i, j) lens i x source j, ("kk", j, k)
    source pairs j <= k.  ``model`` is one HaloModel or one per lens bin
    (cross-bin clustering by :func:`halo.tomographic_powers`); ``nuisance``
    evaluates them at a fiducial systematics point (shifted windows, NLA,
    gk x (1+m_j), kk x (1+m_j)(1+m_k)); ``include_magnification`` adds the
    lens magnification terms with c_i = 2(alpha_i - 1);
    ``matter_power`` "halofit" / "linear" swaps the mm lattice row;
    ``cmb`` (a :class:`cmblens.CMBLensingSpec`) adds ("gK", i), ("kK", j)
    (one (1 + m_j)) and ("KK",), the last with the static decaying part of
    the reconstruction noise N_L - N_inf."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    if include_magnification and nuisance is None:
        raise ValueError("include_magnification needs nuisance= (the "
                         "slopes live in Nuisance3x2pt.alpha_lens)")
    wins_g, wins_k, wk_lens, cal = _tomographic_windows(
        lens_dists, src_dists, nuisance, memo, include_magnification)
    if _is_seq(model):
        if len(model) != len(lens_dists):
            raise ValueError(
                f"per-bin models: got {len(model)} models for "
                f"{len(lens_dists)} lens bins")
        p_lat = dict(limber_fft.p_lattice_tomographic(cosmo, halo_p,
                                                      list(model), st))
        piv = model[0].mass.growth
        key_gg = lambda i, j: ("power_gg", i, j)  # noqa: E731
        key_gm = lambda i: ("power_gm", i)  # noqa: E731
        m0 = model[0]
    else:
        p_lat = dict(limber_fft.p_lattice_halo_all(cosmo, halo_p, model,
                                                   st))
        piv = model.mass.growth
        key_gg = lambda i, j: "power_gg"  # noqa: E731
        key_gm = lambda i: "power_gm"  # noqa: E731
        m0 = model
    if matter_power != "halo":
        p_lat["power_mm"] = limber_fft.mm_override(cosmo, m0.mass.z,
                                                   matter_power, st)
    tag = id(p_lat)

    def make(win_a, win_b, kind):
        return _cl_callable(cosmo, win_a, win_b, p_lat[kind], piv, st,
                            memo, (tag, id(win_a), id(win_b), kind))

    def memoized(make_cl):
        """The callable ``make_cl`` with its C_ell memoized per ells."""
        def cl(ells_np):
            e = np.asarray(ells_np, dtype=np.float64)
            return memo.get(("cl_sum", id(cl), len(e), float(e[0]),
                             float(e[-1])), lambda: make_cl(e))
        return cl

    def scaled(fn, factor):
        if factor is None:
            return fn
        return memoized(lambda e: _bcast(factor, 1) * fn(e))

    def summed(terms):
        def make_cl(ells_np):
            acc = None
            for coeff, f in terms:
                v = _bcast(coeff, 1) * f(ells_np)
                acc = v if acc is None else acc + v
            return acc

        return memoized(make_cl)

    c_mag = (2.0 * (nuisance.alpha_lens - 1.0) if wk_lens is not None
             else None)
    out = {}
    for i in range(len(wins_g)):
        for j in range(i, len(wins_g)):
            base = make(wins_g[i], wins_g[j], key_gg(i, j))
            if c_mag is None:
                out[("gg", i, j)] = base
            else:
                ci, cj = _per_bin(c_mag, i), _per_bin(c_mag, j)
                out[("gg", i, j)] = summed([
                    (1.0, base),
                    (cj, make(wins_g[i], wk_lens[j], key_gm(i))),
                    (ci, make(wins_g[j], wk_lens[i], key_gm(j))),
                    (ci * cj, make(wk_lens[i], wk_lens[j], "power_mm")),
                ])
        for j in range(len(wins_k)):
            base = make(wins_g[i], wins_k[j], key_gm(i))
            if c_mag is not None:
                base = summed([
                    (1.0, base),
                    (_per_bin(c_mag, i),
                     make(wk_lens[i], wins_k[j], "power_mm")),
                ])
            out[("gk", i, j)] = scaled(
                base, None if cal is None else _per_bin(cal, j))
    for j in range(len(wins_k)):
        for k in range(j, len(wins_k)):
            out[("kk", j, k)] = scaled(
                make(wins_k[j], wins_k[k], "power_mm"),
                None if cal is None
                else _per_bin(cal, j) * _per_bin(cal, k))
    if cmb is not None:
        win_kcmb = _cmb_window(cmb, st, memo)
        for i in range(len(wins_g)):
            base = make(wins_g[i], win_kcmb, key_gm(i))
            if c_mag is not None:
                base = summed([
                    (1.0, base),
                    (_per_bin(c_mag, i),
                     make(wk_lens[i], win_kcmb, "power_mm")),
                ])
            out[("gK", i)] = base
        for j in range(len(wins_k)):
            out[("kK", j)] = scaled(
                make(wins_k[j], win_kcmb, "power_mm"),
                None if cal is None else _per_bin(cal, j))
        kk_base = make(win_kcmb, win_kcmb, "power_mm")
        t = dict(dtype=st.dtype, device=st.device)

        def cl_kk_cmb(ells_np):
            e = np.asarray(ells_np, dtype=np.float64)
            return memo.get(
                ("cl_kk_cmb", id(cmb), len(e), float(e[0]), float(e[-1])),
                lambda: kk_base(e) + _const(
                    memo, ("nl_resid", id(cmb), len(e), float(e[0]),
                           float(e[-1])), lambda: cmb.nl_resid(e), t))

        out[("KK",)] = cl_kk_cmb
    return out


def _cmb_window(cmb, st, memo: _Memo):
    """The kappa_CMB window of ``cmb`` on the call's device and dtype, one
    object per call (windows are memoized by identity)."""
    return memo.get(("cmb_window", id(cmb)),
                    lambda: (cmb, cmb.window(device=st.device,
                                             dtype=st.dtype)))[1]


tomographic_lattice_cl_callables = _own_memo(
    _tomographic_lattice_cl_callables)


def tomographic_probes(n_lens: int, n_src: int, cmb_lensing: bool = False):
    """The tomographic 3x2pt probe list in data-vector order: w_i, every
    gamma_t_{ij}, xi_+^{jk} and xi_-^{jk} (j <= k), each (name, mu,
    channels) with channels [((tracer_a, tracer_b), sign)] over the E/B
    decomposition ("g", i) / ("E", j) / ("B", j); ``cmb_lensing`` appends
    the w_{g_i kappa_CMB} probes (tracer ("K", 0))."""
    probes = []
    for i in range(n_lens):
        probes.append((f"w_{i}", 0, [((("g", i), ("g", i)), 1.0)]))
    for i in range(n_lens):
        for j in range(n_src):
            probes.append((f"gt_{i}{j}", 2, [((("g", i), ("E", j)), 1.0)]))
    for j in range(n_src):
        for k in range(j, n_src):
            probes.append((f"xip_{j}{k}", 0,
                           [((("E", j), ("E", k)), 1.0),
                            ((("B", j), ("B", k)), 1.0)]))
    for j in range(n_src):
        for k in range(j, n_src):
            probes.append((f"xim_{j}{k}", 4,
                           [((("E", j), ("E", k)), 1.0),
                            ((("B", j), ("B", k)), -1.0)]))
    if cmb_lensing:
        for i in range(n_lens):
            probes.append((f"wgk_{i}", 0, [((("g", i), ("K", 0)), 1.0)]))
    return probes


def _tomographic_noise_lists(n2d_lens_list, shape_noise_list, n_lens,
                             n_src):
    """Per-bin noise levels as floats (scalars broadcast to every bin)."""
    n2d = [float(x) for x in np.atleast_1d(np.asarray(n2d_lens_list,
                                                      dtype=float))]
    sn = [float(x) for x in np.atleast_1d(np.asarray(shape_noise_list,
                                                     dtype=float))]
    if len(n2d) == 1:
        n2d = n2d * n_lens
    if len(sn) == 1:
        sn = sn * n_src
    return n2d, sn


def _tomographic_pair_fn(cls, n2d, sn, cl_zero, nl_inf: float = 0.0):
    """(C_ell callable, noise level) of any tracer pair of the
    :func:`tomographic_probes` alphabet (the E/B bookkeeping that makes
    the xi_+ x xi_- noise cancellation exact)."""
    def pair(t1, t2):
        k1, i1 = t1
        k2, i2 = t2
        if "B" in (k1, k2):
            if t1 == t2:
                return cl_zero, sn[i1]
            return cl_zero, 0.0
        if "K" in (k1, k2):
            if (k1, k2) == ("K", "K"):
                return cls[("KK",)], nl_inf
            kind, idx = (k2, i2) if k1 == "K" else (k1, i1)
            if kind == "g":
                return cls[("gK", idx)], 0.0
            return cls[("kK", idx)], 0.0
        if (k1, k2) == ("g", "g"):
            lo, hi = min(i1, i2), max(i1, i2)
            return cls[("gg", lo, hi)], (1.0 / n2d[i1] if i1 == i2 else 0.0)
        if (k1, k2) == ("g", "E"):
            return cls[("gk", i1, i2)], 0.0
        if (k1, k2) == ("E", "g"):
            return cls[("gk", i2, i1)], 0.0
        lo, hi = min(i1, i2), max(i1, i2)
        return cls[("kk", lo, hi)], (sn[i1] if i1 == i2 else 0.0)

    return pair


def _tomographic_ng_block_fn(cosmo, halo_p, model, lens_dists, src_dists,
                             edges, omega_s_sr, st, mask, ng_kwargs,
                             memo: _Memo, curved_mask=None, nuisance=None,
                             engine: str = "cng", cmb=None):
    """(probe_a, probe_b) -> the connected (``engine="cng"``) or
    super-sample (``"ssc"``) block of their non-B channel pairs, or None:
    g legs bind their lens bin's window and model, E legs the source
    window (with NLA at a nuisance point) and the shared matter sector,
    one (1 + m_j) per E leg, K legs (``cmb``) the matter field through
    the kappa_CMB window with no calibration factor.  ``curved_mask``
    swaps in the curved engines (:func:`curved.curved_nongaussian_
    covariance`, :func:`ssc.curved_ssc_covariance`) with the probes'
    curved estimator codes; ``ng_kwargs`` then carries their ell_max."""
    per_bin = _is_seq(model)
    wins_g, wins_k, _, cal = _tomographic_windows(lens_dists, src_dists,
                                                  nuisance, memo)

    def leg(t):
        kind, i = t
        if kind == "g":
            return wins_g[i], "g", (model[i] if per_bin else model), 1.0
        if kind == "K":
            return (_cmb_window(cmb, st, memo), "m",
                    (model[0] if per_bin else model), 1.0)
        return (wins_k[i], "m", (model[0] if per_bin else model),
                1.0 if cal is None else _per_bin(cal, i))

    def side_model(ts_pair, ms_pair):
        return ms_pair[0] if ts_pair[0] == "g" else ms_pair[1]

    if curved_mask is not None:
        from chomp_tpu_torch.curved import _curved_probe_code

        def codes(entry_a, entry_b):
            return dict(mu_i=_curved_probe_code(entry_a[1], entry_a[2]),
                        mu_j=_curved_probe_code(entry_b[1], entry_b[2]))
    if engine == "ssc":
        from chomp_tpu_torch.ssc import (_curved_ssc_covariance,
                                         _ssc_covariance)

        fp = mask if mask is not None else omega_s_sr

        def block(ws, ts, ms, entry_a, entry_b):
            m_pair = ((side_model(ts[:2], ms[:2]),
                       side_model(ts[2:], ms[2:])) if per_bin else model)
            if curved_mask is not None:
                return _curved_ssc_covariance(
                    cosmo, halo_p, m_pair, lens_dists[0], edges,
                    curved_mask, windows=ws, tracers=ts,
                    **codes(entry_a, entry_b), st=st, memo=memo,
                    **ng_kwargs)
            return _ssc_covariance(cosmo, halo_p, m_pair, lens_dists[0],
                                   edges, fp, windows=ws, tracers=ts,
                                   mu_i=entry_a[1], mu_j=entry_b[1], st=st,
                                   memo=memo, **ng_kwargs)
    elif curved_mask is not None:
        from chomp_tpu_torch.curved import _curved_nongaussian_covariance

        def block(ws, ts, ms, entry_a, entry_b):
            return _curved_nongaussian_covariance(
                cosmo, halo_p, ms, lens_dists[0], edges, curved_mask,
                windows=ws, tracers=ts, **codes(entry_a, entry_b), st=st,
                memo=memo, **ng_kwargs)
    else:
        def block(ws, ts, ms, entry_a, entry_b):
            return _nongaussian_covariance(
                cosmo, halo_p, ms, lens_dists[0], edges, omega_s_sr,
                windows=ws, tracers=ts, mu_i=entry_a[1], mu_j=entry_b[1],
                mask=mask, st=st, memo=memo, **ng_kwargs)

    def legs(entry_a, entry_b):
        """(sign, windows, tracers, models, calibrations) of each non-B
        channel pair of the block."""
        for (a, b), s_a in entry_a[2]:
            if "B" in (a[0], b[0]):
                continue
            for (c, d), s_b in entry_b[2]:
                if "B" in (c[0], d[0]):
                    continue
                yield (s_a * s_b,
                       *zip(*(leg(t) for t in (a, b, c, d))))

    def ng(entry_a, entry_b):
        acc = None
        for sgn, ws, ts, ms, fs in legs(entry_a, entry_b):
            f_cal = fs[0] * fs[1] * fs[2] * fs[3]
            blk = (sgn * _bcast(f_cal, 2)
                   * block(ws, ts, ms if per_bin else model, entry_a,
                           entry_b))
            acc = blk if acc is None else acc + blk
        return acc

    ng.legs = legs
    return ng


def _prime_block_anchors(cosmo, halo_p, model, sscf, probes, include_ssc,
                         ssc_kwargs, st, memo: _Memo):
    """With ``exact_z_anchors`` in ``ssc_kwargs``, fill ``memo`` with
    every sample's anchor response parts at the anchor span of every
    super-sample block the builder will take (the ``include_ssc`` probe
    pairs of ``probes``), so that they come from one kernel A launch
    (:func:`ssc._prime_anchor_parts`) and not one per span."""
    n_anchor = ssc_kwargs.get("exact_z_anchors")
    if sscf is None or not n_anchor:
        return
    from chomp_tpu_torch.ssc import _prime_anchor_parts

    spans = {}
    for pa in range(len(probes)):
        for pb in range(pa, len(probes)):
            if include_ssc == "autos" and pb != pa:
                continue
            for _, ws, _, _, _ in sscf.legs(probes[pa], probes[pb]):
                spans[_anchor_span(ws)] = None
    _prime_anchor_parts(cosmo, halo_p, model, list(spans), n_anchor, st,
                        memo, **{k: v for k, v in ssc_kwargs.items()
                                 if k in ("n_k_ssc", "local_counts")})


def tomographic_3x2pt_covariance(cosmo, halo_p, model, lens_dists,
                                 src_dists, theta_edges_deg, omega_s_sr,
                                 n2d_lens_list, shape_noise_list,
                                 with_bao: bool | None = None,
                                 grid: GridSpec | None = None,
                                 n_ell_cov_g: int = 4096, mask=None,
                                 include_nongaussian=False, nuisance=None,
                                 include_magnification: bool = False,
                                 include_ssc=False,
                                 ssc_kwargs: dict | None = None,
                                 cmb_lensing=None,
                                 matter_power: str = "halo",
                                 psd_guard: str | None = None,
                                 beyond_nka: bool = False, *,
                                 st: Statics | None = None, **ng_kwargs):
    """Covariance of the tomographic 3x2pt data vector, (B, n_probe nb,
    n_probe nb) in :func:`tomographic_probes` order.  Gaussian blocks
    over the probes' E/B channels (per-bin shot noise 1/n2d_lens_list[i],
    per-source-bin shape noise per component in E and B), from ONE
    lattice halo evaluation; ``include_nongaussian`` / ``include_ssc``:
    False, "autos" (diagonal probe blocks only) or True (every block);
    ``nuisance`` / ``include_magnification`` / ``matter_power`` as in
    :func:`tomographic_lattice_cl_callables`; ``ng_kwargs`` forward to
    :func:`nongaussian_covariance`, ``ssc_kwargs`` to
    :func:`ssc.ssc_covariance`; ``psd_guard="clip"`` :func:`psd_clip`.
    ``cmb_lensing`` (True or a :class:`cmblens.CMBLensingSpec`) appends
    the w_{g_i kappa_CMB} probes: their C_ell from the same lattice
    evaluation, the spec's N_L as C^KK + (N_L - N_inf) with the white
    floor N_inf through the noise closure, kappa_CMB a matter leg of the
    connected and super-sample blocks."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    memo = _Memo()
    cmb = None
    if cmb_lensing is not None and cmb_lensing is not False:
        from chomp_tpu_torch.cmblens import as_cmb_spec

        cmb = as_cmb_spec(cmb_lensing)
    n_lens, n_src = len(lens_dists), len(src_dists)
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
    ng = (_tomographic_ng_block_fn(cosmo, halo_p, model, lens_dists,
                                   src_dists, edges, omega_s_sr, st, mask,
                                   ng_kwargs, memo, nuisance=nuisance,
                                   cmb=cmb)
          if include_nongaussian else None)
    if include_ssc and not (ssc_kwargs or {}).get("exact_z_anchors"):
        from chomp_tpu_torch.ssc import _prime_responses

        _prime_responses(cosmo, halo_p, model, st, memo,
                         **{k: v for k, v in (ssc_kwargs or {}).items()
                            if k in ("n_k_ssc", "local_counts")})
    sscf = (_tomographic_ng_block_fn(cosmo, halo_p, model, lens_dists,
                                     src_dists, edges, omega_s_sr, st,
                                     mask, ssc_kwargs or {}, memo,
                                     nuisance=nuisance, engine="ssc",
                                     cmb=cmb)
            if include_ssc else None)
    _prime_block_anchors(cosmo, halo_p, model, sscf, probes, include_ssc,
                         ssc_kwargs or {}, st, memo)
    n_probe = len(probes)
    blocks = [[None] * n_probe for _ in range(n_probe)]
    for pa in range(n_probe):
        _, mu_a, ch_a = probes[pa]
        for pb in range(pa, n_probe):
            _, mu_b, ch_b = probes[pb]
            acc = None
            for (a, b), s_a in ch_a:
                for (c, d), s_b in ch_b:
                    cl_ac, n_ac = pair(a, c)
                    cl_bd, n_bd = pair(b, d)
                    cl_ad, n_ad = pair(a, d)
                    cl_bc, n_bc = pair(b, c)
                    if (cl_ac is cl_zero and cl_bd is cl_zero
                            and cl_ad is cl_zero and cl_bc is cl_zero
                            and n_ac * n_bd + n_ad * n_bc == 0.0):
                        continue
                    extra = {}
                    if beyond_nka:
                        extra["beyond_nka"] = True
                        kinds = {a[0], b[0], c[0], d[0]}
                        if mu_a == mu_b == 2:
                            extra["wedge_probe"] = "gt"
                        elif mu_a == mu_b == 0 and kinds == {"E"}:
                            extra["field_spins"] = ((4, 4), (0, 0))
                            extra["wedge_probe"] = "xip"
                    blk = s_a * s_b * _gaussian_block(
                        cl_ac, cl_bd, cl_ad, cl_bc, edges, edges,
                        omega_s_sr, mu_a, mu_b, n_ac, n_bd, n_ad, n_bc,
                        n_ell_cov=n_ell_cov_g, mask=mask, memo=memo,
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


def wtheta_covariance(cosmo, halo_p, model, dist, cl_fn, theta_edges_deg,
                      omega_s_sr, n2d, galaxy: bool = True,
                      with_bao: bool | None = None,
                      grid: GridSpec | None = None, n_k_tri: int = 96,
                      n_z_tri: int = 24, *, st: Statics | None = None):
    """Total w(theta) covariance: Gaussian + shot noise + trispectrum (the
    chomp ``Covariance`` object's), (B, nb, nb)."""
    st = resolve_statics(cosmo, st, grid, with_bao)
    cov_g = gaussian_covariance(cl_fn, theta_edges_deg, n2d, omega_s_sr)
    return cov_g + nongaussian_covariance(
        cosmo, halo_p, model, dist, theta_edges_deg, omega_s_sr, galaxy,
        n_k_tri=n_k_tri, n_z_tri=n_z_tri, st=st)
