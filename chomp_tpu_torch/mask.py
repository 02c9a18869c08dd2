"""Survey-mask (window-function) Gaussian covariance for w(theta) bins.

PyTorch counterpart of the JAX package's ``mask.py`` (its docstring has
the flat-sky derivation).  The mask geometries (:class:`DiscMask`,
:class:`UniformMask`, :class:`PixelMask`), the pair normalization, the
mode-coupling matrices K_m(q, q') and the field-phase suppression are
static survey geometry: numpy, copied from the JAX module, with the
coupling matrices cached by the mask's numbers (the dataclasses hash by
their fields, :class:`PixelMask` by its map).  Only
:func:`masked_gaussian_covariance`, which contracts them with the
cosmology batch's C_ell, is torch: every static matrix becomes a tensor
on the device and dtype of the C_ell it meets, at the call.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

#: numpy >= 2 names the trapezoid rule ``trapezoid``; older numpy
#: ``trapz``.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclasses.dataclass(frozen=True)
class DiscMask:
    """Binary disc footprint of ``radius`` radians — the analytic
    reference mask (every ingredient in closed form)."""

    radius: float

    @property
    def area2(self) -> float:
        """A₂ = ∫ W² (binary: the footprint area)."""
        return float(np.pi * self.radius**2)

    @property
    def area4(self) -> float:
        """A₄ = ∫ W⁴ (binary: the footprint area)."""
        return float(np.pi * self.radius**2)

    def wtilde2_sq(self, q):
        """|W̃₂(q)|², W̃₂ = FT of W²: Airy pattern
        (2π R² J1(qR)/(qR))² for a disc."""
        from scipy.special import j1 as sp_j1

        qr = np.maximum(np.asarray(q, dtype=float) * self.radius, 1e-12)
        return (2.0 * np.pi * self.radius**2 * sp_j1(qr) / qr) ** 2

    def pair_function(self, theta):
        """R̄(θ) = ∫ W(x) W(x+r) d²x at |r| = θ: the lens-shaped overlap
        area of two discs, 2R² cos⁻¹(d/2R) − (d/2)√(4R² − d²)."""
        d = np.asarray(theta, dtype=float)
        r = self.radius
        x = np.clip(d / (2.0 * r), 0.0, 1.0)
        return np.where(d < 2.0 * r,
                        2.0 * r**2 * np.arccos(x)
                        - 0.5 * d * np.sqrt(np.maximum(4 * r**2 - d**2, 0.0)),
                        0.0)

    @property
    def coupling_width(self) -> float:
        """Characteristic width of the coupling kernel in q: ~1/R."""
        return 1.0 / self.radius


@dataclasses.dataclass(frozen=True)
class UniformMask:
    """Unmasked survey of solid angle ``omega_s_sr`` — the degenerate
    case; masked_gaussian_covariance then reproduces
    covariance.gaussian_covariance exactly (tested)."""

    omega_s_sr: float

    @property
    def area2(self) -> float:
        return float(self.omega_s_sr)

    @property
    def area4(self) -> float:
        return float(self.omega_s_sr)

    def wtilde2_sq(self, q):
        # Never used: coupling_width 0 sends everything to the delta
        # limit.
        raise NotImplementedError

    def pair_function(self, theta):
        return np.full_like(np.asarray(theta, dtype=float), self.omega_s_sr)

    @property
    def coupling_width(self) -> float:
        return 0.0


class PixelMask:
    """General flat-sky footprint from a pixel weight map W(x) in
    [0, 1] — the practical survey-geometry entry point (arbitrary
    shapes, holes, weights).

    Every covariance ingredient is computed ONCE from the map by FFT
    (numpy; zero-padded 2x per axis so the autocorrelations do not
    wrap):

      - A₂ = ∫W², A₄ = ∫W⁴ (pixel sums);
      - R̄(θ): azimuthally averaged autocorrelation of W (pair counts);
      - R̄₂(θ): same for W² (the noise-closure pair function; equals
        R̄ for binary masks);
      - |W̃₂(q)|²: azimuthally averaged power of W² on a radial q
        grid, log-interpolated (isotropized — exact for circular
        footprints; the standard approximation inside the coupling
        matrix otherwise).

    ``pixel_scale_rad``: pixel side in radians.  Instances hash by map
    content so the coupling-matrix cache works."""

    def __init__(self, w_map, pixel_scale_rad: float):
        w = np.asarray(w_map, dtype=float)
        if w.ndim != 2:
            raise ValueError("PixelMask needs a 2-D weight map")
        a = float(pixel_scale_rad)
        self.pixel_scale_rad = a
        self.area2 = float((w**2).sum() * a * a)
        self.area4 = float((w**4).sum() * a * a)
        ny, nx = w.shape
        pad = np.zeros((2 * ny, 2 * nx))
        # Radial separation lattice of the padded correlation plane.
        ry = np.minimum(np.arange(2 * ny), 2 * ny - np.arange(2 * ny)) * a
        rx = np.minimum(np.arange(2 * nx), 2 * nx - np.arange(2 * nx)) * a
        rr = np.sqrt(ry[:, None] ** 2 + rx[None, :] ** 2)
        r_max = min(ny, nx) * a          # wrap-free separation range
        n_rbin = max(128, min(ny, nx))
        r_edges = np.linspace(0.0, r_max, n_rbin + 1)
        idx = np.clip(np.digitize(rr.ravel(), r_edges) - 1, 0, n_rbin - 1)
        counts = np.bincount(idx, minlength=n_rbin).astype(float)

        def radial_pair(field):
            pad[:ny, :nx] = field
            corr = np.real(np.fft.ifft2(
                np.abs(np.fft.fft2(pad)) ** 2)) * a * a
            sums = np.bincount(idx, weights=corr.ravel(),
                               minlength=n_rbin)
            return sums / np.maximum(counts, 1.0)

        self._r_mid = 0.5 * (r_edges[:-1] + r_edges[1:])
        self._pair = radial_pair(w)
        self._pair2 = radial_pair(w * w)
        # |W2~(q)|^2: power of W^2 on the padded grid, radially averaged
        # in shells of the grid's own frequency step (a survey-size
        # footprint has Airy-like oscillations of period ~pi/L — coarser
        # shells smear them and biased the coupled covariance ~13% on
        # the disc referee; empty shells are dropped, the interp bridges
        # them).
        pad[:ny, :nx] = w * w
        pw = np.abs(np.fft.fft2(pad) * a * a) ** 2
        qy = 2 * np.pi * np.fft.fftfreq(2 * ny, d=a)
        qx = 2 * np.pi * np.fft.fftfreq(2 * nx, d=a)
        qq = np.sqrt(qy[:, None] ** 2 + qx[None, :] ** 2)
        dq = max(qy[1] - qy[0], qx[1] - qx[0])
        q_max = float(qq.max())
        n_qbin = int(np.ceil(q_max / dq)) + 1
        qi = np.minimum((qq.ravel() / dq + 0.5).astype(int), n_qbin - 1)
        qc = np.bincount(qi, minlength=n_qbin).astype(float)
        qs = np.bincount(qi, weights=pw.ravel(), minlength=n_qbin)
        # Count-corrected shell profile: the continuum re-integration
        # ∫ wt2(q) q dq of plain shell MEANS loses ~8% (integer shell
        # counts at low q deviate from the 2π q/dq ring measure, and
        # the power-weighted discrepancy is large).  Scale each shell
        # so that its continuum ring integral reproduces the exact grid
        # sum — Parseval (∫|W̃₂|² d²q/(2π)² = A₄) then holds exactly.
        q_mid = np.arange(n_qbin) * dq
        ring = 2.0 * np.pi * q_mid * dq
        ring[0] = np.pi * (0.5 * dq) ** 2
        wt2 = qs * dq * dq / np.maximum(ring, 1e-300)
        filled_idx = np.nonzero(qc > 0)[0]
        wt2 = np.interp(np.arange(n_qbin), filled_idx, wt2[filled_idx])
        self._wt2_shell = wt2
        self._wt2_dq = dq
        self._q_max = q_max
        self._hash = hash((w.tobytes(), a))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, PixelMask) and self._hash == other._hash

    def wtilde2_sq(self, q):
        """NEAREST-shell lookup, not linear interp: the shell means ARE
        band averages of the (oscillating) mask power, so piecewise-
        constant evaluation conserves ∫|W̃₂|² d²q (Parseval -> A₄);
        linear interp through the rectified oscillations lost ~3% of
        the power and biased the coupled covariance low (measured on
        the disc referee)."""
        q = np.asarray(q, dtype=float)
        i = np.minimum((q / self._wt2_dq + 0.5).astype(int),
                       len(self._wt2_shell) - 1)
        return np.where(q > self._q_max, 0.0, self._wt2_shell[i])

    def pair_function(self, theta):
        return np.interp(np.asarray(theta, dtype=float), self._r_mid,
                         self._pair, right=0.0)

    def pair_function2(self, theta):
        """Pair function of W² (noise closure; = pair_function for a
        binary map)."""
        return np.interp(np.asarray(theta, dtype=float), self._r_mid,
                         self._pair2, right=0.0)

    @property
    def coupling_width(self) -> float:
        # sqrt(pi/A2): equals 1/R for a disc of the same area.
        return float(np.sqrt(np.pi / self.area2))


def pair_normalization(mask, edges_rad, n_theta: int = 512,
                       squared: bool = False):
    """D_i = 2π ∫_bin θ R̄(θ) dθ per bin (numpy, static geometry).

    ``squared=True`` uses the W² pair function (``pair_function2`` when
    the mask provides one — weighted maps; binary masks: identical) —
    the D₂ entering the exact noise closure."""
    pf = mask.pair_function
    if squared:
        pf = getattr(mask, "pair_function2", pf)
    edges = np.asarray(edges_rad, dtype=float)
    d = np.empty(len(edges) - 1)
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        th = np.linspace(lo, hi, n_theta)
        d[i] = 2.0 * np.pi * _trapezoid(th * pf(th), th)
    return d


def _coupling_matrix_impl(mask, lnq_key, n_phi: int, moment: int = 0):
    """K_m(q, q') = (1/2π) ∫ dφ |W̃₂(Δ)|² cos(m φ) on the static low-q
    grid (numpy — survey geometry never traces).  ``moment``: the
    azimuthal moment from spin-2 estimator phases (0 for spin-0 blocks;
    2 for a single spin-2 leg pair; 4 enters the spin-2 auto blocks) —
    φ is the RELATIVE azimuth of q and q', so e^{2i(φ_q'-φ_q)} weights
    reduce to cos(2φ) inside the (even) kernel average.  Accumulated in
    φ chunks: one (nq, nq, n_phi) tensor would reach ~6 GB at
    survey-scale defaults before wtilde2_sq's temporaries triple it;
    chunking caps peak memory at a few (nq, nq) panels."""
    qg = np.exp(np.asarray(lnq_key))
    phi = (np.arange(n_phi) + 0.5) * np.pi / n_phi   # [0, π], even in φ
    q2 = qg[:, None] ** 2 + qg[None, :] ** 2
    qq2 = 2.0 * qg[:, None] * qg[None, :]
    out = np.zeros((len(qg), len(qg)))
    chunk = max(1, int(2e7) // max(len(qg) ** 2, 1))
    for s in range(0, n_phi, chunk):
        c = np.cos(phi[s:s + chunk])
        delta = np.sqrt(np.maximum(
            q2[:, :, None] - qq2[:, :, None] * c[None, None, :], 0.0))
        w2 = mask.wtilde2_sq(delta)
        if moment:
            w2 = w2 * np.cos(moment * phi[s:s + chunk])[None, None, :]
        out += w2.sum(axis=2)
    return np.ascontiguousarray(out / n_phi)


@lru_cache(maxsize=16)
def _coupling_matrix_cached(mask, lnq_key, n_phi: int, moment: int = 0):
    return _coupling_matrix_impl(mask, lnq_key, n_phi, moment)


def _coupling_matrix(mask, lnq_key, n_phi: int, moment: int = 0):
    """Cached when the mask is hashable (the frozen dataclasses here
    are, and PixelMask hashes by content); a user mask carrying
    unhashable state falls back to direct computation instead of
    crashing in the lru_cache key."""
    try:
        return _coupling_matrix_cached(mask, lnq_key, n_phi, moment)
    except TypeError:
        return _coupling_matrix_impl(mask, lnq_key, n_phi, moment)


def masked_gaussian_covariance(cl_fn, theta_edges_deg, n2d, mask,
                               n_ell_cov: int = 4096, ell_lo: float = 1.0,
                               ell_hi: float = 1.0e6,
                               n_phi: int | None = None,
                               resolve_factor: float = 4.0):
    """Gaussian + shot-noise covariance of w(theta) bins on a masked
    survey, (B, nb, nb).  ``cl_fn(ells_np) -> C_l`` (B|1, n_ell) tensors
    at the static numpy ells; ``n2d`` galaxies per sr; ``mask`` a
    DiscMask / UniformMask / PixelMask or any object with their surface.
    The full coupling matrix runs below q* = coupling_width /
    (resolve_factor dlnq); the delta limit (A4 with the exact pair
    normalization D_i) above; the pure noise x noise part is the exact
    pair-count closure 2 N^2 D2_i / D_i^2."""
    from chomp_tpu_torch.covariance import _log_ell_weights, bin_averaged_j0

    edges_rad = np.radians(np.asarray(theta_edges_deg, dtype=float))
    a_i = np.pi * (edges_rad[1:] ** 2 - edges_rad[:-1] ** 2)
    d_i = pair_normalization(mask, edges_rad)
    noise = 1.0 / float(n2d)

    ells_np, w_np = _log_ell_weights(n_ell_cov, ell_lo, ell_hi)
    dln = np.log(ells_np[1] / ells_np[0])
    cl = cl_fn(ells_np)
    t = dict(dtype=cl.dtype, device=cl.device)
    wq = torch.as_tensor(ells_np**2 * w_np, **t)
    jb = bin_averaged_j0(torch.as_tensor(ells_np, **t), edges_rad)
    ct = cl + noise
    n_const = torch.full_like(ct, noise)

    width = mask.coupling_width
    n_low = (int(np.searchsorted(ells_np, width / (resolve_factor * dln)))
             if width > 0.0 else 0)
    n_low = min(n_low, n_ell_cov)
    if n_phi is None:
        n_phi = max(96, int(np.pi / (resolve_factor * dln)))

    def quad_full(vec, k_t):
        m = jb[:, :n_low] * (vec[:, :n_low] * wq[:n_low])[:, None, :]
        return (m @ k_t @ m.mT) / (2.0 * math.pi) ** 2

    def quad_delta(vec2):
        m = jb[:, n_low:] * (vec2[:, n_low:] * wq[n_low:])[:, None, :]
        return mask.area4 * (m @ jb[:, n_low:].T) / (2.0 * math.pi)

    cov = quad_delta(ct * ct) - quad_delta(n_const * n_const)
    if n_low >= 2:
        k_t = torch.as_tensor(_coupling_matrix(
            mask, tuple(np.log(ells_np[:n_low])), n_phi), **t)
        cov = cov + quad_full(ct, k_t) - quad_full(n_const, k_t)
    cov = torch.as_tensor(2.0 * np.outer(a_i, a_i) / np.outer(d_i, d_i),
                          **t) * cov
    d2_i = pair_normalization(mask, edges_rad, squared=True)
    return cov + torch.diag(torch.as_tensor(
        2.0 * noise**2 * d2_i / (d_i * d_i), **t))


# --------------------------------------------------------------------------
# Beyond-NKA ingredient (round 5): the field-phase decoherence factor.
# See covariance.gaussian_block (beyond_nka / field_spins) for where it
# enters, covariance._weighted_bin_bessel for the companion exact
# short-kernel delta weights, and the JAX package's
# tools/calibrate_spin2_wedge.py for the masked-sky MC study behind both.
# --------------------------------------------------------------------------


def field_phase_suppression(mask, q, spin: int, n_u: int = 512):
    """S_s(q): decoherence of an UNCOMPENSATED field-phase factor
    e^{i s phi_k} over the mask coupling kernel — the closed-form
    azimuthal means

        m_2(t) = (1 - t^2)_+ ,
        m_4(t) = [(1 - t^2)(1 - 3 t^2)]_+-signed  (t < 1; 0 beyond),

    of e^{i s psi} with psi the angle of (q - u) relative to q,
    averaged over the direction of u (|u| = t q; contour-integral
    closed forms), weighted by the isotropized mask kernel |W~2(u)|²:

        S_s(q) = ∫ u du |W~2(u)|² m_s(u/q) / ∫ u du |W~2(u)|² .

    S -> 1 for q far above the coupling width (field phases ride
    through the narrow kernel) and -> 0 deep inside it (the kernel
    cannot hold a spin-s phase aligned).  Enters the coupled regime of
    spin-2 blocks whose Wick pairing carries field phases the
    estimator phase does not compensate — the xi_+ auto block's
    <gamma gamma><gamma* gamma*> pairing (measured 2-2.4x NKA
    overprediction; tools/calibrate_spin2_wedge.py)."""
    if spin not in (2, 4):
        raise ValueError(f"field_phase_suppression: spin must be 2 or "
                         f"4, got {spin}")
    q = np.asarray(q, dtype=float)
    w_c = mask.coupling_width
    u = np.exp(np.linspace(np.log(w_c * 1e-3), np.log(w_c * 3e2), n_u))
    k_u = mask.wtilde2_sq(u) * u * u          # u du measure on ln grid
    norm = k_u.sum()
    t = u[None, :] / np.maximum(q[:, None], 1e-300)
    t2 = t * t
    if spin == 2:
        m = np.where(t < 1.0, 1.0 - t2, 0.0)
    else:
        m = np.where(t < 1.0, (1.0 - t2) * (1.0 - 3.0 * t2), 0.0)
    return (k_u[None, :] * m).sum(axis=1) / norm
