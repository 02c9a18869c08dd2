"""Exact (non-Limber) low-multipole C_ell corrections, with the linear RSD
term of the galaxy leg.

PyTorch counterpart of the JAX package's ``nonlimber.py``: the exact
curved-sky projection

    C_ell^AB = (2/pi) ∫ k^2 dk P_AB(k) F_ell^A(k) F_ell^B(k),
    F_ell(k) = ∫ dchi f(chi) j_ell(k chi),   f = W(chi) D~(chi),

in the pipelines' separable approximation, returned as the difference
dC_ell = C^exact - C^Limber at ~20 real multipole nodes uniform in
ln(ell + 1/2), and carried into w(theta) / gamma_t by a static
(n_theta, n_nodes) correction operator (flat J_mu sums, or curved
Legendre / d^l_20 sums).  F_ell comes from FFTLog with the analytic
Mellin kernels of j_ell: the window samples on the static ln chi lattice
go through one rfft, the static complex kernel rows and one irfft, whose
output lands on the k lattice; ``torch.fft`` does both transforms.

The numpy builders (Mellin kernels, node multipoles, kernel rows and the
correction operators) are copied from the JAX module.  The contractions
that the JAX package runs at ``Precision.HIGHEST`` (the exact-leg
k-quadratures and the correction matmul) run in float64 here whatever
the pipeline's dtype, and the Limber leg's convolution sums are kept in
float64: dC is a difference of two near-equal C's as ell approaches the
switch.  :class:`Corrections` is the pipelines' engine: it evaluates each
window's transfers once per forward on a shared
:class:`~chomp_tpu_torch.limber_fft.LatticeState`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from chomp_tpu_torch import background, limber_fft, linear
from chomp_tpu_torch.grids import catmull_rom_weights_np
from chomp_tpu_torch.params import CosmoParams

#: FFTLog bias q (the windows are compactly supported: no tilt needed).
_Q = 0.0
#: Low-pass fraction of the log-Fourier modes (anti-ringing window).
_CWIN = 0.25
#: The k range of the exact leg's quadrature, h/Mpc.
K_LO_CUT, K_HI_CUT = 3e-5, 4.0


def mellin_jl(ell, s):
    """I_ell(s) = ∫_0^inf x^{s-1} j_ell(x) dx (numpy, complex s):
    2^{s-2} sqrt(pi) Gamma((ell+s)/2) / Gamma((ell-s+3)/2), valid for
    -ell < Re s < 2."""
    from scipy.special import loggamma

    ell = np.asarray(ell, dtype=float)
    s = np.asarray(s, dtype=complex)
    return np.exp((s - 2.0) * np.log(2.0) + 0.5 * np.log(np.pi)
                  + loggamma((ell + s) / 2.0)
                  - loggamma((ell - s + 3.0) / 2.0))


def _exact_prefactor(kind: str, ells: np.ndarray) -> np.ndarray:
    ells = np.asarray(ells, dtype=float)
    if kind in ("d", "d_rsd"):
        return np.ones_like(ells)
    if kind == "k_flat":
        return (ells + 0.5) ** 2
    if kind == "k_E":
        return np.sqrt((ells + 2.0) * (ells + 1.0) * ells * (ells - 1.0))
    raise ValueError(f"unknown nonlimber leg kind {kind!r}")


def _limber_prefactor(kind: str, ells: np.ndarray) -> np.ndarray:
    ells = np.asarray(ells, dtype=float)
    if kind in ("d", "k_flat"):
        return np.ones_like(ells)
    if kind == "k_E":
        return np.sqrt((ells + 2.0) * (ells - 1.0) / (ells * (ells + 1.0)))
    raise ValueError(f"unknown nonlimber leg kind {kind!r}")


def ell_nodes(ell_switch: int, n_nodes: int = 20) -> np.ndarray:
    """Real multipole nodes uniform in ln(ell + 1/2) from 2 to
    ``ell_switch``."""
    x = np.linspace(np.log(2.5), np.log(ell_switch + 0.5), n_nodes)
    return np.exp(x) - 0.5


@lru_cache(maxsize=None)
def _nl_static(lattice_key, ells_key, kind: str, k_lo_cut: float,
               k_hi_cut: float):
    """Static FFTLog rows of one leg kind at the node multipoles: (kern
    (L, npad/2 + 1) complex128, i_lo, n_use, npad).  ``kern`` folds
    I_ell, the exact-leg prefactor, the anti-ringing low-pass, the phase
    that lands F on the k lattice from index ``i_lo`` and 1/npad."""
    ln_k, ln_chi = limber_fft._lattices_from_key(lattice_key)
    dln = lattice_key[0]
    n_chi = len(ln_chi)
    npad = 1
    while npad < 2 * n_chi:
        npad *= 2
    eta = 2.0 * np.pi * np.arange(npad // 2 + 1) / (npad * dln)
    s = _Q + 1.0 + 1j * eta
    ells = np.asarray(ells_key, dtype=float)
    if kind == "d":
        i_l = mellin_jl(ells[:, None], s[None, :])
    elif kind == "d_rsd":
        # -j_ell'' from the Bessel ODE and the downward recurrence: three
        # shifted Mellin rows.
        le = ells[:, None]
        sv = s[None, :]
        i_l = -((le + 1.0) * (le + 2.0) * mellin_jl(le, sv - 2.0)
                - mellin_jl(le, sv)
                - 2.0 * mellin_jl(le - 1.0, sv - 1.0))
    else:
        i_l = mellin_jl(ells[:, None], s[None, :] - 2.0)
    i_l = i_l * _exact_prefactor(kind, ells)[:, None]
    x = np.arange(eta.size) / max(eta.size - 1, 1)
    wlp = np.ones_like(x)
    hi = x > 1.0 - _CWIN
    wlp[hi] = 0.5 * (1.0 + np.cos(np.pi * (x[hi] - (1.0 - _CWIN)) / _CWIN))
    i_lo = int(np.searchsorted(ln_k, np.log(k_lo_cut)))
    i_hi = int(np.searchsorted(ln_k, np.log(k_hi_cut)))
    n_use = min(i_hi - i_lo, npad)
    v0 = ln_k[i_lo]
    phase = np.exp(-1j * eta * (v0 + ln_chi[0]))
    kern = np.conj(i_l * (wlp * phase)[None, :] / npad)
    return kern, i_lo, n_use, npad


@lru_cache(maxsize=None)
def _k_quadrature(lattice_key, i_lo: int, n_use: int):
    """(k_sub, w_quad) numpy: the k-lattice subset of the exact leg and
    its trapezoid weights (2/pi) k^3 dln."""
    ln_k, _ = limber_fft._lattices_from_key(lattice_key)
    k_sub = np.exp(ln_k[i_lo:i_lo + n_use])
    w_quad = (2.0 / np.pi) * k_sub**3 * lattice_key[0]
    w_quad[0] *= 0.5
    w_quad[-1] *= 0.5
    return k_sub, w_quad


@lru_cache(maxsize=None)
def _device_rows(lattice_key, ells_key, kind: str, cuts, device, dtype):
    """The kernel rows of :func:`_nl_static` (complex, of ``dtype``'s
    precision) and the output factor k^-(q+1) on the k subset (``dtype``),
    on ``device``: copied there once, not in every forward."""
    kern, i_lo, n_use, npad = _nl_static(lattice_key, ells_key, kind, *cuts)
    k_sub, _ = _k_quadrature(lattice_key, i_lo, n_use)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return (torch.as_tensor(kern, dtype=cdtype, device=device),
            torch.as_tensor(k_sub ** (-(_Q + 1.0)), dtype=dtype,
                            device=device), n_use, npad)


def _transfer(f_lattice, kern, k_factor, n_use: int, npad: int):
    """F_ell on the k-lattice subset from window samples ``f_lattice``
    (..., n_chi): (..., L, n_use), in ``f_lattice``'s dtype; ``kern`` and
    ``k_factor`` from :func:`_device_rows`."""
    n_chi = f_lattice.shape[-1]
    c = torch.fft.rfft(F.pad(f_lattice, (0, npad - n_chi)), dim=-1)
    b = torch.conj(c)[..., None, :] * kern
    big = torch.fft.irfft(b, n=npad, dim=-1) * npad
    return big[..., :n_use] * k_factor


@lru_cache(maxsize=None)
def _limber_rows(ells_key, lattice_key, ell_offset: float, device):
    """(j_lo, j_hi, S) of the Catmull-Rom interpolation from the lattice
    convolution to the static ``ells_key``, S float64 on ``device``."""
    w_full = limber_fft._s_weights(ells_key, ell_offset, lattice_key)
    j_lo, j_hi = limber_fft._used_window(w_full)
    return j_lo, j_hi, torch.as_tensor(w_full[:, j_lo:j_hi],
                                       dtype=torch.float64, device=device)


@lru_cache(maxsize=None)
def _limber_pref(ells_key, kinds, device):
    """The Limber leg's per-node prefactor of the leg kinds, float64 on
    ``device``."""
    ells = np.asarray(ells_key)
    return torch.as_tensor(_limber_prefactor(kinds[0], ells)
                           * _limber_prefactor(kinds[1], ells),
                           dtype=torch.float64, device=device)


@lru_cache(maxsize=None)
def _quad_rows(lattice_key, i_lo: int, n_use: int, device, dtype):
    """(k_sub in ``dtype``, w_quad float64) on ``device``."""
    k_sub, w_quad = _k_quadrature(lattice_key, i_lo, n_use)
    return (torch.as_tensor(k_sub, dtype=dtype, device=device),
            torch.as_tensor(w_quad, dtype=torch.float64, device=device))


class Corrections:
    """The non-Limber engine of one forward: node multipoles ``ells``
    (numpy), the lattice state ``lat`` (separable growth at the pivot),
    and each (window, leg kind) transfer computed once.

    :meth:`delta` gives dC = exact - Limber at the nodes and :meth:`rsd`
    the linear RSD term, both (B, L) in float64."""

    def __init__(self, lat, ells, k_lo_cut: float = K_LO_CUT,
                 k_hi_cut: float = K_HI_CUT, ell_offset: float = 0.5):
        self.lat, self.st = lat, lat.st
        self.key = limber_fft._lattice_key(self.st.grid)
        self.ells_key = tuple(np.asarray(ells, dtype=float).tolist())
        self.cuts = (float(k_lo_cut), float(k_hi_cut))
        self.ell_offset = ell_offset
        _k, self.i_lo, self.n_use, _n = _nl_static(self.key, self.ells_key,
                                                   "d", *self.cuts)
        self.k_sub, self.w_quad = _quad_rows(self.key, self.i_lo, self.n_use,
                                             self.st.device, self.st.dtype)
        self._f = {}

    def transfer(self, win, kind: str):
        """F_ell of ``win`` (x f(z) for "d_rsd", x D~) for leg ``kind``:
        (B, L, n_use), computed in the pipeline's dtype and kept in
        float64 for the contractions."""
        key = (id(win), kind)
        if key not in self._f:
            rows = _device_rows(self.key, self.ells_key, kind, self.cuts,
                                self.st.device, self.st.dtype)
            f = self.lat.window(win)
            if kind == "d_rsd":
                f = f * background.growth_rate(self.lat.cosmo, self.lat.z,
                                               self.st,
                                               self.st.grid.n_growth)
            f = _transfer(f * self.lat.d, *rows)
            self._f[key] = (win, f.double())
        return self._f[key][1]

    def p_sub(self, p_lattice):
        """The k-lattice subset of a lattice row, (B, n_use)."""
        return p_lattice[..., self.i_lo:self.i_lo + self.n_use]

    def exact(self, win_a, win_b, p_lattice, kinds):
        """The exact-leg C_ell at the nodes, (B, L) float64."""
        fa = self.transfer(win_a, kinds[0])
        fb = (fa if win_b is win_a and kinds[1] == kinds[0]
              else self.transfer(win_b, kinds[1]))
        pw = self.p_sub(p_lattice).double() * self.w_quad
        return torch.einsum("bln,bln,bn->bl", fa, fb, pw)

    def limber(self, rows):
        """The Limber legs of ``rows`` [(win_a, win_b, p_lattice, kinds)]
        at the nodes, each with its leg prefactors: (B, R, L) float64,
        from one grouped convolution (float64 sums)."""
        dev = self.st.device
        j_lo, j_hi, s = _limber_rows(self.ells_key, self.key,
                                     self.ell_offset, dev)
        g = self.lat.g_rows([(wa, wb) for wa, wb, _p, _k in rows])
        p = torch.stack([q.expand(g.shape[0], -1) for _a, _b, q, _k in rows],
                        dim=1)
        conv = limber_fft._conv_direct_rows64(p, g, j_lo, j_hi)
        pref = torch.stack([_limber_pref(self.ells_key, tuple(kinds), dev)
                            for _a, _b, _p, kinds in rows])
        return conv @ s.T * pref

    def delta(self, rows):
        """dC = exact - Limber at the nodes for each row of ``rows``
        [(win_a, win_b, p_lattice, kinds)]: [(B, L) float64]."""
        li = self.limber(rows)
        return [self.exact(wa, wb, p, kinds) - li[:, r]
                for r, (wa, wb, p, kinds) in enumerate(rows)]

    def p_lin(self, growth_pivot):
        """The linear P at the pivot epoch on the k subset, (B, n_use)
        float64: P_lin(k, 0) D_pivot^2 (the legs carry D / D_pivot)."""
        st = self.st
        z0 = torch.zeros(1, dtype=st.dtype, device=st.device)
        p = linear.linear_power(self.lat.cosmo, self.k_sub[None, :], z0, st)
        piv = torch.as_tensor(growth_pivot, dtype=st.dtype, device=st.device)
        return (p * piv.reshape(-1, 1) ** 2).double()

    def rsd(self, win_g, win_other, kind_other: str, h_m, h_g, p_lin):
        """The linear Kaiser RSD term at the nodes, (B, L) float64:

          gg:      (2/pi) ∫ k^2 dk P_lin [2 h_g F_d F_r + F_r^2],
          g-other: (2/pi) ∫ k^2 dk P_lin h_m F_other F_r,

        ``kind_other`` "d" for gg (``win_other`` is ``win_g``), or
        "k_flat" / "k_E" for gamma_t.  ``h_m``, ``h_g``: the two-halo
        integrals on the k lattice (B, n_k) (kernel A's launch of the
        forward); ``p_lin``: :meth:`p_lin`."""
        f_r = self.transfer(win_g, "d_rsd")
        if kind_other == "d":
            f_d = self.transfer(win_g, "d")
            h = self.p_sub(h_g).double()[:, None]
            integ = (2.0 * h * f_d + f_r) * f_r
        else:
            f_o = self.transfer(win_other, kind_other)
            integ = self.p_sub(h_m).double()[:, None] * f_o * f_r
        return torch.einsum("bln,bn->bl", integ, p_lin * self.w_quad)


def nonlimber_cl_pair(cosmo: CosmoParams, win_a, win_b, p_kind_lattice,
                      ells, st, kinds=("d", "d"), growth_pivot=1.0,
                      k_lo_cut: float = K_LO_CUT, k_hi_cut: float = K_HI_CUT,
                      ell_offset: float = 0.5):
    """(C_ell^exact, C_ell^Limber), (B, n_ell) float64 each, at the static
    ``ells``: both legs on the same lattice row ``p_kind_lattice`` (B|1,
    n_k), the Limber leg with the per-ell prefactor of ``kinds``."""
    piv = torch.as_tensor(growth_pivot, dtype=st.dtype, device=st.device)
    nl = Corrections(limber_fft.LatticeState(cosmo, st, piv), ells,
                     k_lo_cut, k_hi_cut, ell_offset)
    row = (win_a, win_b, p_kind_lattice, tuple(kinds))
    return nl.exact(*row), nl.limber([row])[:, 0]


def delta_cl_nodes(cosmo: CosmoParams, win_a, win_b, p_kind_lattice,
                   ell_switch: int, st, kinds=("d", "d"), growth_pivot=1.0,
                   n_nodes: int = 20, **kw):
    """dC = exact - Limber at ``ell_nodes(ell_switch, n_nodes)``, (B, n)
    float64."""
    ex, li = nonlimber_cl_pair(cosmo, win_a, win_b, p_kind_lattice,
                               ell_nodes(ell_switch, n_nodes), st, kinds,
                               growth_pivot, **kw)
    return ex - li


def rsd_delta_cl_nodes(cosmo: CosmoParams, halo_p, model, win_g, win_other,
                       ell_switch: int, st, kind_other: str = "d",
                       growth_pivot=1.0, n_nodes: int = 20,
                       k_lo_cut: float = K_LO_CUT,
                       k_hi_cut: float = K_HI_CUT):
    """The linear RSD term at the nodes (see :meth:`Corrections.rsd`),
    (B, n) float64, with the two-halo integrals of ``model`` from one
    kernel A launch on the k lattice."""
    from chomp_tpu_torch import halo

    piv = torch.as_tensor(growth_pivot, dtype=st.dtype, device=st.device)
    nl = Corrections(limber_fft.LatticeState(cosmo, st, piv),
                     ell_nodes(ell_switch, n_nodes), k_lo_cut, k_hi_cut)
    h_m, h_g = halo.contractions(cosmo, halo_p, model, st.lattice_k, st)[:2]
    return nl.rsd(win_g, win_other, kind_other, h_m, h_g, nl.p_lin(piv))


@lru_cache(maxsize=None)
def correction_operator(theta_key, mu: float, ell_switch: int,
                        n_nodes: int = 20, geometry: str = "flat",
                        taper_frac: float = 0.3, bin_average: bool = False):
    """Static (n_theta, n_nodes) float64 matrix (numpy) carrying dC at the
    nodes into w (``mu`` 0) or gamma_t (``mu`` 2): Catmull-Rom onto the
    integers 2..ell_switch, a cosine taper over the top ``taper_frac``,
    then the flat sum l J_mu(l theta) / (2 pi) or the curved sum
    (2l+1)/(4 pi) X_l (X = P_l, or d^l_20).  ``theta_key``: theta in
    degrees, or bin edges with ``bin_average`` (curved only)."""
    theta = np.asarray(theta_key, dtype=float)
    theta_rad = np.radians(theta)
    ints = np.arange(2, ell_switch + 1, dtype=float)
    x_nodes = np.linspace(np.log(2.5), np.log(ell_switch + 0.5), n_nodes)
    dx = x_nodes[1] - x_nodes[0]
    cr = catmull_rom_weights_np(n_nodes,
                                (np.log(ints + 0.5) - x_nodes[0]) / dx)
    tap = np.ones_like(ints)
    l_t = (1.0 - taper_frac) * ell_switch
    hi = ints > l_t
    tap[hi] = 0.5 * (1.0 + np.cos(np.pi * (ints[hi] - l_t)
                                  / (ell_switch - l_t)))
    if geometry == "flat":
        if bin_average:
            raise NotImplementedError(
                "bin_average correction is curved-route only (the flat"
                " pipelines predict at theta points)")
        from scipy.special import jv

        geo = (ints[None, :] * jv(mu, ints[None, :] * theta_rad[:, None])
               / (2.0 * np.pi))
    elif geometry == "curved":
        from chomp_tpu_torch.curved import (_legendre_all, _wigner_d_matrix,
                                            legendre_bin_factors,
                                            legendre_bin_factors_spin2)

        if bin_average:
            bf = (legendre_bin_factors if mu == 0
                  else legendre_bin_factors_spin2)
            b = bf(ell_switch, theta_rad)[:, 2:]
        elif mu == 0:
            b = _legendre_all(ell_switch, np.cos(theta_rad)).T[:, 2:]
        else:
            b = _wigner_d_matrix(2, 0, ell_switch,
                                 np.cos(theta_rad)).T[:, 2:]
        geo = b * ((2.0 * ints + 1.0) / (4.0 * np.pi))[None, :]
    else:
        raise ValueError(f"geometry must be flat|curved, got {geometry!r}")
    return np.ascontiguousarray((geo * tap[None, :]) @ cr)
