"""Lattice Limber projection — the w(theta) pipeline's lattice route.

PyTorch counterpart of the JAX package's ``limber_fft.py`` (the direct
convolution, the whitened-FFT convolution of ``limber_cl_fft(conv_method=
"fft")`` and the tomographic spectra).  With u = ln chi and s = ln(ell +
1/2), C(s) = ∫ du
G(u) P(e^{s-u}) is a 1-D convolution of the P lattice (static ln k) with
the window weights G on the matching static ln chi lattice; z(chi) on
that lattice comes from Newton iteration off a static fiducial seed.
The separable route freezes the halo-model shape at one pivot; the
exact-z route expands it over Chebyshev redshift anchors
(:func:`exact_z_anchor_spectra`, one halo-model evaluation over B x J
rows) and convolves J channels per probe row.  The numpy builders (the
lattices, the fiducial tables, the Catmull-Rom s-interpolation, the
composed lattice -> Hankel -> theta-bins operator and the Chebyshev
nodes) are copied from the JAX module; the runtime pieces are batched
torch.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from chomp_tpu_torch import background, correlation
from chomp_tpu_torch.grids import catmull_rom_weights_np
from chomp_tpu_torch.ops.hankel_matmul import full_fp32_matmul
from chomp_tpu_torch.params import C_OVER_H0, CosmoParams, GridSpec, col
from chomp_tpu_torch.projection import (WindowConvergence,
                                        WindowConvergenceIA, dndz)


#: Pre-whitening tilt of the FFT convolution (the JAX ``TILT_ALPHA``):
#: (P k^alpha) convolved with (G chi^alpha), the output untilted by
#: e^(-alpha s), an identity that flattens the output's dynamic range.
TILT_ALPHA = 1.5


def _lattice_key(grid: GridSpec):
    return (grid.lattice_dln, grid.lattice_k_lo, grid.lattice_k_hi,
            grid.lattice_chi_lo, grid.lattice_chi_hi)


@lru_cache(maxsize=None)
def _lattices_from_key(key):
    dln, k_lo, k_hi, chi_lo, chi_hi = key
    n_k = int(np.ceil(np.log(k_hi / k_lo) / dln)) + 1
    ln_k = np.log(k_lo) + dln * np.arange(n_k)
    n_chi = int(np.ceil(np.log(chi_hi / chi_lo) / dln)) + 1
    ln_chi = np.log(chi_lo) + dln * np.arange(n_chi)
    return ln_k, ln_chi


def _lattices(grid: GridSpec):
    """(ln_k, ln_chi) static lattices (numpy)."""
    return _lattices_from_key(_lattice_key(grid))


@lru_cache(maxsize=None)
def _fiducial_chi_table():
    """Dense fiducial flat-LCDM (z, chi(z)) table (numpy, static)."""
    z_dense = np.linspace(0.0, 25.0, 20001)
    ez = np.sqrt(0.278 * (1.0 + z_dense) ** 3 + 0.722)
    dz = z_dense[1] - z_dense[0]
    integrand = 1.0 / ez
    chi_dense = C_OVER_H0 * dz * (np.cumsum(integrand) - 0.5 * integrand
                                  - 0.5 * integrand[0])
    return z_dense, chi_dense


def fiducial_chi_np(z):
    """Static fiducial chi(z) (numpy): sizes static lattice sub-ranges
    from concrete window supports; the per-cosmology distances stay
    exact."""
    z_dense, chi_dense = _fiducial_chi_table()
    return np.interp(np.asarray(z), z_dense, chi_dense)


@lru_cache(maxsize=None)
def _fiducial_z_seed(key, mid: bool = False):
    """Static Newton seed z_fid(chi) at the lattice nodes (or midpoints)."""
    dln = key[0]
    _, ln_chi = _lattices_from_key(key)
    chi = np.exp(ln_chi + (0.5 * dln if mid else 0.0))
    z_dense, chi_dense = _fiducial_chi_table()
    return np.interp(chi, chi_dense, z_dense)


@lru_cache(maxsize=None)
def _fft_len(n: int) -> int:
    """The least power of two >= ``n``."""
    m = 1
    while m < n:
        m *= 2
    return m


@lru_cache(maxsize=None)
def _s_weights(ells_key, ell_offset: float, key):
    """Static Catmull-Rom matrix from the conv output C(s_n) to
    s_ell = ln(ell + offset)."""
    ells = np.asarray(ells_key)
    ln_k, ln_chi = _lattices_from_key(key)
    dln = key[0]
    s0 = ln_k[0] + ln_chi[0]
    n_out = len(ln_k) + len(ln_chi) - 1
    s_ell = np.log(ells + ell_offset)
    return catmull_rom_weights_np(n_out, (s_ell - s0) / dln)


def _used_window(w_full):
    """[j_lo, j_hi): the conv-output positions an s-interpolation matrix
    reads."""
    used = np.nonzero(np.any(w_full != 0.0, axis=0))[0]
    return int(used[0]), int(used[-1]) + 1


@lru_cache(maxsize=None)
def wtheta_lattice_operator(theta_key, grid: GridSpec, mu: float = 0.0,
                            ell_offset: float = 0.5):
    """(j_lo, j_hi, A): the conv-output -> w(theta bins) map as one static
    float64 matrix (Catmull-Rom lattice interpolation composed with the
    Hankel + binning operator), restricted to the conv positions it uses."""
    ells = correlation.ell_grid(grid)[0]
    w_full = _s_weights(tuple(ells.tolist()), ell_offset, _lattice_key(grid))
    j_lo, j_hi = _used_window(w_full)
    bins_op = correlation.wtheta_bins_operator(theta_key, grid, mu)
    return j_lo, j_hi, np.ascontiguousarray(bins_op @ w_full[:, j_lo:j_hi])


def _conv_direct_rows(p_rows, g_rows, j_lo: int, j_hi: int):
    """Paired per-row direct convolution over conv-output positions
    [j_lo, j_hi): ``p_rows`` (B, R, n_k), ``g_rows`` (B, R, n_chi) ->
    (B, R, j_hi - j_lo) in the input dtype (:func:`_conv_direct_rows64`
    rounded once)."""
    return _conv_direct_rows64(p_rows, g_rows, j_lo, j_hi).to(p_rows.dtype)


def _conv_direct_rows64(p_rows, g_rows, j_lo: int, j_hi: int):
    """The float64 sums of :func:`_conv_direct_rows`.  One grouped
    ``conv1d`` (groups = B R); like the JAX code, g is flipped so the
    cross-correlation is a convolution.

    The sum is accumulated in float64 whatever the input dtype:
    PyTorch's grouped float32 conv1d sums the ~1.3k taps in float32,
    measured on an H100 (700 W) at 6.2e-6 worst relative error per
    output on the pipeline's own rows, against ~6e-8 (the output
    rounding) in float64 at +0.8 ms per 512-cosmology batch.  (Its TF32
    switch does not reach this grouped kernel: measured the same error
    with it on.)"""
    b, r, n_k = p_rows.shape
    n_chi = g_rows.shape[-1]
    lhs = p_rows.reshape(1, b * r, n_k).to(torch.float64)
    rhs = g_rows.flip(-1).reshape(b * r, 1, n_chi).to(torch.float64)
    pad_l = n_chi - 1 - j_lo
    pad_r = max(j_hi - n_k, 0)
    lhs = F.pad(lhs, (pad_l, pad_r))
    out = F.conv1d(lhs, rhs, groups=b * r)
    return out[0, :, :j_hi - j_lo].reshape(b, r, j_hi - j_lo)


def _window_on_lattice(cosmo, win, z, chi, st, z_mid):
    """Window values at the lattice nodes, (B, n_chi).  The convergence
    window uses cumulative Simpson in u = ln chi' with the exact-lattice
    midpoints (O(du^4), one reverse cumsum for each inner integral); the
    NLA window adds its local IA term at the nodes to that."""
    if isinstance(win, WindowConvergenceIA):
        kappa = _window_on_lattice(cosmo, WindowConvergence(dist=win.dist),
                                   z, chi, st, z_mid)
        return kappa + win.ia_term_z(cosmo, z, st)
    if isinstance(win, WindowConvergence):
        dln = st.grid.lattice_dln
        chi_mid = chi * float(np.exp(0.5 * dln))

        def q(z_pts, chi_pts):
            p = dndz(win.dist, z_pts, st)
            jac = background.ez(cosmo, z_pts) / C_OVER_H0 * chi_pts
            return p * jac, p * jac / chi_pts

        q1, q2 = q(z, chi)
        q1m, q2m = q(z_mid, chi_mid)
        seg1 = dln / 6.0 * (q1[:, :-1] + 4.0 * q1m[:, :-1] + q1[:, 1:])
        seg2 = dln / 6.0 * (q2[:, :-1] + 4.0 * q2m[:, :-1] + q2[:, 1:])
        zero = torch.zeros_like(q1[:, :1])
        f1 = torch.cat([seg1.flip(-1).cumsum(-1).flip(-1), zero], dim=-1)
        f2 = torch.cat([seg2.flip(-1).cumsum(-1).flip(-1), zero], dim=-1)
        pref = col(1.5 * cosmo.omega_m0 / C_OVER_H0**2, 1)
        return pref * (1.0 + z) * chi * (f1 - chi * f2)
    return win.window_z(cosmo, z, st)


def _lattice_z(cosmo: CosmoParams, st):
    """(chi (1, n_chi), z, z_mid (B, n_chi)) at the lattice nodes and
    midpoints: Newton chi -> z from the static fiducial seeds."""
    chi = st.lattice_chi[None, :]
    n = st.grid.n_dist
    z = background.z_of_chi(cosmo, chi, st.z_seed[None, :], st, n)
    z_mid = background.z_of_chi(
        cosmo, chi * float(np.exp(0.5 * st.grid.lattice_dln)),
        st.z_seed_mid[None, :], st, n)
    return chi, z, z_mid


def _window_rows(cosmo, pairs, st, z, chi, z_mid):
    """W_a W_b / chi * dln on the lattice for each window pair in
    ``pairs``: (B, R, n_chi), each distinct window evaluated once."""
    wins = {}
    for win in (w for pair in pairs for w in pair):
        if id(win) not in wins:
            wins[id(win)] = _window_on_lattice(cosmo, win, z, chi, st, z_mid)
    return torch.stack([wins[id(wa)] * wins[id(wb)] / chi
                        * st.grid.lattice_dln for wa, wb in pairs], dim=1)


class LatticeState:
    """One forward's evaluations on the ln chi lattice, shared by every
    consumer: chi (1, n_chi), the Newton z and z_mid (B, n_chi), the
    separable growth d = D(z) / D_pivot and each distinct window (by
    identity), evaluated the first time it is asked for."""

    def __init__(self, cosmo: CosmoParams, st, growth_pivot):
        self.cosmo, self.st = cosmo, st
        self.chi, self.z, self.z_mid = _lattice_z(cosmo, st)
        self.d = (background.growth_factor(cosmo, self.z, st,
                                           st.grid.n_growth)
                  / col(growth_pivot, 1))
        self._wins = {}

    def window(self, win):
        """``win`` at the lattice nodes, (B, n_chi)."""
        if id(win) not in self._wins:
            self._wins[id(win)] = (win, _window_on_lattice(
                self.cosmo, win, self.z, self.chi, self.st, self.z_mid))
        return self._wins[id(win)][1]

    def g_rows(self, pairs):
        """G(u) = W_a W_b D~^2 / chi * dln of each window pair: (B, R,
        n_chi)."""
        dln = self.st.grid.lattice_dln
        return torch.stack([self.window(wa) * self.window(wb) / self.chi
                            * dln for wa, wb in pairs], dim=1) * (
            self.d * self.d)[:, None]


def _lattice_g_rows(cosmo: CosmoParams, pairs, st, growth_pivot):
    """Limber lattice weights G(u) = W_a W_b D^2 / chi * dln for each
    window pair in ``pairs``: (B, R, n_chi).  The lattice redshifts, the
    growth and each distinct window are evaluated once."""
    return LatticeState(cosmo, st, growth_pivot).g_rows(pairs)


def _ells_window(ells, ell_offset, st):
    """(j_lo, j_hi, S): the conv-output window that the static ``ells``
    read and the Catmull-Rom matrix S (n_ell, j_hi - j_lo) on it."""
    w_full = _s_weights(tuple(np.asarray(ells, dtype=np.float64).tolist()),
                        ell_offset, _lattice_key(st.grid))
    j_lo, j_hi = _used_window(w_full)
    return j_lo, j_hi, torch.as_tensor(w_full[:, j_lo:j_hi], dtype=st.dtype,
                                       device=st.device)


def limber_cl_fft(cosmo: CosmoParams, win_a, win_b, ells, p_lattice, st,
                  ell_offset: float = 0.5, growth_pivot=1.0,
                  conv_method: str = "direct"):
    """Separable C_ell at the static (numpy) ``ells`` from P sampled on
    the k lattice, ``p_lattice`` (B|1, n_k), with the growth pivot
    ``growth_pivot`` (a float or (B,)): (B, n_ell).

    ``conv_method``: "direct" (the grouped direct convolution over the
    output window the ells read) or "fft" (the JAX package's whitened FFT
    convolution: P k^alpha and G chi^alpha through ``torch.fft.rfft`` at
    the next power of two, the product back through ``irfft``, untilted,
    then the full Catmull-Rom matrix).  The JAX package calls the FFT
    route float64-grade only, so it runs in float64 whatever the inputs'
    dtype and rounds once, as the direct route's sums do."""
    if conv_method not in ("direct", "fft"):
        raise ValueError(f"conv_method must be 'direct' or 'fft', got "
                         f"{conv_method!r} (the fft path is float64-grade "
                         "only)")
    piv = torch.as_tensor(growth_pivot, dtype=st.dtype, device=st.device)
    g = _lattice_g_rows(cosmo, [(win_a, win_b)], st, piv)[:, 0]
    p = p_lattice.expand(g.shape[0], -1)
    if conv_method == "fft":
        return _cl_fft_whitened(p, g, ells, ell_offset, st)
    j_lo, j_hi, w = _ells_window(ells, ell_offset, st)
    conv = _conv_direct_rows(p[:, None], g[:, None], j_lo, j_hi)[:, 0]
    with full_fp32_matmul():
        return conv @ w.T


def _cl_fft_whitened(p, g, ells, ell_offset, st):
    """C_ell (B, n_ell) from P (B, n_k) on the k lattice and the window
    weights G (B, n_chi) on the chi lattice by the whitened FFT
    convolution, in float64, rounded once to ``p``'s dtype."""
    ln_k, ln_chi = _lattices(st.grid)
    n_out = len(ln_k) + len(ln_chi) - 1
    nfft = _fft_len(n_out)
    f64 = dict(dtype=torch.float64, device=p.device)
    tilt_p = torch.as_tensor(np.exp(TILT_ALPHA * (ln_k - ln_k[0])), **f64)
    tilt_g = torch.as_tensor(np.exp(TILT_ALPHA * (ln_chi - ln_chi[0])),
                             **f64)
    untilt = torch.as_tensor(
        np.exp(-TILT_ALPHA * np.arange(n_out) * st.grid.lattice_dln), **f64)
    pf = torch.fft.rfft(p.double() * tilt_p, n=nfft, dim=-1)
    gf = torch.fft.rfft(g.double() * tilt_g, n=nfft, dim=-1)
    conv = torch.fft.irfft(pf * gf, n=nfft, dim=-1)[..., :n_out] * untilt
    w = torch.as_tensor(_s_weights(
        tuple(np.asarray(ells, dtype=np.float64).tolist()), ell_offset,
        _lattice_key(st.grid)), **f64)
    return (conv @ w.T).to(p.dtype)


def _cheb_nodes(lo: float, hi: float, n: int):
    """Chebyshev (2nd kind / extrema) nodes on [lo, hi] + barycentric
    weights (numpy, static)."""
    j = np.arange(n)
    x = np.cos(np.pi * j / (n - 1))          # [1, -1]
    z = 0.5 * (lo + hi) + 0.5 * (hi - lo) * x[::-1]
    w = np.ones(n)
    w[1::2] = -1.0
    w[0] *= 0.5
    w[-1] *= 0.5
    # Reversed to ascending z; barycentric weights pick up (-1)^(n-1).
    return z, w[::-1].copy()


def _barycentric_rows(z_query, z_nodes_np, w_np):
    """L_j(z_query): Lagrange basis rows by the barycentric formula,
    (..., n) -> (..., n, J) for the static nodes ``z_nodes_np`` (J,) and
    weights ``w_np``.  A query within 1e-12 of a node is nudged off it,
    as in the JAX code (the nudged row still sums to the hit's basis
    row)."""
    zn = torch.as_tensor(z_nodes_np, dtype=z_query.dtype,
                         device=z_query.device)
    w = torch.as_tensor(w_np, dtype=z_query.dtype, device=z_query.device)
    diff = z_query[..., None] - zn
    diff = torch.where(diff.abs() < 1e-12, 1e-12, diff)
    terms = w / diff
    return terms / terms.sum(-1, keepdim=True)


def _repeat_rows(params, b: int, j: int):
    """``params`` with every field of batch length ``b`` > 1 repeated
    ``j`` times per row, b-major (row b j + i is row b, copy i); 0-d and
    length-1 fields broadcast as before."""
    return dataclasses.replace(params, **{
        k: v.repeat_interleave(j, dim=0) if v.dim() and v.shape[0] == b > 1
        else v for k, v in params.fields().items()})


def exact_z_anchor_models(cosmo, halo_params, hod, n_z_anchor: int,
                          z_anchor_lo: float, z_anchor_hi: float, st):
    """The halo models of :func:`exact_z_anchor_spectra`: (rows, halo
    params, models, z (B J,), z_nodes, w_bary) over B x J rows, row b J +
    j cosmology b at anchor j; ``hod`` one HOD (one model) or a list of
    HODs (one model each, on ONE mass-table build)."""
    from chomp_tpu_torch import halo as halo_mod

    cosmo = cosmo.batched()
    b, j = cosmo.batch, int(n_z_anchor)
    z_nodes, w_bary = _cheb_nodes(z_anchor_lo, z_anchor_hi, j)
    rows = _repeat_rows(cosmo, b, j)
    hp = _repeat_rows(halo_params, b, j)
    z = torch.as_tensor(z_nodes, dtype=st.dtype, device=st.device).repeat(b)
    hods = hod if isinstance(hod, (list, tuple)) else [hod]
    models = halo_mod.build_halo_models(
        rows, hp, [_repeat_rows(h, b, j) for h in hods], z, st)
    return rows, hp, models, z, z_nodes, w_bary


def exact_z_anchor_spectra(cosmo, halo_params, hod, kinds, n_z_anchor: int,
                           z_anchor_lo: float, z_anchor_hi: float, st,
                           matter_power: str = "halo"):
    """Halo spectra on the k lattice at the ``n_z_anchor`` Chebyshev
    redshift anchors on [z_anchor_lo, z_anchor_hi], for every kind in
    ``kinds``, from ONE halo model over B x J rows: row b J + j is
    cosmology b at anchor j, so ``halo.powers`` launches kernel A once
    (the JAX code runs the anchors one after another under ``lax.map``).

    ``hod`` a list of HODs (the per-bin HODs of exact-z tomography):
    their models share one mass-table build over the B x J rows, and
    every sample's galaxy pack folds into the batch as row (b J + j) L +
    i (``halo.tomographic_powers``), so the L samples still take ONE
    kernel A launch, over B x J x L rows (the JAX code runs one anchor
    sweep per HOD).  The spectra are then keyed "power_mm" (sample 0's),
    ("power_gg", i, i) and ("power_gm", i), those whose kind is in
    ``kinds``.

    ``matter_power`` "halofit" or "linear" swaps the power_mm anchors
    (halofit or the linear power at each anchor row, B x J rows); gg and
    gm stay the halo model's.

    Returns dict(p_j={kind: (B, J, n_k)}, d_j (B, J) the growth at the
    anchors, z_nodes and w_bary (numpy), z_lo and z_hi)."""
    from chomp_tpu_torch import halo as halo_mod

    if matter_power not in ("halo", "halofit", "linear"):
        raise ValueError(f"matter_power must be halo|halofit|linear, got "
                         f"{matter_power!r}")
    b = cosmo.batched().batch
    rows, hp, models, z, z_nodes, w_bary = exact_z_anchor_models(
        cosmo, halo_params, hod, n_z_anchor, z_anchor_lo, z_anchor_hi, st)
    if isinstance(hod, (list, tuple)):
        p_all = halo_mod.tomographic_powers(rows, hp, models, st.lattice_k,
                                            st, with_cross=False)
    else:
        p_all = halo_mod.powers(rows, hp, models[0], st.lattice_k, st)
    p_all = {key: v for key, v in p_all.items()
             if (key if isinstance(key, str) else key[0]) in kinds}
    if "power_mm" in p_all and matter_power != "halo":
        p_all["power_mm"] = mm_override(rows, z, matter_power, st)
    j = len(z_nodes)
    return dict(p_j={k: v.reshape(b, j, -1) for k, v in p_all.items()},
                d_j=models[0].mass.growth.reshape(b, j), z_nodes=z_nodes,
                w_bary=w_bary, z_lo=float(z_anchor_lo),
                z_hi=float(z_anchor_hi))


def exact_z_g_rows(cosmo, anchors, pairs, st):
    """Per-anchor lattice weights for each window pair of ``pairs``:
    (B, R, J, n_chi),

        G_j(u) = W_a W_b / chi du * D(z_u)^2 L_j(z_u) / D_j^2,

    L_j the Lagrange basis at z_u clipped into the anchor window (the
    growth keeps the exact z_u).  The lattice z, the growth, the basis
    rows and each distinct window are evaluated once."""
    chi, z_u, z_mid = _lattice_z(cosmo, st)
    d_u = background.growth_factor(cosmo, z_u, st, st.grid.n_growth)
    lag = _barycentric_rows(torch.clamp(z_u, anchors["z_lo"],
                                        anchors["z_hi"]),
                            anchors["z_nodes"], anchors["w_bary"])
    g0 = _window_rows(cosmo, pairs, st, z_u, chi, z_mid) * (d_u * d_u)[:, None]
    d_j = anchors["d_j"]
    return (g0[:, :, None] * lag.transpose(1, 2)[:, None]
            / (d_j * d_j)[:, None, :, None])


def anchor_conv(p_j, g_j, j_lo: int, j_hi: int):
    """sum_j conv(P_j, G_j) over conv-output positions [j_lo, j_hi):
    ``p_j`` (B, R, J, n_k), ``g_j`` (B, R, J, n_chi) -> (B, R, j_hi -
    j_lo) in ``p_j``'s dtype.  All rows' anchors go through ONE grouped
    convolution (B R J groups), summed over j in float64 and rounded
    once."""
    b, r, j, n_chi = g_j.shape
    conv = _conv_direct_rows64(p_j.reshape(b, r * j, -1),
                               g_j.reshape(b, r * j, n_chi), j_lo, j_hi)
    return conv.reshape(b, r, j, -1).sum(2).to(p_j.dtype)


def exact_z_conv_rows(cosmo, anchors, rows, st, j_lo: int, j_hi: int):
    """The Chebyshev-anchored lattice convolution for each probe row of
    ``rows`` (win_a, win_b, source): (B, R, j_hi - j_lo), in the anchors'
    dtype (:func:`exact_z_g_rows`, then :func:`anchor_conv`).  A row's
    source is a key of ``anchors["p_j"]`` or its own anchor spectra (B,
    J, n_k) (exact-z tomography: lens bin i's gg / gm, the shared mm)."""
    g_j = exact_z_g_rows(cosmo, anchors, [(wa, wb) for wa, wb, _k in rows],
                         st)
    p_j = torch.stack([src if torch.is_tensor(src) else anchors["p_j"][src]
                       for _wa, _wb, src in rows], dim=1)
    return anchor_conv(p_j, g_j, j_lo, j_hi)


def limber_cl_fft_exact_z(cosmo, halo_params, hod, win_a, win_b, ells, st,
                          kind: str = "power_gg", n_z_anchor: int = 8,
                          z_anchor_lo: float = 1e-3, z_anchor_hi: float = 3.0,
                          ell_offset: float = 0.5):
    """Limber C_ell at the static (numpy) ``ells`` with the halo model's
    exact redshift evolution (Chebyshev anchors, see
    :func:`exact_z_g_rows`): (B, n_ell)."""
    anchors = exact_z_anchor_spectra(cosmo, halo_params, hod, (kind,),
                                     n_z_anchor, z_anchor_lo, z_anchor_hi, st)
    j_lo, j_hi, w = _ells_window(ells, ell_offset, st)
    conv = exact_z_conv_rows(cosmo, anchors, [(win_a, win_b, kind)], st,
                             j_lo, j_hi)[:, 0]
    with full_fp32_matmul():
        return conv @ w.T


def limber_wtheta_fft_exact_z(cosmo, halo_params, hod, win_a, win_b,
                              theta_deg, st, kind: str = "power_gg",
                              n_z_anchor: int = 8, z_anchor_lo: float = 1e-3,
                              z_anchor_hi: float = 3.0, mu: float = 0.0,
                              ell_offset: float = 0.5):
    """w(theta bins) (mu 0) / gamma_t (mu 2) with the halo model's exact
    redshift evolution: the anchored convolution through the composed
    lattice -> Hankel -> bins operator and kernel C, (B, n_theta)."""
    anchors = exact_z_anchor_spectra(cosmo, halo_params, hod, (kind,),
                                     n_z_anchor, z_anchor_lo, z_anchor_hi, st)
    return limber_wtheta_from_anchors(cosmo, anchors, win_a, win_b,
                                      theta_deg, kind, st, mu, ell_offset)


def limber_wtheta_from_anchors(cosmo, anchors, win_a, win_b, theta_deg,
                               kind: str, st, mu: float = 0.0,
                               ell_offset: float = 0.5):
    """Exact-z w(theta bins) / gamma_t (B, n_theta) from prebuilt anchor
    spectra: :func:`exact_z_conv_rows`, then kernel C on the float64
    operator (float32: its hi/lo split)."""
    from chomp_tpu_torch.ops.df32 import df_contract, split_operator

    theta_key = tuple(np.asarray(theta_deg, dtype=np.float64).tolist())
    j_lo, j_hi, a_np = wtheta_lattice_operator(theta_key, st.grid, mu,
                                               ell_offset)
    conv = exact_z_conv_rows(cosmo, anchors, [(win_a, win_b, kind)], st,
                             j_lo, j_hi)[:, 0]
    if conv.dtype == torch.float64:
        ops = (torch.as_tensor(a_np, device=st.device), None)
    else:
        ops = (torch.as_tensor(x, device=st.device)
               for x in split_operator(a_np))
    return df_contract(conv.contiguous(), *ops)


def p_lattice_halo_all(cosmo, halo_params, model, st):
    """All halo-model spectra on the static k lattice (one evaluation)."""
    from chomp_tpu_torch import halo as halo_mod

    return halo_mod.powers(cosmo, halo_params, model, st.lattice_k, st)


def p_lattice_tomographic(cosmo, halo_params, models, st,
                          with_cross: bool = True):
    """Per-sample spectra on the k lattice for halo models sharing one
    mass-table build (:func:`halo.tomographic_powers`, one kernel A
    launch for every sample): keys "power_mm", ("power_gm", i),
    ("power_gg", i, i) and, with ``with_cross``, ("power_gg", i, j) for
    i < j."""
    from chomp_tpu_torch import halo as halo_mod

    return halo_mod.tomographic_powers(cosmo, halo_params, models,
                                       st.lattice_k, st,
                                       with_cross=with_cross)


def p_lattice_halo(cosmo, halo_params, model, kind: str, st):
    """One halo-model spectrum on the k lattice, (B, n_k)."""
    return p_lattice_halo_all(cosmo, halo_params, model, st)[kind]


def p_lattice_linear(cosmo, st):
    """Linear P(k, z = 0) on the k lattice, (B, n_k), with the statics'
    transfer (``st.with_bao``)."""
    from chomp_tpu_torch import linear

    z = torch.zeros(1, dtype=st.dtype, device=st.device)
    return linear.linear_power(cosmo, st.lattice_k[None, :], z, st)


def mm_override(cosmo, z, matter_power: str, st):
    """The power_mm lattice row of ``matter_power`` "halofit" or "linear"
    at redshift ``z`` ((B|1,)), (B, n_k): the mm leg that the pipelines'
    ``matter_power`` option puts in place of the halo model's."""
    from chomp_tpu_torch import linear, nlpower

    if matter_power == "halofit":
        return nlpower.p_lattice_halofit(cosmo, z, st)
    if matter_power == "linear":
        return linear.linear_power(cosmo, st.lattice_k[None, :], z, st)
    raise ValueError(f"matter_power must be halofit|linear, got "
                     f"{matter_power!r}")

