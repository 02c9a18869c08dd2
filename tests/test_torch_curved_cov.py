"""Parity of the port's curved-sky covariance stack against the JAX
package, float64 on the CPU: the curved masks and their geometry (pair
functions, spherical pair counts, the Ξ coupling matrices, HEALPix
ingestion), the Gaussian blocks, the curved super-sample variance and
blocks, the connected blocks with exact sphere bin factors, the joint,
3x2pt and tomographic builders, the B-mode null test, and the JAX
tests' structural checks on the port (tests/test_curved.py:107, :135,
:157, :255, :440, :457, :484, :513, :1031, :1230; tests/test_ssc.py:81,
:94).

The inputs are tests/torch_cov_cases.py's (small grid, three cosmologies;
CURVED: a 30-degree cap and a two-cap pixel map, l <= 256 with the dense
coupling to 64); the JAX values of the blocks and builders are the
``tiny`` block of tests/data/torch_cov_more_reference.json, the numpy
geometry and the analytic-C_ell blocks are computed live.

Tolerances: the geometry is the JAX package's numpy code, equal to 1e-13;
1e-12 of the peak where no trispectrum enters (Gaussian blocks,
sigma_b^2, super-sample blocks; measured ~1e-15); 1e-6 of a connected
block's peak and 1e-7 of an assembled matrix's block peaks (T̄'s K13
cancellation noise, ROADMAP queue 3); the structural checks at the JAX
tests' own tolerances.
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL_GEOM = 1e-13
TOL = 1e-12
TOL_CNG = 1e-6
TOL_TOTAL = 1e-7
EDGES_DEG = np.array([0.05, 0.1, 0.2, 0.4])


def cl_powerlaw(ells):
    e = np.asarray(ells, dtype=float)
    return torch.as_tensor(1.0e-6 / (1.0 + (e / 100.0) ** 1.4))[None]


def cl_powerlaw_jax(ells):
    return jnp.asarray(cl_powerlaw(ells)[0].numpy())


def _cap_weight_map(n_ring, n_phi, radius_rad, center=(0.0, 0.0)):
    """Binary cap indicator on the iso-latitude grid (any center)."""
    th = (np.arange(n_ring) + 0.5) * np.pi / n_ring
    ph = np.arange(n_phi) * 2 * np.pi / n_phi
    ct0, st0 = np.cos(center[0]), np.sin(center[0])
    mu = ct0 * np.cos(th)[:, None] \
        + st0 * np.sin(th)[:, None] * np.cos(ph[None, :] - center[1])
    return (mu >= np.cos(radius_rad)).astype(float)


def _masks(mod):
    cap, pix = C.curved_masks(mod)
    th = np.linspace(0.0, np.radians(30.0), 400)
    profile = mod.ProfileCurvedMask(th, np.clip(1.5 - th / 0.4, 0.0, 1.0),
                                    lmax_mask=256)
    return {"cap": cap, "pixel": pix, "profile": profile,
            "uniform": mod.UniformSphereMask()}


@pytest.fixture(scope="module")
def masks():
    from chomp_tpu import curved as jcur
    from chomp_tpu_torch import curved as pcur

    return _masks(jcur), _masks(pcur)


@pytest.mark.parametrize("name", ["cap", "pixel", "profile", "uniform"])
def test_mask_geometry_matches_jax(masks, name):
    """Areas, coupling width, both pair functions, xi_W2, the spherical
    pair counts (W and W^2) and every Ξ kind with both weights equal the
    JAX package's."""
    from chomp_tpu import curved as jcur
    from chomp_tpu_torch import curved as pcur

    jm, pm = masks[0][name], masks[1][name]
    for attr in ("area2", "area4", "coupling_ell"):
        assert getattr(pm, attr) == pytest.approx(getattr(jm, attr),
                                                  rel=TOL_GEOM, abs=0)
    th = np.linspace(0.0, np.pi, 181)
    mu = np.linspace(-1.0, 1.0, 101)
    for fn, x in (("pair_function", th), ("pair_function2", th),
                  ("xi_w2", mu)):
        np.testing.assert_allclose(getattr(pm, fn)(x), getattr(jm, fn)(x),
                                   rtol=TOL_GEOM, atol=0)
    edges = np.radians(C.CURVED["edges_deg"])
    for sq in (False, True):
        np.testing.assert_allclose(
            pcur.curved_pair_normalization(pm, edges, squared=sq),
            jcur.curved_pair_normalization(jm, edges, squared=sq),
            rtol=TOL_GEOM)
    split = C.CURVED["ell_split"]
    assert pcur._auto_ell_split(pm, 256) == jcur._auto_ell_split(jm, 256)
    if name == "uniform":
        return
    kinds = ("0", "2", "P", "Q", "M")
    for weight in ("W2", "W"):
        got = pcur._xi_matrices(pm, split, kinds, weight)
        want = jcur._xi_matrices(jm, split, kinds, weight)
        for k in kinds:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TOL_GEOM * np.abs(want[k]).max())


@pytest.mark.parametrize("codes", [
    (0, 0, "nn"), (0, 2, "n"), (2, 2, "nn"), ("xip", "xip", "nn"),
    ("xip", "xim", "quad"), (0, "xim", "zero"), (2, "xip", "n")])
def test_curved_gaussian_block_matches_jax(masks, codes):
    """curved_gaussian_block against the JAX function on the cap with an
    analytic C_l: every estimator-code family and its Ξ kernel, the noise
    closure, nn_quadrature; 1e-12 of the peak.  A batch of two C_l rows
    gives the rows' own blocks."""
    from chomp_tpu import curved as jcur
    from chomp_tpu_torch import curved as pcur

    mu_i, mu_j, noise = codes
    jm, pm = masks[0]["cap"], masks[1]["cap"]
    n = {"nn": (1e-8, 2e-8, 1e-8, 2e-8), "n": (1e-8, 0.0, 0.0, 1e-8),
         "quad": (1e-8, 1e-8, 1e-8, 1e-8), "zero": (0.0,) * 4}[noise]
    extra = {"nn_quadrature": True} if noise == "quad" else {}
    kw = dict(ell_max=C.CURVED["ell_max"], ell_split=C.CURVED["ell_split"],
              **extra)
    edges = C.CURVED["edges_deg"]

    def two_rows(e):
        return torch.cat([cl_powerlaw(e), 2.0 * cl_powerlaw(e)])

    got = pcur.curved_gaussian_block(two_rows, two_rows, cl_powerlaw,
                                     cl_powerlaw, edges, edges, pm, mu_i,
                                     mu_j, *n, **kw)
    for row, scale in ((0, 1.0), (1, 2.0)):
        def jcl(e, s=scale):
            return s * cl_powerlaw_jax(e)

        want = np.asarray(jcur.curved_gaussian_block(
            jcl, jcl, cl_powerlaw_jax, cl_powerlaw_jax, edges, edges, jm,
            mu_i, mu_j, *n, **kw))
        assert C.peak_err(got[row], want) < TOL


def test_uniform_sphere_exact():
    """The JAX test tests/test_curved.py:107: W == 1 gives the exact
    full-sky sum plus the pair closure to rtol 1e-9, and the flat-sky
    formula to 2%."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.curved import (UniformSphereMask,
                                        curved_gaussian_covariance,
                                        legendre_bin_factors)

    n2d, lmax = 3.0e7, 3000
    got = curved_gaussian_covariance(cl_powerlaw, EDGES_DEG, n2d,
                                     UniformSphereMask(), ell_max=lmax)[0]
    edges_rad = np.radians(EDGES_DEG)
    ells = np.arange(lmax + 1)
    b0 = legendre_bin_factors(lmax, edges_rad)
    ct = cl_powerlaw(ells)[0].numpy() + 1.0 / n2d
    nn = 2.0 / n2d**2
    ref = np.einsum("il,l,jl->ij", b0, (2 * ells + 1.0) * (2 * ct * ct - nn),
                    b0) / (16 * np.pi**2)
    dmu = np.cos(edges_rad[:-1]) - np.cos(edges_rad[1:])
    a_i = 2 * np.pi * dmu
    d_i = a_i * 4 * np.pi
    ref += nn * np.diag(a_i * 4 * np.pi) / np.outer(d_i, d_i)
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    flat = covariance.gaussian_covariance(
        cl_powerlaw, EDGES_DEG, n2d, 4 * np.pi, n_ell_cov=2048, ell_lo=0.5,
        ell_hi=float(lmax))[0]
    np.testing.assert_allclose(got, flat, rtol=0.02)


def test_uniform_sphere_xipm_exact():
    """The JAX test tests/test_curved.py:1031: on the full sky the xi_+
    EE block is the exact sum, and the (+, -) EE - BB assembly cancels
    the pure noise exactly."""
    from chomp_tpu_torch.curved import (UniformSphereMask,
                                        curved_gaussian_block,
                                        wigner_bin_factors)

    lmax, ns = 2000, 2.0e-8
    edges_rad = np.radians(EDGES_DEG)
    ells = np.arange(lmax + 1)
    mask = UniformSphereMask()
    kw = dict(ell_max=lmax, ell_split=0)

    def zero(e):
        return torch.zeros(1, len(np.asarray(e)), dtype=torch.float64)

    c_pp_ee = curved_gaussian_block(
        cl_powerlaw, cl_powerlaw, cl_powerlaw, cl_powerlaw, EDGES_DEG,
        EDGES_DEG, mask, "xip", "xip", ns, ns, ns, ns, **kw)[0].numpy()
    b22 = wigner_bin_factors(2, 2, lmax, edges_rad)
    ct = cl_powerlaw(ells)[0].numpy() + ns
    nn = 2 * ns * ns
    ref = np.einsum("il,l,jl->ij", b22, (2 * ells + 1.0) * (2 * ct * ct - nn),
                    b22) / (16 * np.pi**2)
    dmu = np.cos(edges_rad[:-1]) - np.cos(edges_rad[1:])
    a_i = 2 * np.pi * dmu
    d_i = a_i * 4 * np.pi
    ref += nn * np.diag(a_i * 4 * np.pi) / np.outer(d_i, d_i)
    np.testing.assert_allclose(c_pp_ee, ref, rtol=1e-9)
    pm = (curved_gaussian_block(cl_powerlaw, cl_powerlaw, cl_powerlaw,
                                cl_powerlaw, EDGES_DEG, EDGES_DEG, mask,
                                "xip", "xim", ns, ns, ns, ns,
                                nn_quadrature=True, **kw)
          - curved_gaussian_block(zero, zero, zero, zero, EDGES_DEG,
                                  EDGES_DEG, mask, "xip", "xim", ns, ns, ns,
                                  ns, nn_quadrature=True, **kw))[0].numpy()
    b2m2 = wigner_bin_factors(2, -2, lmax, edges_rad)
    cs = cl_powerlaw(ells)[0].numpy()
    ref_pm = np.einsum("il,l,jl->ij", b22,
                       (2 * ells + 1.0) * 2 * (cs * cs + 2 * cs * ns), b2m2
                       ) / (16 * np.pi**2)
    np.testing.assert_allclose(pm, ref_pm, rtol=1e-8,
                               atol=1e-12 * np.abs(ref_pm).max())


def test_curved_pair_normalization_cap():
    """The JAX test tests/test_curved.py:135: uniform counts A_i 4 pi,
    cap counts falling toward the footprint scale, and a step profile
    reproducing the analytic cap."""
    from chomp_tpu_torch.curved import (ProfileCurvedMask, SphericalCapMask,
                                        UniformSphereMask,
                                        curved_pair_normalization)

    edges_rad = np.radians(np.array([1.0, 3.0, 8.0, 20.0, 45.0]))
    a_i = 2 * np.pi * (np.cos(edges_rad[:-1]) - np.cos(edges_rad[1:]))
    np.testing.assert_allclose(
        curved_pair_normalization(UniformSphereMask(), edges_rad),
        a_i * 4 * np.pi, rtol=1e-6)
    cap = SphericalCapMask(np.radians(30.0))
    d_c = curved_pair_normalization(cap, edges_rad)
    frac = d_c / (a_i * cap.area2)
    assert np.all(np.diff(frac) < 0) and frac[0] > 0.9 and frac[-1] < 0.6
    th_nodes = np.linspace(0.0, np.radians(30.0), 4000)
    pm = ProfileCurvedMask(th_nodes, np.ones_like(th_nodes), lmax_mask=512)
    assert abs(pm.area2 / cap.area2 - 1.0) < 1e-3
    assert abs(pm.area4 / cap.area4 - 1.0) < 1e-3
    np.testing.assert_allclose(curved_pair_normalization(pm, edges_rad),
                               d_c, rtol=2e-2)


def test_xi_row_sum_parseval():
    """The JAX test tests/test_curved.py:157: the scalar kernel's row sum
    sum_l' (2l' + 1) Ξ⁰_ll' approaches A4/4pi like 1/ell_split (deficit
    below 0.5% at split 320, halving from 160)."""
    from chomp_tpu_torch.curved import SphericalCapMask, _xi_matrices_impl

    cap = SphericalCapMask(0.6)
    target = cap.area4 / (4.0 * np.pi)

    def deficit(split):
        xi0 = _xi_matrices_impl(cap, split, ("0",))["0"]
        rows = (2.0 * np.arange(split + 1) + 1.0)[None, :] * xi0
        return np.max(np.abs(rows[:40].sum(axis=1) / target - 1.0))

    d160, d320 = deficit(160), deficit(320)
    assert d320 < 5e-3
    assert 1.6 < d160 / d320 < 2.4


def test_wide_cap_structure():
    """The JAX test tests/test_curved.py:255: on a 30-degree cap with
    degree-scale bins the matrix is PD, and the noise-only diagonal
    exceeds the uniform same-area one increasingly toward the cap scale;
    the rows of a batch of C_l give their own matrices."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.curved import (SphericalCapMask,
                                        curved_gaussian_covariance)

    cap = SphericalCapMask(np.radians(30.0))
    edges = np.array([0.5, 1.5, 4.0, 10.0, 25.0])
    lmax = 600

    def cl2(e):
        e = np.asarray(e, dtype=float)
        base = torch.as_tensor(1.0e-5 / (1.0 + (e / 40.0) ** 1.8))
        return torch.stack([base, 0.5 * base])

    cov_m = curved_gaussian_covariance(cl2, edges, 1e7, cap,
                                       ell_max=lmax).numpy()
    for c in cov_m:
        assert np.all(np.linalg.eigvalsh(0.5 * (c + c.T)) > 0)

    def zero(e):
        return torch.zeros(1, len(np.asarray(e)), dtype=torch.float64)

    n_m = np.diag(curved_gaussian_covariance(zero, edges, 1e7, cap,
                                             ell_max=lmax)[0].numpy())
    n_u = np.diag(covariance.gaussian_covariance(
        zero, edges, 1e7, cap.area2, n_ell_cov=1024, ell_lo=0.5,
        ell_hi=float(lmax))[0].numpy())
    assert np.all(n_m > 0.99 * n_u)
    assert (n_m / n_u)[-1] > (n_m / n_u)[0]


def test_pixel_sphere_uniform_exact():
    """The JAX test tests/test_curved.py:440: a uniform pixel map
    reproduces the full sky (xi == 1, areas 4 pi)."""
    from chomp_tpu_torch.curved import PixelSphereMask

    m = PixelSphereMask(np.ones((64, 128)))
    np.testing.assert_allclose(m.xi_w2(np.linspace(-1.0, 1.0, 201)), 1.0,
                               rtol=2e-4)
    np.testing.assert_allclose(m.area2, 4.0 * np.pi, rtol=1e-3)
    np.testing.assert_allclose(m.area4, 4.0 * np.pi, rtol=1e-3)
    np.testing.assert_allclose(
        m.pair_function(np.linspace(0.01, np.pi - 0.01, 100)), 4.0 * np.pi,
        rtol=2e-4)


@pytest.mark.parametrize("center", [(0.0, 0.0), (1.2, 0.7)])
def test_pixel_sphere_vs_analytic_cap(center):
    """The JAX tests tests/test_curved.py:457 and :484: a pixelized cap
    (grid-aligned and rotated) against the analytic cap at its effective
    radius: pair function within 4% of A2, pair counts within 2.5%, and
    the Gaussian covariance within 5% of the diagonal scale."""
    from chomp_tpu_torch.curved import (PixelSphereMask, SphericalCapMask,
                                        curved_gaussian_covariance,
                                        curved_pair_normalization)

    rad = np.radians(25.0)
    m = PixelSphereMask(_cap_weight_map(256, 512, rad, center))
    r_eff = np.arccos(1.0 - m.area2 / (2.0 * np.pi))
    assert abs(r_eff - rad) < np.pi / 256
    ref = SphericalCapMask(r_eff)
    assert m.area4 == pytest.approx(m.area2)
    th_g = np.radians(np.linspace(0.3, 48.0, 100))
    dev = (m.pair_function(th_g) - ref.pair_function(th_g)) / ref.area2
    assert np.max(np.abs(dev)) < 0.04
    np.testing.assert_allclose(m.xi_w2(1.0), m.area4 / (4.0 * np.pi),
                               rtol=1e-12)
    edges = np.radians([1.0, 2.0, 4.0, 8.0])
    np.testing.assert_allclose(curved_pair_normalization(m, edges),
                               curved_pair_normalization(ref, edges),
                               rtol=2.5e-2)

    def cl(e):
        e = np.asarray(e, dtype=float)
        return torch.as_tensor(1.0e-6 / (1.0 + (e / 80.0) ** 1.3))[None]

    edges_deg = np.array([0.5, 1.0, 2.0, 4.0])
    ca = curved_gaussian_covariance(cl, edges_deg, 1.0e7, ref,
                                    ell_max=512)[0].numpy()
    cp = curved_gaussian_covariance(cl, edges_deg, 1.0e7, m,
                                    ell_max=512)[0].numpy()
    scale = np.sqrt(np.outer(np.diag(ca), np.diag(ca)))
    assert np.max(np.abs(cp - ca) / scale) < 0.05
    np.testing.assert_allclose(cp, cp.T, rtol=1e-10)


def test_pixel_sphere_two_caps():
    """The JAX test tests/test_curved.py:513: two disjoint caps add their
    areas, the W^2 pair function vanishes in the separation gap and
    reappears around the centre separation."""
    from chomp_tpu_torch.curved import PixelSphereMask, SphericalCapMask

    rad, sep = np.radians(12.0), 2.2
    w = (_cap_weight_map(256, 512, rad)
         + _cap_weight_map(256, 512, rad, center=(sep, 1.0)))
    assert w.max() == 1.0
    m = PixelSphereMask(w)
    np.testing.assert_allclose(m.area2, 2.0 * SphericalCapMask(rad).area2,
                               rtol=2e-2)
    gap = np.linspace(2.0 * rad + 0.1, sep - 2.0 * rad - 0.1, 20)
    assert np.all(m.pair_function2(gap) < 1e-3 * m.area2)
    bump = m.pair_function2(np.linspace(sep - 0.05, sep + 0.05, 11))
    assert np.all(bump > 0.01 * m.area2)


@pytest.mark.parametrize("order", ["RING", "NESTED"])
def test_from_healpix_matches_jax(order):
    """PixelSphereMask.from_healpix of a HEALPix cap map (both orderings)
    equals the JAX package's: the same resampled grid, pair functions and
    areas."""
    from chomp_tpu import curved as jcur, healpix as jhp
    from chomp_tpu_torch import curved as pcur, healpix as php

    nside = 16
    th, ph = php.pix2ang_ring(nside, np.arange(php.npix(nside)))
    ring = (np.cos(th) >= np.cos(np.radians(40.0))).astype(float)
    ring *= 0.5 + 0.5 * (np.cos(ph) > 0.0)
    hp_map = ring
    if order == "NESTED":
        nest = np.arange(php.npix(nside))
        hp_map = np.empty_like(ring)
        hp_map[nest] = ring[jhp.nest2ring(nside, nest)]
    got = pcur.PixelSphereMask.from_healpix(hp_map, order=order)
    want = jcur.PixelSphereMask.from_healpix(hp_map, order=order)
    assert got == pcur.PixelSphereMask.from_healpix(ring)
    assert (got.n_ring, got.n_phi) == (want.n_ring, want.n_phi) == (64, 128)
    th_g = np.linspace(0.0, np.pi, 91)
    np.testing.assert_array_equal(got.pair_function(th_g),
                                  want.pair_function(th_g))
    assert (got.area2, got.area4) == (want.area2, want.area4)
    with pytest.raises(ValueError, match="12\\*nside"):
        pcur.PixelSphereMask.from_healpix(np.ones(100))
    with pytest.raises(ValueError, match="RING or NESTED"):
        pcur.PixelSphereMask.from_healpix(ring, order="GALACTIC")


def test_sigma_b2_curved(masks):
    """sigma_b2_curved on the cap and the pixel map, and sigma_b2_fn's
    bare solid angle (its polar cap), against JAX (1e-12); the JAX tests
    tests/test_ssc.py:81 (full sky: the monopole P_lin(0.5/chi)/(4 pi
    chi^2), 1e-8) and :94 (the cap against the independent harmonic sum
    of the closed-form g_l, 2e-3)."""
    from scipy.special import eval_legendre

    from chomp_tpu_torch import linear, ssc
    from chomp_tpu_torch.curved import SphericalCapMask, UniformSphereMask

    p = C.port_side()
    chi = torch.tensor(np.geomspace(200.0, 3000.0, 5), dtype=torch.float64)
    g = torch.tensor(np.linspace(0.9, 0.5, 5), dtype=torch.float64)
    pm = masks[1]
    for name, got in (
            ("cap", ssc.sigma_b2_curved(p.cosmo, pm["cap"], chi, g,
                                        st=p.st)),
            ("pixel", ssc.sigma_b2_curved(p.cosmo, pm["pixel"], chi, g,
                                          st=p.st)),
            ("omega", ssc.sigma_b2_fn(p.cosmo, C.OMEGA_S, "curved",
                                      st=p.st)(chi, g))):
        err = C.peak_err(got[2], C.ref_more("curved_blocks", 2,
                                            f"sigma_b2.{name}"))
        assert err < TOL, name
    chi2, d2 = torch.tensor([800.0, 2000.0], dtype=torch.float64), \
        torch.tensor([0.8, 0.6], dtype=torch.float64)
    got = ssc.sigma_b2_curved(p.cosmo, UniformSphereMask(), chi2, d2,
                              st=p.st)
    zero = torch.zeros(1, dtype=torch.float64)
    ref = (linear.linear_power(p.cosmo, (0.5 / chi2)[None], zero, p.st)
           * d2**2 / (4.0 * np.pi * chi2**2))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    alpha, lmax = 0.35, 4096
    got = float(ssc.sigma_b2_curved(
        p.cosmo, SphericalCapMask(alpha), torch.tensor([1200.0]).double(),
        torch.tensor([0.7]).double(), st=p.st)[1, 0])
    ca = np.cos(alpha)
    ell = np.arange(lmax + 1)
    p_all = np.array([eval_legendre(l_, ca) for l_ in range(lmax + 2)])
    g_l = np.empty(lmax + 1)
    g_l[0] = 1.0 - ca
    g_l[1:] = (p_all[:lmax] - p_all[2:lmax + 2]) / (2.0 * ell[1:] + 1.0)
    c_delta = (linear.linear_power(
        p.cosmo, torch.tensor((ell + 0.5) / 1200.0)[None], zero,
        p.st)[1].numpy() * 0.7**2 / 1200.0**2)
    a2 = 2.0 * np.pi * (1.0 - ca)
    ref = np.pi / a2**2 * np.sum((2.0 * ell + 1.0) * g_l**2 * c_delta)
    np.testing.assert_allclose(got, ref, rtol=2e-3)


@pytest.fixture(scope="module")
def blocks(masks):
    """curved_nongaussian_covariance and curved_ssc_covariance on the cap
    for gggg (0, 0), gggm (0, 2) and mmmm (xi_+, xi_-), and the SSC on a
    bare solid angle with anchors."""
    from chomp_tpu_torch import curved, ssc
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    p = C.port_side()
    cv = C.CURVED
    cap = masks[1]["cap"]
    win_g, win_k = WindowGalaxy(p.dist), WindowConvergence(p.dist)
    out = {}
    for case, (ws, ts, mi, mj) in {
            "gggg": ((win_g,) * 4, ("g",) * 4, 0, 0),
            "gggm": ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"),
                     0, 2),
            "mmmm": ((win_k,) * 4, ("m",) * 4, "xip", "xim")}.items():
        out[f"cng.{case}"] = curved.curved_nongaussian_covariance(
            p.cosmo, p.halo, p.model, p.dist, cv["edges_deg"], cap, mi, mj,
            cv["ell_max"], windows=ws, tracers=ts, n_ell_tbl=cv["n_ell_tbl"],
            n_k_tri=16, u_stride=2, st=p.st)
        out[f"ssc.{case}"] = ssc.curved_ssc_covariance(
            p.cosmo, p.halo, p.model, p.dist, cv["edges_deg"], cap,
            windows=ws, tracers=ts, mu_i=mi, mu_j=mj, ell_max=cv["ell_max"],
            n_ell_tbl=cv["n_ell_tbl"], u_stride=2, n_k_ssc=cv["n_k_ssc"],
            st=p.st)
    out["ssc.omega"] = ssc.curved_ssc_covariance(
        p.cosmo, p.halo, p.model, p.dist, cv["edges_deg"], C.OMEGA_S,
        ell_max=cv["ell_max"], n_ell_tbl=cv["n_ell_tbl"], u_stride=2,
        n_k_ssc=cv["n_k_ssc"], exact_z_anchors=C.J_ANCHORS, st=p.st)
    return out


@pytest.mark.parametrize("key", ["cng.gggg", "cng.gggm", "cng.mmmm",
                                 "ssc.gggg", "ssc.gggm", "ssc.mmmm",
                                 "ssc.omega"])
def test_curved_blocks_against_jax(blocks, key):
    """The curved connected (1e-6) and super-sample (1e-12) blocks
    against JAX at row 2."""
    tol = TOL_CNG if key.startswith("cng") else TOL
    assert C.peak_err(blocks[key][2], C.ref_more("curved_blocks", 2, key)) \
        < tol


def _curved_args(p):
    cv = C.CURVED
    return (p.cosmo, p.halo, p.model, p.dist, p.dist, cv["edges_deg"], C.N2D,
            C.SHAPE_NOISE)


def _curved_kw(p):
    cv = C.CURVED
    return dict(ell_max=cv["ell_max"], ell_split=cv["ell_split"],
                n_ell_tbl=cv["n_ell_tbl"], n_k_tri=16, u_stride=2,
                ssc_kwargs=dict(n_ell_tbl=cv["n_ell_tbl"], u_stride=2,
                                n_k_ssc=cv["n_k_ssc"]), st=p.st)


@pytest.fixture(scope="module")
def builders(masks):
    """The curved joint w + gamma_t matrix on the pixel map, the 3x2pt
    matrix on the cap (raw and clipped), both with cNG and SSC."""
    from chomp_tpu_torch import curved

    p = C.port_side()
    pm = masks[1]
    ng = dict(include_nongaussian=True, include_ssc=True)
    return {
        "joint": curved.curved_joint_wtheta_gammat_covariance(
            *_curved_args(p), pm["pixel"], **ng, **_curved_kw(p)),
        "x3x2pt": curved.curved_joint_3x2pt_covariance(
            *_curved_args(p), pm["cap"], **ng, **_curved_kw(p)),
        "x3x2pt_clip": curved.curved_joint_3x2pt_covariance(
            *_curved_args(p), pm["cap"], psd_guard="clip", **ng,
            **_curved_kw(p))}


@pytest.mark.parametrize("row", [0, 2])
def test_curved_joint_against_jax(builders, row):
    """The curved joint w + gamma_t matrix on the two-cap pixel map (cNG,
    SSC) against JAX per cosmology."""
    got = builders["joint"]
    assert got.shape == (3, 6, 6)
    assert C.block_err(got[row], C.ref_more("curved_joint", row), 3) \
        < TOL_TOTAL


def test_curved_3x2pt_against_jax(builders):
    """The curved 3x2pt matrix on the cap against JAX (raw: the JAX
    function ignores psd_guard, ROADMAP queue 3), its clip the port's own
    psd_clip of the raw matrix, symmetric and PSD."""
    from chomp_tpu_torch import covariance

    raw, clip = builders["x3x2pt"], builders["x3x2pt_clip"]
    assert raw.shape == (3, 12, 12)
    assert C.block_err(raw[2], C.ref_more("curved_3x2pt", 2), 3) < TOL_TOTAL
    torch.testing.assert_close(clip, covariance.psd_clip(raw), rtol=0,
                               atol=0)
    a = clip.numpy()
    np.testing.assert_allclose(a, a.transpose(0, 2, 1), rtol=0,
                               atol=1e-12 * np.abs(a).max())
    for c in a:
        assert np.linalg.eigvalsh(c).min() >= -1e-10 * np.abs(c).max()


def test_curved_3x2pt_corner_is_the_joint_matrix(masks):
    """The JAX test tests/test_curved.py:1195 on the port: the 3x2pt
    matrix's [w, gamma_t] corner equals the joint matrix (1e-10), and the
    3x2pt matrix is symmetric with a positive diagonal."""
    from chomp_tpu_torch import curved

    p = C.port_side()
    cap = masks[1]["cap"]
    kw = dict(ell_max=C.CURVED["ell_max"], ell_split=C.CURVED["ell_split"],
              st=p.st)
    nb = len(C.CURVED["edges_deg"]) - 1
    cov = curved.curved_joint_3x2pt_covariance(*_curved_args(p), cap,
                                               **kw).numpy()
    two = curved.curved_joint_wtheta_gammat_covariance(*_curved_args(p),
                                                       cap, **kw).numpy()
    np.testing.assert_allclose(cov[:, :2 * nb, :2 * nb], two, rtol=1e-10)
    np.testing.assert_allclose(cov, cov.transpose(0, 2, 1), rtol=1e-8)
    assert np.all(np.diagonal(cov, axis1=1, axis2=2) > 0)


def test_curved_tomographic_against_jax(masks):
    """The curved tomographic 2 x 2 + kappa_CMB matrix (per-bin HODs,
    nuisances, magnification, cNG and SSC on every block) on the cap
    against JAX at row 2."""
    from chomp_tpu_torch import curved
    from chomp_tpu_torch.cmblens import CMBLensingSpec

    p = C.port_side()
    t = C.TOMO
    kw = _curved_kw(p)
    got = curved.curved_tomographic_3x2pt_covariance(
        p.cosmo, p.halo, p.models, p.lens, p.src, C.CURVED["edges_deg"],
        t["n2d"], t["shape_noise"], masks[1]["cap"],
        include_nongaussian=True, nuisance=p.nuisance,
        include_magnification=True, include_ssc=True,
        cmb_lensing=CMBLensingSpec(nl_ell=C.CMB_NL_ELL, nl=C.CMB_NL), **kw)
    assert got.shape == (3, 42, 42)
    assert C.block_err(got[2], C.ref_more("curved_tomo", 2), 3) < TOL_TOTAL


def test_curved_tomographic_cmb_structure(masks):
    """The JAX test tests/test_cmblens.py:392 on the port: the kappa_CMB
    probes leave the curved 3x2pt corner unchanged (1e-12), the matrix is
    symmetric and PSD, the kappa crosses nonzero."""
    from chomp_tpu_torch import curved

    p = C.port_side()
    edges = np.logspace(0.0, 1.0, 3)
    nb = len(edges) - 1
    kw = dict(ell_max=C.CURVED["ell_max"], ell_split=C.CURVED["ell_split"],
              st=p.st)
    args = (p.cosmo, p.halo, p.model, p.lens[:1], p.src[:1], edges,
            [C.N2D], [C.SHAPE_NOISE], masks[1]["cap"])
    base = curved.curved_tomographic_3x2pt_covariance(*args, **kw).numpy()
    full = curved.curved_tomographic_3x2pt_covariance(
        *args, cmb_lensing=True, **kw).numpy()
    n_old = base.shape[-1]
    assert full.shape[-1] == n_old + nb
    np.testing.assert_allclose(full[:, :n_old, :n_old], base, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(full, full.transpose(0, 2, 1), rtol=1e-12,
                               atol=0)
    for c in full:
        ev = np.linalg.eigvalsh(c)
        assert ev.min() > -1e-10 * ev.max()
    assert np.all(np.abs(full[:, :nb, n_old:]).max(axis=(1, 2)) > 0.0)


def test_bmode_null_matches_jax_and_full_sky(masks):
    """curved_bmode_null on the cap against JAX (mean, noise bias and
    covariance, 1e-12 of each peak), and the JAX test
    tests/test_curved.py:1230 on the full sky: no leakage, the closed-form
    noise floor, the pure pair closure as the covariance."""
    from chomp_tpu import curved as jcur
    from chomp_tpu_torch.curved import (UniformSphereMask, curved_bmode_null,
                                        curved_pair_normalization,
                                        wigner_bin_factors)

    ns = 2.0e-8
    edges_deg = np.array([2.0, 4.0, 8.0, 16.0])
    kw = dict(shape_noise=ns, ell_max=C.CURVED["ell_max"],
              ell_split=C.CURVED["ell_split"])
    got = curved_bmode_null(cl_powerlaw, edges_deg, masks[1]["cap"], **kw)
    want = jcur.curved_bmode_null(cl_powerlaw_jax, edges_deg,
                                  masks[0]["cap"], **kw)
    assert C.peak_err(got[0][0], want[0]) < TOL
    assert C.peak_err(got[1], want[1]) < TOL
    assert C.peak_err(got[2][0], want[2]) < TOL

    edges_deg = np.array([1.0, 2.0, 4.0])
    mean, bias, cov = curved_bmode_null(
        cl_powerlaw, edges_deg, UniformSphereMask(), shape_noise=ns,
        ell_max=1024)
    mean, bias, cov = mean[0].numpy(), bias.numpy(), cov[0].numpy()
    assert np.all(np.abs(mean) < 1e-20)
    edges = np.radians(edges_deg)
    b22 = wigner_bin_factors(2, 2, 1024, edges)
    ells = np.arange(1025)
    np.testing.assert_allclose(
        bias, ns * (b22 * (2 * ells + 1)).sum(axis=1) / (4 * np.pi),
        rtol=1e-8)
    d_i = curved_pair_normalization(UniformSphereMask(), edges)
    lo, hi = edges[:-1], edges[1:]
    expect = np.zeros((2, 2))
    for i in range(2):
        for j in range(2):
            a, b = max(lo[i], lo[j]), min(hi[i], hi[j])
            if b > a:
                expect[i, j] = 2 * ns * ns * curved_pair_normalization(
                    UniformSphereMask(), np.array([a, b]),
                    squared=True)[0] / (d_i[i] * d_i[j])
    np.testing.assert_allclose(cov, expect, rtol=1e-12)


def test_convert_curved_masks(masks):
    """utils.convert.mask turns each JAX curved mask into the port's, with
    the same geometry and hash (so the Ξ cache keys agree)."""
    from chomp_tpu_torch import curved as pcur
    from chomp_tpu_torch.utils import convert

    th = np.linspace(0.0, np.pi, 91)
    for name, jm in masks[0].items():
        pm = convert.mask(jm)
        assert type(pm).__name__ == type(jm).__name__
        assert isinstance(pm, getattr(pcur, type(jm).__name__))
        assert hash(pm) == hash(masks[1][name])
        np.testing.assert_array_equal(pm.pair_function(th),
                                      jm.pair_function(th))
        np.testing.assert_array_equal(pm.xi_w2(np.cos(th)),
                                      jm.xi_w2(np.cos(th)))
        assert (pm.area2, pm.area4) == (jm.area2, jm.area4)
