"""Parity of the port's covariance builders (chomp_tpu_torch.covariance)
against the JAX package, float64 on the CPU.

The builders run once on the batch of tests/torch_cov_cases.py's three
cosmologies; the JAX values are tests/data/torch_cov_reference.json's
``tiny`` block, one cosmology at a time (eager JAX: the joint w + gamma_t
matrix at every row, the other cases at row 2, the cosmology with
baryonic feedback, massive neutrinos and a_mod).  Elementwise pieces
(Bessel factors, closures, the Gaussian covariance of an analytic C_ell)
are compared live.

Tolerances, relative to each block's peak:
- 1e-12 where no trispectrum enters (Bessel factors, Gaussian blocks,
  the C_ell callables; measured ~1e-15);
- 1e-6 for a connected block or T_proj, and 1e-7 for an assembled
  matrix: T̄'s star term 2 P1^2 P2 K13(k1/k2) is cancellation noise at
  the table's extreme k ratios (K13's bracket loses all digits beyond
  r ~ 1e3, where one ulp of log1p differs between XLA and torch, and
  XLA's own jit and eager runs differ likewise:
  tools/torch_cov_diagnostics.py prints the three beside the exact
  value), and the 2-tap log-interpolation carries it into the small
  off-diagonal entries.
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = 1e-12
TOL_CNG = 1e-6
TOL_TOTAL = 1e-7


def _cl(ells):
    return 1.0e-7 * (np.asarray(ells) / 100.0) ** -1.2


@pytest.fixture(scope="module")
def joint():
    """The joint w + gamma_t matrix of the batch (cNG, SSC, clip)."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    return covariance.joint_wtheta_gammat_covariance(
        p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, C.OMEGA_S, C.N2D,
        C.SHAPE_NOISE, include_ssc=True, psd_guard="clip", st=p.st, **C.KW)


@pytest.mark.parametrize("mu", [0, 2, 4])
def test_bin_averaged_bessel(mu):
    """bin_averaged_bessel against JAX across the small-x series switch
    (x = 1 for mu 2, x = 2 for mu 4), 1e-12 of each row's peak."""
    from chomp_tpu import covariance as jc
    from chomp_tpu_torch import covariance as pc

    ells = np.geomspace(1e-3, 1e6, 400)
    edges = np.radians(np.geomspace(1e-3, 5.0, 9))
    got = pc.bin_averaged_bessel(torch.tensor(ells), edges, mu).numpy()
    want = np.asarray(jc.bin_averaged_bessel(jnp.asarray(ells), edges, mu))
    err = np.max(np.abs(got - want), axis=1) / np.max(np.abs(want), axis=1)
    assert np.all(err < TOL), err
    with pytest.raises(ValueError, match="mu=3"):
        pc.bin_averaged_bessel(torch.tensor(ells), edges, 3)


def test_static_helpers():
    """theta_bin_edges_deg, _log_ell_weights, ovl_closure and the
    xi_+ x xi_- Weber-Schafheitlin constant equal the JAX functions."""
    from chomp_tpu import covariance as jc
    from chomp_tpu_torch import covariance as pc

    np.testing.assert_array_equal(pc.theta_bin_edges_deg(n_bins=7),
                                  jc.theta_bin_edges_deg(n_bins=7))
    for a, b in zip(pc._log_ell_weights(50, 1.0, 1e5),
                    jc._log_ell_weights(50, 1.0, 1e5)):
        np.testing.assert_array_equal(a, b)
    ei = np.radians([0.01, 0.03, 0.1, 0.3])
    ej = np.radians([0.02, 0.06, 0.2])
    np.testing.assert_array_equal(pc.ovl_closure(ei, ej),
                                  jc.ovl_closure(ei, ej))
    np.testing.assert_allclose(pc.xipm_mixed_noise_constant(ei, ej),
                               jc.xipm_mixed_noise_constant(ei, ej),
                               rtol=1e-14)


def test_gaussian_covariance_and_block_reduction():
    """gaussian_covariance against JAX (analytic C_ell, 1e-12); the
    4-pairing gaussian_block with all legs g reduces to it (the JAX test
    tests/test_covariance.py:177, its rtol 1e-10)."""
    from chomp_tpu import covariance as jc
    from chomp_tpu_torch import covariance as pc

    edges = pc.theta_bin_edges_deg(n_bins=5)

    def cl(e):
        return torch.tensor(_cl(e))[None]

    got = pc.gaussian_covariance(cl, edges, C.N2D, C.OMEGA_S, n_ell_cov=1024)
    want = np.asarray(jc.gaussian_covariance(
        lambda e: jnp.asarray(_cl(e)), edges, C.N2D, C.OMEGA_S,
        n_ell_cov=1024))
    assert C.peak_err(got[0], want) < TOL
    n = 1.0 / C.N2D
    blk = pc.gaussian_block(cl, cl, cl, cl, edges, edges, C.OMEGA_S, 0, 0,
                            n, n, n, n, n_ell_cov=1024)
    np.testing.assert_allclose(blk, got, rtol=1e-10)
    zero = torch.tensor(0.0, dtype=torch.float64)
    np.testing.assert_allclose(
        pc.gaussian_block(cl, cl, cl, cl, edges, edges, C.OMEGA_S, 0, 0,
                          zero + n, n, n, n, n_ell_cov=1024), blk,
        rtol=1e-13)
    with pytest.raises(ValueError, match="noise x noise"):
        pc.gaussian_block(cl, cl, cl, cl, edges, edges, C.OMEGA_S, 0, 2,
                          n, n, n, n, n_ell_cov=64)
    with pytest.raises(ValueError, match="needs a mask"):
        pc.gaussian_block(cl, cl, cl, cl, edges, edges, C.OMEGA_S,
                          beyond_nka=True, n_ell_cov=64)


@pytest.mark.parametrize("row", [0, 1, 2])
def test_joint_wtheta_gammat_per_cosmology(joint, row):
    """The batch's joint matrix (Gaussian + cNG + SSC, clipped) against
    the JAX builder run on each cosmology alone."""
    assert joint.shape == (3, 6, 6)
    assert C.block_err(joint[row], C.ref("joint", row), 3) < TOL_TOTAL


def test_uniform_mask_joint_equals_unmasked(joint):
    """The joint builder with UniformMask(Omega_s) equals the unmasked one
    (the JAX test tests/test_covariance.py:573, its rtol 1e-9), with the
    connected and super-sample terms on."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.mask import UniformMask

    p = C.port_side()
    uni = covariance.joint_wtheta_gammat_covariance(
        p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, 999.0, C.N2D,
        C.SHAPE_NOISE, mask=UniformMask(C.OMEGA_S), include_ssc=True,
        psd_guard="clip", st=p.st, **C.KW)
    np.testing.assert_allclose(uni, joint, rtol=1e-9)


def test_joint_symmetric_and_psd(joint):
    """Symmetric, finite, PSD after the clip."""
    a = joint.numpy()
    assert np.all(np.isfinite(a))
    np.testing.assert_allclose(a, a.transpose(0, 2, 1), rtol=1e-12,
                               atol=1e-12 * np.abs(a).max())
    assert np.all(np.linalg.eigvalsh(0.5 * (a + a.transpose(0, 2, 1)))
                  >= -1e-10 * np.abs(a).max())


@pytest.mark.parametrize("case", ["pixel", "table", "x3x2pt"])
def test_builders_against_jax(case):
    """Row 2 of: the joint matrix on the pixel-map footprint (with SSC);
    the table routes (cl_method and tri_method "table"); the full 3x2pt
    joint matrix (cNG + SSC, clipped)."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.mask import PixelMask

    p = C.port_side()
    args = (p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, C.OMEGA_S,
            C.N2D, C.SHAPE_NOISE)
    kw = dict(st=p.st, **C.KW)
    if case == "pixel":
        got = covariance.joint_wtheta_gammat_covariance(
            *args, include_ssc=True, mask=PixelMask(*C.pixel_map()), **kw)
    elif case == "table":
        got = covariance.joint_wtheta_gammat_covariance(
            *args, cl_method="table", tri_method="table", n_z_tri=24, **kw)
        # The JAX test tests/test_covariance.py:446: the lattice and table
        # routes within 1e-3 of sqrt(diag_i diag_j).
        lat = covariance.joint_wtheta_gammat_covariance(*args, **kw)
        d = torch.diagonal(got, dim1=1, dim2=2)
        norm = torch.sqrt(d[:, :, None] * d[:, None, :])
        assert torch.max(torch.abs(lat - got) / norm) < 1e-3
    else:
        got = covariance.joint_3x2pt_covariance(
            *args, include_ssc=True, psd_guard="clip", **kw)
        a = got[2].numpy()
        np.testing.assert_allclose(a, a.T, rtol=0, atol=1e-12 * abs(a).max())
    assert C.block_err(got[2], C.ref(case, 2), 3) < TOL_TOTAL


@pytest.fixture(scope="module")
def tomo():
    """The 2 x 2 tomographic matrix (per-bin HODs, nuisances,
    magnification, cNG and SSC on every block, clipped)."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    t = C.TOMO
    return covariance.tomographic_3x2pt_covariance(
        p.cosmo, p.halo, p.models, p.lens, p.src, C.EDGES, C.OMEGA_S,
        t["n2d"], t["shape_noise"], n_ell_cov_g=C.KW["n_ell_cov_g"],
        include_nongaussian=True, nuisance=p.nuisance,
        include_magnification=True, include_ssc=True, psd_guard="clip",
        ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"],
                        u_stride=C.KW["u_stride"]),
        n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=C.KW["n_k_tri"],
        u_stride=C.KW["u_stride"], st=p.st)


def test_tomographic_2x2(tomo):
    """The 12-probe matrix against JAX at row 2 (every block), symmetric
    and PSD after the clip."""
    assert tomo.shape == (3, 36, 36)
    assert C.block_err(tomo[2], C.ref("tomo", 2), 3) < TOL_TOTAL
    a = tomo.numpy()
    np.testing.assert_allclose(a, a.transpose(0, 2, 1), rtol=0,
                               atol=1e-12 * np.abs(a).max())
    assert np.all(np.linalg.eigvalsh(a) >= -1e-10 * np.abs(a).max())


def test_tomographic_probes_and_noise_lists():
    """The probe list and the noise bookkeeping equal the JAX helpers."""
    from chomp_tpu import covariance as jc
    from chomp_tpu_torch import covariance as pc

    for n_l, n_s in ((2, 2), (5, 4)):
        assert pc.tomographic_probes(n_l, n_s) == jc.tomographic_probes(
            n_l, n_s)
    assert pc._tomographic_noise_lists(3e7, [1e-9, 2e-9], 3, 2) == \
        jc._tomographic_noise_lists(3e7, [1e-9, 2e-9], 3, 2)


@pytest.fixture(scope="module")
def pieces():
    """name -> (B, ...) tensor: nongaussian_covariance (ww, w-gt, xi_- x
    xi_-), projected_trispectrum on both routes (one model gggg, per-leg
    gmgm), the lattice C_ell callables and wtheta_covariance."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    p = C.port_side()
    win_g, win_k = WindowGalaxy(p.dist), WindowConvergence(p.dist)
    leg = (p.models[0], p.models[1], p.models[1], p.models[0])
    out = {}
    for case, (ws, ts, mi, mj) in {
            "gggg": ((win_g,) * 4, ("g",) * 4, 0, 0),
            "gggm": ((win_g, win_g, win_g, win_k), ("g", "g", "g", "m"),
                     0, 2),
            "mmmm": ((win_k,) * 4, ("m",) * 4, 4, 4)}.items():
        out[f"cng.{case}"] = covariance.nongaussian_covariance(
            p.cosmo, p.halo, p.model, p.dist, C.EDGES, C.OMEGA_S,
            windows=ws, tracers=ts, mu_i=mi, mu_j=mj, n_ell_cov=12,
            n_k_tri=16, u_stride=2, st=p.st)
    for meth in ("lattice", "table"):
        for trs, mdl in (("gggg", p.model), ("gmgm", leg)):
            out[f"proj.{meth}.{trs}"] = covariance.projected_trispectrum(
                p.cosmo, p.halo, mdl, p.dist, C.ELLS, n_k_tri=16,
                n_z_tri=24, windows=((win_g, win_k, win_g, win_k)
                                     if trs == "gmgm" else None),
                tracers=tuple(trs), method=meth, u_stride=2, st=p.st)
    cl_gg, cl_gk, cl_kk = covariance.lattice_cl_callables(
        p.cosmo, p.halo, p.model, p.dist, p.dist, st=p.st)
    for name, fn in (("gg", cl_gg), ("gk", cl_gk), ("kk", cl_kk)):
        out[f"cl.{name}"] = fn(C.ELLS)
    out["wtheta_cov"] = covariance.wtheta_covariance(
        p.cosmo, p.halo, p.model, p.dist, cl_gg, C.EDGES, C.OMEGA_S, C.N2D,
        n_k_tri=16, n_z_tri=8, st=p.st)
    return out


_PIECE_TOL = {"cng": TOL_CNG, "proj": TOL_CNG, "cl": TOL,
              "wtheta_cov": TOL_TOTAL}


@pytest.mark.parametrize("row", [0, 2])
@pytest.mark.parametrize("group", ["cng", "proj", "cl", "wtheta_cov"])
def test_connected_pieces(pieces, group, row):
    """The connected blocks, both projection routes, the C_ell callables
    and wtheta_covariance against JAX."""
    for key, v in pieces.items():
        if key.split(".")[0] == group:
            err = C.peak_err(v[row], C.ref("pieces", row, key))
            assert err < _PIECE_TOL[group], (key, err)


def test_lattice_route_matches_table_route():
    """The two projection routes integrate the same bilinear T̄ (the JAX
    test tests/test_covariance.py:415 at its n_k_tri 48 and 24 ells:
    within 2e-3 of the peak at stride 4 of a 0.008 lattice, and a finer
    stride moves toward the refined table route)."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.grids import Statics

    p = C.port_side()
    st = Statics(C.GRID.replace(lattice_dln=0.008), device="cpu",
                 dtype=torch.float64)
    ells, _ = covariance._log_ell_weights(24, 1.0, 1.0e5)
    kw = dict(n_k_tri=48, st=st)
    t_tab = covariance.projected_trispectrum(
        p.cosmo, p.halo, p.model, p.dist, ells, n_z_tri=96, method="table",
        **kw).numpy()
    den = np.max(np.abs(t_tab), axis=(1, 2), keepdims=True)
    errs = [np.max(np.abs(covariance.projected_trispectrum(
        p.cosmo, p.halo, p.model, p.dist, ells, u_stride=s, **kw).numpy()
        - t_tab) / den) for s in (4, 2)]
    assert errs[0] < 2e-3 and errs[1] < errs[0] + 1e-5, errs


def test_disjoint_window_supports_give_zero():
    """Windows with no common support give a zero block (the JAX test
    tests/test_covariance.py:372)."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.projection import DNdzGaussian, WindowGalaxy

    p = C.port_side()

    def d(a, b, z0, s):
        return DNdzGaussian(*(torch.tensor(v, dtype=torch.float64)
                              for v in (a, b, z0, s)))

    lo, hi = WindowGalaxy(d(0.05, 0.4, 0.2, 0.05)), WindowGalaxy(
        d(0.8, 1.4, 1.1, 0.1))
    t = covariance.projected_trispectrum(
        p.cosmo, p.halo, p.model, p.dist, np.logspace(1.5, 3.0, 3),
        n_k_tri=16, windows=(lo, lo, hi, hi), tracers=("g",) * 4, st=p.st)
    assert torch.all(torch.abs(t) < 1e-30), t


def test_psd_clip():
    """psd_clip clips a known negative eigenvalue as the JAX package's
    does (1e-12 of the peak), returns a symmetric PSD input unchanged, bit
    for bit, and is grad-transparent (the JAX test
    tests/test_covariance.py:642); batched."""
    from chomp_tpu import covariance as jcov
    from chomp_tpu_torch import covariance

    rng = np.random.default_rng(7)
    a = rng.normal(size=(6, 6))
    psd = a @ a.T + 6 * np.eye(6)
    psd = 0.5 * (psd + psd.T)
    lam, v = np.linalg.eigh(psd)
    lam[0] = -0.5
    neg = (v * lam[None, :]) @ v.T
    both = torch.tensor(np.stack([psd, neg]))
    out = covariance.psd_clip(both).numpy()
    np.testing.assert_array_equal(out[0], psd)
    for got, raw in zip(out, (psd, neg)):
        want = np.asarray(jcov.psd_clip(jnp.asarray(raw)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    assert np.linalg.eigvalsh(out[1]).min() >= -1e-10
    np.linalg.cholesky(out[1] + 1e-12 * np.eye(6))
    c = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(covariance.psd_clip(c * both[1]).sum(), c)
    np.testing.assert_allclose(float(g), neg.sum(), rtol=1e-12)
    with pytest.raises(ValueError, match="psd_guard"):
        covariance._apply_psd_guard(both, "bogus")


@pytest.mark.parametrize("name", [
    "covariance.gaussian_block", "covariance.projected_trispectrum",
    "covariance.nongaussian_covariance", "covariance.lattice_cl_callables",
    "covariance.tomographic_lattice_cl_callables",
    "covariance.joint_wtheta_gammat_covariance",
    "covariance.joint_3x2pt_covariance",
    "covariance.tomographic_3x2pt_covariance", "ssc.projected_ssc",
    "ssc.ssc_covariance", "trispectrum.trispectrum_parallelogram_tracers",
    "ssc.curved_ssc_covariance", "curved.curved_gaussian_block",
    "curved.curved_gaussian_covariance",
    "curved.curved_nongaussian_covariance",
    "curved.curved_joint_wtheta_gammat_covariance",
    "curved.curved_joint_3x2pt_covariance",
    "curved.curved_tomographic_3x2pt_covariance"])
def test_no_cache_outlives_a_call(name):
    """The public functions take no cache (a builder's memo keys entries
    by object identity, so it must not outlive the call): their
    signatures name none, and passing one is a TypeError (where no
    ``**kwargs`` forwards it)."""
    import inspect

    import chomp_tpu_torch

    mod, fn = name.split(".")
    f = getattr(getattr(chomp_tpu_torch, mod), fn)
    params = inspect.signature(f).parameters
    assert not {"memo", "cache", "sigma_key", "shared"} & set(params)
    assert f.__name__ == fn and f.__doc__
    if all(p.kind != p.VAR_KEYWORD for p in params.values()):
        with pytest.raises(TypeError):
            f(*([None] * 5), memo=None)


def test_statics_resolution():
    """Builders take the JAX signatures' grid / with_bao: they must agree
    with ``st`` when both are given."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    assert covariance.resolve_statics(p.cosmo, p.st, C.GRID, False) is p.st
    with pytest.raises(ValueError, match="grid"):
        covariance.resolve_statics(p.cosmo, p.st, C.GRID.replace(n_mu=4))
    with pytest.raises(ValueError, match="with_bao"):
        covariance.resolve_statics(p.cosmo, p.st, with_bao=True)


def test_deferred_routes_raise():
    """The routes that raised NotImplementedError until the exact-z,
    kappa_CMB and curved-sky slice now give results (their parity cases
    are tests/test_torch_cov_exactz.py, test_torch_cov_cmb.py and
    test_torch_curved_cov.py); the argument checks stay: the two exact-z
    flags exclude each other, the anchors need the lattice route, and the
    3x2pt builder is lattice-only."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    args = (p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, C.OMEGA_S,
            C.N2D, C.SHAPE_NOISE)
    with pytest.raises(ValueError, match="not both"):
        covariance.projected_trispectrum(
            p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z=True,
            exact_z_anchors=4, st=p.st)
    with pytest.raises(ValueError, match="lattice-route"):
        covariance.projected_trispectrum(
            p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z_anchors=4,
            method="table", st=p.st)
    with pytest.raises(ValueError, match="lattice-only"):
        covariance.joint_3x2pt_covariance(*args, cl_method="table",
                                          st=p.st)
    assert not hasattr(covariance, "deferred")
