"""Parity of the port's kappa_CMB covariance blocks against the JAX
package, float64 on the CPU: the gK / kK / KK callables (KK with the
reconstruction noise's decaying part), the probe list, the tomographic
builder's kappa_CMB rows with the connected and super-sample terms, and
the JAX tests' structure checks (tests/test_cmblens.py:226, :246, :265)
on the port.

The inputs are tests/torch_cov_cases.py's (2 x 2 tomographic layout with
per-bin HODs, nuisances and magnification; the N_L table CMB_NL); the
JAX values are the ``tiny`` block of
tests/data/torch_cov_more_reference.json at row 2.

Tolerances: 1e-12 of the peak for the C_ell callables (no trispectrum;
measured ~1e-15), 1e-7 of each block's peak for the assembled matrix
with connected blocks (tests/test_torch_covariance.py's TOL_TOTAL: T̄'s
K13 cancellation noise, ROADMAP queue 3); the structure checks at the
JAX tests' own tolerances.
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

pytest.importorskip("jax")

TOL = 1e-12
TOL_TOTAL = 1e-7


def _spec():
    from chomp_tpu_torch.cmblens import CMBLensingSpec

    return CMBLensingSpec(nl_ell=C.CMB_NL_ELL, nl=C.CMB_NL)


def _tomo(**kw):
    from chomp_tpu_torch import covariance

    p = C.port_side()
    t = C.TOMO
    return covariance.tomographic_3x2pt_covariance(
        p.cosmo, p.halo, p.models, p.lens, p.src, C.EDGES, C.OMEGA_S,
        t["n2d"], t["shape_noise"], n_ell_cov_g=C.KW["n_ell_cov_g"],
        nuisance=p.nuisance, include_magnification=True, st=p.st, **kw)


@pytest.fixture(scope="module")
def full():
    """The 2 x 2 + kappa_CMB matrix with cNG and SSC on every block (raw)
    and the Gaussian-only pair with and without the kappa_CMB probes."""
    ng = dict(include_nongaussian=True, include_ssc=True,
              ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"], u_stride=2,
                              n_k_ssc=32),
              n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=16, u_stride=2)
    return {"ng": _tomo(cmb_lensing=_spec(), **ng),
            "gauss": _tomo(cmb_lensing=_spec()), "base": _tomo()}


def test_cmb_callables():
    """gK_i (with magnification), kK_j (one (1 + m_j)) and KK + (N_L -
    N_inf) against JAX."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    cls = covariance.tomographic_lattice_cl_callables(
        p.cosmo, p.halo, p.models, p.lens, p.src, nuisance=p.nuisance,
        include_magnification=True, cmb=_spec(), st=p.st)
    for key, tag in ((("gK", 0), "gK0"), (("gK", 1), "gK1"),
                     (("kK", 0), "kK0"), (("kK", 1), "kK1"),
                     (("KK",), "KK")):
        got = cls[key](C.ELLS)
        assert C.peak_err(got[2], C.ref_more("cmb_cls", 2, tag)) < TOL, key


def test_cmb_probes():
    """tomographic_probes(cmb_lensing=True) equals the JAX list."""
    from chomp_tpu import covariance as jc
    from chomp_tpu_torch import covariance as pc

    for n_l, n_s in ((2, 2), (5, 4)):
        assert pc.tomographic_probes(n_l, n_s, cmb_lensing=True) == \
            jc.tomographic_probes(n_l, n_s, cmb_lensing=True)


def test_cmb_tomographic_against_jax(full):
    """The 14-probe matrix (cNG and SSC on every block, kappa_CMB a
    matter leg through its window) against JAX at row 2."""
    got = full["ng"]
    assert got.shape == (3, 42, 42)
    assert C.block_err(got[2], C.ref_more("cmb_tomo", 2), 3) < TOL_TOTAL


def test_cmb_structure(full):
    """The JAX test tests/test_cmblens.py:226 on the port: appending the
    kappa probes leaves every 3x2pt block unchanged (1e-12), the matrix is
    symmetric (1e-12) and PSD, and the w_i x wgk_i cross is nonzero."""
    nb = len(C.EDGES) - 1
    base, ext = full["base"].numpy(), full["gauss"].numpy()
    n_old = base.shape[-1]
    assert ext.shape[-1] == n_old + 2 * nb
    np.testing.assert_allclose(ext[:, :n_old, :n_old], base, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(ext, ext.transpose(0, 2, 1), rtol=1e-12,
                               atol=0)
    for a in ext:
        ev = np.linalg.eigvalsh(a)
        assert ev.min() > -1e-10 * ev.max()
    assert np.all(np.abs(ext[:, :nb, n_old:n_old + nb]).max(axis=(1, 2))
                  > 0.0)


def test_cmb_block_bookkeeping(full):
    """The JAX test tests/test_cmblens.py:246: the (wgk_0, wgk_0) block
    equals a hand-assembled gaussian_block over the same callables and
    noise split (the white floor N_inf as the KK noise), exactly up to
    1e-12."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    spec = _spec()
    nb = len(C.EDGES) - 1
    n_old = full["gauss"].shape[-1] - 2 * nb
    cls = covariance.tomographic_lattice_cl_callables(
        p.cosmo, p.halo, p.models, p.lens, p.src, nuisance=p.nuisance,
        include_magnification=True, cmb=spec, st=p.st)
    blk = covariance.gaussian_block(
        cls[("gg", 0, 0)], cls[("KK",)], cls[("gK", 0)], cls[("gK", 0)],
        C.EDGES, C.EDGES, C.OMEGA_S, 0, 0, 1.0 / C.TOMO["n2d"][0],
        spec.nl_inf, 0.0, 0.0, n_ell_cov=C.KW["n_ell_cov_g"])
    np.testing.assert_allclose(
        full["gauss"][:, n_old:n_old + nb, n_old:n_old + nb], blk,
        rtol=1e-12, atol=0)


def test_nl_closure_vs_quadrature():
    """The JAX test tests/test_cmblens.py:265 on the port: a constant N_L
    through the analytic closure (the white floor) against the same
    constant inside the quadrature: off-diagonal entries within 2e-2 of
    the peak or 5%, the diagonal within 5%."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.cmblens import CMBLensingSpec

    p = C.port_side()
    edges = np.logspace(-1.5, 0, 4)
    cls = covariance.tomographic_lattice_cl_callables(
        p.cosmo, p.halo, p.model, p.lens, p.src, cmb=CMBLensingSpec(),
        st=p.st)
    c = 3e-8
    kk = cls[("KK",)]

    def kk_plus_const(ells_np):
        return kk(ells_np) + c

    gg, gk = cls[("gg", 0, 0)], cls[("gK", 0)]
    closure = covariance.gaussian_block(
        gg, kk, gk, gk, edges, edges, C.OMEGA_S, 0, 0, 1.0 / C.N2D, c, 0.0,
        0.0, n_ell_cov=4096).numpy()
    quad = covariance.gaussian_block(
        gg, kk_plus_const, gk, gk, edges, edges, C.OMEGA_S, 0, 0,
        1.0 / C.N2D, 0.0, 0.0, 0.0, n_ell_cov=4096).numpy()
    off = ~np.eye(len(edges) - 1, dtype=bool)
    for cl_, q in zip(closure, quad):
        np.testing.assert_allclose(q[off], cl_[off],
                                   atol=2e-2 * np.abs(cl_).max(), rtol=0.05)
        np.testing.assert_allclose(np.diag(q), np.diag(cl_), rtol=0.05)


def test_cmb_window_is_one_object_per_call(monkeypatch):
    """The kappa_CMB window is built once per builder call on the call's
    device and dtype (the lattice windows are memoized by identity)."""
    from chomp_tpu_torch.cmblens import CMBLensingSpec

    built = []
    real = CMBLensingSpec.window

    def window(self, *, device, dtype):
        built.append((str(device), dtype))
        return real(self, device=device, dtype=dtype)

    monkeypatch.setattr(CMBLensingSpec, "window", window)
    _tomo(cmb_lensing=True, include_nongaussian="autos",
          n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=16, u_stride=2)
    assert built == [("cpu", torch.float64)]


@pytest.mark.parametrize("engine", ["ssc", "cng"])
def test_cmb_ssc_and_cng_legs(engine):
    """The JAX test tests/test_cmblens.py:359 on the port (the small
    grid; slow in the JAX tier): with the term on the probe autos, the
    (wgk_0, wgk_0) block minus the Gaussian-only one equals the direct
    block with windows (g, K, g, K) and tracers (g, m, g, m) to 1e-10 —
    the leg wiring, kappa_CMB a matter leg through its window."""
    from chomp_tpu_torch import covariance, ssc
    from chomp_tpu_torch.cmblens import CMBLensingSpec
    from chomp_tpu_torch.projection import WindowGalaxy

    p = C.port_side()
    edges = np.logspace(-1.5, 0, 3)
    nb = len(edges) - 1
    spec = CMBLensingSpec()
    knobs = dict(n_ell_cov=C.KW["n_ell_cov_ng"], u_stride=2)
    if engine == "ssc":
        opts = dict(include_ssc="autos", ssc_kwargs=dict(n_k_ssc=32,
                                                         **knobs))
    else:
        opts = dict(include_nongaussian="autos", n_k_tri=16, **knobs)
    args = (p.cosmo, p.halo, p.model, p.lens[:1], p.src[:1], edges,
            C.OMEGA_S, [C.N2D], [C.SHAPE_NOISE])
    full = covariance.tomographic_3x2pt_covariance(
        *args, n_ell_cov_g=512, cmb_lensing=spec, st=p.st, **opts)
    base = covariance.tomographic_3x2pt_covariance(
        *args, n_ell_cov_g=512, cmb_lensing=spec, st=p.st)
    win_g = WindowGalaxy(dist=p.lens[0])
    win_kcmb = spec.window(device="cpu", dtype=torch.float64)
    legs = dict(windows=(win_g, win_kcmb, win_g, win_kcmb),
                tracers=("g", "m", "g", "m"), mu_i=0, mu_j=0, st=p.st)
    if engine == "ssc":
        direct = ssc.ssc_covariance(p.cosmo, p.halo, p.model, p.lens[0],
                                    edges, C.OMEGA_S, n_k_ssc=32, **knobs,
                                    **legs)
    else:
        direct = covariance.nongaussian_covariance(
            p.cosmo, p.halo, p.model, p.lens[0], edges, C.OMEGA_S,
            n_k_tri=16, **knobs, **legs)
    got = full[:, -nb:, -nb:] - base[:, -nb:, -nb:]
    np.testing.assert_allclose(got, direct, rtol=1e-10, atol=0)
