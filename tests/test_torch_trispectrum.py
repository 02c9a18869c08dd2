"""Parity of the port's trispectrum (chomp_tpu_torch.trispectrum), the
Bessel functions J0/J1/J2 and the plain halo-model integrals of the
covariance stack against the JAX package, float64 on the CPU.

The JAX values of the halo-model pieces are the ``pieces`` case of
tests/data/torch_cov_reference.json (tests/torch_cov_cases.py's grid and
cosmologies: row 2 has baryonic feedback, massive neutrinos and a_mod);
the elementwise functions are compared live.

Tolerances, relative to each array's peak: 1e-12 for the mass integrals,
y matrices, the union pack and P_lin (measured ~1e-15); 1e-9 for T̄ and
T̄_PT (measured 9e-12): the 4h term's star part 2 P1^2 P2 K13(k1/k2)
cancels catastrophically in K13's bracket at ratios far from 1 (12/r^2
against the log term), so one ulp of a log1p or log in either package
comes out amplified there (measured ~1e-11 at the ratio 1e3 of these
k).
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL_PLAIN = 1e-12
TOL_TRI = 1e-9


def _p():
    return C.port_side()


def _k():
    return torch.tensor(C.K_TRI, dtype=torch.float64)


def test_bessel_j0_j1_j2():
    """special.j0/j1/j2 against the JAX package's across the table / Hankel
    switch at x = 8 (1e-15 absolute) and scipy (1e-12 absolute)."""
    from scipy import special as sp

    from chomp_tpu import special as js
    from chomp_tpu_torch import special as ps

    x = np.concatenate([-np.geomspace(1e-6, 50.0, 40), [0.0],
                        np.geomspace(1e-6, 1e4, 200), [8.0 - 1e-12, 8.0]])
    xt = torch.tensor(x, dtype=torch.float64)
    for name, ref in (("j0", sp.j0), ("j1", sp.j1),
                      ("j2", lambda v: sp.jv(2, v))):
        got = getattr(ps, name)(xt).numpy()
        want = np.asarray(getattr(js, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
        np.testing.assert_allclose(got, ref(x), rtol=0, atol=1e-12)


def test_fiducial_chi_np():
    """limber_fft.fiducial_chi_np equals the JAX function."""
    from chomp_tpu import limber_fft as jl
    from chomp_tpu_torch import limber_fft as pl

    z = np.linspace(0.0, 5.0, 23)
    np.testing.assert_array_equal(pl.fiducial_chi_np(z),
                                  jl.fiducial_chi_np(z))


@pytest.mark.parametrize("row", [0, 2])
def test_halo_integrals_and_profiles(row):
    """two_halo_integrals, one_halo_integrals, the four y matrices,
    linear_power, galaxy_bias_avg and union_gal_pack against JAX."""
    from chomp_tpu_torch import halo

    p, k = _p(), _k()
    got = {}
    ints = (halo.two_halo_integrals(p.cosmo, p.halo, p.model, k)
            + halo.one_halo_integrals(p.cosmo, p.halo, p.model, k))
    got.update({f"integrals.{i}": v for i, v in enumerate(ints)})
    for name in ("y_matrix", "y_gal", "y_matter", "y_gal_matter"):
        got[name] = getattr(halo, "_" + name)(p.cosmo, p.halo, p.model, k)
    got["linear_power"] = halo.linear_power(p.cosmo, p.model, k, p.st)
    got["bias_avg"] = halo.galaxy_bias_avg(p.model)
    got.update({f"union.{j}": v for j, v in enumerate(
        halo.union_gal_pack(p.cosmo, p.halo, p.models, p.st))})
    for key, v in got.items():
        err = C.peak_err(v[row], C.ref("pieces", row, key))
        assert err < TOL_PLAIN, (key, err)


def test_halo_integrals_match_kernel_a_outputs():
    """The plain integrals are kernel A's five outputs (its plain version
    on the CPU), to 1e-12 of each peak."""
    from chomp_tpu_torch import halo

    p, k = _p(), _k()
    plain = (halo.two_halo_integrals(p.cosmo, p.halo, p.model, k)
             + halo.one_halo_integrals(p.cosmo, p.halo, p.model, k))
    for a, b in zip(plain, halo.contractions(p.cosmo, p.halo, p.model, k,
                                             p.st)):
        assert C.peak_err(a, b.numpy()) < 1e-12


def test_f2_and_k13_kernels():
    """f2_scalar and k13_kernel elementwise against JAX (K13 to 1e-13 of
    its peak for r in [1e-2, 1e2] and at the r = 1 nudge)."""
    from chomp_tpu import trispectrum as jt
    from chomp_tpu_torch import trispectrum as pt

    rng = np.random.default_rng(3)
    a2, b2 = rng.uniform(0.1, 2.0, (2, 50))
    ab = rng.uniform(-1.0, 1.0, 50) * np.sqrt(a2 * b2)
    np.testing.assert_allclose(
        pt.f2_scalar(*(torch.tensor(v) for v in (a2, b2, ab))).numpy(),
        np.asarray(jt.f2_scalar(a2, b2, ab)), rtol=1e-14)
    r = np.concatenate([np.geomspace(1e-2, 1e2, 61), [1.0, 1.0 + 1e-5]])
    want = np.asarray(jt.k13_kernel(r))
    assert C.peak_err(pt.k13_kernel(torch.tensor(r)), want) < 1e-13


@pytest.mark.parametrize("row", [0, 2])
def test_pt_trispectrum_and_bispectrum(row):
    """t_pt_parallelogram and b_pt_avg at z = 0.4 on the K_TRI grid."""
    from chomp_tpu_torch import trispectrum as pt

    p, k = _p(), _k()
    for name, fn in (("t_pt", pt.t_pt_parallelogram), ("b_pt", pt.b_pt_avg)):
        got = fn(p.cosmo, k[:, None], k[None, :], p.st, z=0.4)[row]
        assert C.peak_err(got.reshape(-1), C.ref("pieces", row, name)) \
            < TOL_TRI, name


@pytest.mark.parametrize("tracers", ["gggg", "gggm", "gmgm", "ggmm", "mmmm"])
@pytest.mark.parametrize("legs", [False, True])
def test_trispectrum_tracers(tracers, legs):
    """trispectrum_parallelogram_tracers on the K_TRI x K_TRI table (the
    outer form) against JAX, one model or the per-leg models (default,
    HOD_B, HOD_B, default: mixed galaxy legs on the union pack)."""
    from chomp_tpu_torch import trispectrum as pt

    p, k = _p(), _k()
    model = ((p.models[0], p.models[1], p.models[1], p.models[0])
             if legs else p.model)
    got = pt.trispectrum_parallelogram_tracers(
        p.cosmo, p.halo, model, k[:, None], k[None, :], tuple(tracers), p.st)
    for row in (0, 2):
        key = f"tri_legs.{tracers}" if legs else f"tri.{tracers}"
        err = C.peak_err(got[row].reshape(-1), C.ref("pieces", row, key))
        assert err < TOL_TRI, err


def test_trispectrum_wrappers_and_pointwise_form():
    """The matter / galaxy wrappers against JAX; the pointwise form
    (broadcast k1, k2) equals the outer form."""
    from chomp_tpu_torch import trispectrum as pt

    p, k = _p(), _k()
    args = (p.cosmo, p.halo, p.model, k[:, None], k[None, :], p.st)
    for row in (0, 2):
        assert C.peak_err(pt.trispectrum_parallelogram(*args)[row]
                          .reshape(-1), C.ref("pieces", row, "tri.matter")) \
            < TOL_TRI
        assert C.peak_err(pt.trispectrum_parallelogram_galaxy(*args)[row]
                          .reshape(-1), C.ref("pieces", row, "tri.galaxy")) \
            < TOL_TRI
    k1, k2 = torch.meshgrid(k, k, indexing="ij")
    point = pt.trispectrum_parallelogram_tracers(
        p.cosmo, p.halo, p.model, k1.reshape(-1), k2.reshape(-1),
        ("g", "m", "g", "m"), p.st)
    outer = pt.trispectrum_parallelogram_tracers(
        p.cosmo, p.halo, p.model, k[:, None], k[None, :],
        ("g", "m", "g", "m"), p.st)
    assert C.peak_err(point, outer.reshape(3, -1).numpy()) < 1e-13


def test_trispectrum_symmetries():
    """The JAX test's symmetries (tests/test_covariance.py:145): order
    within a leg pair is irrelevant, (pair, k) exchange is a symmetry,
    the wrappers are the uniform-tracer cases, four identical per-leg
    models reproduce the single model; all positive here."""
    from chomp_tpu_torch import trispectrum as pt

    p = _p()
    k1 = torch.tensor([0.1, 1.0], dtype=torch.float64)
    k2 = torch.tensor([0.5, 2.0], dtype=torch.float64)
    f = pt.trispectrum_parallelogram_tracers
    t_gmgm = f(p.cosmo, p.halo, p.model, k1, k2, tuple("gmgm"), p.st)
    t_mgmg = f(p.cosmo, p.halo, p.model, k1, k2, tuple("mgmg"), p.st)
    t_swap = f(p.cosmo, p.halo, p.model, k2, k1, tuple("gmgm"), p.st)
    np.testing.assert_allclose(t_gmgm, t_mgmg, rtol=1e-12)
    np.testing.assert_allclose(t_gmgm, t_swap, rtol=1e-12)
    np.testing.assert_allclose(
        pt.trispectrum_parallelogram_galaxy(p.cosmo, p.halo, p.model, k1,
                                            k2, p.st),
        f(p.cosmo, p.halo, p.model, k1, k2, ("g",) * 4, p.st), rtol=1e-12)
    np.testing.assert_allclose(
        f(p.cosmo, p.halo, [p.model] * 4, k1, k2, ("g",) * 4, p.st),
        f(p.cosmo, p.halo, p.model, k1, k2, ("g",) * 4, p.st), rtol=1e-12)
    assert torch.all(t_gmgm > 0)
    with pytest.raises(ValueError, match="need 4"):
        f(p.cosmo, p.halo, [p.model] * 3, k1, k2, ("g",) * 4, p.st)


def test_i_mu_beta_is_the_matter_one_halo_term():
    """_i_mu_beta over four matter legs (M/rho_bar)^4 y1^2 y2^2 is the
    1-halo term of the matter trispectrum (1e-13 of its peak), and over
    one bias-weighted leg the 2-halo integral h_m (1e-12)."""
    from chomp_tpu_torch import halo
    from chomp_tpu_torch import trispectrum as pt

    p, k = _p(), _k()
    k2 = torch.flip(k, (0,))
    y1 = halo._y_matrix(p.cosmo, p.halo, p.model, k)
    y2 = halo._y_matrix(p.cosmo, p.halo, p.model, k2)
    got = pt._i_mu_beta(p.cosmo, p.halo, p.model, [y1, y1, y2, y2], 4, 0)
    want = pt.trispectrum_parallelogram(p.cosmo, p.halo, p.model, k, k2,
                                        p.st, terms=("1h",))
    assert C.peak_err(got, want.numpy()) < 1e-13
    # I_1^1 = h_m where the matter profile has no feedback (rows 0-1).
    b1 = pt._i_mu_beta(p.cosmo, p.halo, p.model, [y1], 1, 1)
    h_m = halo.two_halo_integrals(p.cosmo, p.halo, p.model, k)[0]
    assert C.peak_err(b1[:2], h_m[:2].numpy()) < 1e-12
