"""chomp_tpu_torch special functions and copied numpy operators against
the JAX package (same inputs from numpy, float64 CPU unless stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chomp_tpu import _special_coeffs as jax_coeffs
from chomp_tpu import correlation as jcorr
from chomp_tpu import fftlog as jfftlog
from chomp_tpu import grids as jgrids
from chomp_tpu import limber_fft as jlimber
from chomp_tpu import special as jspecial
from chomp_tpu_torch import _special_coeffs as coeffs
from chomp_tpu_torch import correlation, fftlog, grids, limber_fft, special
from torch_threads import capped_threads  # noqa: F401 (autouse)

GRID = graft._tiny_grid().replace(lattice_dln=0.04)
# Every branch of the auxiliary functions: series (x <= 4), both
# Chebyshev ranges, the asymptotic tail, and the branch edges.
X = np.concatenate([np.logspace(-4, 7.5, 1500), [4.0, 16.0, 64.0]])
X_ERFC = np.linspace(-6.0, 6.0, 601)


def _both(name, x, jdt, tdt):
    ref = np.asarray(getattr(jspecial, name)(jnp.asarray(x, dtype=jdt)),
                     np.float64)
    got = getattr(special, name)(torch.tensor(x, dtype=tdt)).double()
    return got.numpy(), ref


@pytest.mark.parametrize("name", ["aux_g", "aux_fm", "erfc"])
def test_special_f64(name):
    """Same formulas, same tables: rtol 1e-13 in float64."""
    x = X_ERFC if name == "erfc" else X
    got, ref = _both(name, x, jnp.float64, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", ["aux_g", "aux_fm", "erfc"])
def test_special_f32_trimmed(name):
    """float32 with the trimmed tables: rtol 1e-6 against the JAX float32
    evaluation.  In the series branch (x <= 4) the two libraries' float32
    sin/cos/log differ by an ulp, which the g(x) cancellation near x = 4
    amplifies to ~2e-6; there both are held to the float32 error they
    share against float64 (measured 1.1e-5 worst for both, bound 2e-5).
    erfc: the libraries' float32 algorithms differ by a few ulp in the
    deep tail (erfc < 1e-8, x > 4), where both are held to float64 at
    2e-5."""
    x = X_ERFC if name == "erfc" else X
    x = x.astype(np.float32).astype(np.float64)
    got, ref = _both(name, x, jnp.float32, torch.float32)
    same = x <= 4.0 if name == "erfc" else x > 4.0
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-6, atol=0)
    exact = np.asarray(getattr(jspecial, name)(jnp.asarray(x)))
    for val in (got, ref):
        np.testing.assert_allclose(val[~same], exact[~same], rtol=2e-5,
                                   atol=0)


def test_float32_trimming_matches():
    """_trim keeps the same terms as the JAX package's float32 trimming."""
    probe32 = torch.zeros((), dtype=torch.float32)
    for name in ("sici_a_fm", "sici_a_g", "sici_b_fm", "sici_b_g"):
        tab = getattr(coeffs, name)
        ref = jspecial._trim(tab, jnp.zeros((), jnp.float32))
        assert special._trim(tab, probe32) == list(ref)
        assert special._trim(tab, probe32.double()) == tab


def test_coefficient_tables_identical():
    names = [n for n in dir(jax_coeffs) if not n.startswith("_")]
    assert names
    for n in names:
        assert getattr(coeffs, n) == getattr(jax_coeffs, n), n


def _static_pairs():
    theta = tuple(jcorr.theta_bins_deg(GRID).tolist())
    ells = tuple(jcorr.ell_grid(GRID)[0].tolist())
    key = jlimber._lattice_key(GRID)
    ln0, dln = jcorr.ell_grid(GRID)[1:]
    t = np.linspace(-1.5, 60.5, 40)
    return {
        "gauss_legendre": (lambda m: m.gauss_legendre(17), jgrids, grids),
        "gl_composite": (lambda m: m.gl_composite(-3.0, 5.0, 4, 16),
                         jgrids, grids),
        "catmull_rom_weights_np": (
            lambda m: m.catmull_rom_weights_np(64, t), jgrids, grids),
        "hankel_operator": (
            lambda m: m.hankel_operator(GRID.n_ell, ln0, dln, 2.0, q=1.0,
                                        taper_lo=0.08, taper_hi=0.05),
            jfftlog, fftlog),
        "ell_grid": (lambda m: m.ell_grid(GRID), jcorr, correlation),
        "theta_bins_deg": (lambda m: m.theta_bins_deg(GRID), jcorr,
                           correlation),
        "wtheta_operator": (lambda m: m.wtheta_operator(GRID, 2.0), jcorr,
                            correlation),
        "wtheta_bins_operator": (
            lambda m: m.wtheta_bins_operator(theta, GRID, 0.0), jcorr,
            correlation),
        "lattices": (lambda m: m._lattices(GRID), jlimber, limber_fft),
        "fiducial_chi_table": (lambda m: m._fiducial_chi_table(), jlimber,
                               limber_fft),
        "fiducial_z_seed": (lambda m: m._fiducial_z_seed(key, True),
                            jlimber, limber_fft),
        "s_weights": (lambda m: m._s_weights(ells, 0.5, key), jlimber,
                      limber_fft),
        "wtheta_lattice_operator": (
            lambda m: m.wtheta_lattice_operator(theta, GRID, 2.0), jlimber,
            limber_fft),
    }


@pytest.mark.parametrize("name", sorted(_static_pairs()))
def test_copied_numpy_operators_identical(name):
    """The numpy builders copied into the port give bit-identical arrays."""
    fn, jmod, tmod = _static_pairs()[name]
    ref, got = fn(jmod), fn(tmod)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), name
        else:
            assert a == b, name
