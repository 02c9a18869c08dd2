"""Parity of the port's survey masks (chomp_tpu_torch.mask) and the masked
Gaussian blocks against the JAX package, float64 on the CPU.

The mask geometry is numpy in both packages (copied): the port's
DiscMask / UniformMask / PixelMask, pair normalizations, coupling
matrices and field-phase suppression equal the JAX ones to 1e-14 of each
peak.  masked_gaussian_covariance runs live on both packages with an
analytic C_ell (1e-12 of the peak); the masked joint builders' Gaussian
blocks (disc, beyond-NKA, uniform) are the ``gaussian_masked`` case of
tests/data/torch_cov_reference.json (1e-12 of each block's peak,
measured ~1e-15).
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL_GEOM = 1e-14
TOL = 1e-12


def _masks():
    from chomp_tpu import mask as jm
    from chomp_tpu_torch import mask as pm
    from chomp_tpu_torch.utils import convert

    w, a = C.pixel_map()
    jax_masks = {"disc": jm.DiscMask(C.DISC_RADIUS),
                 "uniform": jm.UniformMask(C.OMEGA_S),
                 "pixel": jm.PixelMask(w, a)}
    port = {"disc": pm.DiscMask(C.DISC_RADIUS),
            "uniform": pm.UniformMask(C.OMEGA_S),
            "pixel": pm.PixelMask(w, a)}
    converted = {k: convert.mask(v) for k, v in jax_masks.items()}
    return jax_masks, port, converted


def _cl(ells):
    return 1.0e-6 * (np.asarray(ells) / 100.0) ** -1.4


def test_mask_geometry_matches_jax():
    """Areas, |W2~(q)|^2, pair functions and coupling widths; the
    converted JAX masks equal the port's own."""
    jax_masks, port, converted = _masks()
    q = np.geomspace(0.1, 3000.0, 57)
    th = np.linspace(0.0, 0.4, 41)
    for name in ("disc", "pixel"):
        for m in (port[name], converted[name]):
            j = jax_masks[name]
            assert m.area2 == j.area2 and m.area4 == j.area4
            assert m.coupling_width == j.coupling_width
            np.testing.assert_array_equal(m.wtilde2_sq(q), j.wtilde2_sq(q))
            np.testing.assert_array_equal(m.pair_function(th),
                                          j.pair_function(th))
    np.testing.assert_array_equal(port["pixel"].pair_function2(th),
                                  jax_masks["pixel"].pair_function2(th))
    assert hash(port["pixel"]) == hash(converted["pixel"])
    assert port["pixel"] == converted["pixel"]
    assert port["uniform"].area4 == C.OMEGA_S
    with pytest.raises(TypeError, match="no converter"):
        from chomp_tpu_torch.utils import convert

        convert.mask(object())


def test_pair_normalization_coupling_and_field_phase():
    """pair_normalization (both), the coupling-matrix moments 0..8 and
    field_phase_suppression (spins 2 and 4) against JAX."""
    from chomp_tpu import mask as jm
    from chomp_tpu_torch import mask as pm

    jax_masks, port, _ = _masks()
    edges = np.radians(C.EDGES * 20.0)
    lnq = tuple(np.log(np.geomspace(1.0, 200.0, 24)))
    for name in ("disc", "pixel"):
        for sq in (False, True):
            np.testing.assert_allclose(
                pm.pair_normalization(port[name], edges, squared=sq),
                jm.pair_normalization(jax_masks[name], edges, squared=sq),
                rtol=TOL_GEOM)
        for moment in (0, 2, 4, 6, 8):
            a = pm._coupling_matrix(port[name], lnq, 96, moment=moment)
            b = jm._coupling_matrix(jax_masks[name], lnq, 96, moment=moment)
            assert C.peak_err(a, b) < TOL_GEOM
        for spin in (2, 4):
            np.testing.assert_allclose(
                pm.field_phase_suppression(port[name], np.exp(lnq), spin),
                jm.field_phase_suppression(jax_masks[name], np.exp(lnq),
                                           spin), rtol=TOL_GEOM, atol=1e-15)
    with pytest.raises(ValueError, match="spin"):
        pm.field_phase_suppression(port["disc"], np.ones(2), 3)


@pytest.mark.parametrize("name", ["disc", "pixel", "uniform"])
def test_masked_gaussian_covariance(name):
    """masked_gaussian_covariance against JAX at 512 log-ell nodes."""
    from chomp_tpu import mask as jm
    from chomp_tpu_torch import mask as pm

    jax_masks, port, _ = _masks()
    edges = C.EDGES * 10.0
    got = pm.masked_gaussian_covariance(
        lambda e: torch.tensor(_cl(e))[None], edges, C.N2D, port[name],
        n_ell_cov=512)
    want = np.asarray(jm.masked_gaussian_covariance(
        lambda e: jnp.asarray(_cl(e)), edges, C.N2D, jax_masks[name],
        n_ell_cov=512))
    assert got.shape == (1, 3, 3)
    assert C.peak_err(got[0], want) < TOL


def test_uniform_mask_reduces_to_gaussian_covariance():
    """UniformMask(Omega_s) equals covariance.gaussian_covariance (the
    JAX test tests/test_mask_covariance.py:32, its rtol 1e-10)."""
    from chomp_tpu_torch import covariance, mask as pm

    edges = covariance.theta_bin_edges_deg(n_bins=6)
    ref = covariance.gaussian_covariance(
        lambda e: torch.tensor(_cl(e))[None], edges, C.N2D, C.OMEGA_S,
        n_ell_cov=1024)
    got = pm.masked_gaussian_covariance(
        lambda e: torch.tensor(_cl(e))[None], edges, C.N2D,
        pm.UniformMask(C.OMEGA_S), n_ell_cov=1024)
    np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("case", ["disc", "beyond", "uniform"])
def test_masked_builders_gaussian_blocks(case):
    """The masked Gaussian blocks of the joint builders (3x2pt with a
    disc, plain and beyond-NKA; w + gamma_t with the uniform mask) at
    row 2 of the batch, against the JAX builders."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    _, port, _ = _masks()
    m = port["uniform" if case == "uniform" else "disc"]
    kw = dict(include_nongaussian=False, mask=m, st=p.st, **C.KW)
    args = (p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, C.OMEGA_S,
            C.N2D, C.SHAPE_NOISE)
    if case == "uniform":
        got = covariance.joint_wtheta_gammat_covariance(*args, **kw)
    else:
        got = covariance.joint_3x2pt_covariance(
            *args, beyond_nka=(case == "beyond"), **kw)
    assert C.block_err(got[2], C.ref("gaussian_masked", 2, case), 3) < TOL
