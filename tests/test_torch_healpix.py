"""The port's HEALPix RING / NESTED pixelization (chomp_tpu_torch.healpix,
numpy) against the JAX package's module, exactly, and the JAX tests'
self-validation on the port (tests/test_healpix.py: the round-trip
bijection, the ring structure, the equal-area Monte Carlo, the nesting
hierarchy and the from_healpix ingestion against the analytic cap)."""

import numpy as np
import pytest

from chomp_tpu_torch.healpix import (ang2pix_ring, nest2ring, npix,
                                     pix2ang_ring, reorder_nest_to_ring)
from torch_threads import capped_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("nside", [1, 2, 3, 4, 8, 16, 64])
def test_roundtrip_and_parity(nside):
    """ang2pix(pix2ang(p)) == p for every pixel, and both functions equal
    the JAX package's bit for bit (angles of every pixel; pixels of
    random angles)."""
    from chomp_tpu import healpix as jhp

    p = np.arange(npix(nside))
    th, ph = pix2ang_ring(nside, p)
    np.testing.assert_array_equal(ang2pix_ring(nside, th, ph), p)
    jth, jph = jhp.pix2ang_ring(nside, p)
    np.testing.assert_array_equal(th, jth)
    np.testing.assert_array_equal(ph, jph)
    rng = np.random.default_rng(nside)
    t = np.arccos(rng.uniform(-1.0, 1.0, 2000))
    f = rng.uniform(0.0, 2.0 * np.pi, 2000)
    np.testing.assert_array_equal(ang2pix_ring(nside, t, f),
                                  jhp.ang2pix_ring(nside, t, f))
    assert npix(nside) == jhp.npix(nside)
    with pytest.raises(ValueError, match="out of range"):
        pix2ang_ring(nside, [npix(nside)])


def test_ring_structure():
    """Monotone z with pixel index, 4i pixels in cap ring i, 4 nside in
    the belt, and the documented z values (tests/test_healpix.py:24)."""
    nside = 8
    th, _ = pix2ang_ring(nside, np.arange(npix(nside)))
    z = np.cos(th)
    assert np.all(np.diff(z) < 1e-12)
    ring_z, counts = np.unique(np.round(z, 12), return_counts=True)
    assert len(ring_z) == 4 * nside - 1
    counts = counts[::-1]
    for i in range(1, nside):
        assert counts[i - 1] == 4 * i
        assert counts[-i] == 4 * i
    assert np.all(counts[nside - 1:3 * nside] == 4 * nside)
    z_sorted = np.sort(ring_z)[::-1]
    for i in range(1, nside):
        np.testing.assert_allclose(z_sorted[i - 1],
                                   1.0 - i * i / (3.0 * nside**2),
                                   atol=1e-12)
    for i in range(nside, 3 * nside + 1):
        np.testing.assert_allclose(z_sorted[i - 1],
                                   4.0 / 3.0 - 2.0 * i / (3.0 * nside),
                                   atol=1e-12)


def test_equal_area_mc():
    """Uniform random points fill every pixel equally, within 5 Poisson
    sigma (tests/test_healpix.py:50)."""
    rng = np.random.default_rng(0)
    nside, n = 16, 400000
    z = rng.uniform(-1.0, 1.0, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    counts = np.bincount(ang2pix_ring(nside, np.arccos(z), ph),
                         minlength=npix(nside))
    exp = n / npix(nside)
    assert np.max(np.abs(counts - exp)) / np.sqrt(exp) < 5.0


def test_nest2ring_bijection_and_hierarchy():
    """nest2ring is a bijection equal to the JAX package's; the children
    of a nested pixel lie in their parent; the base pixels sit on their
    known faces; the reordering round-trips (tests/test_healpix.py:95)."""
    from chomp_tpu import healpix as jhp

    for nside in (1, 2, 4, 16):
        perm = nest2ring(nside, np.arange(npix(nside)))
        assert np.array_equal(np.sort(perm), np.arange(npix(nside)))
        np.testing.assert_array_equal(
            perm, jhp.nest2ring(nside, np.arange(npix(nside))))
    for nside in (2, 8):
        p = np.arange(npix(nside))
        for c in range(4):
            th, ph = pix2ang_ring(2 * nside, nest2ring(2 * nside, 4 * p + c))
            assert np.array_equal(ang2pix_ring(nside, th, ph),
                                  nest2ring(nside, p)), (nside, c)
    th, _ = pix2ang_ring(1, nest2ring(1, np.arange(12)))
    z = np.cos(th)
    assert np.all(z[:4] > 0.5) and np.all(np.abs(z[4:8]) < 1e-12) \
        and np.all(z[8:] < -0.5)
    nside = 4
    nest_map = np.arange(npix(nside), dtype=float)
    ring_map = reorder_nest_to_ring(nest_map)
    assert np.array_equal(
        ring_map[nest2ring(nside, np.arange(npix(nside)))], nest_map)
    np.testing.assert_array_equal(ring_map,
                                  jhp.reorder_nest_to_ring(nest_map))
    with pytest.raises(ValueError):
        nest2ring(3, 0)


def test_from_healpix_cap():
    """A polar cap painted at nside 64, ingested by
    PixelSphereMask.from_healpix, matches the analytic cap at its
    effective radius: pair function within 5% of A2, pair counts within
    3%, exact zero-lag anchors (tests/test_healpix.py:64); the NESTED
    ingestion of the same map equals the RING one (:140)."""
    from chomp_tpu_torch.curved import (PixelSphereMask, SphericalCapMask,
                                        curved_pair_normalization)

    nside = 64
    rad = np.radians(25.0)
    th, _ = pix2ang_ring(nside, np.arange(npix(nside)))
    hp_map = (th <= rad).astype(float)
    m = PixelSphereMask.from_healpix(hp_map)
    r_eff = np.arccos(1.0 - m.area2 / (2.0 * np.pi))
    assert abs(r_eff - rad) < 2.0 * np.pi / (4.0 * nside)
    ref = SphericalCapMask(r_eff)
    th_g = np.radians(np.linspace(0.3, 48.0, 100))
    dev = (m.pair_function(th_g) - ref.pair_function(th_g)) / ref.area2
    assert np.max(np.abs(dev)) < 0.05
    np.testing.assert_allclose(m.xi_w2(1.0), m.area4 / (4.0 * np.pi),
                               rtol=1e-12)
    edges = np.radians([1.0, 2.0, 4.0, 8.0])
    np.testing.assert_allclose(curved_pair_normalization(m, edges),
                               curved_pair_normalization(ref, edges),
                               rtol=3e-2)
    nside = 8
    th, _ = pix2ang_ring(nside, np.arange(npix(nside)))
    ring = (np.cos(th) > 0.4).astype(float)
    nest = ring[nest2ring(nside, np.arange(npix(nside)))]
    m1 = PixelSphereMask.from_healpix(ring, n_ring=64)
    m2 = PixelSphereMask.from_healpix(nest, n_ring=64, order="NESTED")
    assert m1.area2 == m2.area2
    tq = np.linspace(0.01, 3.0, 50)
    np.testing.assert_array_equal(m1.pair_function(tq), m2.pair_function(tq))
