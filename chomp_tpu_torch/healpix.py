"""Minimal HEALPix RING-ordering pixelization (numpy, no healpy).

The port's copy of the JAX package's ``healpix.py`` (numpy only): what
:meth:`chomp_tpu_torch.curved.PixelSphereMask.from_healpix` needs to
ingest a survey mask shipped as a HEALPix map: ``npix``,
``pix2ang_ring``, ``ang2pix_ring`` (nside any positive integer; the RING
scheme needs no power of two) and the NESTED -> RING reordering.  The
geometry is the standard one (Gorski et al. 2005, ApJ 622, 759):
equal-area pixels on iso-latitude rings, a north polar cap (rings i =
1..nside-1 with 4i pixels), an equatorial belt (2 nside + 1 rings of 4
nside) and the mirrored south cap.
"""

from __future__ import annotations

import numpy as np

__all__ = ["npix", "pix2ang_ring", "ang2pix_ring", "nest2ring",
           "reorder_nest_to_ring"]


def npix(nside: int) -> int:
    """Total pixel count 12 nside²."""
    return 12 * int(nside) * int(nside)


def pix2ang_ring(nside: int, p):
    """(theta, phi) of RING-ordered pixel centers ``p`` (vectorized)."""
    nside = int(nside)
    p = np.asarray(p, dtype=np.int64)
    if np.any((p < 0) | (p >= npix(nside))):
        raise ValueError("pixel index out of range")
    ncap = 2 * nside * (nside - 1)
    n_pix = npix(nside)
    z = np.empty(p.shape, dtype=float)
    phi = np.empty(p.shape, dtype=float)

    # North polar cap: rings i = 1..nside-1, 4i pixels each.
    m = p < ncap
    if np.any(m):
        ph = (p[m] + 1) / 2.0
        i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(
            np.int64) + 1
        j = p[m] + 1 - 2 * i * (i - 1)
        z[m] = 1.0 - i * i / (3.0 * nside * nside)
        phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    # Equatorial belt: rings i = nside..3 nside, 4 nside pixels each.
    m = (p >= ncap) & (p < n_pix - ncap)
    if np.any(m):
        pp = p[m] - ncap
        i = pp // (4 * nside) + nside
        j = pp % (4 * nside) + 1
        fodd = 0.5 * (1 + ((i + nside) & 1))   # ring-parity phase shift
        z[m] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
        phi[m] = (j - fodd) * np.pi / (2.0 * nside)

    # South polar cap (mirror of the north).
    m = p >= n_pix - ncap
    if np.any(m):
        ps = n_pix - 1 - p[m]
        ph = (ps + 1) / 2.0
        i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(
            np.int64) + 1
        j = ps + 1 - 2 * i * (i - 1)
        z[m] = -(1.0 - i * i / (3.0 * nside * nside))
        # the mirror reverses the azimuth ordering within the ring
        phi[m] = (4 * i - j + 0.5) * np.pi / (2.0 * i)

    return np.arccos(np.clip(z, -1.0, 1.0)), phi % (2.0 * np.pi)


def _compress_even_bits(v):
    """Keep the even-position bits of ``v`` and pack them densely
    (the inverse of bit interleaving; int64, up to 32 output bits)."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


# Face layout constants (Gorski et al. 2005 Fig. 4): the base ring of
# each of the 12 faces (in units of nside) and its azimuthal offset
# (in units of pi/4).
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def nest2ring(nside: int, p):
    """RING index of NESTED-ordered pixels ``p`` (vectorized).

    NESTED requires nside a power of two.  Decompose p into face
    number f and within-face (ix, iy) by de-interleaving bits, then
    map to the ring index jr = jrll[f]·nside - ix - iy - 1 and the
    in-ring position (standard HEALPix geometry; validated without
    healpy by bijectivity + the parent/child nesting hierarchy against
    the already-validated RING angles, tests/test_healpix.py)."""
    nside = int(nside)
    if nside <= 0 or (nside & (nside - 1)) != 0:
        raise ValueError("NESTED ordering requires nside a power of 2")
    p = np.asarray(p, dtype=np.int64)
    if np.any((p < 0) | (p >= npix(nside))):
        raise ValueError("pixel index out of range")
    n_pix = npix(nside)
    ncap = 2 * nside * (nside - 1)
    f = p // (nside * nside)
    pf = p % (nside * nside)
    ix = _compress_even_bits(pf)
    iy = _compress_even_bits(pf >> 1)

    jr = _JRLL[f] * nside - ix - iy - 1       # ring index 1..4nside-1
    out = np.empty(p.shape, dtype=np.int64)

    north = jr < nside
    south = jr > 3 * nside
    eq = ~(north | south)
    # Number of pixels per quadrant on this ring + ring phase.
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    kshift = np.where(eq, (jr - nside) & 1, 0)
    jp = (_JPLL[f] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    startpix = np.where(
        north, 2 * nr * (nr - 1),
        np.where(south, n_pix - 2 * nr * (nr + 1),
                 ncap + (jr - nside) * 4 * nside))
    out[...] = startpix + jp - 1
    return out


def reorder_nest_to_ring(m):
    """Reorder a NESTED-ordered map array to RING ordering (the
    ingestion direction: ring_map[nest2ring(p)] = nest_map[p])."""
    m = np.asarray(m)
    ns = int(round(np.sqrt(m.shape[-1] / 12)))
    if 12 * ns * ns != m.shape[-1]:
        raise ValueError("map length is not 12 nside^2")
    out = np.empty_like(m)
    out[..., nest2ring(ns, np.arange(m.shape[-1]))] = m
    return out


def ang2pix_ring(nside: int, theta, phi):
    """RING pixel index containing each (theta, phi) (vectorized)."""
    nside = int(nside)
    theta = np.asarray(theta, dtype=float)
    phi = np.asarray(phi, dtype=float)
    z = np.cos(theta)
    tt = (phi % (2.0 * np.pi)) * (2.0 / np.pi)      # in [0, 4)
    out = np.empty(np.broadcast(theta, phi).shape, dtype=np.int64)
    z, tt = np.broadcast_arrays(z, tt)
    ncap = 2 * nside * (nside - 1)
    n_pix = npix(nside)

    eq = np.abs(z) <= 2.0 / 3.0
    if np.any(eq):
        temp1 = nside * (0.5 + tt[eq])
        temp2 = nside * z[eq] * 0.75
        jp = np.floor(temp1 - temp2).astype(np.int64)
        jm = np.floor(temp1 + temp2).astype(np.int64)
        ir = nside + 1 + jp - jm                 # 1..2 nside+1
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = ip % (4 * nside)
        out[eq] = ncap + (ir - 1) * 4 * nside + ip

    north = z > 2.0 / 3.0
    south = z < -2.0 / 3.0
    for m, is_north in ((north, True), (south, False)):
        if not np.any(m):
            continue
        tp = tt[m] - np.floor(tt[m])
        tmp = nside * np.sqrt(3.0 * (1.0 - np.abs(z[m])))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1                         # ring from the pole
        # ir = nside (reachable when z sits on the 2/3 boundary to
        # float precision) lands exactly on the first/last belt ring:
        # 2 nside (nside-1) + ip = ncap + ip — the cap closed form
        # continues consistently onto the boundary ring.  Clamp only
        # the (unreachable) overshoot.
        ir = np.minimum(ir, nside)
        ip = np.floor(tt[m] * ir).astype(np.int64) % (4 * ir)
        if is_north:
            out[m] = 2 * ir * (ir - 1) + ip
        else:
            out[m] = n_pix - 2 * ir * (ir + 1) + ip
    return out
