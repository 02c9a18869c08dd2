"""Shared inputs of the covariance-stack parity tests
(tests/test_torch_trispectrum.py, test_torch_mask.py, test_torch_ssc.py,
test_torch_covariance.py, and test_torch_cov_exactz.py,
test_torch_cov_cmb.py, test_torch_curved_cov.py) and of the ``tiny``
blocks of tests/data/torch_cov_reference.json and
torch_cov_more_reference.json that hold their JAX values.

One small grid (the JAX covariance tests' ``GridSpec(n_mass=48, n_mu=8,
...)`` with the tomographic tests' 0.08 lattice and a 512-node k
table), the JAX tests' survey numbers (Omega_s 0.1 sr, 3e7 galaxies per
sr, three log bins over the default theta range) and their knobs (n_k_tri 16, n_ell_cov_ng 12, n_ell_cov_g 96, here
u_stride 2 on the coarser lattice), ``tests/torch_parity.py``'s three
cosmologies (the third with baryonic feedback, massive neutrinos and
a_mod), and a 2 x 2 tomographic layout with per-bin HODs and a nuisance
point.  Both packages build everything here from the same numbers;
:func:`jax_side` and :func:`port_side` return the objects of one
package.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np

from chomp_tpu.params import DEFAULT_GRID, GridSpec

GRID = GridSpec(n_mass=48, n_mu=8, sigma_panels=6, sigma_n_per_panel=24,
                n_growth=24, n_dist=24, lattice_dln=0.08, n_k_table=512)
OMEGA_S = 0.1
N2D = 3.0e7
SHAPE_NOISE = 1.0e-9
EDGES = np.logspace(np.log10(DEFAULT_GRID.theta_min_deg),
                    np.log10(DEFAULT_GRID.theta_max_deg), 4)
KW = dict(n_k_tri=16, n_ell_cov_ng=12, n_ell_cov_g=96, u_stride=2)
Z_MODEL = 0.3
COSMO = dict(omega_m0=[0.25, 0.278, 0.31], sigma_8=[0.76, 0.811, 0.86],
             bary_c=[1.0, 1.0, 0.8], bary_eta=[0.0, 0.0, 0.3],
             m_nu=[0.0, 0.0, 0.1], a_mod=[1.0, 1.0, 1.1])
DIST = dict(z_min=0.0, z_max=2.0, z0=1.0, sigma_z=0.2)
HOD_B = dict(log10_m_min=12.6, log10_m_0=12.6, log10_m_1p=13.9, alpha=1.05)
#: The 2 x 2 tomographic layout: lens and source dN/dz, the per-bin HODs
#: (default, HOD_B), the model redshift and the nuisance point.
TOMO = dict(lens=[dict(z_min=0.0, z_max=2.5, z0=0.4, sigma_z=0.12),
                  dict(z_min=0.0, z_max=2.5, z0=0.7, sigma_z=0.12)],
            src=[dict(z_min=0.0, z_max=2.5, z0=0.8, sigma_z=0.2),
                 dict(z_min=0.0, z_max=2.5, z0=1.2, sigma_z=0.25)],
            z_model=0.6, n2d=[2.0e7, 3.0e7], shape_noise=[1.0e-9, 2.0e-9],
            nuisance=dict(dz_lens=[0.01, -0.02], dz_src=[0.015, -0.01],
                          m=[0.01, -0.02], a_ia=0.5, eta_ia=0.3,
                          z0_ia=0.62, alpha_lens=[1.4, 0.7]))
#: k of the trispectrum and response checks, h/Mpc.
K_TRI = np.geomspace(1e-2, 10.0, 6)
#: ells of the projected trispectrum checks.
ELLS = np.logspace(1, 3.5, 8)
#: The disc of the masked cases: Omega_s's equal-area radius.
DISC_RADIUS = float(np.sqrt(OMEGA_S / np.pi))
#: The Chebyshev anchors of the exact-z cases.
J_ANCHORS = 4
#: The GL nodes of the per-node exact-z table route.
N_Z_EXACT = 8
#: The curved-sky cases: a 30-degree polar cap, a two-cap pixel map on a
#: 48 x 96 iso-latitude grid, bins of 1-15 degrees, multipoles to 256
#: with the dense coupling to 64 (one 1280-node quadrature per mask).
CURVED = dict(cap_deg=30.0, edges_deg=[1.0, 2.5, 6.0, 15.0], ell_max=256,
              ell_split=64, n_ell_tbl=16, n_k_ssc=32,
              map_shape=(48, 96), map_cap_deg=25.0, map_center2=(2.0, 1.0))
#: The kappa_CMB reconstruction noise table of the cmb cases.
CMB_NL_ELL = np.geomspace(2.0, 5000.0, 24)
CMB_NL = 1.0e-7 * (1.0 + (CMB_NL_ELL / 800.0) ** 2)


def two_cap_map(n_ring, n_phi, radius_deg, center2):
    """A binary two-cap footprint on the iso-latitude grid (numpy; the
    map of examples/curved_sky_example.py)."""
    th = (np.arange(n_ring) + 0.5) * np.pi / n_ring
    ph = np.arange(n_phi) * 2 * np.pi / n_phi
    rad = np.radians(radius_deg)

    def cap(center):
        ct0, st0 = np.cos(center[0]), np.sin(center[0])
        mu = (ct0 * np.cos(th)[:, None] + st0 * np.sin(th)[:, None]
              * np.cos(ph[None, :] - center[1]))
        return mu >= np.cos(rad)

    return (cap((0.0, 0.0)) | cap(center2)).astype(float)


def curved_masks(curved_module):
    """(cap, pixel) masks of CURVED from a package's ``curved`` module."""
    c = CURVED
    return (curved_module.SphericalCapMask(np.radians(c["cap_deg"])),
            curved_module.PixelSphereMask(two_cap_map(
                *c["map_shape"], c["map_cap_deg"], c["map_center2"])))


def cosmo_row(i):
    """COSMO's row ``i`` as keywords (omega_l0 = 1 - omega_m0)."""
    row = {k: v[i] for k, v in COSMO.items()}
    row["omega_l0"] = 1.0 - row["omega_m0"]
    return row


@lru_cache(maxsize=None)
def pixel_map():
    """A 48 x 48 weight map: a disc of radius 0.15 rad with a hole and
    a soft edge, at 0.01 rad pixels (numpy)."""
    n, a = 48, 0.01
    yy, xx = np.mgrid[:n, :n]
    r = np.hypot(yy - n / 2 + 0.5, xx - n / 2 + 0.5) * a
    w = np.clip((0.15 - r) / 0.02 + 0.5, 0.0, 1.0)
    w[np.hypot(yy - 30, xx - 18) * a < 0.03] = 0.0
    return w, a


def jax_side(i=None):
    """The JAX package's objects (cosmology row ``i``, or the batch of
    all three when None)."""
    import dataclasses

    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo, halo, mask
    from chomp_tpu import projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import Nuisance3x2pt

    def gauss(spec):
        return projection.DNdzGaussian(**{k: jnp.asarray(float(v))
                                          for k, v in spec.items()})

    cosmo = dataclasses.replace(default_cosmo(), **{
        k: jnp.asarray(v) for k, v in cosmo_row(i).items()})
    hp = default_halo()
    hods = [default_hod(), default_hod(**HOD_B)]
    nu = TOMO["nuisance"]
    return SimpleNamespace(
        cosmo=cosmo, halo=hp, hods=hods, dist=gauss(DIST),
        model=halo.build_halo_model(cosmo, hp, hods[0], Z_MODEL, False,
                                    GRID),
        models=halo.build_halo_models(cosmo, hp, hods, TOMO["z_model"],
                                      False, GRID),
        lens=[gauss(d) for d in TOMO["lens"]],
        src=[gauss(d) for d in TOMO["src"]],
        nuisance=Nuisance3x2pt(**{k: jnp.asarray(v)
                                  for k, v in nu.items()}),
        disc=mask.DiscMask(DISC_RADIUS), uniform=mask.UniformMask(OMEGA_S),
        pixel=mask.PixelMask(*pixel_map()))


@lru_cache(maxsize=None)
def port_side():
    """The port's objects for the batch of the three cosmologies (float64
    CPU)."""
    import torch

    from chomp_tpu_torch import default_cosmo, default_halo, halo
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.parallel.sweep import (Nuisance3x2pt,
                                                broadcast_cosmo)
    from chomp_tpu_torch.projection import DNdzGaussian

    kw = dict(device="cpu", dtype=torch.float64)
    st = Statics(GRID, **kw)
    rows = [cosmo_row(i) for i in range(3)]
    cosmo = broadcast_cosmo(default_cosmo(**kw), **{
        k: torch.tensor([r[k] for r in rows], **kw) for k in rows[0]})
    hp = default_halo(**kw)
    from chomp_tpu_torch.hod import default_hod

    hods = [default_hod(**kw), default_hod(**kw, **HOD_B)]

    def gauss(spec):
        return DNdzGaussian(**{k: torch.tensor(float(v), **kw)
                               for k, v in spec.items()})

    z = torch.tensor([Z_MODEL], **kw)
    nu = TOMO["nuisance"]
    return SimpleNamespace(
        st=st, cosmo=cosmo, halo=hp, hods=hods, dist=gauss(DIST),
        model=halo.build_halo_model(cosmo, hp, hods[0], z, st),
        models=halo.build_halo_models(
            cosmo, hp, hods, torch.tensor([TOMO["z_model"]], **kw), st),
        lens=[gauss(d) for d in TOMO["lens"]],
        src=[gauss(d) for d in TOMO["src"]],
        nuisance=Nuisance3x2pt(**{k: torch.tensor(v, **kw)
                                  for k, v in nu.items()}))


REFERENCE = "torch_cov_reference.json"
MORE_REFERENCE = "torch_cov_more_reference.json"


@lru_cache(maxsize=None)
def reference(name=REFERENCE):
    """The ``tiny`` block of tests/data/``name``: case -> row -> JAX
    value(s) (written by ``python tools/torch_slice_reference.py
    <name>``)."""
    import json
    from pathlib import Path

    data = json.loads((Path(__file__).parent / "data" / name)
                      .read_text())["tiny"]
    assert data["grid"] == __import__("dataclasses").asdict(GRID), \
        f"tests/data/{name} is stale: regenerate it"
    return data["cases"]


def ref(case, row, key=None, name=REFERENCE):
    """One JAX reference array (float64 numpy)."""
    val = reference(name)[case][str(row)]
    return np.asarray(val if key is None else val[key], dtype=np.float64)


def ref_more(case, row, key=None):
    """One JAX reference array of torch_cov_more_reference.json."""
    return ref(case, row, key, MORE_REFERENCE)


def peak_err(got, want):
    """max|got - want| / max|want| (numpy or torch ``got``)."""
    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def block_err(got, want, nb):
    """The worst :func:`peak_err` over the nb x nb blocks of two matrices."""
    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got)
    n = want.shape[-1] // nb
    return max(peak_err(got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb],
                        want[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
               for i in range(n) for j in range(n))
