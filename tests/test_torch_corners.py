"""The lattice route at the prior corners against the JAX package
(float64 CPU).

The float32 serving gate of the JAX package (tests/test_f32_budget.py)
holds configuration A's pipeline across the prior: low/high (omega_m,
sigma_8), the CPL (w0, wa) phantom and quintessence corners, an open
Omega_k = 0.10 case (``utils.corners``) and two near-fiducial points,
flat on its grid and curved on its wide-angle grid.  The port's float64
lattice route is held here to the JAX float64 outputs that
tools/torch_slice_reference.py commits in the ``corners`` block of
tests/data/torch_families_reference.json, at 1e-10 of each row's peak;
chip_smoke.py phase 24 holds the card's float32 to its float64 there.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chomp_tpu_torch import default_cosmo, default_halo, default_hod
from chomp_tpu_torch.params import GridSpec
from chomp_tpu_torch.parallel.sweep import make_pipeline
from chomp_tpu_torch.projection import DNdzGaussian
from chomp_tpu_torch.utils import corners
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
REF = json.loads((Path(__file__).parent / "data"
                  / "torch_families_reference.json").read_text())


def test_corner_table_is_the_reference_table():
    from chomp_tpu.utils import corners as jcorners

    assert corners.PRIOR_CORNERS == jcorners.PRIOR_CORNERS
    assert REF["prior_corners"] == {k: list(v) for k, v in
                              corners.PRIOR_CORNERS.items()}
    assert [list(r) for r in corners.NEAR_FIDUCIAL] == REF["near_fiducial"]
    assert corners.corner_arrays(corners.NEAR_FIDUCIAL) == \
        jcorners.corner_arrays(extra=corners.NEAR_FIDUCIAL)
    batch = corners.corner_batch(default_cosmo(**KW))
    assert batch.omega_m0.shape == (7,)
    ok = (1.0 - batch.omega_m0 - batch.omega_l0).numpy()
    np.testing.assert_allclose(ok, [0, 0, 0, 0, 0.1, 0, 0], atol=1e-15)


@pytest.mark.parametrize("geometry", ["flat", "curved"])
def test_lattice_route_at_the_corners_matches_jax(geometry):
    block = REF["corners"][geometry]
    grid = GridSpec(**block["grid"])
    dist = DNdzGaussian(*(torch.tensor(v, **KW)
                          for v in (0.0, 2.0, 1.0, 0.2)))
    pipe = make_pipeline(default_halo(**KW), default_hod(**KW), dist,
                         grid=grid, geometry=geometry, **KW)
    out = pipe(corners.corner_batch(default_cosmo(**KW)))
    np.testing.assert_allclose(out["theta_deg"].numpy(), block["theta_deg"],
                               rtol=1e-14)
    for key in ("w_theta", "gamma_t", "n_g"):
        ref = np.asarray(block[key])
        got = out[key].numpy()
        peak = np.max(np.abs(ref), axis=-1, keepdims=True)
        assert np.max(np.abs(got - ref) / peak) < 1e-10, key
    assert dataclasses.asdict(grid) == block["grid"]
