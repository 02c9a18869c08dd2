"""Parity of the port's flat-sky super-sample covariance
(chomp_tpu_torch.ssc) against the JAX package, float64 on the CPU.

The JAX values are the ``pieces`` case of
tests/data/torch_cov_reference.json at rows 0 and 2 of
tests/torch_cov_cases.py's batch (row 2: baryonic feedback, which the
response's 1-halo integrals must NOT see while the 2-halo and spectra
terms do).  Tolerances, relative to each array's peak: 1e-12 for the
response parts, the 1-halo response integrals, dln k^3 P / dln k,
sigma_b^2 and the SSC blocks (measured ~1e-15: no trispectrum in them).
"""

import numpy as np
import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

TOL = 1e-12


def _k():
    return torch.tensor(C.K_TRI, dtype=torch.float64)


def _masks():
    from chomp_tpu_torch import mask as pm

    return {"disc": pm.DiscMask(C.DISC_RADIUS),
            "pixel": pm.PixelMask(*C.pixel_map()),
            "uniform": pm.UniformMask(C.OMEGA_S)}


@pytest.mark.parametrize("row", [0, 2])
def test_response_parts(row):
    """power_response_parts (pos and cnt), power_responses without the
    counts term, response_one_halo_integrals and _dln_k3p_dlnk."""
    from chomp_tpu_torch import ssc

    p, k = C.port_side(), _k()
    pos, cnt = ssc.power_response_parts(p.cosmo, p.halo, p.model, k,
                                        st=p.st)
    got = {f"pos.{a}": pos[a] for a in pos}
    got.update({f"cnt.{a}": cnt[a] for a in ("gm", "gg")})
    got.update({f"resp_nolocal.{a}": v for a, v in ssc.power_responses(
        p.cosmo, p.halo, p.model, k, local_counts=False, st=p.st).items()})
    got.update({f"resp_1h.{j}": v for j, v in enumerate(
        ssc.response_one_halo_integrals(p.cosmo, p.halo, p.model, k))})
    got["dlnk3p"] = ssc._dln_k3p_dlnk(p.cosmo, k, p.st)
    for key, v in got.items():
        err = C.peak_err(v[row], C.ref("pieces", row, key))
        assert err < TOL, (key, err)
    assert torch.all(cnt["mm"] == 0.0)


def test_primed_responses_equal_per_model_parts():
    """_prime_responses (every sample's kernel A rows in one launch)
    gives each model's power_response_parts."""
    from chomp_tpu_torch import ssc
    from chomp_tpu_torch.covariance import _Memo

    p = C.port_side()
    memo = _Memo()
    ssc._prime_responses(p.cosmo, p.halo, p.models, p.st, memo, n_k_ssc=32)
    _, _, kk = ssc._k_ssc(32, p.st)
    for m in p.models:
        primed = memo.get(ssc._response_key(m, 32, True), None)
        direct = ssc.power_response_parts(p.cosmo, p.halo, m, kk, st=p.st)
        for a, b in zip(primed, direct):
            for key in ("mm", "gm", "gg"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-13,
                                           atol=0.0)


@pytest.mark.parametrize("row", [0, 2])
def test_sigma_b2(row):
    """sigma_b2_flat for the disc, pixel and uniform masks and
    sigma_b2_fn of a bare solid angle (its equal-area disc)."""
    from chomp_tpu_torch import ssc

    p = C.port_side()
    chi = torch.tensor(np.geomspace(200.0, 3000.0, 5))[None]
    g = torch.tensor(np.linspace(0.9, 0.5, 5))[None]
    for name, m in _masks().items():
        got = ssc.sigma_b2_flat(p.cosmo, m, chi, g, st=p.st)
        assert C.peak_err(got[row], C.ref("pieces", row,
                                          f"sigma_b2.{name}")) < TOL
    got = ssc.sigma_b2_fn(p.cosmo, C.OMEGA_S, st=p.st)(chi, g)
    assert C.peak_err(got[row], C.ref("pieces", row, "sigma_b2.omega")) < TOL


@pytest.mark.parametrize("case", ["gggg", "gggm", "mmmm"])
def test_ssc_blocks(case):
    """ssc_covariance on the disc footprint for ww, w-gt and xi_- x
    xi_- probe pairs, against JAX at rows 0 and 2."""
    from chomp_tpu_torch import ssc
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    p = C.port_side()
    win_g, win_k = WindowGalaxy(p.dist), WindowConvergence(p.dist)
    ws, ts, mi, mj = {"gggg": ((win_g,) * 4, ("g",) * 4, 0, 0),
                      "gggm": ((win_g, win_g, win_g, win_k),
                               ("g", "g", "g", "m"), 0, 2),
                      "mmmm": ((win_k,) * 4, ("m",) * 4, 4, 4)}[case]
    got = ssc.ssc_covariance(p.cosmo, p.halo, p.model, p.dist, C.EDGES,
                             _masks()["disc"], windows=ws, tracers=ts,
                             mu_i=mi, mu_j=mj, n_ell_cov=12, u_stride=2,
                             st=p.st)
    for row in (0, 2):
        assert C.peak_err(got[row], C.ref("pieces", row, f"ssc.{case}")) \
            < TOL


def test_projected_ssc_two_models():
    """projected_ssc with per-side models (the two HODs) and distinct
    ell grids on the two sides."""
    from chomp_tpu_torch import ssc
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    p = C.port_side()
    win_g, win_k = WindowGalaxy(p.dist), WindowConvergence(p.dist)
    got = ssc.projected_ssc(
        p.cosmo, p.halo, (p.models[0], p.models[1]), C.ELLS, C.ELLS[:5],
        (win_g, win_g, win_g, win_k), ("g", "g", "g", "m"),
        ssc.sigma_b2_fn(p.cosmo, C.OMEGA_S, st=p.st), n_k_ssc=32,
        u_stride=2, st=p.st)
    assert got.shape == (3, 8, 5)
    for row in (0, 2):
        assert C.peak_err(got[row], C.ref("pieces", row, "ssc.pair")) < TOL


def test_ssc_block_gradient():
    """d(sum of the w-gt SSC block)/d omega_m0 through the responses'
    autograd log-derivative (create_graph) agrees with central
    differences (1e-6 relative; step 1e-5)."""
    import dataclasses

    from chomp_tpu_torch import halo, ssc
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    p = C.port_side()
    win_g, win_k = WindowGalaxy(p.dist), WindowConvergence(p.dist)
    z = torch.tensor([C.Z_MODEL], dtype=torch.float64)

    def total(om):
        c = dataclasses.replace(p.cosmo, omega_m0=om, omega_l0=1.0 - om)
        m = halo.build_halo_model(c, p.halo, p.hods[0], z, p.st)
        return ssc.ssc_covariance(
            c, p.halo, m, p.dist, C.EDGES, C.OMEGA_S,
            windows=(win_g, win_g, win_g, win_k),
            tracers=("g", "g", "g", "m"), mu_i=0, mu_j=2, n_ell_cov=12,
            u_stride=2, n_k_ssc=32, st=p.st).sum(dim=(1, 2))

    om = p.cosmo.omega_m0.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(total(om).sum(), om)
    h = 1e-5
    with torch.no_grad():
        fd = (total(om + h) - total(om - h)) / (2 * h)
    np.testing.assert_allclose(grad, fd, rtol=1e-6)


def test_deferred_routes_raise():
    """The curved sky and the exact-z anchors, which raised until their
    slice, now give results (parity: tests/test_torch_curved_cov.py and
    test_torch_cov_exactz.py): a bare solid angle's curved sigma_b^2 is
    its polar cap's (1e-15), and the curved block still rejects an
    unknown estimator code."""
    from chomp_tpu_torch import ssc
    from chomp_tpu_torch.curved import SphericalCapMask

    p = C.port_side()
    chi = torch.tensor([[600.0, 1500.0]], dtype=torch.float64)
    g = torch.tensor([[0.8, 0.6]], dtype=torch.float64)
    radius = float(np.arccos(1.0 - C.OMEGA_S / (2.0 * np.pi)))
    got = ssc.sigma_b2_fn(p.cosmo, C.OMEGA_S, geometry="curved",
                          st=p.st)(chi, g)
    want = ssc.sigma_b2_curved(p.cosmo, SphericalCapMask(radius), chi, g,
                               st=p.st)
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0)
    with pytest.raises(ValueError, match="estimator code"):
        ssc.curved_ssc_covariance(p.cosmo, p.halo, p.model, p.dist,
                                  C.EDGES, C.OMEGA_S, mu_i=3, ell_max=64,
                                  n_ell_tbl=8, n_k_ssc=16, u_stride=2,
                                  st=p.st)
