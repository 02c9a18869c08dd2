"""Parity of the port's exact-z covariance routes against the JAX package,
float64 on the CPU: the Chebyshev-anchored (``exact_z_anchors``) and
per-node (``exact_z=True``) connected term on both projection routes,
the anchored super-sample term, and the builders that take them.

The inputs are tests/torch_cov_cases.py's (small grid, three cosmologies,
the third with feedback, massive neutrinos and a_mod; J_ANCHORS anchors,
N_Z_EXACT GL nodes); the JAX values are the ``tiny`` block of
tests/data/torch_cov_more_reference.json (eager JAX, one cosmology at a
time).

Tolerances, relative to each block's peak: 1e-6 for a connected block
or T_proj and 1e-7 for an assembled matrix, as tests/test_torch_
covariance.py's (T̄'s K13 star term is cancellation noise at the table's
extreme k ratios, ROADMAP queue 3); 1e-12 for the super-sample term
alone (no T̄ enters; measured ~1e-14); the anchors against the per-node
route within 5e-3 of the peak, the JAX package's own gate
(tests/test_covariance.py:607).
"""

import pytest
import torch

import torch_cov_cases as C
from torch_threads import capped_threads  # noqa: F401 (autouse)

pytest.importorskip("jax")

TOL_CNG = 1e-6
TOL_TOTAL = 1e-7
TOL_SSC = 1e-12


def _windows(p):
    from chomp_tpu_torch.projection import WindowConvergence, WindowGalaxy

    return WindowGalaxy(p.dist), WindowConvergence(p.dist)


def _legs(p):
    return (p.models[0], p.models[1], p.models[1], p.models[0])


KW = dict(n_k_tri=16, u_stride=2)


@pytest.fixture(scope="module")
def proj():
    """projected_trispectrum on the exact-z routes: anchors (one model
    gggg, per-leg models gmgm), per-node table and lattice routes."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    win_g, win_k = _windows(p)
    gmgm = dict(windows=(win_g, win_k, win_g, win_k), tracers=tuple("gmgm"))
    run = covariance.projected_trispectrum
    return {
        "anchors.gggg": run(p.cosmo, p.halo, p.model, p.dist, C.ELLS,
                            exact_z_anchors=C.J_ANCHORS, st=p.st, **KW),
        "anchors.gmgm": run(p.cosmo, p.halo, _legs(p), p.dist, C.ELLS,
                            exact_z_anchors=C.J_ANCHORS, st=p.st, **gmgm,
                            **KW),
        "exact.table": run(p.cosmo, p.halo, p.model, p.dist, C.ELLS,
                           exact_z=True, n_z_tri=C.N_Z_EXACT, st=p.st,
                           **KW),
        "exact.lattice": run(p.cosmo, p.halo, _legs(p), p.dist, C.ELLS,
                             exact_z=True, method="lattice", st=p.st,
                             **gmgm, **KW)}


@pytest.mark.parametrize("key,row", [
    ("anchors.gggg", 0), ("anchors.gggg", 2), ("anchors.gmgm", 2),
    ("exact.table", 2), ("exact.lattice", 2)])
def test_projected_trispectrum_exact_z(proj, key, row):
    """Each route against JAX at 1e-6 of the peak: the anchors mix T̄/D^6
    over the J Chebyshev anchors per lattice node (per-leg models rebuilt
    once per distinct sample), the per-node routes rebuild the halo model
    and T̄ at every GL / lattice node."""
    route, case = key.split(".")
    want = C.ref_more("proj_anchors" if route == "anchors" else "proj_exact",
                      row, case)
    assert C.peak_err(proj[key][row], want) < TOL_CNG


def test_anchors_against_per_node_route():
    """The anchors against the per-node table route within 5e-3 of the
    peak (the JAX test tests/test_covariance.py:607: its J = 6, n_k_tri 32
    and 24 GL nodes, here on the small grid's lattice at stride 1)."""
    from chomp_tpu_torch import covariance

    p = C.port_side()
    kw = dict(n_k_tri=32, st=p.st)
    ex_tab = covariance.projected_trispectrum(
        p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z=True, n_z_tri=24,
        **kw)
    ex_anc = covariance.projected_trispectrum(
        p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z_anchors=6,
        u_stride=1, **kw)
    den = torch.amax(torch.abs(ex_tab), dim=(1, 2))
    err = torch.amax(torch.abs(ex_anc - ex_tab), dim=(1, 2)) / den
    assert torch.all(err < 5e-3), err


def test_exact_z_flags():
    """The two flags exclude each other; the anchors are a lattice-route
    feature; a support that differs between cosmology rows has no static
    anchor span (the JAX code's ValueError for a traced one)."""
    from chomp_tpu_torch import covariance
    from chomp_tpu_torch.projection import DNdzGaussian, WindowGalaxy

    p = C.port_side()
    with pytest.raises(ValueError, match="not both"):
        covariance.projected_trispectrum(
            p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z=True,
            exact_z_anchors=4, st=p.st)
    with pytest.raises(ValueError, match="lattice-route"):
        covariance.projected_trispectrum(
            p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z_anchors=4,
            method="table", st=p.st)
    f64 = dict(dtype=torch.float64)
    rows = WindowGalaxy(DNdzGaussian(
        torch.tensor(0.0, **f64), torch.tensor([1.8, 2.0, 2.2], **f64),
        torch.tensor(1.0, **f64), torch.tensor(0.2, **f64)))
    with pytest.raises(ValueError, match="concrete window supports"):
        covariance.projected_trispectrum(
            p.cosmo, p.halo, p.model, p.dist, C.ELLS, exact_z_anchors=4,
            windows=(rows,) * 4, tracers=("g",) * 4, st=p.st, **KW)
    assert covariance._anchor_span(_windows(p)) == (1e-3, 2.0)


def test_ssc_anchors(monkeypatch):
    """projected_ssc with two per-side samples and ssc_covariance (gg x
    gm on the disc) with anchors against JAX (1e-12 of the peak); the two
    samples' anchor responses come from ONE kernel A call over B x J x 2
    rows (the JAX code maps the anchors one after another)."""
    from chomp_tpu_torch import halo, ssc
    from chomp_tpu_torch.mask import DiscMask

    p = C.port_side()
    win_g, win_k = _windows(p)
    calls = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, mat, gal, cheb: (
        calls.append(mat.shape[0]), real(k, mat, gal, cheb))[1])
    pair = ssc.projected_ssc(
        p.cosmo, p.halo, (p.models[0], p.models[1]), C.ELLS, C.ELLS[:5],
        (win_g, win_g, win_g, win_k), ("g", "g", "g", "m"),
        ssc.sigma_b2_fn(p.cosmo, C.OMEGA_S, st=p.st), n_k_ssc=32,
        u_stride=2, exact_z_anchors=C.J_ANCHORS, st=p.st)
    assert calls == [3 * C.J_ANCHORS * 2]
    blk = ssc.ssc_covariance(
        p.cosmo, p.halo, p.model, p.dist, C.EDGES, DiscMask(C.DISC_RADIUS),
        windows=(win_g, win_g, win_g, win_k), tracers=("g", "g", "g", "m"),
        mu_i=0, mu_j=2, n_ell_cov=12, u_stride=2, n_k_ssc=32,
        exact_z_anchors=C.J_ANCHORS, st=p.st)
    for key, got in (("pair", pair), ("gggm", blk)):
        assert C.peak_err(got[2], C.ref_more("ssc_anchors", 2, key)) \
            < TOL_SSC, key


def test_joint_builder_exact_z(monkeypatch):
    """The joint w + gamma_t builder with anchors on the connected and
    super-sample terms, and with the per-node rebuilds (table route, no
    SSC), against JAX at row 2 (1e-7 of each block's peak); the anchored
    build launches kernel A twice: the lattice C_ell and the anchors'
    responses."""
    from chomp_tpu_torch import covariance, halo

    p = C.port_side()
    calls = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, mat, gal, cheb: (
        calls.append(mat.shape[0]), real(k, mat, gal, cheb))[1])
    args = (p.cosmo, p.halo, p.model, p.dist, p.dist, C.EDGES, C.OMEGA_S,
            C.N2D, C.SHAPE_NOISE)
    anchors = covariance.joint_wtheta_gammat_covariance(
        *args, include_ssc=True, exact_z_anchors=C.J_ANCHORS, st=p.st,
        **C.KW)
    assert calls == [3, 3 * C.J_ANCHORS]
    pernode = covariance.joint_wtheta_gammat_covariance(
        *args, exact_z=True, n_z_tri=C.N_Z_EXACT, st=p.st, **C.KW)
    assert C.block_err(anchors[2], C.ref_more("joint_anchors", 2), 3) \
        < TOL_TOTAL
    assert C.block_err(pernode[2], C.ref_more("joint_pernode", 2), 3) \
        < TOL_TOTAL


@pytest.mark.parametrize("route", ["anchors", "pernode"])
def test_joint_builder_exact_z_one_cosmology(route):
    """The exact-z joint builder at B = 1 (the third cosmology alone: the
    node and anchor rows then carry one cosmology each) against JAX
    there, 1e-7 of each block's peak."""
    import dataclasses

    from chomp_tpu_torch import covariance, halo

    p = C.port_side()
    one = dataclasses.replace(p.cosmo, **{
        k: v[2:] if v.dim() and v.shape[0] == 3 else v
        for k, v in p.cosmo.fields().items()})
    model = halo.build_halo_model(one, p.halo, p.hods[0],
                                  torch.tensor([C.Z_MODEL],
                                               dtype=torch.float64), p.st)
    opts = (dict(include_ssc=True, exact_z_anchors=C.J_ANCHORS)
            if route == "anchors" else dict(exact_z=True,
                                            n_z_tri=C.N_Z_EXACT))
    got = covariance.joint_wtheta_gammat_covariance(
        one, p.halo, model, p.dist, p.dist, C.EDGES, C.OMEGA_S, C.N2D,
        C.SHAPE_NOISE, st=p.st, **opts, **C.KW)
    assert got.shape[0] == 1
    assert C.block_err(got[0], C.ref_more(f"joint_{route}", 2), 3) \
        < TOL_TOTAL


def test_tomographic_builder_exact_z(monkeypatch):
    """The 2 x 2 tomographic builder with anchors in ng_kwargs and
    ssc_kwargs (connected and super-sample terms on the probe autos, per-
    bin HODs, nuisances) against JAX at row 2; kernel A is launched once
    for the lattice C_ell and once per distinct anchor span for every
    sample's anchor responses (B x J x 2 rows), not once per block."""
    from chomp_tpu_torch import covariance, halo

    p = C.port_side()
    t = C.TOMO
    calls = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, mat, gal, cheb: (
        calls.append(mat.shape[0]), real(k, mat, gal, cheb))[1])
    got = covariance.tomographic_3x2pt_covariance(
        p.cosmo, p.halo, p.models, p.lens, p.src, C.EDGES, C.OMEGA_S,
        t["n2d"], t["shape_noise"], n_ell_cov_g=C.KW["n_ell_cov_g"],
        include_nongaussian="autos", include_ssc="autos",
        nuisance=p.nuisance,
        ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"], u_stride=2,
                        n_k_ssc=32, exact_z_anchors=C.J_ANCHORS),
        n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=16, u_stride=2,
        exact_z_anchors=C.J_ANCHORS, st=p.st)
    rows = 3 * C.J_ANCHORS * len(p.models)
    assert len(calls) == 2 and calls[1] % rows == 0 and calls[1] > rows
    assert got.shape == (3, 36, 36)
    assert C.block_err(got[2], C.ref_more("tomo_anchors", 2), 3) < TOL_TOTAL
