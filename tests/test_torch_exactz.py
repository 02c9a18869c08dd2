"""The exact-z lattice route and the shear outputs of chomp_tpu_torch
against the JAX package (float64 CPU).

- The Chebyshev anchors and barycentric Lagrange rows against the JAX
  functions; the machinery test of tests/test_exact_z_lattice.py (linear
  P is separable, so the anchored route reproduces the separable one);
  the anchored C_ell at that file's configuration against the JAX
  lattice and table routes.
- ``make_pipeline(exact_z_anchors=4, include_shear=True)`` and both
  separable routes with shear on the parity grid, and the exact-z
  Jacobian, against the JAX package.
- The design of the exact-z forward: one kernel A call over B x J rows,
  one kernel C call per distinct operator, the clamp of the Lagrange
  rows, no separable-bias warning.

The JAX values of the pipelines, the C_ell and the Jacobian are committed
in tests/data/torch_exactz_reference.json by tools/torch_slice_reference.py
(JAX float64 on the CPU; compiling them here would cost ~95 s); each block
records its grid and cosmologies, checked below.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu import limber_fft as jlimber
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import (DNdzGaussian, background, correlation,
                             default_cosmo, inference, limber_fft,
                             projection)
from chomp_tpu_torch import default_halo as port_halo
from chomp_tpu_torch import default_hod as port_hod
from chomp_tpu_torch import halo as port_halo_mod
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.params import GridSpec
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import test_exact_z_lattice as tz
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
REF = json.loads((Path(__file__).parent / "data"
                  / "torch_exactz_reference.json").read_text())
TINY = REF["tiny_grid"]
KEYS = ("n_g", "w_theta", "gamma_t", "xi_plus", "xi_minus")


def _row_peak_err(got, ref):
    """max over rows of max|got - ref| / max|ref| (last axis = theta); a
    1-D ``ref`` (n_g) is compared elementwise."""
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.ndim == 1:
        return float(np.max(np.abs(got / ref - 1.0)))
    return float(np.max(np.max(np.abs(got - ref), axis=-1)
                        / np.max(np.abs(ref), axis=-1)))


def _pipeline(dtype=torch.float64, **options):
    kw = dict(device="cpu", dtype=dtype)
    args = dict(power_spec="power_gg", grid=tp.GRID, include_lensing=True,
                z_pivot=tp.Z_PIVOT, include_shear=True)
    args.update(options)
    return sweep.make_pipeline(
        convert.halo_params(default_halo(), **kw),
        convert.hod_zheng(default_hod(), **kw),
        convert.dndz_gaussian(tp.jax_dist(), **kw), **args, **kw)


def _batch(dtype=torch.float64):
    return convert.cosmo_batch(tp.jax_batch(), device="cpu", dtype=dtype)


ROUTES = {"exact_z": dict(exact_z_anchors=TINY["exact_z_anchors"]),
          "fft": {}, "table": dict(method="table")}


@pytest.fixture(scope="module")
def outs():
    """Each route's outputs (float64 and float32) on the parity batch."""
    res = {}
    for name, options in ROUTES.items():
        res[name] = {dt: _pipeline(dt, **options)(_batch(dt))
                     for dt in (torch.float64, torch.float32)}
    return res


def test_reference_is_current():
    """The committed JAX values were written for these grids, cosmologies
    and anchors."""
    assert TINY["grid"] == dataclasses.asdict(tp.GRID)
    assert TINY["cosmo"] == tp.COSMO
    assert REF["cl_exact_z"]["grid"] == dataclasses.asdict(tz.G)
    dist = tz._win().dist
    assert REF["cl_exact_z"]["dist"] == [float(dist.z_min),
                                         float(dist.z_max), float(dist.z0),
                                         float(dist.sigma_z)]


@pytest.mark.parametrize("n", [2, 6, 9])
def test_cheb_nodes_and_barycentric_rows_match_jax(n):
    """The static Chebyshev nodes and weights equal the JAX ones; the
    batched Lagrange rows (B, n, J) match the JAX rows of each cosmology
    (1e-14), exact node hits included, and sum to 1."""
    z, w = limber_fft._cheb_nodes(1e-3, 2.0, n)
    jz, jw = jlimber._cheb_nodes(1e-3, 2.0, n)
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(w, jw)
    rng = np.random.default_rng(n)
    zq = rng.uniform(1e-3, 2.0, (3, 40))
    zq[1, :n] = z                                 # exact node hits
    got = limber_fft._barycentric_rows(torch.tensor(zq), z, w).numpy()
    assert got.shape == (3, 40, n)
    for b in range(3):
        ref = np.asarray(jlimber._barycentric_rows(jnp.asarray(zq[b]), z, w))
        np.testing.assert_allclose(got[b], ref, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-13)


@pytest.fixture(scope="module")
def g_setup():
    """tests/test_exact_z_lattice.py's grid G and window on the port."""
    st = Statics(GridSpec(**dataclasses.asdict(tz.G)), **KW)
    dist = convert.dndz_gaussian(tz._win().dist, **KW)
    win = projection.WindowGalaxy(dist)
    return st, win, default_cosmo(**KW), port_halo(**KW), port_hod(**KW)


def test_exact_z_linear_equals_separable(g_setup):
    """The port of tests/test_exact_z_lattice.py::test_exact_z_linear_
    equals_separable: for linear P the evolution is separable, so the
    anchored route (J = 6) reproduces the separable lattice C_ell (rtol
    2e-5)."""
    st, win, c, hp, hod = g_setup
    ells = np.logspace(1, 3, 8)
    cl_exact = limber_fft.limber_cl_fft_exact_z(
        c, hp, hod, win, win, ells, st, "linear_power", n_z_anchor=6)
    cl_sep = limber_fft.limber_cl_fft(c, win, win, ells,
                                      limber_fft.p_lattice_linear(c, st), st)
    assert cl_exact.shape == cl_sep.shape == (1, 8)
    np.testing.assert_allclose(cl_exact.numpy(), cl_sep.numpy(), rtol=2e-5)


def test_exact_z_cl_matches_jax(g_setup):
    """limber_cl_fft_exact_z (power_gg, J = 8, grid G) against the JAX
    lattice route (1e-10 of the peak) and the JAX table route
    projection.limber_cl_exact_z with its 32 halo models (< 1e-4, the
    bar of the JAX package's slow test)."""
    st, win, c, hp, hod = g_setup
    ref = REF["cl_exact_z"]
    cl = limber_fft.limber_cl_fft_exact_z(
        c, hp, hod, win, win, np.asarray(ref["ells"]), st, "power_gg",
        n_z_anchor=ref["n_z_anchor"])[0].numpy()
    lat, tab = np.asarray(ref["lattice"]), np.asarray(ref["table"])
    assert np.max(np.abs(cl - lat)) / np.max(np.abs(lat)) < 1e-10
    assert np.max(np.abs(cl / tab - 1.0)) < 1e-4


def test_cl_fft_conv_method():
    """Both convolutions are ported: "fft" (the whitened FFT, float64
    sums) gives the direct route's C_ell within 1e-10, in float64 and,
    rounded once, in float32; anything else is a ValueError."""
    st = Statics(tp.GRID, **KW)
    win = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(), **KW))
    c = default_cosmo(**KW)
    p = limber_fft.p_lattice_linear(c, st)
    ells = [10.0, 100.0, 1000.0]
    fft = limber_fft.limber_cl_fft(c, win, win, ells, p, st,
                                   conv_method="fft")
    direct = limber_fft.limber_cl_fft(c, win, win, ells, p, st)
    torch.testing.assert_close(fft, direct, rtol=1e-10, atol=0.0)
    kw32 = dict(device="cpu", dtype=torch.float32)
    st32 = Statics(tp.GRID, **kw32)
    win32 = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(),
                                                          **kw32))
    fft32 = limber_fft.limber_cl_fft(default_cosmo(**kw32), win32, win32,
                                     ells, p.float(), st32,
                                     conv_method="fft")
    assert fft32.dtype == torch.float32
    torch.testing.assert_close(fft32.double(), direct, rtol=1e-5, atol=0.0)
    with pytest.raises(ValueError):
        limber_fft.limber_cl_fft(c, win, win, [10.0], p, st,
                                 conv_method="gather")


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("key", KEYS)
def test_shear_pipelines_match_jax(route, key, outs):
    """Every output of the three lattice / table pipelines with shear
    (float64 CPU, parity grid, 3 cosmologies) against the JAX package's
    make_pipeline: 1e-10 of each row's peak over theta (n_g: relative)."""
    got = outs[route][torch.float64][key]
    ref = np.asarray(TINY[route][key])
    assert got.shape == ref.shape
    assert _row_peak_err(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("route", list(ROUTES))
def test_shear_pipelines_float32_track_float64(route, outs):
    """Float32 on the CPU within 1e-4 of the float64 port, worst bin (xi-
    relative to each row's peak: it is small at small theta)."""
    o32, o64 = outs[route][torch.float32], outs[route][torch.float64]
    for key in KEYS:
        assert o32[key].dtype == torch.float32
        got, ref = o32[key].double().numpy(), o64[key].numpy()
        err = (_row_peak_err(got, ref) if key == "xi_minus"
               else float(np.max(np.abs(got / ref - 1.0))))
        assert err < 1e-4, key


def test_exact_z_differs_from_separable(outs):
    """The anchors carry the halo model's evolution: at z_pivot = 1 under
    a window spread over 0 < z < 2 the separable route is off by far
    more than the numerics (> 1e-3 somewhere)."""
    for key in ("w_theta", "gamma_t", "xi_plus"):
        ez = outs["exact_z"][torch.float64][key].numpy()
        sep = outs["fft"][torch.float64][key].numpy()
        assert np.max(np.abs(sep / ez - 1.0)) > 1e-3, key


# A CPU Jacobian by replicas costs one exact-z forward and backward of
# J rows per data-vector entry (the plain kernel A dominates: ~80 s for
# all 16 entries), so the test takes the first and last theta bin of w
# and of gamma_t; chip_smoke.py phase 11 holds the whole vector on the
# card at DEFAULT_GRID.
SEL = [0, tp.GRID.n_theta - 1, tp.GRID.n_theta, 2 * tp.GRID.n_theta - 1]


def test_exact_z_jacobian_matches_jax():
    """d(w, gamma_t)/d(omega_m0, sigma_8) of the exact-z pipeline
    (reverse mode by replicas, float64, parity grid, the cosmology with
    every extra knob on) at the entries SEL against the JAX package's
    jacfwd: within 1e-9 of each column's peak; the value to 1e-10."""
    i = 2
    batch = _batch()
    cosmo0 = dataclasses.replace(batch, **{
        f: v[i] for f, v in batch.fields().items()})
    pipe = _pipeline(exact_z_anchors=TINY["exact_z_anchors"],
                     include_shear=False)
    fn, p0 = inference.make_theory_fn(pipe, cosmo0)
    jac = inference.jacobian(lambda p: fn(p)[:, SEL], p0).numpy()
    ref = np.asarray(TINY["jacobian"][i])[SEL]
    assert jac.shape == ref.shape == (len(SEL), 2)
    err = np.max(np.max(np.abs(jac - ref), axis=0)
                 / np.max(np.abs(ref), axis=0))
    assert err < 1e-9
    with torch.no_grad():
        val = fn(p0)[0].numpy()
    np.testing.assert_allclose(val, TINY["value"][i], rtol=1e-10, atol=0)


def test_exact_z_forward_launch_structure(monkeypatch):
    """Exact-z forward at B = 3, J = 4 with lensing and shear: ONE kernel
    A call over the B J = 12 anchor rows (the pivot model only gives
    n_g), and one kernel C call per distinct operator (mu = 0, 2, 4),
    the mu = 0 one over the w and xi+ rows together."""
    calls_a, calls_c = [], []
    real_a, real_c = port_halo_mod.halo_contract, sweep.df_contract

    def count_a(k, mat, gal, cheb):
        calls_a.append(mat.shape[0])
        return real_a(k, mat, gal, cheb)

    def count_c(c, a_hi, a_lo=None):
        calls_c.append((c.shape[0], a_hi.shape[0]))
        return real_c(c, a_hi, a_lo)

    monkeypatch.setattr(port_halo_mod, "halo_contract", count_a)
    monkeypatch.setattr(sweep, "df_contract", count_c)
    pipe = _pipeline(exact_z_anchors=4)
    assert pipe.mus == (0.0, 2.0, 4.0)
    out = pipe(_batch())
    assert calls_a == [12]
    assert calls_c == [(6, tp.GRID.n_theta), (3, tp.GRID.n_theta),
                       (3, tp.GRID.n_theta)]
    assert set(out) == {"theta_deg", *KEYS}


def test_lagrange_rows_clamp_but_growth_is_exact():
    """Below the anchor window (z_u < 1e-3 on the lattice's first nodes)
    the Lagrange rows are taken at the clamped z, while D(z_u)^2 stays
    exact.  With anchor spectra P_j = z_j P0 (Lagrange interpolation is
    exact on a line) and D_j = 1, every row j-sums to P0 clamp(z_u):
    the anchored convolution equals the plain one of P0 against
    W W / chi du D(z_u)^2 clamp(z_u), and differs from the unclamped
    one."""
    st = Statics(tp.GRID, **KW)
    dist = DNdzGaussian(*(torch.tensor(v, **KW) for v in (0.0, 0.5, 0.0,
                                                           0.01)))
    win = projection.WindowGalaxy(dist)
    c = _batch()
    chi, z_u, z_mid = limber_fft._lattice_z(c, st)
    assert float(z_u.min()) < 1e-3
    j = 5
    z_nodes, w_bary = limber_fft._cheb_nodes(1e-3, 2.0, j)
    p0 = limber_fft.p_lattice_linear(c, st)               # (B, n_k)
    anchors = dict(p_j={"linear_power": p0[:, None] * torch.tensor(
        z_nodes)[:, None]}, d_j=torch.ones(3, j, **KW), z_nodes=z_nodes,
        w_bary=w_bary, z_lo=1e-3, z_hi=2.0)
    j_lo, j_hi, _ = limber_fft.wtheta_lattice_operator(
        tuple(correlation.theta_bins_deg(tp.GRID).tolist()), tp.GRID, 0.0)
    got = limber_fft.exact_z_conv_rows(c, anchors,
                                       [(win, win, "linear_power")], st,
                                       j_lo, j_hi)
    g0 = limber_fft._window_rows(c, [(win, win)], st, z_u, chi, z_mid)
    d = background.growth_factor(c, z_u, st, tp.GRID.n_growth)
    want = limber_fft._conv_direct_rows(
        p0[:, None], g0 * (d * d * torch.clamp(z_u, 1e-3, 2.0))[:, None],
        j_lo, j_hi)
    unclamped = limber_fft._conv_direct_rows(
        p0[:, None], g0 * (d * d * z_u)[:, None], j_lo, j_hi)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) < 1e-9 * peak
    assert float((unclamped - want).abs().max()) > 1e-6 * peak


def test_no_separable_bias_warning_with_anchors():
    """The separable-bias warning names exact_z_anchors; with anchors on
    the lattice route it is not given (z_pivot = 0 under a z ~ 1
    window), and the anchor window is fixed at construction."""
    dist = convert.dndz_gaussian(tp.jax_dist(), **KW)
    kw = dict(grid=tp.GRID, z_pivot=0.0, **KW)
    with pytest.warns(UserWarning, match="exact_z_anchors"):
        sweep.make_pipeline(port_halo(**KW), port_hod(**KW), dist, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe = sweep.make_pipeline(port_halo(**KW), port_hod(**KW), dist,
                                   exact_z_anchors=6, **kw)
    assert pipe.z_hi_anchor == 2.0 and pipe.exact_z_anchors == 6


def test_exact_z_anchor_spectra_refuses_matter_power():
    """matter_power is ported now: "halofit" / "linear" swap the power_mm
    anchors for halofit / the linear power at each anchor row (the same
    functions at the anchors' redshifts, bit for bit) and leave power_gg
    as the halo model's; an unknown value raises ValueError."""
    st = Statics(tp.GRID, **KW)
    args = (_batch(), port_halo(**KW), port_hod(**KW),
            ("power_mm", "power_gg"), 4, 1e-3, 2.0, st)
    halo_mm = limber_fft.exact_z_anchor_spectra(*args)
    for mp in ("halofit", "linear"):
        got = limber_fft.exact_z_anchor_spectra(*args, matter_power=mp)
        assert torch.equal(got["p_j"]["power_gg"], halo_mm["p_j"]["power_gg"])
        z = torch.as_tensor(got["z_nodes"], **KW).repeat(3)
        rows = limber_fft._repeat_rows(_batch(), 3, 4)
        want = limber_fft.mm_override(rows, z, mp, st).reshape(3, 4, -1)
        assert torch.equal(got["p_j"]["power_mm"], want)
        assert not torch.equal(want, halo_mm["p_j"]["power_mm"])
    with pytest.raises(ValueError, match="matter_power"):
        limber_fft.exact_z_anchor_spectra(*args, matter_power="emulated")


def test_wtheta_fft_exact_z_is_the_pipelines_w(outs):
    """limber_wtheta_fft_exact_z (one probe: its own anchors, kernel C on
    the mu = 0 operator) gives the exact-z pipeline's w(theta): to 1e-12
    of each row's peak against the port's pipeline and 1e-10 against the
    JAX one."""
    st = Statics(tp.GRID, **KW)
    win = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(), **KW))
    w = limber_fft.limber_wtheta_fft_exact_z(
        _batch(), convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW), win, win,
        correlation.theta_bins_deg(tp.GRID), st, "power_gg",
        n_z_anchor=TINY["exact_z_anchors"], z_anchor_hi=2.0).numpy()
    assert _row_peak_err(w, outs["exact_z"][torch.float64]["w_theta"]) < 1e-12
    assert _row_peak_err(w, TINY["exact_z"]["w_theta"]) < 1e-10
