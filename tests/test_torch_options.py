"""The options of chomp_tpu_torch's pipelines against the JAX package
(float64 CPU) on tests/test_torch_tomographic.py's tiny grid.

- Each ported piece against the JAX function, evaluated here: the EH98
  BAO transfer and its sound horizon, the Tinker mass function and bias
  (and the mass tables with ``mass_fn = 1``), the growth rate and
  Omega_de(z), halofit (parameters and power at m_nu = 0 and > 0), the
  kappa_CMB window, the curved operators at theta >= 0.5 deg (lmax stays
  small there), and the non-Limber statics, correction operators and
  exact / Limber C_ell pair.  Tolerance 1e-10 relative (row peak for the
  operators and C_ell rows; measured ~1e-15).
- The pipeline cells of chip_smoke.py phases 15-19 (OPTION_CELLS of
  tools/torch_slice_reference.py) at TINY_THETA_DEG: every output against
  the JAX values committed in the ``tiny_grid`` block of
  tests/data/torch_options_reference.json (the JAX programs take 40-130 s
  each to compile), to 1e-10 of each row's peak; the tomographic cell on
  2 lens x 2 source bins with per-bin HODs, nuisances and magnification,
  including the w_gk_cmb rows and the data vector's order.
- The float64 autograd Jacobian of the flat cell against the committed
  jacfwd, on 6 entries of the data vector.
- The two options that raised until PR 10 (exact-z tomography, the
  whitened FFT convolution) give results.

Budget: no JAX pipeline is compiled here; ~47 s and ~1 GiB alone
(CHANGES.md).
"""

import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import background as jbg
from chomp_tpu import cmblens as jcmb
from chomp_tpu import curved as jcurved
from chomp_tpu import default_halo
from chomp_tpu import limber_fft as jlimber
from chomp_tpu import linear as jlinear
from chomp_tpu import mass as jmass
from chomp_tpu import nlpower as jnl
from chomp_tpu import nonlimber as jnonlimber
from chomp_tpu import projection as jproj
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import (background, cmblens, curved, limber_fft, linear,
                             mass, nlpower, nonlimber, projection)
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import test_torch_tomographic as tt
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_slice_reference as tsr  # noqa: E402

KW = dict(device="cpu", dtype=torch.float64)
GRID = tt.GRID
RTOL = 1e-10
REF = json.loads((Path(__file__).parent / "data"
                  / "torch_options_reference.json").read_text())["tiny_grid"]
K = np.logspace(-4, 2, 40)
Z3 = np.array([0.0, 0.7, 2.0])


def _rel(got, ref):
    """Worst |got - ref| over each row relative to the row's peak."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    ref2, got2 = ref.reshape(-1, ref.shape[-1]), got.reshape(-1,
                                                             ref.shape[-1])
    return float(np.max(np.abs(got2 - ref2).max(-1)
                        / np.abs(ref2).max(-1)))


def port_cosmo():
    return convert.cosmo_batch(tp.jax_batch(), **KW)


def statics(with_bao=False):
    return Statics(GRID, with_bao=with_bao, **KW)


# -- the pieces -----------------------------------------------------------

def _jit_vmap(fn):
    """The JAX reference pieces, compiled (one small program each: cheaper
    than their eager dispatch)."""
    return jax.jit(jax.vmap(fn))


def test_bao_transfer_and_sound_horizon():
    """transfer_eh_full, sound_horizon_drag and P_lin with the wiggles."""
    jb = tp.jax_batch()
    k = torch.as_tensor(K, **KW)[None]
    ref, rs, p_lin = _jit_vmap(lambda c: (
        jlinear.transfer_eh_full(c, jnp.asarray(K)),
        jlinear.sound_horizon_drag(c),
        jlinear.linear_power(c, jnp.asarray(K), 0.5, True, GRID)))(jb)
    assert _rel(linear.transfer_eh_full(port_cosmo(), k), ref) < RTOL
    assert _rel(linear.sound_horizon_drag(port_cosmo())[:, None],
                np.asarray(rs)[:, None]) < RTOL
    got = linear.linear_power(port_cosmo(), k, torch.tensor([0.5], **KW),
                              statics(True))
    assert _rel(got, p_lin) < RTOL


@pytest.mark.parametrize("with_bao", [False, True])
def test_tinker_mass_tables(with_bao):
    """Tinker 2008 f(nu) and Tinker 2010 b(nu) alone, and the mass tables
    with mass_fn = 1 (norms pinned to 1); a per-row mass_fn mixes the two
    families row by row."""
    jh = dataclasses.replace(default_halo(), mass_fn=jnp.asarray(1.0))
    ph = convert.halo_params(jh, **KW)
    z = torch.tensor([0.5], **KW)
    ref = _jit_vmap(lambda c: jmass.build_mass_tables(c, jh, 0.5, with_bao,
                                                      GRID))(tp.jax_batch())
    got = mass.build_mass_tables(port_cosmo(), ph, z, statics(with_bao))
    for f in ("nu", "f_nu", "bias", "dndlnm"):
        assert _rel(getattr(got, f), getattr(ref, f)) < RTOL, f
    assert torch.equal(got.f_norm, torch.ones(3, **KW))
    nu = np.geomspace(0.05, 20.0, 30)
    assert _rel(mass._f_tinker08_raw(torch.as_tensor(nu, **KW),
                                     torch.tensor(0.5, **KW),
                                     torch.tensor(1.68, **KW)),
                jmass._f_tinker08_raw(jnp.asarray(nu), 0.5, 1.68)) < RTOL
    assert _rel(mass._bias_tinker10_raw(torch.as_tensor(nu, **KW)),
                jmass._bias_tinker10_raw(jnp.asarray(nu))) < RTOL
    mixed = dataclasses.replace(ph, mass_fn=torch.tensor([0.0, 1.0, 0.0],
                                                         **KW))
    both = mass.build_mass_tables(port_cosmo(), mixed, z, statics(with_bao))
    st_only = mass.build_mass_tables(
        port_cosmo(), dataclasses.replace(ph, mass_fn=torch.tensor(0.0, **KW)),
        z, statics(with_bao))
    for f in ("f_nu", "bias"):
        torch.testing.assert_close(getattr(both, f)[1], getattr(got, f)[1],
                                   rtol=1e-14, atol=0.0)
        torch.testing.assert_close(getattr(both, f)[0::2],
                                   getattr(st_only, f)[0::2], rtol=1e-14,
                                   atol=0.0)


def test_growth_rate_and_omega_l():
    jb = tp.jax_batch()
    z = torch.as_tensor(Z3, **KW)
    ref = _jit_vmap(lambda c, zz: jbg.growth_rate(c, zz, GRID.n_growth))(
        jb, jnp.asarray(Z3))
    got = background.growth_rate(port_cosmo(), z, statics(), GRID.n_growth)
    assert _rel(got[:, None], np.asarray(ref)[:, None]) < RTOL
    ref = jax.vmap(jbg.omega_l_z)(jb, jnp.asarray(Z3))
    got = background.omega_l_z(port_cosmo(), z)
    assert _rel(got[:, None], np.asarray(ref)[:, None]) < RTOL


@functools.lru_cache(maxsize=None)
def _jax_halofit(with_bao):
    return _jit_vmap(lambda c: (
        jnl.halofit_params(c, 0.8, with_bao, GRID),
        jnl.halofit_power(c, jnp.asarray(K), 0.8, with_bao, GRID)))


@pytest.mark.parametrize("m_nu", [0.0, 0.1])
@pytest.mark.parametrize("with_bao", [False, True])
def test_halofit(m_nu, with_bao):
    """halofit_params (k_sigma, n_eff, C) and halofit_power at z = 0.8 on
    tests/torch_parity's cosmologies (the third with a_mod and the
    feedback knobs) with every m_nu set to ``m_nu``."""
    jb = dataclasses.replace(tp.jax_batch(), m_nu=jnp.full(3, m_nu))
    pc = convert.cosmo_batch(jb, **KW)
    z = torch.tensor([0.8], **KW)
    st = statics(with_bao)
    params, ref = _jax_halofit(with_bao)(jb)
    got = nlpower.halofit_params(pc, z, st)
    for g, r in zip(got, params):
        assert _rel(g[:, None], np.asarray(r)[:, None]) < RTOL
    got = nlpower.halofit_power(pc, torch.as_tensor(K, **KW)[None], z, st)
    assert _rel(got, ref) < RTOL


def test_cmb_window():
    """WindowConvergenceCMB at redshifts inside and beyond its support, the
    spec carried across by ``convert.cmb_spec`` (with its noise table)."""
    jspec = jcmb.CMBLensingSpec(z_support=3.0, nl_ell=[2.0, 100.0, 3000.0],
                                nl=[1e-6, 1e-7, 5e-8])
    spec = convert.cmb_spec(jspec)
    ells = np.array([0.0, 10.0, 500.0, 5000.0])
    np.testing.assert_allclose(spec.nl_total(ells), jspec.nl_total(ells),
                               rtol=1e-14)
    assert spec.nl_inf == pytest.approx(jspec.nl_inf, rel=1e-14)
    jw = jspec.window()
    pw = spec.window(**KW)
    zq = np.linspace(0.05, 4.0, 12)
    ref = _jit_vmap(lambda c: jw.window_z(c, jnp.asarray(zq), GRID))(
        tp.jax_batch())
    got = pw.window_z(port_cosmo(), torch.as_tensor(zq, **KW)[None],
                      statics())
    assert _rel(got, ref) < RTOL
    assert torch.all(got[:, zq > 3.0] == 0.0)
    with pytest.raises(TypeError):
        cmblens.as_cmb_spec("planck")


@pytest.mark.parametrize("spec", [(0.0, None), (2.0, None), (0.0, "xip"),
                                  (4.0, "xim")])
def test_curved_operator(spec):
    """curved_lattice_operator at TINY_THETA_DEG (lmax 7334): the same
    window and matrix as the JAX package's."""
    key = tuple(tsr.TINY_THETA_DEG)
    jl_, jh_, ja = jcurved.curved_lattice_operator(key, GRID, spec[0],
                                                   stat=spec[1])
    lo, hi, a = curved.curved_lattice_operator(key, GRID, spec[0],
                                               stat=spec[1])
    assert (lo, hi) == (jl_, jh_)
    assert _rel(a, ja) < 1e-13


@pytest.mark.parametrize("kind", ["d", "d_rsd", "k_flat", "k_E"])
def test_nl_static(kind):
    ells = tuple(jnonlimber.ell_nodes(60).tolist())
    key = jlimber._lattice_key(GRID)
    ref = jnonlimber._nl_static(key, ells, kind, 3e-5, 4.0)
    got = nonlimber._nl_static(key, ells, kind, 3e-5, 4.0)
    assert got[1:] == ref[1:]
    assert np.max(np.abs(got[0] - ref[0])) <= 1e-13 * np.abs(ref[0]).max()


@pytest.mark.parametrize("geometry,mu", [("flat", 0.0), ("flat", 2.0),
                                         ("curved", 0.0), ("curved", 2.0)])
def test_correction_operator(geometry, mu):
    key = tuple(tsr.TINY_THETA_DEG)
    ref = jnonlimber.correction_operator(key, mu, 60, 20, geometry)
    assert _rel(nonlimber.correction_operator(key, mu, 60, 20, geometry),
                ref) < 1e-13


@pytest.mark.parametrize("kinds", [("d", "d"), ("d", "k_flat"),
                                   ("d", "k_E")])
def test_nonlimber_cl_pair(kinds):
    """(C^exact, C^Limber) of a narrow lens bin against itself or a source
    window, on the linear spectrum at the lattice k, at the fiducial."""
    c0 = jax.tree.map(lambda v: v[1], tp.jax_batch())
    lens, src = tt.dist_at(0.5, 0.05, 1.0), tt.dist_at(1.0, 0.2)
    jwb = (jproj.WindowGalaxy(dist=lens) if kinds[1] == "d"
           else jproj.WindowConvergence(dist=src))
    jwa = jproj.WindowGalaxy(dist=lens)
    p = np.array(jax.jit(lambda c: jlinear.linear_power(
        c, jnp.exp(jnp.asarray(jlimber.k_lattice(GRID))), 0.0, False,
        GRID))(c0))
    ells = jnonlimber.ell_nodes(40)
    ex, li = jax.jit(lambda c, q: jnonlimber.nonlimber_cl_pair(
        c, jwa, jwb, q, ells, GRID, kinds, 1.0))(c0, jnp.asarray(p))
    pc = convert.cosmo_batch(jax.tree.map(lambda v: v[None], c0), **KW)
    wa = projection.WindowGalaxy(dist=convert.dndz(lens, **KW))
    wb = (wa if kinds[1] == "d" else
          projection.WindowConvergence(dist=convert.dndz(src, **KW)))
    gex, gli = nonlimber.nonlimber_cl_pair(
        pc, wa, wb, torch.as_tensor(p, **KW)[None], ells, statics(), kinds,
        1.0)
    assert _rel(gex, np.asarray(ex)[None]) < RTOL
    assert _rel(gli, np.asarray(li)[None]) < RTOL
    # The correction is not negligible for this bin at the lowest nodes.
    assert float(torch.abs(gex - gli)[0, 0] / torch.abs(gli)[0, 0]) > 1e-2


# -- the pipeline cells ---------------------------------------------------

def _port_halo(name):
    return convert.halo_params(dataclasses.replace(
        default_halo(), mass_fn=jnp.asarray(tsr.OPTION_CELLS[name][
            "mass_fn"])), **KW)


def port_cell(name, dtype=torch.float64, **extra):
    """The option cell ``name`` of the port on the tiny grid at
    TINY_THETA_DEG (configuration B with the tiny block's anchors)."""
    cell = tsr.OPTION_CELLS[name]
    kw = dict(device="cpu", dtype=dtype)
    options = dict(cell["options"], **extra)
    if cell["config"] == "B":
        options["exact_z_anchors"] = REF["exact_z_anchors"]
    if cell["config"] == "tomo":
        hods = [default_hod(), default_hod(**tt.HOD_B)]
        return sweep.make_tomographic_pipeline(
            _port_halo(name), convert.hod_list(hods, **kw),
            [convert.dndz(d, **kw) for d in tt.LENS],
            [convert.dndz(d, **kw) for d in tt.SRC], grid=GRID,
            z_pivot=tt.Z_PIVOT, theta_deg=tsr.TINY_THETA_DEG,
            with_nuisance=True, include_magnification=True, **options, **kw)
    return sweep.make_pipeline(
        _port_halo(name), convert.hod_zheng(default_hod(), **kw),
        convert.dndz_gaussian(tp.jax_dist(), **kw), power_spec="power_gg",
        grid=GRID, include_lensing=True, theta_deg=tsr.TINY_THETA_DEG,
        z_pivot=1.0 if cell["config"] == "A" else 0.0, **options, **kw)


def run_cell(name, **extra):
    pipe = port_cell(name, **extra)
    if tsr.OPTION_CELLS[name]["config"] == "tomo":
        nu = sweep.Nuisance3x2pt(**{
            k: torch.as_tensor(v, **KW)
            for k, v in tt.nuisance_points(True).items()})
        return pipe(convert.cosmo_batch(tt.jax_batch(), **KW), nu)
    return pipe(port_cosmo())


@pytest.fixture(scope="module")
def cells():
    assert REF["grid"] == dataclasses.asdict(GRID)
    assert REF["theta_deg"] == tsr.TINY_THETA_DEG
    return {name: run_cell(name) for name in tsr.OPTION_CELLS}


CELL_KEYS = [(name, key) for name, keys in (
    ("flat_options", ("w_theta", "gamma_t", "xi_plus", "xi_minus",
                      "w_gk_cmb", "n_g")),
    ("curved", ("w_theta", "gamma_t", "xi_plus", "xi_minus", "w_gk_cmb")),
    ("exact_z", ("w_theta", "gamma_t", "xi_plus", "xi_minus", "w_gk_cmb")),
    ("table", ("w_theta", "gamma_t", "xi_plus", "xi_minus", "n_g")),
    ("tomographic", ("w_theta", "gamma_t", "xi_plus", "xi_minus",
                     "w_gk_cmb", "n_g", "vector"))) for key in keys]


@pytest.mark.parametrize("name,key", CELL_KEYS,
                         ids=[f"{n}-{k}" for n, k in CELL_KEYS])
def test_cell_matches_jax(cells, name, key):
    """Each output of each option cell against the committed JAX values:
    1e-10 of each row's peak (xi_- and some gamma_t rows change sign over
    theta); the JAX shapes with the batch first."""
    ref = np.asarray(REF["cells"][name][key])
    got = cells[name][key]
    assert tuple(got.shape) == ref.shape
    assert bool(torch.isfinite(got).all())
    if key == "n_g":
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0.0)
    else:
        assert _rel(got, ref) < RTOL


def test_tomographic_vector_order(cells):
    """The data vector is w, gamma_t, xi_+, xi_-, w_gk_cmb in the JAX
    package's covariance.tomographic_probes order."""
    out = cells["tomographic"]
    want = torch.cat([out[k].flatten(1) for k in
                      ("w_theta", "gamma_t", "xi_plus", "xi_minus",
                       "w_gk_cmb")], dim=1)
    assert torch.equal(out["vector"], want)
    assert out["w_gk_cmb"].shape == (3, 2, len(tsr.TINY_THETA_DEG))


@pytest.mark.parametrize("name", ["flat_options", "tomographic"])
def test_nonlimber_moves_the_rows(cells, name):
    """Switching the non-Limber repair off changes w and gamma_t by more
    than 1e-4 of their peaks and leaves xi_+- and w_gk_cmb as they were."""
    off = run_cell(name, nonlimber_ell_switch=None, nonlimber_rsd=False)
    on = cells[name]
    for key in ("w_theta", "gamma_t"):
        assert _rel(off[key], on[key].numpy()) > 1e-4, key
    for key in ("xi_plus", "xi_minus", "w_gk_cmb"):
        torch.testing.assert_close(off[key], on[key], rtol=0.0, atol=0.0)


def test_flat_cell_jacobian_matches_jacfwd():
    """The float64 autograd Jacobian of the flat cell's data vector over
    (omega_m0, sigma_8) against the committed JAX jacfwd, on 6 entries
    (one of each output kind), at each of the 3 cosmologies: 1e-9 of the
    column's peak."""
    ref = REF["flat_options_jacobian"]
    val, jac = np.asarray(ref["vector"]), np.asarray(ref["jacobian"])
    pipe = port_cell("flat_options")
    n_t = len(tsr.TINY_THETA_DEG)
    entries = [1, n_t + 2, 2 * n_t + 3, 3 * n_t + 1, 4 * n_t + 4, n_t - 1]
    om = torch.tensor(tp.COSMO["omega_m0"], **KW, requires_grad=True)
    s8 = torch.tensor(tp.COSMO["sigma_8"], **KW, requires_grad=True)
    base = port_cosmo()
    out = pipe(dataclasses.replace(base, omega_m0=om, omega_l0=1.0 - om,
                                   sigma_8=s8))
    vec = torch.cat([out[k] for k in ("w_theta", "gamma_t", "xi_plus",
                                      "xi_minus", "w_gk_cmb")], dim=1)
    assert _rel(vec, val) < RTOL
    peak = np.abs(jac).max(axis=1)
    for e in entries:
        g_om, g_s8 = torch.autograd.grad(vec[:, e].sum(), (om, s8),
                                         retain_graph=True)
        got = torch.stack([g_om, g_s8], dim=1).numpy()
        assert np.max(np.abs(got - jac[:, e]) / peak) < 1e-9, e


# -- what was unported until exact-z tomography --------------------------

def test_unported_options_still_raise():
    """The two options that raised until they were ported, exact-z
    tomography (ROADMAP item 8.1) and the whitened FFT convolution (item
    7b), now give results: the exact-z tomographic pipeline (per-bin
    HODs, J = 4, TINY_THETA_DEG) builds and runs, finite, with the
    separable pipeline's shapes and values of its own (its JAX values:
    tests/test_torch_exactz_tomo.py); ``conv_method="fft"`` gives the
    direct route's C_ell within 1e-10; an unknown method stays a
    ValueError."""
    theta = tsr.TINY_THETA_DEG
    exact = tt.port_pipeline(True, exact_z_anchors=4, theta_deg=theta)(
        tt.port_batch())
    plain = tt.port_pipeline(True, theta_deg=theta)(tt.port_batch())
    for key in ("w_theta", "gamma_t", "xi_plus", "xi_minus", "vector"):
        assert exact[key].shape == plain[key].shape
        assert bool(torch.isfinite(exact[key]).all())
        assert _rel(exact[key], plain[key].numpy()) > 1e-3, key
    torch.testing.assert_close(exact["n_g"], plain["n_g"], rtol=0.0,
                               atol=0.0)
    win = projection.WindowGalaxy(dist=convert.dndz(tt.LENS[0], **KW))
    st = statics()
    p = limber_fft.p_lattice_linear(port_cosmo(), st)
    ells = np.geomspace(10.0, 3000.0, 7)
    fft = limber_fft.limber_cl_fft(port_cosmo(), win, win, ells, p, st,
                                   conv_method="fft")
    direct = limber_fft.limber_cl_fft(port_cosmo(), win, win, ells, p, st)
    torch.testing.assert_close(fft, direct, rtol=1e-10, atol=0.0)
    with pytest.raises(ValueError, match="conv_method"):
        limber_fft.limber_cl_fft(port_cosmo(), win, win, ells, p, st,
                                 conv_method="gather")
