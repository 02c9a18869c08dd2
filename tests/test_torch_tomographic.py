"""The tomographic 3x2pt pipeline of chomp_tpu_torch against the JAX
package (float64 CPU), on the JAX tests' tiny grid
(tests/test_tomographic.py:315) with two lens and two source bins.

- The new dN/dz shapes (magnitude-limited, tabulated, photo-z shifted)
  and the NLA window, each alone, in its nested-GL and lattice forms.
- ``halo.build_halo_models``, ``tomographic_powers`` (one kernel A call
  for every sample and cross pack) and ``power_gg_cross``.
- ``make_tomographic_pipeline`` in four cases: one HOD shared by both
  lens bins, per-bin HODs, non-zero nuisances, and magnification with
  alpha != 1, each on a seeded batch of 3 cosmologies, each row its own
  nuisance point.  The JAX side (:func:`jax_cases`) evaluates every case
  in ONE vmapped call of its nuisance + magnification program, the HODs
  and nuisance points being inputs: a shared HOD is the pair (a, a) and
  the cases without nuisances or magnification use the zero point, where
  the JAX program reduces to the plain one (its test_nuisance_pipeline).
  That program takes ~75 s to compile (~170 s eager), so
  tools/torch_slice_reference.py commits its outputs, with the JAX
  ``jacfwd`` below, in the ``tiny_grid`` block of
  tests/data/torch_tomo_reference.json; the fixture checks that block's
  inputs against this file's and evaluates the pieces above in eager
  JAX.
- ``default_nuisance`` reduces to the plain pipeline, and (1+m) scales
  the shear rows exactly.
- The float64 autograd Jacobian over cosmology and nuisances through
  ``inference.make_theory_fn`` against the JAX ``jacfwd`` (10 entries of
  the data vector, every probe kind and bin).
- Each option builds and runs, exact-z tomography included (their
  values against JAX: tests/test_torch_options.py and
  tests/test_torch_exactz_tomo.py).
"""

import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_cosmo, default_halo, halo as jhalo
from chomp_tpu import limber_fft as jlimber
from chomp_tpu import projection as jproj
from chomp_tpu.hod import default_hod
from chomp_tpu.params import GridSpec
from chomp_tpu_torch import halo, inference, limber_fft, projection
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from torch_threads import capped_threads  # noqa: F401 (autouse)

# The module, not the function of the same name in chomp_tpu.parallel.
jsweep = importlib.import_module("chomp_tpu.parallel.sweep")
KW = dict(device="cpu", dtype=torch.float64)
GRID = GridSpec(n_k=64, n_mass=64, n_ell=256, n_theta=6, lattice_dln=0.08)
Z_PIVOT = 0.6
RTOL = 1e-10
REF_PATH = Path(__file__).parent / "data" / "torch_tomo_reference.json"
OUTPUTS = ("w_theta", "gamma_t", "xi_plus", "xi_minus", "n_g", "vector")
CASES = ("shared", "per_bin", "nuisance", "magnification")
HOD_B = dict(log10_m_min=12.6, log10_m_0=12.6, log10_m_1p=13.9, alpha=1.05)


def dist_at(z0, sz, z_max=2.5):
    return jproj.DNdzGaussian(z_min=jnp.asarray(0.0),
                              z_max=jnp.asarray(z_max),
                              z0=jnp.asarray(z0), sigma_z=jnp.asarray(sz))


LENS = [dist_at(0.4, 0.12), dist_at(0.7, 0.12)]
SRC = [dist_at(0.8, 0.2), dist_at(1.2, 0.25)]


def cosmologies():
    """(omega_m0, sigma_8) of the seeded batch of 3."""
    rng = np.random.default_rng(8)
    return rng.uniform(0.25, 0.31, 3), rng.uniform(0.76, 0.86, 3)


def nuisance_points(magnification: bool):
    """3 seeded non-zero nuisance points (numpy, leading batch axis);
    alpha = 1 unless ``magnification``."""
    rng = np.random.default_rng(9)
    pts = dict(dz_lens=rng.normal(0.0, 0.02, (3, 2)),
               dz_src=rng.normal(0.0, 0.03, (3, 2)),
               m=rng.normal(0.0, 0.02, (3, 2)),
               a_ia=rng.uniform(-0.5, 1.5, 3), eta_ia=rng.uniform(-1, 2, 3),
               z0_ia=np.full(3, 0.62),
               alpha_lens=np.ones((3, 2)))
    if magnification:
        pts["alpha_lens"] = rng.uniform(0.4, 2.4, (3, 2))
    return pts


def zero_points():
    """The JAX zero nuisance point, repeated for the 3 cosmologies."""
    return {k: np.broadcast_to(np.asarray(v, dtype=np.float64),
                               (3,) + np.shape(v)).copy()
            for k, v in dataclasses.asdict(
                jsweep.default_nuisance(2, 2)).items()}


def case_inputs(case):
    """(per-bin HODs (bool), the JAX HOD pair, nuisance points)."""
    hod_a = default_hod()
    hod_b = default_hod(**HOD_B)
    if case == "shared":
        return False, (hod_a, hod_a), zero_points()
    if case == "per_bin":
        return True, (hod_a, hod_b), zero_points()
    return True, (hod_a, hod_b), nuisance_points(case == "magnification")


def jax_batch():
    om, s8 = cosmologies()
    return jsweep.broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(om),
                                  omega_l0=jnp.asarray(1.0 - om),
                                  sigma_8=jnp.asarray(s8))


def jax_cases():
    """The JAX outputs of every case: one jitted, vmapped call of the
    nuisance + magnification pipeline over 4 cases x 3 cosmologies, the
    HOD pair and the nuisance points as inputs (~75 s to compile;
    tools/torch_slice_reference.py commits the result)."""
    cosmo = jax_batch()
    rows = [case_inputs(c) for c in CASES]
    hods = [jax.tree.map(lambda *x: jnp.stack(
        [jnp.broadcast_to(v, (3,)) for v in x]).reshape(-1),
        *[r[1][i] for r in rows]) for i in range(2)]
    nus = jsweep.Nuisance3x2pt(**{
        k: jnp.asarray(np.concatenate([r[2][k] for r in rows]))
        for k in rows[0][2]})
    cosmos = jax.tree.map(lambda v: jnp.tile(v, len(CASES)), cosmo)

    def one(c, hod_a, hod_b, nu):
        fn = jsweep.make_tomographic_pipeline(
            default_halo(), [hod_a, hod_b], LENS, SRC, grid=GRID,
            z_pivot=Z_PIVOT, with_nuisance=True, include_magnification=True)
        return {k: fn(c, nu)[k] for k in OUTPUTS}

    out = jax.jit(jax.vmap(one))(cosmos, *hods, nus)
    ref = {c: {k: np.asarray(out[k])[3 * i:3 * i + 3] for k in OUTPUTS}
           for i, c in enumerate(CASES)}
    ref["shared"]["n_g"] = ref["shared"]["n_g"][:, 0]
    return ref


@pytest.fixture(scope="module")
def jax_ref():
    """The committed JAX outputs of every case (:func:`jax_cases`, checked
    against this file's inputs) and the JAX pieces, evaluated here
    (eager, ~30 s)."""
    ref = json.loads(REF_PATH.read_text())["tiny_grid"]
    om, s8 = cosmologies()
    assert np.allclose(ref["omega_m0"], om) and np.allclose(ref["sigma_8"],
                                                            s8)
    assert ref["grid"] == dataclasses.asdict(GRID)
    out = {c: {k: np.asarray(v) for k, v in ref["cases"][c].items()}
           for c in CASES}
    out["pieces"] = jax_pieces(jax_batch())
    return out


Z_QUERY = np.linspace(0.05, 2.4, 9)


def jax_dists():
    """The new dN/dz shapes of the piece tests (JAX)."""
    z_tab = np.linspace(0.1, 1.9, 37)
    return {
        "maglim": jproj.DNdzMagLim(z_min=jnp.asarray(0.05),
                                   z_max=jnp.asarray(2.4), a=jnp.asarray(2.0),
                                   z0=jnp.asarray(0.5), b=jnp.asarray(1.5)),
        "interp": jproj.DNdzInterpolation(
            z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
            z_array=jnp.asarray(z_tab),
            n_array=jnp.asarray(np.exp(-((z_tab - 0.9) / 0.3) ** 2)
                                * (1.0 + 0.3 * np.sin(7.0 * z_tab)))),
        "shifted": jproj.DNdzShifted(base=dist_at(0.8, 0.2), dz=jnp.asarray(
            0.05)),
        "shifted_maglim": jproj.DNdzShifted(base=jproj.DNdzMagLim(
            z_min=jnp.asarray(0.05), z_max=jnp.asarray(2.4),
            a=jnp.asarray(2.0), z0=jnp.asarray(0.5), b=jnp.asarray(1.5)),
            dz=jnp.asarray(-0.03)),
    }


def jax_ia_window(dist):
    return jproj.WindowConvergenceIA(dist=dist, a_ia=jnp.asarray(0.7),
                                     eta_ia=jnp.asarray(1.5),
                                     z0_ia=jnp.asarray(0.62))


def jax_pieces(cosmo):
    """dN/dz and windows at Z_QUERY, the lattice IA window, and
    tomographic_powers (with the cross spectra) on the lattice k, at
    cosmology 0 (eager)."""
    out = {}
    c0 = jax.tree.map(lambda v: v[0], cosmo)
    z = jnp.asarray(Z_QUERY)
    for name, d in jax_dists().items():
        out[f"dndz.{name}"] = np.asarray(jproj.dndz(d, z, GRID))
    win = jax_ia_window(jax_dists()["shifted"])
    out["window_ia"] = np.asarray(win.window_z(c0, z, GRID))
    chi, z_l, z_m = jlimber._lattice_z(c0, GRID)
    out["window_ia.lattice"] = np.asarray(
        jlimber._window_on_lattice(c0, win, z_l, chi, GRID, z_m))
    models = jhalo.build_halo_models(
        c0, default_halo(), [default_hod(), default_hod(**HOD_B)], Z_PIVOT,
        False, GRID)
    p = jlimber.p_lattice_tomographic(c0, default_halo(), models, False,
                                      GRID)
    out["n_g"] = np.asarray([m.n_g for m in models])
    for key, v in p.items():
        out["tomo." + _name(key)] = np.asarray(v)
    return out


def _name(key):
    return key if isinstance(key, str) else ".".join(map(str, key))


def port_batch():
    return convert.cosmo_batch(jax_batch(), **KW)


def port_nuisance(pts):
    return sweep.Nuisance3x2pt(**{k: torch.as_tensor(v, **KW)
                                  for k, v in pts.items()})


def port_pipeline(per_bin, with_nuisance=False, magnification=False,
                  dtype=torch.float64, **options):
    kw = dict(device="cpu", dtype=dtype)
    hods = ([default_hod(), default_hod(**HOD_B)] if per_bin
            else default_hod())
    return sweep.make_tomographic_pipeline(
        convert.halo_params(default_halo(), **kw),
        (convert.hod_list(hods, **kw) if per_bin
         else convert.hod_zheng(hods, **kw)),
        [convert.dndz(d, **kw) for d in LENS],
        [convert.dndz(d, **kw) for d in SRC], grid=GRID, z_pivot=Z_PIVOT,
        with_nuisance=with_nuisance, include_magnification=magnification,
        **options, **kw)


def _assert_close(got, ref, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_jax(jax_ref, case):
    """Every output and the data vector of each case within rtol 1e-10
    of the JAX package; the shapes of the JAX outputs with the batch
    first."""
    per_bin, _hods, pts = case_inputs(case)
    nuis = case in ("nuisance", "magnification")
    pipe = port_pipeline(per_bin, with_nuisance=nuis,
                         magnification=case == "magnification")
    out = (pipe(port_batch(), port_nuisance(pts)) if nuis
           else pipe(port_batch()))
    assert out["w_theta"].shape == (3, 2, GRID.n_theta)
    assert out["gamma_t"].shape == (3, 4, GRID.n_theta)
    assert out["xi_plus"].shape == out["xi_minus"].shape == (3, 3,
                                                             GRID.n_theta)
    assert out["vector"].shape == (3, 12 * GRID.n_theta)
    for key in OUTPUTS:
        _assert_close(out[key], jax_ref[case][key], f"{case}.{key}")


@pytest.mark.parametrize("name", ["maglim", "interp", "shifted",
                                  "shifted_maglim"])
def test_dndz_matches_jax(jax_ref, name):
    """Each new dN/dz alone: normalized p(z) at z inside and outside its
    support (float64)."""
    d = convert.dndz(jax_dists()[name], **KW)
    st = Statics(GRID, **KW)
    got = projection.dndz(d, torch.as_tensor(Z_QUERY, **KW), st)
    _assert_close(got, jax_ref["pieces"][f"dndz.{name}"], name)


def test_dndz_batched_fields():
    """(B,) fields: a per-row shift and a per-row table equal the rows
    evaluated one at a time."""
    st = Statics(GRID, **KW)
    z = torch.as_tensor(np.tile(Z_QUERY, (2, 1)), **KW)
    base = convert.dndz(jax_dists()["interp"], **KW)
    dz = torch.tensor([0.05, -0.02], **KW)
    tab = dataclasses.replace(base, z_min=base.z_min.expand(2),
                              z_max=base.z_max.expand(2),
                              z_array=base.z_array.expand(2, -1),
                              n_array=torch.stack([base.n_array,
                                                   2.0 * base.n_array]))
    for d, one in ((projection.DNdzShifted(base, dz),
                    lambda i: projection.DNdzShifted(base, dz[i])),
                   (tab, lambda i: tab.rows(i, i + 1))):
        got = projection.dndz(d, z, st)
        for i in range(2):
            want = projection.dndz(one(i), z[i:i + 1], st)
            torch.testing.assert_close(got[i:i + 1], want, rtol=1e-14,
                                       atol=0.0)


def test_ia_window_matches_jax(jax_ref):
    """WindowConvergenceIA alone: its nested-GL form at Z_QUERY and the
    lattice route's form at the lattice nodes (the convergence window by
    cumulative Simpson plus the IA term) against the JAX package's, and
    the IA term against its closed formula."""
    st = Statics(GRID, **KW)
    cosmo = port_batch()
    d = convert.dndz(jax_dists()["shifted"], **KW)
    win = projection.WindowConvergenceIA(
        dist=d, a_ia=torch.tensor(0.7, **KW), eta_ia=torch.tensor(1.5, **KW),
        z0_ia=torch.tensor(0.62, **KW))
    z = torch.as_tensor(Z_QUERY, **KW)[None]
    c0 = cosmo.rows(0, 1)
    _assert_close(win.window_z(c0, z, st)[0], jax_ref["pieces"]["window_ia"],
                  "window_ia")
    chi, z_l, z_m = limber_fft._lattice_z(c0, st)
    lat = limber_fft._window_on_lattice(c0, win, z_l, chi, st, z_m)[0]
    ref = jax_ref["pieces"]["window_ia.lattice"]
    np.testing.assert_allclose(lat.numpy(), ref, rtol=RTOL,
                               atol=1e-14 * np.abs(ref).max())
    from chomp_tpu_torch import background

    ia = win.ia_term_z(c0, z, st)
    want = (-0.7 * projection.C1_RHOCRIT * c0.omega_m0[:, None]
            / background.growth_factor(c0, z, st, GRID.n_growth)
            * ((1.0 + z) / 1.62) ** 1.5 * projection.dndz(d, z, st)
            * background.ez(c0, z) / projection.C_OVER_H0)
    torch.testing.assert_close(ia, want, rtol=1e-13, atol=0.0)


def _models(cosmo, st):
    hods = convert.hod_list([default_hod(), default_hod(**HOD_B)], **KW)
    return halo.build_halo_models(cosmo, convert.halo_params(default_halo(),
                                                             **KW),
                                  hods, torch.tensor([Z_PIVOT], **KW), st)


def test_tomographic_powers_matches_jax(jax_ref, monkeypatch):
    """build_halo_models (one mass-table build) and tomographic_powers
    with the cross spectra against the JAX package at cosmology 0: every
    key, and one kernel A call for both samples and their cross pack
    (rows b G + i); n_g per sample."""
    st = Statics(GRID, **KW)
    cosmo = port_batch().rows(0, 1)
    models = _models(cosmo, st)
    assert models[0].mass is models[1].mass
    calls = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract",
                        lambda *a: calls.append(a[1].shape[0]) or real(*a))
    p = limber_fft.p_lattice_tomographic(
        cosmo, convert.halo_params(default_halo(), **KW), models, st)
    assert calls == [3]
    pieces = jax_ref["pieces"]
    keys = {k for k in pieces if k.startswith("tomo.")}
    assert keys == {"tomo." + _name(k) for k in p}
    for k, v in p.items():
        _assert_close(v[0], pieces["tomo." + _name(k)], _name(k))
    _assert_close(torch.cat([m.n_g for m in models]), pieces["n_g"], "n_g")
    calls.clear()
    q = limber_fft.p_lattice_tomographic(
        cosmo, convert.halo_params(default_halo(), **KW), models, st,
        with_cross=False)
    assert calls == [2] and ("power_gg", 0, 1) not in q
    for k, v in q.items():
        assert torch.equal(v, p[k]), k


def test_power_gg_cross_matches_jax(jax_ref):
    """power_gg_cross through kernel A's plain version (the cross 1-halo
    term as the gg contraction of its own pack) against the JAX
    package's y-matrix product."""
    st = Statics(GRID, **KW)
    cosmo = port_batch().rows(0, 1)
    models = _models(cosmo, st)
    got = halo.power_gg_cross(cosmo, convert.halo_params(default_halo(),
                                                         **KW),
                              models[0], models[1], st.lattice_k, st)
    _assert_close(got[0], jax_ref["pieces"]["tomo.power_gg.0.1"], "cross")


def test_default_nuisance_reduces_and_calibration_scales():
    """The zero nuisance point gives the plain pipeline to 1e-13 (alpha
    = 1 switches magnification off); (1+m) scales gamma_t by (1+m_j) and
    xi_+- by (1+m_j)(1+m_k) exactly, leaving w untouched."""
    plain = port_pipeline(True)(port_batch())
    pipe = port_pipeline(True, with_nuisance=True, magnification=True)
    nu0 = sweep.default_nuisance(2, 2, **KW)
    zero = pipe(port_batch(), nu0)
    for key in OUTPUTS:
        torch.testing.assert_close(zero[key], plain[key], rtol=1e-13,
                                   atol=0.0)
    m = torch.tensor([0.02, -0.03], **KW)
    got = pipe(port_batch(), dataclasses.replace(nu0, m=m))
    cal = 1.0 + m
    assert torch.equal(got["w_theta"], zero["w_theta"])
    torch.testing.assert_close(
        got["gamma_t"].reshape(3, 2, 2, -1),
        zero["gamma_t"].reshape(3, 2, 2, -1) * cal[None, None, :, None],
        rtol=1e-15, atol=0.0)
    for r, (j, k) in enumerate([(0, 0), (0, 1), (1, 1)]):
        for key in ("xi_plus", "xi_minus"):
            torch.testing.assert_close(got[key][:, r],
                                       zero[key][:, r] * cal[j] * cal[k],
                                       rtol=1e-15, atol=0.0)


def test_one_kernel_a_and_three_c_calls(monkeypatch):
    """Per-bin HODs with nuisances and magnification: one kernel A call
    over B x n_lens rows and one kernel C call per operator (mu = 0: 2 w
    + 3 xi_+ + 4 magnification rows a cosmology; mu = 2: 4 gamma_t + 4
    magnification; mu = 4: 3 xi_-)."""
    pipe = port_pipeline(True, with_nuisance=True, magnification=True)
    a_rows, c_rows = [], []
    real_a, real_c = halo.halo_contract, sweep.df_contract
    monkeypatch.setattr(halo, "halo_contract",
                        lambda *a: a_rows.append(a[1].shape[0]) or real_a(*a))
    monkeypatch.setattr(sweep, "df_contract",
                        lambda c, *a: c_rows.append(c.shape[0])
                        or real_c(c, *a))
    pipe(port_batch(), port_nuisance(nuisance_points(True)))
    assert a_rows == [3 * 2]
    assert c_rows == [3 * 9, 3 * 8, 3 * 3]


@pytest.mark.parametrize("per_bin", [True, False])
def test_contraction_rows_are_the_forward_launch(monkeypatch, per_bin):
    """contraction_rows gives kernel A's inputs as the forward launches
    them; with per-bin HODs row b L + i is cosmology b's mass pack with
    lens bin i's galaxy pack."""
    pipe = port_pipeline(per_bin, with_nuisance=True, magnification=True)
    seen = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, mat, gal, cheb: (
        seen.append((mat, gal)) or real(k, mat, gal, cheb)))
    pipe(port_batch(), port_nuisance(nuisance_points(True)))
    rows = pipe.contraction_rows(port_batch())
    assert len(rows) == len(seen) == 1
    for got, ref in zip(rows[0], seen[0]):
        assert torch.equal(got, ref)
    mat, gal = rows[0]
    models = pipe.halo_models(port_batch())
    assert mat.shape[0] == 3 * len(models)
    for i, m in enumerate(models):
        ref_mat, ref_gal = halo.contraction_nodes(port_batch(),
                                                  pipe.halo_params, m)
        assert torch.equal(mat[i::len(models)], ref_mat)
        assert torch.equal(gal[i::len(models)], ref_gal)


#: Entries of the parity grid's data vector (12 probe rows x 6 theta)
#: whose Jacobian rows are held to JAX: two of each probe kind, every
#: lens and source bin (a CPU replica row costs a whole pipeline row).
JAC_ENTRIES = (1, 10, 14, 23, 33, 40, 48, 57, 61, 71)


def test_jacobian_matches_jax_jacfwd():
    """The float64 autograd Jacobian of ``vector`` through
    make_theory_fn over (omega_m0, sigma_8, dz_src, m, a_ia), per-bin
    HODs with magnification, at the committed point: the rows of
    JAC_ENTRIES within 1e-9 of each column's peak over them of the JAX
    jacfwd; p0 appends the nuisance leaves."""
    REF = json.loads(REF_PATH.read_text())["tiny_grid"]
    om, s8 = cosmologies()
    assert np.allclose(REF["omega_m0"], om) and np.allclose(REF["sigma_8"],
                                                            s8)
    assert REF["grid"] == dataclasses.asdict(GRID)
    pts = nuisance_points(True)
    nu0 = port_nuisance({k: v[REF["row"]] for k, v in pts.items()})
    assert np.allclose(REF["nuisance"]["m"], nu0.m.numpy())
    pipe = port_pipeline(True, with_nuisance=True, magnification=True)
    cosmo0 = convert.cosmo_params(default_cosmo(), **KW)
    fn, p0 = inference.make_theory_fn(
        pipe, cosmo0, ("omega_m0", "sigma_8"), output="vector",
        nuisance0=nu0, nuisance_names=tuple(REF["nuisance_names"]))
    assert p0.shape == (2 + 2 + 2 + 1,)
    assert torch.equal(p0[2:4], nu0.dz_src) and torch.equal(p0[4:6], nu0.m)
    p = torch.tensor([om[REF["row"]], s8[REF["row"]], *p0[2:].tolist()],
                     **KW)
    sel = list(JAC_ENTRIES)
    jac = inference.jacobian(lambda q: fn(q)[:, sel], p).numpy()
    want = np.asarray(REF["jacobian"])[sel]
    peak = np.abs(want).max(axis=0)
    assert np.all(peak > 0)
    assert float(np.max(np.abs(jac - want).max(axis=0) / peak)) < 1e-9


def test_theory_fn_replicas_take_their_own_nuisance():
    """A parameter batch (R, n_par) gives R replicas, each with its own
    nuisance slots: row r equals the pipeline at its point."""
    pipe = port_pipeline(False, with_nuisance=True)
    nu0 = sweep.default_nuisance(2, 2, **KW)
    cosmo0 = convert.cosmo_params(default_cosmo(), **KW)
    fn, p0 = inference.make_theory_fn(pipe, cosmo0, ("omega_m0",),
                                      output="vector", nuisance0=nu0,
                                      nuisance_names=("m", "a_ia"))
    p = torch.stack([p0, p0 + torch.tensor([0.01, 0.02, -0.01, 0.5], **KW)])
    got = fn(p)
    c1 = dataclasses.replace(cosmo0, omega_m0=p[1, 0],
                             omega_l0=1.0 - p[1, 0])
    want = pipe(c1, dataclasses.replace(nu0, m=p[1, 1:3], a_ia=p[1, 3]))
    torch.testing.assert_close(got[1:], want["vector"], rtol=1e-14, atol=0.0)
    torch.testing.assert_close(got[:1], pipe(cosmo0, nu0)["vector"],
                               rtol=1e-14, atol=0.0)


UNPORTED = [dict(exact_z_anchors=4), dict(geometry="curved"),
            dict(include_cmb_lensing=True), dict(nonlimber_ell_switch=40),
            dict(nonlimber_ell_switch=40, nonlimber_rsd=True),
            dict(matter_power="halofit"), dict(matter_power="linear"),
            dict(with_bao=True)]


#: Per option of UNPORTED that is ported now: the outputs it must change
#: against the plain per-bin pipeline (the others stay bit for bit).
_OPTION_MOVES = {"exact_z_anchors": "all", "geometry": "all",
                 "include_cmb_lensing": (),
                 "nonlimber_ell_switch": ("w_theta", "gamma_t"),
                 "matter_power": ("xi_plus", "xi_minus"), "with_bao": "all"}
THETA_OPTIONS = np.geomspace(0.5, 4.0, 5)


@pytest.mark.parametrize("options", UNPORTED,
                         ids=[",".join(o) for o in UNPORTED])
def test_unported_options_raise(options):
    """Every option is ported now, exact-z tomography included: with
    per-bin HODs at THETA_OPTIONS it builds and runs, finite and of the
    plain pipeline's shapes (w_gk_cmb of w's, appended to the vector),
    changed where the option acts and bit for bit the same elsewhere.
    Its values against the JAX package are held in
    tests/test_torch_options.py (the tomographic option cell) and
    tests/test_torch_exactz_tomo.py (exact-z tomography)."""
    out = port_pipeline(True, theta_deg=THETA_OPTIONS, **options)(
        port_batch())
    base = port_pipeline(True, theta_deg=THETA_OPTIONS)(port_batch())
    name = next(iter(options))
    moves = _OPTION_MOVES[name]
    for key in ("w_theta", "gamma_t", "xi_plus", "xi_minus"):
        got, ref = out[key], base[key]
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        gap = float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
        if moves == "all" or key in moves:
            assert gap > 1e-6, key
        else:
            assert gap == 0.0, key
    if name == "include_cmb_lensing":
        assert out["w_gk_cmb"].shape == out["w_theta"].shape
        assert torch.equal(out["vector"][:, -out["w_gk_cmb"][0].numel():],
                           out["w_gk_cmb"].flatten(1))


def test_mass_fn_and_jax_refusals():
    """mass_fn = 1 (Tinker) is ported now: the pipeline builds and runs,
    finite, with n_g unlike the Sheth-Tormen one's; the JAX function's own
    refusals stay ValueErrors (and its nuisance + exact-z refusal a
    NotImplementedError)."""
    kw = dict(grid=GRID, device="cpu", dtype=torch.float64)
    hp = convert.halo_params(default_halo(), **KW)
    hod = convert.hod_zheng(default_hod(), **KW)
    lens = [convert.dndz(d, **KW) for d in LENS]
    tinker = sweep.make_tomographic_pipeline(
        dataclasses.replace(hp, mass_fn=torch.tensor(1.0, **KW)), hod,
        lens, lens, **kw)(port_batch())
    plain = sweep.make_tomographic_pipeline(hp, hod, lens, lens,
                                            **kw)(port_batch())
    assert bool(torch.isfinite(tinker["vector"]).all())
    assert float((tinker["n_g"] / plain["n_g"] - 1.0).abs().min()) > 1e-3
    for bad in (dict(geometry="sphere"), dict(include_magnification=True),
                dict(nonlimber_rsd=True), dict(matter_power="emu")):
        with pytest.raises(ValueError):
            sweep.make_tomographic_pipeline(hp, hod, lens, lens, **bad, **kw)
    with pytest.raises(ValueError, match="per-bin HODs"):
        sweep.make_tomographic_pipeline(hp, [hod], lens, lens, **kw)
    with pytest.raises(NotImplementedError, match="with_nuisance"):
        sweep.make_tomographic_pipeline(hp, hod, lens, lens,
                                        with_nuisance=True,
                                        exact_z_anchors=4, **kw)
    pipe = sweep.make_tomographic_pipeline(hp, hod, lens, lens,
                                           with_nuisance=True, **kw)
    with pytest.raises(ValueError, match="with_nuisance"):
        pipe(port_batch())


def test_converters_round_trip():
    """The JAX objects' converters: a Nuisance3x2pt, a list of HODs, a
    shifted dN/dz over a tabulated base."""
    nu = jsweep.default_nuisance(3, 2)
    got = convert.nuisance_3x2pt(nu, **KW)
    assert got.dz_lens.shape == (3,) and float(got.z0_ia) == 0.62
    assert torch.equal(got.alpha_lens, torch.ones(3, **KW))
    hods = convert.hod_list([default_hod(), default_hod(**HOD_B)], **KW)
    assert [float(h.log10_m_min) for h in hods] == [12.14, 12.6]
    assert all(isinstance(h, convert.HODZheng) for h in hods)
    d = convert.dndz(jproj.DNdzShifted(base=jax_dists()["interp"],
                                       dz=jnp.asarray(0.1)), **KW)
    assert isinstance(d.base, projection.DNdzInterpolation)
    assert float(d.z_max) == pytest.approx(2.1)
    with pytest.raises(TypeError):
        convert.dndz(object(), **KW)
