"""Exact redshift evolution on every route of chomp_tpu_torch against the
JAX package (float64 CPU).

- Exact-z tomography (``make_tomographic_pipeline(exact_z_anchors=4)``)
  on tests/test_torch_tomographic.py's 2 lens x 2 source layout and tiny
  grid: the cases of ``EXACTZ_TOMO_CASES`` (tools/
  torch_slice_reference.py: a shared HOD and per-bin HODs, flat and
  curved, halofit / linear mm legs, BAO, kappa_CMB, non-Limber with RSD)
  against the JAX values committed in the ``tiny`` block of
  tests/data/torch_exactz_tomo_reference.json, to 1e-10 of each row's
  peak; in the same forwards one kernel A call over B x J (x n_lens)
  anchor rows (a second, at the pivot, with non-Limber), one kernel C
  call per distinct operator, and no separable-bias warning; the nL = nS
  = 1 equality with the exact-z ``make_pipeline`` (flat and curved, rtol
  1e-12, the JAX test tests/test_tomographic.py::test_tomographic_exact_z);
  ``contraction_rows`` as the forward launches them; and the Jacobian
  over (omega_m0, sigma_8) against the committed ``jacfwd``, as J^T v
  for a seeded v (one backward pass).
- ``projection.limber_cl_exact_z`` (the Gauss-Legendre exact-z C_ell, a
  k row per halo-model row): kind ``linear_power`` against the separable
  ``limber_cl`` (rtol 2e-5, tests/test_projection.py::
  test_limber_exact_z_linear_anchor's grids); ``power_gg`` against the
  JAX values of tests/data/torch_exactz_reference.json (1e-10), the
  anchored lattice (J = 8) within 1e-4 of it (the bar of the JAX
  package's slow test); d C_ell / d(omega_m0, sigma_8) through kernel A's
  grad_k against the committed ``jacfwd``; one kernel A call.
- Kernel A's plain version with a k row per row against calls with a
  shared k, bit for bit, and the plain backward's grad_k against autograd
  of the plain forward (1e-12).
- ``limber_cl_fft(conv_method="fft")``: the whitened FFT convolution
  against the JAX function (eager, x64) and the port's direct route
  (1e-10).
- The float32 EH98 BAO transfer: the float64 one of its inputs, rounded
  once.

Budget: no JAX pipeline is compiled here (the committed values cost ~24
min of JAX CPU to make); ~53 s alone (CHANGES.md).
"""

import dataclasses
import json
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_cosmo as jax_default_cosmo
from chomp_tpu import default_halo
from chomp_tpu import limber_fft as jlimber
from chomp_tpu import projection as jproj
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import (default_cosmo, halo, inference, limber_fft,
                             projection)
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.ops import halo_contract as hc
from chomp_tpu_torch.params import DEFAULT_GRID, GridSpec
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import test_exact_z_lattice as tz
from tests import test_torch_tomographic as tt
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_slice_reference as tsr  # noqa: E402

KW = dict(device="cpu", dtype=torch.float64)
DATA = Path(__file__).parent / "data"
REF = json.loads((DATA / "torch_exactz_tomo_reference.json").read_text())
TINY = REF["tiny"]
J = TINY["exact_z_anchors"]
CL_REF = json.loads((DATA / "torch_exactz_reference.json").read_text())[
    "cl_exact_z"]


def _rel(got, ref):
    """Worst |got - ref| over each row relative to the row's peak (1-D:
    elementwise relative)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if ref.ndim == 1:
        return float(np.max(np.abs(got / ref - 1.0)))
    g2, r2 = got.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.abs(g2 - r2).max(-1) / np.abs(r2).max(-1)))


def test_reference_is_current():
    """The committed JAX values were made for this file's layout, grid,
    cosmologies, cases and anchors."""
    om, s8 = tt.cosmologies()
    assert TINY["grid"] == dataclasses.asdict(tt.GRID)
    assert np.allclose(TINY["omega_m0"], om)
    assert np.allclose(TINY["sigma_8"], s8)
    assert REF["cases"] == tsr.EXACTZ_TOMO_CASES
    assert TINY["theta_tiny"] == tsr.TINY_THETA_DEG
    assert REF["gl"]["grid"] == dataclasses.asdict(tz.G)
    assert REF["chip_gl"]["ells"] == tsr.GL_ELLS


def _case_pipeline(case):
    spec = tsr.EXACTZ_TOMO_CASES[case]
    theta = tsr.TINY_THETA_DEG if spec["theta"] == "tiny" else None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return tt.port_pipeline(spec["per_bin"], exact_z_anchors=J,
                                theta_deg=theta, **spec["options"])


@pytest.mark.parametrize("case", list(tsr.EXACTZ_TOMO_CASES))
def test_exact_z_tomography_matches_jax(case, monkeypatch):
    """Each case's outputs and data vector against the committed JAX
    values (1e-10 of each row's peak; n_g relative), built and run with
    warnings as errors; one kernel A call over B x J rows (B x J x n_lens
    with per-bin HODs), a second over the pivot rows with non-Limber, and
    one kernel C call per distinct operator (flat 3, curved 4)."""
    spec = tsr.EXACTZ_TOMO_CASES[case]
    a_rows, c_rows = [], []
    real_a, real_c = halo.halo_contract, sweep.df_contract
    monkeypatch.setattr(halo, "halo_contract",
                        lambda *a: a_rows.append(a[1].shape[0]) or real_a(*a))
    monkeypatch.setattr(sweep, "df_contract",
                        lambda c, *a: c_rows.append(c.shape[0])
                        or real_c(c, *a))
    pipe = _case_pipeline(case)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = pipe(tt.port_batch())
    n_l = 2 if spec["per_bin"] else 1
    want_a = [3 * J * n_l]
    if spec["options"].get("nonlimber_ell_switch"):
        want_a.append(3 * n_l)
    assert a_rows == want_a
    assert len(c_rows) == (4 if spec["options"].get("geometry") == "curved"
                           else 3)
    ref = TINY["cases"][case]
    assert set(ref) == set(out) - {"theta_deg"}
    for key, val in ref.items():
        assert _rel(out[key], val) < 1e-10, key


@pytest.mark.parametrize("geometry", ["flat", "curved"])
def test_single_bin_equals_exact_z_pipeline(geometry):
    """nL = nS = 1 (source bin 1 as lens and source): the exact-z
    tomographic rows equal the exact-z make_pipeline with shear, to rtol
    1e-12 (they share the anchor window [1e-3, max(1, z_max)])."""
    hp = convert.halo_params(default_halo(), **KW)
    hod = convert.hod_zheng(default_hod(), **KW)
    src = convert.dndz(tt.SRC[1], **KW)
    kw = dict(grid=tt.GRID, exact_z_anchors=J, geometry=geometry,
              theta_deg=tsr.TINY_THETA_DEG, **KW)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tomo = sweep.make_tomographic_pipeline(hp, hod, [src], [src], **kw)
        one = sweep.make_pipeline(hp, hod, src, include_shear=True, **kw)
    batch = tt.port_batch()
    a, b = tomo(batch), one(batch)
    for key in ("w_theta", "gamma_t", "xi_plus", "xi_minus"):
        torch.testing.assert_close(a[key][:, 0], b[key], rtol=1e-12,
                                   atol=0.0)


def test_contraction_rows_are_the_forward_launch(monkeypatch):
    """Per-bin HODs, exact-z: contraction_rows gives kernel A's inputs as
    the forward launches them, row (b J + j) L + i = cosmology b at anchor
    j with lens bin i's galaxy pack."""
    pipe = _case_pipeline("per_bin")
    seen = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, mat, gal, cheb: (
        seen.append((mat, gal)) or real(k, mat, gal, cheb)))
    pipe(tt.port_batch())
    rows = pipe.contraction_rows(tt.port_batch())
    assert len(rows) == len(seen) == 1
    for got, ref in zip(rows[0], seen[0]):
        assert torch.equal(got, ref)
    mat, gal = rows[0]
    assert mat.shape[0] == 3 * J * 2
    assert torch.equal(mat[0::2], mat[1::2])


def test_exact_z_tomography_jacobian_matches_jacfwd():
    """The float64 autograd gradient of v . vector over (omega_m0,
    sigma_8) per cosmology, for a seeded v, against the committed JAX
    jacfwd contracted with v: 1e-9 of sum |J| |v| (the per-bin case)."""
    jac = np.asarray(TINY["per_bin_jacobian"]["jacobian"])    # (3, n, 2)
    val = np.asarray(TINY["per_bin_jacobian"]["vector"])
    v = np.random.default_rng(5).normal(size=val.shape)
    pipe = _case_pipeline("per_bin")
    om = torch.tensor(TINY["omega_m0"], **KW, requires_grad=True)
    s8 = torch.tensor(TINY["sigma_8"], **KW, requires_grad=True)
    base = tt.port_batch()
    out = pipe(dataclasses.replace(base, omega_m0=om, omega_l0=1.0 - om,
                                   sigma_8=s8))
    assert _rel(out["vector"], val) < 1e-10
    g_om, g_s8 = torch.autograd.grad(
        (out["vector"] * torch.as_tensor(v, **KW)).sum(), (om, s8))
    got = torch.stack([g_om, g_s8], dim=1).numpy()
    want = np.einsum("bnp,bn->bp", jac, v)
    scale = np.einsum("bnp,bn->bp", np.abs(jac), np.abs(v))
    assert np.max(np.abs(got - want) / scale) < 1e-9


def test_exact_z_tomography_refuses_nuisances():
    """The JAX refusal stays: with_nuisance (and so magnification) with
    exact_z_anchors raises NotImplementedError."""
    with pytest.raises(NotImplementedError, match="with_nuisance"):
        tt.port_pipeline(True, with_nuisance=True, exact_z_anchors=J)


# -- the Gauss-Legendre exact-z C_ell ------------------------------------

def _g_window():
    return projection.WindowGalaxy(convert.dndz_gaussian(tz._win().dist,
                                                         **KW))


def _g_statics():
    return Statics(GridSpec(**dataclasses.asdict(tz.G)), **KW)


def _gl_cl(cosmo, st, kind="power_gg", n_z=32, ells=None):
    win = _g_window()
    return projection.limber_cl_exact_z(
        cosmo, convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW), win, win,
        np.asarray(CL_REF["ells"] if ells is None else ells), st, kind,
        n_z=n_z)


def test_gl_exact_z_linear_equals_separable():
    """Kind linear_power: the exact-z GL route equals the separable
    limber_cl (linear growth is separable), rtol 2e-5, on the grids of
    the JAX package's test_limber_exact_z_linear_anchor."""
    dist = convert.dndz_gaussian(tp.jax_dist(), **KW)
    win = projection.WindowGalaxy(dist)
    ells = np.array([10.0, 100.0, 1000.0])
    c = default_cosmo(**KW)
    st_sep = Statics(DEFAULT_GRID.replace(n_z_proj=64), **KW)
    sep = projection.limber_cl(c, win, win, ells,
                               projection.power_table_linear(c, st_sep),
                               st_sep)
    st_x = Statics(DEFAULT_GRID.replace(n_mass=64, sigma_panels=8,
                                        sigma_n_per_panel=32), **KW)
    exact = projection.limber_cl_exact_z(
        c, convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW), win, win, ells, st_x,
        kind="linear_power", n_z=64)
    assert exact.shape == sep.shape == (1, 3)
    np.testing.assert_allclose(exact.numpy(), sep.numpy(), rtol=2e-5)


def test_gl_exact_z_matches_jax_and_lattice(monkeypatch):
    """power_gg at tests/test_exact_z_lattice.py's configuration: one
    kernel A call over the 32 GL rows with a k row each, within 1e-10 of
    the JAX projection.limber_cl_exact_z; the port's anchored lattice
    route (J = 8) within 1e-4 of it."""
    rows = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract", lambda k, *a: (
        rows.append(tuple(k.shape)) or real(k, *a)))
    st = _g_statics()
    cl = _gl_cl(default_cosmo(**KW), st)[0].numpy()
    assert rows == [(32, len(CL_REF["ells"]))]
    tab = np.asarray(CL_REF["table"])
    assert np.max(np.abs(cl - tab)) / np.max(np.abs(tab)) < 1e-10
    win = _g_window()
    lat = limber_fft.limber_cl_fft_exact_z(
        default_cosmo(**KW), convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW), win, win,
        np.asarray(CL_REF["ells"]), st, "power_gg", n_z_anchor=8)[0]
    assert np.max(np.abs(lat.numpy() / cl - 1.0)) < 1e-4


def test_gl_exact_z_jacobian_matches_jacfwd():
    """d C_ell / d(omega_m0, sigma_8) of the GL route (omega_l0 = 1 -
    omega_m0; chi_j, and so each row's k, moves with the cosmology:
    kernel A's grad_k) by inference.jacobian against the committed JAX
    jacfwd: 1e-9 of each column's peak."""
    ref = REF["gl"]
    st = _g_statics()
    base = default_cosmo(**KW)

    def fn(p):
        c = sweep.broadcast_cosmo(base, omega_m0=p[:, 0],
                                  omega_l0=1.0 - p[:, 0], sigma_8=p[:, 1])
        return _gl_cl(c, st, ells=ref["ells"], n_z=ref["n_z"])

    p = torch.tensor([ref["omega_m0"], ref["sigma_8"]], **KW)
    with torch.no_grad():
        assert _rel(fn(p[None])[0], ref["value"]) < 1e-10
    jac = inference.jacobian(fn, p).numpy()
    want = np.asarray(ref["jacobian"])
    peak = np.abs(want).max(axis=0)
    assert np.max(np.abs(jac - want).max(axis=0) / peak) < 1e-9


# -- kernel A with a k row per row -----------------------------------------

def _random_nodes(rows, nm, ng, nk, seed):
    rng = np.random.default_rng(seed)
    mat = rng.uniform(0.05, 1.0, (rows, nm, 4))
    mat[..., 1] = rng.uniform(1.0, 20.0, (rows, nm))
    gal = rng.uniform(0.05, 1.0, (rows, ng, 9))
    gal[..., 3] = rng.uniform(1.0, 20.0, (rows, ng))
    gal[:, ::2, 2:4] = gal[:, ::2, 0:2]          # one profile, as no hooks
    k = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (rows, nk)))
    return tuple(torch.tensor(a, **KW) for a in (k, mat, gal))


def test_plain_kernel_a_per_row_k_bit_for_bit():
    """halo_contract_ref with k (R, NK) gives row r the result of the
    call with the shared k = k[r] (NK,), bit for bit, for every r; the
    public wrapper takes the same route on the CPU."""
    k, mat, gal = _random_nodes(6, 40, 33, 300, 1)
    out = hc.halo_contract_ref(k, mat, gal)
    assert out.shape == (6, hc.N_OUT, 300)
    for r in range(6):
        assert torch.equal(out[r], hc.halo_contract_ref(k[r], mat, gal)[r])
    cheb = torch.tensor(hc.cheb_table(), **KW)
    assert torch.equal(hc.halo_contract(k, mat, gal, cheb), out)
    with pytest.raises(ValueError, match="row per cosmology"):
        hc.halo_contract(k[:5], mat, gal, cheb)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_backward_grad_k_matches_autograd(shared):
    """halo_contract_bwd_ref's grad_k (and grad_mat, grad_gal) against
    torch.autograd of halo_contract_ref, to 1e-12 of each field's peak,
    for a k row per row and for a shared k (grad_k summed over rows); the
    autograd Function returns the same grad_k."""
    k, mat, gal = _random_nodes(5, 24, 18, 40, 2)
    if shared:
        k = k[0]
    g = torch.tensor(np.random.default_rng(3).normal(
        size=(5, hc.N_OUT, 40)), **KW)
    cheb = torch.tensor(hc.cheb_table(), **KW)
    leaves = [t.clone().requires_grad_(True) for t in (k, mat, gal)]
    ref = torch.autograd.grad((hc.halo_contract_ref(*leaves) * g).sum(),
                              leaves)
    g_mat, g_gal, g_k = hc.halo_contract_bwd_ref(k, mat, gal, cheb, g,
                                                 grad_k=True)
    for got, want in zip((g_k, g_mat, g_gal), ref):
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) < 1e-12
    kk = k.clone().requires_grad_(True)
    (via_fn,) = torch.autograd.grad(
        (hc.halo_contract(kk, mat, gal, cheb) * g).sum(), kk)
    assert torch.equal(via_fn, g_k)
    two = hc.halo_contract_bwd_ref(k, mat, gal, cheb, g)
    assert len(two) == 2 and torch.equal(two[0], g_mat)


# -- the whitened FFT convolution -------------------------------------------

def test_cl_fft_conv_matches_jax_and_direct():
    """limber_cl_fft(conv_method="fft") against the JAX function (eager,
    x64) and the port's direct route, on a smooth P lattice and a growth
    pivot: 1e-10 relative, from ell 2 to 2e4."""
    st = Statics(tp.GRID, **KW)
    ln_k, _ = limber_fft._lattices(tp.GRID)
    kk = np.exp(ln_k)
    p_np = 2.0e4 * kk / (1.0 + (kk / 0.02) ** 2.6)
    ells = np.geomspace(2.0, 2.0e4, 12)
    jw = jproj.WindowGalaxy(tp.jax_dist())
    ref = np.asarray(jlimber.limber_cl_fft(
        jax_default_cosmo(), jw, jw, ells, jnp.asarray(p_np), tp.GRID,
        growth_pivot=0.9, conv_method="fft"))
    win = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(),
                                                        **KW))
    c = default_cosmo(**KW)
    p = torch.tensor(p_np, **KW)[None]
    got = limber_fft.limber_cl_fft(c, win, win, ells, p, st,
                                   growth_pivot=0.9, conv_method="fft")
    direct = limber_fft.limber_cl_fft(c, win, win, ells, p, st,
                                      growth_pivot=0.9)
    assert got.shape == direct.shape == (1, 12)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-10,
                               atol=0.0)


# -- the float32 BAO transfer ---------------------------------------------

def test_bao_transfer_float32_is_rounded_float64():
    """transfer_eh_full on float32 inputs is the float64 transfer of the
    same (float32) inputs rounded once, within 1.2e-7 relative: in float32
    arithmetic its wiggles lost ~6e-7, which the curved P_ell sums carried
    to 1.2e-4 of a w(theta) bin near zero at 4 deg (chip_smoke.py phase
    21, the exact-z tomographic cell curved with BAO)."""
    from chomp_tpu_torch import linear

    kw32 = dict(device="cpu", dtype=torch.float32)
    om = np.array([0.24, 0.28, 0.32])
    c32 = sweep.broadcast_cosmo(default_cosmo(**kw32), omega_m0=om,
                                omega_l0=1.0 - om)
    k32 = torch.tensor(np.logspace(-4, 2, 400), **kw32)[None]
    got = linear.transfer_eh_full(c32, k32)
    assert got.dtype == torch.float32
    want = linear.transfer_eh_full(c32.to(dtype=torch.float64), k32.double())
    assert float(((got.double() - want).abs() / want.abs()).max()) < 1.2e-7
