"""chomp_tpu_torch halo model and kernel A's plain version against the JAX
package: mass tables, HOD switch masses, galaxy pack and the halo-model
spectra (float64 CPU, tiny grid, rtol 1e-10), halo_contract_ref in the
Pallas kernel's own terms (float32, 2e-6 of peak), and the kernel's
small-argument route (moment coefficients and series, float64)."""

import math


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu import special as jspecial
from chomp_tpu.hod import default_hod
from chomp_tpu.ops.halo_pallas import fused_contractions
from chomp_tpu_torch import halo
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.ops import halo_contract as hc
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_values():
    return tp.jax_reference()


@pytest.fixture(scope="module")
def port_values():
    st = Statics(tp.GRID, **KW)
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    hp = convert.halo_params(default_halo(), **KW)
    model = halo.build_halo_model(batch, hp, convert.hod_zheng(
        default_hod(), **KW), torch.full((1,), tp.Z_PIVOT, **KW), st)
    k = st.lattice_k
    integrals = halo.contractions(batch, hp, model, k, st)
    out = tp.flatten(model, halo.powers(batch, hp, model, k, st), integrals)
    return {name: v.numpy() for name, v in out.items()}


NAMES = ([f"mass.{f}" for f in tp.MASS_FIELDS]
         + [f"gal.{f}" for f in tp.GAL_FIELDS] + list(tp.MODEL_FIELDS)
         + [f"integrals.{f}" for f in tp.INTEGRALS]
         + [f"powers.{k}" for k in tp.POWERS])


@pytest.mark.parametrize("name", NAMES)
def test_halo_model_matches_jax(name, jax_values, port_values):
    """Mass tables, HOD switch masses (ln_m_sw1/2), the panel-refined
    galaxy pack, the five mass integrals and halo.powers (through kernel
    A's plain version on the CPU) agree with the JAX package to rtol
    1e-10 in float64."""
    ref, got = jax_values[name], port_values[name]
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize("feedback", [False, True])
def test_y_nfw_matches_jax(feedback):
    """profiles.y_nfw (k, M) matrix, with and without the matter-profile
    feedback hooks, against the JAX package: rtol 1e-12 in float64."""
    from chomp_tpu import default_cosmo as jax_default_cosmo
    from chomp_tpu import profiles as jprofiles
    from chomp_tpu_torch import profiles

    k, m = np.logspace(-3, 4, 40), np.logspace(10, 15.5, 30)
    m_star, z = 2.3e12, 0.7
    c_scale, k_scale = (0.8, 1.3) if feedback else (None, None)
    ref = np.asarray(jprofiles.y_nfw(
        jax_default_cosmo(), default_halo(), jnp.asarray(k)[:, None],
        jnp.asarray(m)[None, :], m_star, z, c_scale=c_scale,
        k_scale=k_scale))

    def t(v):
        return None if v is None else torch.tensor(v, **KW)

    got = profiles.y_nfw(
        convert.cosmo_params(jax_default_cosmo(), **KW),
        convert.halo_params(default_halo(), **KW), t(k)[None, :, None],
        t(m)[None, None, :], t([m_star]), t([z]),
        c_scale=t(None if c_scale is None else [c_scale]), k_scale=t(k_scale))
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-12, atol=0)


def test_scranton_switches_inside_mass_range(port_values):
    sw1, sw2 = port_values["ln_m_sw1"], port_values["ln_m_sw2"]
    ln_m = port_values["mass.ln_m"]
    assert np.all((ln_m[:, 0] < sw1) & (sw1 < sw2) & (sw2 < ln_m[:, -1]))


def _pallas_inputs():
    """The inputs of tests/test_fftlog.py's Pallas interpret-mode test."""
    rng = np.random.default_rng(1)
    nk, nm = 300, 200
    k = np.logspace(-4, 6, nk).astype(np.float32)
    rs = (10 ** rng.uniform(-3, 0.5, nm)).astype(np.float32)
    c = (10 ** rng.uniform(0.2, 1.6, nm)).astype(np.float32)
    wa = rng.normal(size=(nm, 8)).astype(np.float32)
    wb = rng.normal(size=(nm, 8)).astype(np.float32)
    return k, rs, c, wa, wb


def test_halo_contract_ref_in_pallas_terms():
    """Pallas column j = sum_m N wa[:, j] + N^2 wb[:, j].  In kernel A's
    terms, cosmology j of a batch of 8 carries the same nodes as matter
    nodes (wa, wb) and as galaxy nodes (matter = galaxy profile, a_gg =
    a_gm = wa, b_gg = b_gm = wb), so h_m + pp_mm, pp_gg and pp_gm must
    each equal column j.  float32, 2e-6 of peak (test_fftlog.py's gate)."""
    k, rs, c, wa, wb = _pallas_inputs()
    ref = np.asarray(fused_contractions(
        jnp.asarray(k), jnp.asarray(rs), jnp.asarray(c), jnp.asarray(wa),
        jnp.asarray(wb), interpret=True), np.float64)          # (nk, 8)
    n_out = wa.shape[1]
    node = np.broadcast_to(np.stack([rs, c], -1), (n_out, len(rs), 2))
    mat = np.concatenate([node, wa.T[..., None], wb.T[..., None]], -1)
    gal = np.concatenate([node, node, np.zeros_like(wa.T)[..., None],
                          wa.T[..., None], wb.T[..., None],
                          wa.T[..., None], wb.T[..., None]], -1)
    out = hc.halo_contract_ref(torch.tensor(k), torch.tensor(mat),
                               torch.tensor(gal)).double().numpy()
    scale = np.max(np.abs(ref))
    for got in (out[:, 0] + out[:, 2], out[:, 3], out[:, 4]):
        assert np.max(np.abs(got.T - ref)) / scale < 2e-6


def test_halo_contract_cpu_is_plain_version():
    """On CPU tensors the wrapper is the plain version."""
    k, rs, c, wa, wb = _pallas_inputs()
    rng = np.random.default_rng(3)
    mat = torch.tensor(np.stack([rs, c, wa[:, 0], wb[:, 0]], -1)[None])
    gal = torch.tensor(rng.uniform(0.1, 2.0, (1, 50, 9)))
    gal[..., 0:4] = torch.tensor(np.stack([rs[:50], c[:50]] * 2, -1))
    st = Statics(tp.GRID, **KW)
    k64, mat64 = torch.tensor(k, dtype=torch.float64), mat.double()
    got = hc.halo_contract(k64, mat64, gal, st.cheb)
    assert torch.equal(got, hc.halo_contract_ref(k64, mat64, gal))
    assert got.shape == (1, hc.N_OUT, len(k))


@pytest.mark.parametrize("bad", ["k_2d", "fields", "dtype", "table",
                                 "device"])
def test_halo_contract_rejects_bad_inputs(bad):
    """Malformed inputs raise; so does a device that is neither the CPU
    nor CUDA (no silent plain-version fallback)."""
    k = torch.ones(10, dtype=torch.float64)
    mat = torch.ones(2, 5, 4, dtype=torch.float64)
    gal = torch.ones(2, 6, 9, dtype=torch.float64)
    cheb = torch.tensor(hc.cheb_table())
    if bad == "k_2d":
        k = k[None]
    elif bad == "fields":
        mat = torch.ones(2, 5, 5, dtype=torch.float64)
    elif bad == "dtype":
        gal = gal.float()
    elif bad == "table":
        cheb = cheb[:-1]
    else:
        k, mat, gal, cheb = (t.to("meta") for t in (k, mat, gal, cheb))
    with pytest.raises((ValueError, TypeError)):
        hc.halo_contract(k, mat, gal, cheb)


def test_cheb_table_layout():
    """The packed table holds each Chebyshev table at its offset, the
    float32 term counts match special.py's trimming, and the kernel's
    compile-time counts per type (struct Lens in halo_contract.cu) are
    the wrapper's."""
    import re

    from chomp_tpu_torch import _special_coeffs as cf
    from chomp_tpu_torch.ops.build import CSRC

    t = hc.cheb_table()
    for name, off in hc._TABLES:
        tab = getattr(cf, name)
        assert np.array_equal(t[off:off + len(tab)], tab)
    assert hc._lens(torch.float64)[4:] == [16, 7]
    assert hc._lens(torch.float32)[4:] == [10, 4]
    assert all(n32 < n64 for n32, n64 in zip(hc._lens(torch.float32)[:4],
                                             hc._lens(torch.float64)[:4]))
    src = (CSRC / "halo_contract.cu").read_text()
    for name, dtype in (("float", torch.float32), ("double", torch.float64)):
        body = re.search(r"struct Lens<%s> \{(.*?)\};" % name, src, re.S)[1]
        got = dict(re.findall(r"(\w+) = (\d+)", body))
        want = dict(zip(("afm", "ag", "bfm", "bg", "series", "g_asym"),
                        hc._lens(dtype)), moments=hc.n_moments(dtype))
        assert {k: int(got[k]) for k in want} == want


# Concentrations of the main path's nodes (0.87-9.4), and beyond.
C_MOMENTS = np.array([0.5, 0.87, 1.0, 2.3, 4.0, 6.5, 9.4, 12.0])


def test_moment_coeffs_against_quadrature():
    """a_n = (-1)^n M_n(c) / (2n+1)!, M_n = int_0^c t^(2n+1)/(1+t)^2 dt:
    the recurrence against 128-node Gauss-Legendre on [0, c] (exact for
    the polynomial, converged for 1/(1+t)^2).  Each term a_n x^2n at the
    route's edge x = SMALL_B/(1+c) agrees to 1e-14 of mu(c) (the forward
    recurrence loses relative accuracy in the high, negligible terms at
    small c), and a_0 = mu(c) to 1e-14."""
    n = hc.n_moments(torch.float64)
    got = hc.moment_coeffs(torch.tensor(C_MOMENTS), n).numpy()
    assert got.shape == (len(C_MOMENTS), n)
    t, w = np.polynomial.legendre.leggauss(128)
    for c, row in zip(C_MOMENTS, got):
        tt, ww = 0.5 * c * (t + 1.0), 0.5 * c * w
        ref = [(-1) ** j * np.sum(ww * tt ** (2 * j + 1) / (1 + tt) ** 2)
               / math.factorial(2 * j + 1) for j in range(n)]
        mu = np.log1p(c) - c / (1 + c)
        edge = (hc.SMALL_B / (1 + c)) ** (2 * np.arange(n)) / mu
        np.testing.assert_allclose(row * edge, np.asarray(ref) * edge,
                                   rtol=0, atol=1e-14)
        assert abs(row[0] / mu - 1) < 1e-14


def _small_points():
    """(x, c) with b = (1+c)x <= SMALL_B: x from 1e-7 up to the edge."""
    c = np.repeat(C_MOMENTS[1:-1], 60)
    frac = np.tile(np.logspace(-7, 0, 60), len(C_MOMENTS) - 2)
    return frac * hc.SMALL_B / (1.0 + c), c


@pytest.mark.parametrize("n_terms", ["float64", "float32"])
def test_small_argument_series(n_terms):
    """The kernel's small-argument route (moment coefficients, Horner in
    x^2, float64) against special.nfw_n and against the JAX package's
    g(x) + sin(cx) fm(b) - cos(cx) g(b) from special.aux_g / aux_fm, on
    the same numpy inputs with b <= 4: rtol 1e-13 with the float64 term
    count; with the float32 count (truncated series, float64 arithmetic)
    within 3e-8 of mu(c)."""
    from chomp_tpu_torch.special import nfw_n

    x, c = _small_points()
    dtype = getattr(torch, n_terms)
    coeffs = hc.moment_coeffs(torch.tensor(c), hc.n_moments(dtype))
    got = hc.nfw_n_small(torch.tensor(x), coeffs).numpy()
    b, cx = (1.0 + c) * x, c * x
    ref_jax = np.asarray(jspecial.aux_g(jnp.asarray(x))
                         + jnp.sin(cx) * jspecial.aux_fm(jnp.asarray(b))
                         - jnp.cos(cx) * jspecial.aux_g(jnp.asarray(b)))
    ref = nfw_n(torch.tensor(x), torch.tensor(c)).numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)
        np.testing.assert_allclose(got, ref_jax, rtol=1e-13, atol=0)
    else:
        mu = coeffs[:, 0].numpy()
        assert np.max(np.abs(got - ref) / mu) < 3e-8


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_small_route_dc_series(dtype):
    """The backward's dN/dc on the small-argument route, sum_n e_n x^2n
    (hc.dc_coeffs, Horner in x^2 in float64), against the closed form
    sin(cx) / (x (1+c)^2), relative to its scale c / (1+c)^2: 1e-14 with
    the float64 term count (16), within 3e-8 with the float32 count (10,
    the truncation below 4^20 / 21!)."""
    x, c = _small_points()
    n = hc.n_moments(getattr(torch, dtype))
    e = hc.dc_coeffs(torch.tensor(c), n).numpy()
    assert e.shape == (len(c), n)
    got = np.zeros_like(x)
    for j in range(n - 1, -1, -1):
        got = got * (x * x) + e[:, j]
    ref = np.sin(c * x) / (x * (1.0 + c) ** 2)
    scale = c / (1.0 + c) ** 2
    assert np.max(np.abs(got - ref) / scale) < (1e-14 if dtype == "float64"
                                                else 3e-8)
