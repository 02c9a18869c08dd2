"""The chomp_tpu_torch slice (separable-growth, flat w(theta) + gamma_t)
against chomp_tpu.parallel.sweep.make_pipeline, plus the parameter
conversions and the options the port does not carry yet."""

import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from chomp_tpu import default_cosmo as jax_default_cosmo
from chomp_tpu import default_halo, params as jparams, projection
from chomp_tpu.hod import HODZheng as JaxHODZheng
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import DEFAULT_GRID, DNdzGaussian, GridSpec
from chomp_tpu_torch import default_cosmo, default_halo as port_halo
from chomp_tpu_torch import default_hod as port_hod
from chomp_tpu_torch.ops import df32, halo_contract as hc
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)


def _pipeline(**options):
    kw = dict(power_spec="power_gg", grid=tp.GRID, include_lensing=True,
              z_pivot=tp.Z_PIVOT, **KW)
    kw.update(options)
    return sweep.make_pipeline(
        convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW),
        convert.dndz_gaussian(tp.jax_dist(), **KW), **kw)


@pytest.fixture(scope="module")
def port_out():
    return _pipeline()(convert.cosmo_batch(tp.jax_batch(), **KW))


@pytest.mark.parametrize("key", tp.PIPELINE)
def test_slice_matches_jax(key, port_out):
    """The whole slice (float64 CPU: halo model, kernel A's and kernel C's
    plain versions, lattice windows and convolution) against the JAX
    pipeline for 3 cosmologies: rtol 1e-8 (measured ~4e-15)."""
    ref = tp.jax_reference()[f"pipe.{key}"]
    got = port_out[key].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=0)


@pytest.fixture(scope="module")
def default_grid_out():
    """The slice at DEFAULT_GRID (float64 CPU) for the cosmologies of the
    committed JAX reference file that chip_smoke.py reads."""
    ref = json.loads((Path(__file__).parent / "data"
                      / "torch_slice_reference.json").read_text())
    oms = np.asarray(ref["omega_m0"])
    pipe = _pipeline(grid=DEFAULT_GRID)
    batch = sweep.broadcast_cosmo(default_cosmo(**KW), omega_m0=oms,
                                  omega_l0=1.0 - oms,
                                  sigma_8=np.asarray(ref["sigma_8"]))
    return ref, pipe(batch)


@pytest.mark.parametrize("key", ["w_theta", "gamma_t"])
def test_slice_default_grid_matches_committed_reference(key,
                                                        default_grid_out):
    """At full DEFAULT_GRID the float64 port reproduces the JAX float64
    values in tests/data/torch_slice_reference.json (written by
    tools/torch_slice_reference.py) to rtol 1e-10 (measured ~1e-14)."""
    ref, out = default_grid_out
    np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(out["theta_deg"].numpy(), ref["theta_deg"],
                               rtol=1e-14)


def test_slice_float32_tracks_float64(port_out):
    """The float32 serving precision on the CPU: worst bin < 1e-4
    against the float64 port (the budget the chip run holds)."""
    pipe = sweep.make_pipeline(
        convert.halo_params(default_halo(), device="cpu",
                            dtype=torch.float32),
        convert.hod_zheng(default_hod(), device="cpu", dtype=torch.float32),
        convert.dndz_gaussian(tp.jax_dist(), device="cpu",
                              dtype=torch.float32),
        grid=tp.GRID, z_pivot=tp.Z_PIVOT, device="cpu", dtype=torch.float32)
    out = pipe(convert.cosmo_batch(tp.jax_batch(), device="cpu",
                                   dtype=torch.float32))
    for key in ("w_theta", "gamma_t"):
        got = out[key].double().numpy()
        assert out[key].dtype == torch.float32
        assert np.max(np.abs(got / port_out[key].numpy() - 1.0)) < 1e-4


def test_slice_outputs_and_no_kernel_launch_on_cpu(port_out):
    """CPU tensors take the plain versions: no kernel launch counted."""
    before = (hc.halo_contract.launches, df32.df_contract.launches)
    out = _pipeline()(convert.cosmo_batch(tp.jax_batch(), **KW))
    assert (hc.halo_contract.launches, df32.df_contract.launches) == before
    assert out["w_theta"].shape == (3, tp.GRID.n_theta)
    assert torch.equal(out["theta_deg"], port_out["theta_deg"])
    assert torch.all(out["w_theta"] > 0) and torch.all(out["gamma_t"] > 0)


def test_pipeline_rejects_mismatched_batch():
    pipe = _pipeline()
    batch = convert.cosmo_batch(tp.jax_batch(), device="cpu",
                                dtype=torch.float32)
    with pytest.raises(ValueError):
        pipe(batch)


#: Theta of the option cases (>= 0.5 deg: the curved operators' lmax
#: stays small there).
THETA_OPTIONS = np.geomspace(0.5, 4.0, 5)
#: Per option: the outputs it must change against the same pipeline
#: without it (the others must stay bit for bit).
_OPTION_MOVES = {"include_cmb_lensing": (), "geometry": "all",
                 "nonlimber_ell_switch": ("w_theta", "gamma_t"),
                 "matter_power": ("xi_plus", "xi_minus"), "with_bao": "all"}


@pytest.fixture(scope="module")
def option_bases():
    """The plain pipelines (with shear, at THETA_OPTIONS) of both routes."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    return {m: _pipeline(method=m, include_shear=True,
                         theta_deg=THETA_OPTIONS)(batch)
            for m in ("fft", "table")}


@pytest.mark.parametrize("option", [
    dict(include_cmb_lensing=True),
    dict(geometry="curved"), dict(nonlimber_ell_switch=40),
    dict(nonlimber_ell_switch=40, nonlimber_rsd=True),
    dict(matter_power="halofit"), dict(matter_power="linear"),
    dict(with_bao=True), dict(method="table", with_bao=True)])
def test_unported_options_raise(option, option_bases):
    """Each option, ported now, builds and runs with include_shear at
    THETA_OPTIONS: finite outputs of the plain pipeline's shapes (and
    w_gk_cmb of w's), changed where the option acts (by more than 1e-6 of
    the row's peak somewhere) and bit for bit the same elsewhere.  Their
    values against the JAX package are held in tests/test_torch_options.py
    (the option cells on the tomographic tests' grid)."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    out = _pipeline(include_shear=True, theta_deg=THETA_OPTIONS,
                    **option)(batch)
    base = option_bases[option.get("method", "fft")]
    name = next(k for k in option if k != "method")
    moves = _OPTION_MOVES[name]
    keys = ("w_theta", "gamma_t", "xi_plus", "xi_minus")
    for key in keys:
        got, ref = out[key], base[key]
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        gap = float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
        if moves == "all" or key in moves:
            assert gap > 1e-6, key
        else:
            assert gap == 0.0, key
    if name == "include_cmb_lensing":
        assert out["w_gk_cmb"].shape == out["w_theta"].shape
        assert bool(torch.isfinite(out["w_gk_cmb"]).all())


def test_unported_mass_function_raises():
    """mass_fn = 1 (Tinker), ported now, builds and runs: finite outputs
    whose n_g and w(theta) differ from the Sheth-Tormen pipeline's."""
    halo = dataclasses.replace(convert.halo_params(default_halo(), **KW),
                               mass_fn=torch.tensor(1.0, **KW))
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    pipe = sweep.make_pipeline(halo, port_hod(**KW),
                               convert.dndz_gaussian(tp.jax_dist(), **KW),
                               grid=tp.GRID, z_pivot=1.0, **KW)
    out, base = pipe(batch), _pipeline(z_pivot=1.0)(batch)
    for key in ("n_g", "w_theta", "gamma_t"):
        assert bool(torch.isfinite(out[key]).all())
        assert out[key].shape == base[key].shape
        assert float((out[key] / base[key] - 1.0).abs().max()) > 1e-3, key


@pytest.mark.parametrize("option", [
    dict(geometry="spherical"), dict(method="fast"),
    dict(matter_power="emulated"), dict(power_spec="power_xx"),
    dict(method="table", geometry="curved"),
    dict(method="table", nonlimber_ell_switch=40),
    dict(method="table", matter_power="linear"),
    dict(nonlimber_rsd=True)])
def test_invalid_options_raise_value_error(option):
    """Bad values, and the combinations the JAX make_pipeline refuses
    (sweep.py:233-251: the table route's, and nonlimber_rsd without
    nonlimber_ell_switch, ahead of any unported option), raise
    ValueError."""
    with pytest.raises(ValueError):
        _pipeline(**option)


def test_separable_bias_warning():
    with pytest.warns(UserWarning, match="separable growth"):
        sweep.make_pipeline(port_halo(**KW), port_hod(**KW),
                            convert.dndz_gaussian(tp.jax_dist(), **KW),
                            grid=tp.GRID, z_pivot=0.0, **KW)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _pipeline()


def test_table_route_takes_exact_z_anchors_as_the_reference():
    """As the JAX make_pipeline (sweep.py:272-275), method="table" ignores
    exact_z_anchors and skips the separable-bias warning: at z_pivot=0.0,
    where the same call without anchors warns, the table pipeline with
    exact_z_anchors=6 warns nothing and gives the same output bit for
    bit.  The port alone, float64 on the CPU at the parity grid."""
    dist = DNdzGaussian(*(torch.tensor(v, **KW) for v in (0.0, 2.0, 1.0,
                                                           0.2)))

    def table(**options):
        return sweep.make_pipeline(port_halo(**KW), port_hod(**KW), dist,
                                   grid=tp.GRID, z_pivot=0.0,
                                   method="table", **options, **KW)

    with pytest.warns(UserWarning, match="separable growth"):
        plain = table()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        anchored = table(exact_z_anchors=6)
    batch = sweep.broadcast_cosmo(default_cosmo(**KW),
                                  omega_m0=np.array([0.26, 0.31]))
    want, got = plain(batch), anchored(batch)
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("kind", ["cosmo", "halo", "hod", "dist"])
def test_convert_round_trip(kind):
    """JAX parameters -> port -> numpy -> JAX constructor -> port: equal
    leaves, and the numpy dict rebuilds the JAX dataclass."""
    src, conv, jcls = {
        "cosmo": (jax_default_cosmo(omega_m0=0.3, m_nu=0.06),
                  convert.cosmo_params, jparams.CosmoParams),
        "halo": (default_halo(), convert.halo_params, jparams.HaloParams),
        "hod": (default_hod(alpha=1.1), convert.hod_zheng, JaxHODZheng),
        "dist": (tp.jax_dist(), convert.dndz_gaussian,
                 projection.DNdzGaussian),
    }[kind]
    port = conv(src, **KW)
    back = convert.to_numpy(port)
    for name, val in back.items():
        assert np.array_equal(val, np.asarray(getattr(src, name))), name
    again = conv(jcls(**back), **KW)
    assert convert.to_numpy(again).keys() == back.keys()
    for name in back:
        assert torch.equal(getattr(again, name), getattr(port, name))


def test_cosmo_batch_and_broadcast():
    """convert.cosmo_batch and sweep.broadcast_cosmo give (B,) leaves."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    assert batch.batch == 3
    assert all(v.shape == (3,) for v in batch.fields().values())
    np.testing.assert_array_equal(batch.omega_m0.numpy(),
                                  tp.COSMO["omega_m0"])
    b2 = sweep.broadcast_cosmo(default_cosmo(**KW),
                               omega_m0=np.array([0.25, 0.3]))
    assert b2.batch == 2 and float(b2.h[1]) == 0.7
    assert all(v.shape == (2,) for v in b2.fields().values())
    with pytest.raises(ValueError):
        sweep.broadcast_cosmo(default_cosmo(**KW))


def test_gridspec_mirrors_jax():
    """The port's GridSpec has the JAX package's fields and defaults."""
    assert (dataclasses.asdict(DEFAULT_GRID)
            == dataclasses.asdict(jparams.DEFAULT_GRID))
    port_grid = GridSpec(**dataclasses.asdict(tp.GRID))
    assert dataclasses.asdict(port_grid) == dataclasses.asdict(tp.GRID)
