"""The method="table" route of chomp_tpu_torch against the JAX package.

interp_loglog_cubic, the nested-GL convergence window, z_bar, the ln P
tables, limber_cl and the table pipeline on the tiny grid of
tests/torch_parity.py (float64 CPU, the same numpy inputs for both
packages), the pipeline at DEFAULT_GRID against the committed JAX
values, and the port's table route against its own lattice route.
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu import projection as jproj
from chomp_tpu.grids import interp_loglog_cubic as jax_interp_cubic
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import DEFAULT_GRID, GridSpec, default_cosmo, halo
from chomp_tpu_torch import projection
from chomp_tpu_torch.correlation import ell_grid
from chomp_tpu_torch.grids import interp_loglog_cubic
from chomp_tpu_torch.ops import halo_contract as hc
from chomp_tpu_torch.ops import hankel_matmul as hm
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10
ELLS = ell_grid(tp.GRID)[0]


@pytest.fixture(scope="module")
def ref():
    return tp.jax_reference()


@pytest.fixture(scope="module")
def port():
    return tp.port_table_inputs()


def _table_pipeline(grid=tp.GRID, **kw):
    return sweep.make_pipeline(
        convert.halo_params(default_halo(), **kw),
        convert.hod_zheng(default_hod(), **kw),
        convert.dndz_gaussian(tp.jax_dist(), **kw), power_spec="power_gg",
        grid=grid, include_lensing=True, z_pivot=tp.Z_PIVOT, method="table",
        **kw)


@pytest.mark.parametrize("side", ["interior", "below", "above"])
def test_interp_loglog_cubic_matches_jax(side):
    """Batched tables (one per row) and both power-law extrapolation
    sides, against the JAX function vmapped over the rows."""
    rng = np.random.default_rng(7)
    n, ln_x0, dln = 40, -2.0, 0.1
    table = np.cumsum(rng.normal(0.0, 0.3, (3, n)), axis=-1)
    u = rng.uniform(0.0, 1.0, (3, 5, 4))
    t = {"interior": u * (n - 1), "below": -0.01 - 4.0 * u,
         "above": n - 0.99 + 4.0 * u}[side]
    q = ln_x0 + dln * t
    want = jax.vmap(lambda qq, yy: jax_interp_cubic(qq, ln_x0, dln, yy))(
        jnp.asarray(q), jnp.asarray(table))
    got = interp_loglog_cubic(torch.tensor(q), ln_x0, dln,
                              torch.tensor(table))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-14)


def test_interp_loglog_cubic_shared_table_and_queries():
    """A (1, n) table broadcasts over (B, ...) queries, and (1, ...)
    queries over a (B, n) batch of tables."""
    rng = np.random.default_rng(8)
    tables = torch.tensor(rng.normal(0.0, 1.0, (4, 30)))
    q = torch.tensor(rng.uniform(-0.5, 3.5, (4, 6)))
    one = interp_loglog_cubic(q, 0.0, 0.1, tables[:1])
    rows = interp_loglog_cubic(q[:1], 0.0, 0.1, tables)
    for b in range(4):
        assert torch.equal(one[b], interp_loglog_cubic(
            q[b:b + 1], 0.0, 0.1, tables[:1])[0])
        assert torch.equal(rows[b], interp_loglog_cubic(
            q[:1], 0.0, 0.1, tables[b:b + 1])[0])


@pytest.mark.parametrize("win", ["galaxy", "kappa"])
def test_windows_match_jax(win, ref, port):
    """window_z at Z_QUERY; the convergence window is the nested GL."""
    w = port.win_g if win == "galaxy" else port.win_k
    z = torch.tensor(tp.Z_QUERY, **KW)[None, :]
    got = w.window_z(port.cosmo, z, port.st)
    np.testing.assert_allclose(got.numpy(), ref[f"window.{win}"],
                               rtol=RTOL)


def test_nested_window_chunks_agree(port, monkeypatch):
    """Cutting the cosmology axis into chunks changes nothing."""
    z = torch.tensor(tp.Z_QUERY, **KW)[None, :]
    whole = port.win_k.window_z(port.cosmo, z, port.st)
    g = tp.GRID
    monkeypatch.setattr(projection, "NESTED_CHUNK_ELEMENTS",
                        len(tp.Z_QUERY) * g.n_z_lens * g.n_dist)
    parts = port.win_k.window_z(port.cosmo, z, port.st)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-14)


def test_window_supports(port):
    lo, hi = port.win_g.support()
    assert float(lo) == 0.0 and float(hi) == 2.0
    lo, hi = port.win_k.support()
    assert float(lo) == 0.0 and float(hi) == 2.0


@pytest.mark.parametrize("pair", ["gg", "kg"])
def test_z_bar_matches_jax(pair, ref, port):
    wa = port.win_g if pair == "gg" else port.win_k
    got = projection.z_bar(port.cosmo, wa, port.win_g, port.st)
    np.testing.assert_allclose(got.numpy(), ref[f"z_bar.{pair}"], rtol=RTOL)


@pytest.mark.parametrize("kind", ["power_gg", "linear"])
def test_power_tables_match_jax(kind, ref, port):
    """ln P on the static ln k table: the halo-model P_gg (one
    halo.powers evaluation) and the linear P(k, z=0)."""
    table = port.tables[kind]
    ln_k, dln = jproj._k_table(tp.GRID)
    assert float(table.ln_k0) == float(ln_k[0]) and float(table.dln) == dln
    np.testing.assert_allclose(table.ln_p.numpy(), ref[f"ln_p.{kind}"],
                               rtol=RTOL)


@pytest.mark.parametrize("pair", ["gg", "kg", "kk"])
def test_limber_cl_matches_jax(pair, ref, port):
    """Limber C_ell on the ell grid: gg and kappa-g on the P_gg table,
    kappa-kappa on the linear table."""
    wa, wb, table = {"gg": (port.win_g, port.win_g, "power_gg"),
                     "kg": (port.win_k, port.win_g, "power_gg"),
                     "kk": (port.win_k, port.win_k, "linear")}[pair]
    got = projection.limber_cl(port.cosmo, wa, wb, ELLS, port.tables[table],
                               port.st)
    np.testing.assert_allclose(got.numpy(), ref[f"cl.{pair}"], rtol=RTOL)


def test_limber_cl_on_a_converted_jax_table(ref, port):
    """convert.power_table turns the JAX package's PowerTable into the
    port's, so both limber_cl integrate one table."""
    ln_k, dln = jproj._k_table(tp.GRID)
    src = jproj.PowerTable(ln_k0=jnp.asarray(ln_k[0]), dln=jnp.asarray(dln),
                           ln_p=jnp.asarray(ref["ln_p.power_gg"]),
                           growth_pivot=jnp.asarray(ref["mass.growth"]))
    table = convert.power_table(src, **KW)
    assert table.ln_p.shape == ref["ln_p.power_gg"].shape
    got = projection.limber_cl(port.cosmo, port.win_g, port.win_g,
                               ELLS, table, port.st)
    np.testing.assert_allclose(got.numpy(), ref["cl.gg"], rtol=RTOL)


@pytest.fixture(scope="module")
def table_out():
    return _table_pipeline(**KW)(convert.cosmo_batch(tp.jax_batch(), **KW))


@pytest.mark.parametrize("key", tp.PIPELINE)
def test_table_pipeline_matches_jax(key, ref, table_out):
    """make_pipeline(method="table") against the JAX table route for the
    3 parity cosmologies: rtol 1e-8 (measured ~5e-15)."""
    want = ref[f"table.{key}"]
    assert table_out[key].shape == want.shape
    np.testing.assert_allclose(table_out[key].numpy(), want, rtol=1e-8)


def test_table_pipeline_evaluates_spectra_once(monkeypatch):
    """One halo.powers call per forward (both probes' tables), and CPU
    tensors launch no kernel."""
    calls = []
    powers = halo.powers
    monkeypatch.setattr(halo, "powers",
                        lambda *a: calls.append(1) or powers(*a))
    before = (hc.halo_contract.launches, hm.hankel_matmul.launches)
    out = _table_pipeline(**KW)(convert.cosmo_batch(tp.jax_batch(), **KW))
    assert len(calls) == 1
    assert (hc.halo_contract.launches, hm.hankel_matmul.launches) == before
    assert set(out) == {"theta_deg", "n_g", "w_theta", "gamma_t"}


def test_table_pipeline_float32_tracks_float64(table_out):
    """The float32 table route on the CPU: worst bin < 1e-4 against the
    float64 port."""
    kw = dict(device="cpu", dtype=torch.float32)
    out = _table_pipeline(**kw)(convert.cosmo_batch(tp.jax_batch(), **kw))
    for key in ("w_theta", "gamma_t"):
        assert out[key].dtype == torch.float32
        err = np.abs(out[key].double().numpy() / table_out[key].numpy() - 1)
        assert np.max(err) < 1e-4


@pytest.fixture(scope="module")
def default_grid_out():
    """The table route at DEFAULT_GRID (float64 CPU) for the cosmologies
    of the committed JAX reference that chip_smoke.py reads."""
    ref = json.loads((Path(__file__).parent / "data"
                      / "torch_table_reference.json").read_text())
    oms = np.asarray(ref["omega_m0"])
    batch = sweep.broadcast_cosmo(default_cosmo(**KW), omega_m0=oms,
                                  omega_l0=1.0 - oms,
                                  sigma_8=np.asarray(ref["sigma_8"]))
    return ref, _table_pipeline(grid=DEFAULT_GRID, **KW)(batch)


@pytest.mark.parametrize("key", ["w_theta", "gamma_t"])
def test_table_default_grid_matches_committed_reference(key,
                                                        default_grid_out):
    """At DEFAULT_GRID the float64 port reproduces the JAX float64 table
    route in tests/data/torch_table_reference.json (written by
    tools/torch_slice_reference.py) to rtol 1e-10 (measured ~6e-15)."""
    ref, out = default_grid_out
    np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(out["theta_deg"].numpy(), ref["theta_deg"],
                               rtol=1e-14)


def test_table_route_tracks_lattice_route():
    """The port's table and lattice routes agree to 3e-5 for the
    fiducial cosmology on tests/test_prior_corners.py's grid (the JAX
    package measures <= 5.4e-6 there at its prior corners)."""
    grid = GridSpec(n_mass=256, lattice_dln=0.016, n_ell=512, n_theta=16)
    batch = default_cosmo(**KW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = [sweep.make_pipeline(
            convert.halo_params(default_halo(), **KW),
            convert.hod_zheng(default_hod(), **KW),
            convert.dndz_gaussian(tp.jax_dist(), **KW), grid=grid,
            method=method, **KW)(batch) for method in ("fft", "table")]
    for key in ("w_theta", "gamma_t"):
        a, b = outs[0][key].numpy(), outs[1][key].numpy()
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
        assert np.max(np.abs(a / b - 1.0)) < 3e-5, key
