"""The HOD families of chomp_tpu_torch against the JAX package (float64
CPU): Zheng, Poisson, Mandelbaum and Kravtsov.

- Every moment (central, satellite, first, second, the n-th factorial
  moment for n = 1-4) and the breakpoints against the JAX classes
  (eager) at 1e-13, on masses on both sides of each step and break, and
  the cases of the JAX package's tests/test_hod.py.
- Gradients of the moments in the mass and in every field stay finite
  at masses below each family's onset (the masked branches of ``where``).
- ``make_pipeline`` with each family on both routes (and Mandelbaum's
  exact-z route) and ``make_tomographic_pipeline`` with a Mandelbaum and
  a Kravtsov lens bin, against the JAX outputs that
  tools/torch_slice_reference.py commits in the ``tiny`` block of
  tests/data/torch_families_reference.json (no JAX pipeline compiled
  here), at 1e-10 of each row's peak; with kernel A's plain calls: one
  per distinct galaxy node count (Mandelbaum's two breakpoints give 5
  panels of 64 nodes, 320, where the others give 256).
- ``utils.convert.hod`` / ``hod_list`` convert each family by its type.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu import hod as jhod
from chomp_tpu_torch import halo, hod
from chomp_tpu_torch.parallel.sweep import (make_pipeline,
                                            make_tomographic_pipeline)
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
REF = json.loads((Path(__file__).parent / "data"
                  / "torch_families_reference.json").read_text())
FAMILIES = {name: tuple(spec) for name, spec in REF["families"].items()}
FAMILIES["zheng"] = ("HODZheng", dict(log10_m_min=12.14, sigma=0.15,
                                      log10_m_0=12.14, log10_m_1p=13.43,
                                      alpha=1.0))
RTOL = 1e-10


def jax_hod(spec):
    cls, fields = spec
    return getattr(jhod, cls)(**{k: jnp.asarray(float(v))
                                 for k, v in fields.items()})


def port_hod(spec, **kw):
    return convert.hod(jax_hod(spec), **(kw or KW))


def masses(spec):
    """Masses over 1e9-1e16 and on both sides of every breakpoint (and
    of Mandelbaum's satellite break at 3 M0), (1, n)."""
    bps = np.exp([float(b) for b in jax_hod(spec).breakpoints()])
    near = np.concatenate([b * np.array([1 - 1e-9, 1 + 1e-9, 0.5, 2.0])
                           for b in bps])
    return np.sort(np.concatenate([np.logspace(9, 16, 71), near]))[None, :]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_moments_match_jax(name):
    spec = FAMILIES[name]
    m = masses(spec)
    j, p = jax_hod(spec), port_hod(spec)
    mt = torch.tensor(m, **KW)

    def close(got, ref, what):
        # 1e-13 of each value, or of the moment's peak over the masses
        # (Zheng's erfc tail reaches 1e-193, where the two erfc
        # implementations part at 4e-13 of the value).
        np.testing.assert_allclose(got, ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max(),
                                   err_msg=what)

    for what in ("central_moment", "satellite_moment", "first_moment",
                 "second_moment"):
        close(getattr(p, what)(mt).numpy(),
              np.asarray(getattr(j, what)(jnp.asarray(m))), what)
    for n in (1, 2, 3, 4):
        close(p.nth_moment(mt, n).numpy(),
              np.asarray(j.nth_moment(jnp.asarray(m), n)), f"n={n}")
    np.testing.assert_allclose([float(b) for b in p.breakpoints()],
                               [float(b) for b in j.breakpoints()],
                               rtol=1e-15)


def test_moment_relations_and_reference_cases():
    """The JAX package's tests/test_hod.py cases on the port."""
    zheng = hod.default_hod(**KW)
    m = torch.tensor(np.logspace(11, 16, 50), **KW)[None, :]
    nc, ns = zheng.central_moment(m), zheng.satellite_moment(m)
    torch.testing.assert_close(zheng.nth_moment(m, 3), 3 * nc * ns**2 + ns**3,
                               rtol=1e-14, atol=0)
    torch.testing.assert_close(zheng.nth_moment(m, 2), zheng.second_moment(m),
                               rtol=1e-14, atol=0)
    pois = hod.HODPoisson(*(torch.tensor(v, **KW) for v in (12.0, 1.0)))
    n = pois.first_moment(torch.tensor([[1e11, 1e13]], **KW))
    np.testing.assert_allclose(n.numpy()[0], [0.0, 10.0], rtol=1e-12)
    torch.testing.assert_close(pois.second_moment(
        torch.tensor([[1e11, 1e13]], **KW)), n * n)
    mand = hod.HODMandelbaum(*(torch.tensor(v, **KW) for v in (1e12, 1.5)))
    lo, hi = (mand.satellite_moment(torch.tensor([[3e12 * f]], **KW))
              for f in (1 - 1e-9, 1 + 1e-9))
    np.testing.assert_allclose(lo.item(), hi.item(), rtol=1e-6)
    krav = hod.HODKravtsov(*(torch.tensor(v, **KW)
                             for v in (11.5, 12.5, 1.0)))
    np.testing.assert_allclose(
        krav.first_moment(torch.tensor([[10.0**12.5]], **KW)).item(), 2.0,
        rtol=1e-12)
    assert krav.first_moment(torch.tensor([[1e11]], **KW)).item() == 0.0
    # A (B,) field broadcasts over the batch's rows.
    alphas = torch.tensor([0.8, 1.0, 1.2], **KW)
    batch = hod.default_hod(**KW)
    batch = type(batch)(**{**batch.fields(), "alpha": alphas})
    out = batch.first_moment(torch.full((3, 1), 1e14, **KW))[:, 0]
    assert out.shape == (3,) and out[0] < out[2]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_moment_gradients_are_finite(name):
    """d moment / d (m, every field) is finite at every mass, those below
    the onsets included (where a masked branch must not leak NaN); a
    field that enters only through a step (Kravtsov's M_min) has none."""
    p = port_hod(FAMILIES[name])
    fields = {k: v.clone().requires_grad_(True)
              for k, v in p.fields().items()}
    p = type(p)(**fields)
    m = torch.tensor(masses(FAMILIES[name]), **KW).requires_grad_(True)
    for n in (1, 2, 3):
        grads = torch.autograd.grad(p.nth_moment(m, n).sum(),
                                    [m, *fields.values()], allow_unused=True)
        assert all(torch.isfinite(g).all() for g in grads
                   if g is not None), (name, n)


def test_float32_gradients_below_the_onset():
    """Zheng's satellites with alpha < 1 in float32, every field's
    gradient: the masked branch's floor is the dtype's smallest normal
    (the JAX package's 1e-300 rounds to 0 in float32, where 0 ** alpha
    has an infinite slope and the gradient in M_1' turns NaN)."""
    kw = dict(device="cpu", dtype=torch.float32)
    p = hod.default_hod(alpha=0.8, **kw)
    fields = {k: v.clone().requires_grad_(True)
              for k, v in p.fields().items()}
    p = type(p)(**fields)
    m = torch.tensor(np.logspace(10, 15, 40)[None, :], **kw)
    m.requires_grad_(True)
    grads = torch.autograd.grad(p.second_moment(m).sum(),
                                [m, *fields.values()])
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name", ["poisson", "mandelbaum", "kravtsov"])
def test_float32_switch_masses_are_float64s(name):
    """The Scranton switch masses are solved in float64 for a float32
    model too: where a moment reaches 1 at an onset or a step the Newton
    steps do not settle (Poisson's float64 iterate one ulp below its onset
    jumps 20 e-folds, a float32 one stays), and in float32 the 1e-300
    floor of the log rounds to 0 (NaN for Poisson and Kravtsov)."""
    from chomp_tpu_torch.grids import Statics

    sw = {}
    for dtype in (torch.float32, torch.float64):
        kw = dict(device="cpu", dtype=dtype)
        cosmo = convert.cosmo_batch(tp.jax_batch(), **kw)
        model = halo.build_halo_model(
            cosmo, convert.halo_params(default_halo(), **kw),
            port_hod(FAMILIES[name], **kw), torch.ones(1, **kw),
            Statics(tp.GRID, **kw))
        sw[dtype] = torch.stack([model.ln_m_sw1, model.ln_m_sw2]).double()
    assert torch.isfinite(sw[torch.float32]).all()
    torch.testing.assert_close(sw[torch.float32], sw[torch.float64],
                               rtol=1e-7, atol=0)


def test_convert_by_type():
    hods = convert.hod_list([jax_hod(FAMILIES[n]) for n in
                             ("zheng", "poisson", "mandelbaum", "kravtsov")],
                            **KW)
    assert [type(h).__name__ for h in hods] == [
        "HODZheng", "HODPoisson", "HODMandelbaum", "HODKravtsov"]
    with pytest.raises(TypeError, match="no converter"):
        convert.hod(object(), **KW)


def peak_rel(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    return float(np.max(np.abs(got - ref)
                        / np.max(np.abs(ref), axis=-1, keepdims=True)))


@pytest.fixture
def ng_calls(monkeypatch):
    """The galaxy node count of each kernel A call."""
    calls = []
    real = halo.halo_contract
    monkeypatch.setattr(halo, "halo_contract",
                        lambda *a: calls.append(a[2].shape[1]) or real(*a))
    return calls


@pytest.mark.parametrize("name,method,options", [
    (n, m, {}) for n in ("poisson", "mandelbaum", "kravtsov")
    for m in ("fft", "table")] + [("mandelbaum", "fft",
                                   {"exact_z_anchors": 4})])
def test_make_pipeline_matches_jax(name, method, options, ng_calls):
    block = REF["tiny"]
    assert block["grid"] == tp.GRID.__dict__
    key = f"{name}_exact_z" if options else f"{name}_{method}"
    pipe = make_pipeline(convert.halo_params(default_halo(), **KW),
                         port_hod(FAMILIES[name]),
                         convert.dndz_gaussian(tp.jax_dist(), **KW),
                         power_spec="power_gg", grid=tp.GRID,
                         include_lensing=True, z_pivot=tp.Z_PIVOT,
                         method=method, **options, **KW)
    out = pipe(convert.cosmo_batch(tp.jax_batch(), **KW))
    for k in ("w_theta", "gamma_t", "n_g"):
        assert peak_rel(out[k], block[key][k]) < RTOL, k
    want_ng = 320 if name == "mandelbaum" else 256
    assert ng_calls == [want_ng], ng_calls


def test_mixed_family_tomographic_matches_jax(ng_calls):
    """A Mandelbaum and a Kravtsov lens bin: their packs (320 and 256
    nodes) and the cross pack (320) take one kernel A call per node
    count."""
    from tests import test_torch_tomographic as tt

    block = REF["tiny"]
    assert block["tomo_grid"] == tt.GRID.__dict__
    pipe = make_tomographic_pipeline(
        convert.halo_params(default_halo(), **KW),
        [port_hod(tuple(h)) for h in REF["mixed_tiny_hods"]],
        [convert.dndz_gaussian(d, **KW) for d in tt.LENS],
        [convert.dndz_gaussian(d, **KW) for d in tt.SRC], grid=tt.GRID,
        z_pivot=tt.Z_PIVOT, **KW)
    out = pipe(convert.cosmo_batch(tt.jax_batch(), **KW))
    for k in ("w_theta", "gamma_t", "xi_plus", "xi_minus", "n_g", "vector"):
        assert peak_rel(out[k], block["tomo_mixed"][k]) < RTOL, k
    assert sorted(ng_calls) == [256, 320], ng_calls
