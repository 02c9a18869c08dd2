"""Gradients of chomp_tpu_torch against the JAX package (float64 CPU).

- Kernel A's plain backward (``halo_contract_bwd_ref``, the formulas the
  CUDA backward kernel runs) against autograd of the plain forward.
- The port's Jacobians of (w, gamma_t) with respect to (omega_m0,
  sigma_8), both routes on the tiny grid, against ``jax.jacfwd`` of the
  JAX package, committed in tests/data/torch_grad_reference.json by
  tools/torch_slice_reference.py (no JAX program is compiled here).
- dP_gg/d omega_m0 and finite, nonzero gradients of the growth, Limber
  C_ell and w(theta), mirroring the JAX package's own gradient tests.
- The autograd wiring of kernels B and C on CPU tensors, and, on a CUDA
  card only, the three backward kernels against their plain versions.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import (DEFAULT_GRID, background, correlation, halo,
                             inference, projection)
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.ops import df32, halo_contract as hc
from chomp_tpu_torch.ops import hankel_matmul as hm
from chomp_tpu_torch.ops.tiles import split_k
from chomp_tpu_torch.params import default_cosmo
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
REF = json.loads((Path(__file__).parent / "data"
                  / "torch_grad_reference.json").read_text())


def _col_peak_err(got, ref):
    """max over columns of max|got - ref| / max|ref| (last axis =
    parameter)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.max(np.abs(got - ref), axis=0)
                        / np.max(np.abs(ref), axis=0)))


@pytest.fixture(scope="module")
def statics():
    return Statics(tp.GRID, **KW)


def _nodes(statics, feedback):
    """Kernel A's node arrays of the halo model at z = 1 for two
    cosmologies of the parity batch (the feedback set switches on the
    matter-profile hooks, so no galaxy node's two profiles coincide)."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW).rows(0, 2)
    if feedback:
        batch = dataclasses.replace(
            batch, bary_c=torch.full((2,), 1.2, **KW),
            bary_eta=torch.full((2,), 0.1, **KW))
    hp = convert.halo_params(default_halo(), **KW)
    model = halo.build_halo_model(
        batch, hp, convert.hod_zheng(default_hod(), **KW),
        torch.ones(1, **KW), statics)
    return halo.contraction_nodes(batch, hp, model)


def _small_route_nodes():
    """Nodes and k with every b = (1+c) k r_s <= 4 (the moment series
    only)."""
    rng = np.random.default_rng(4)
    c = rng.uniform(0.9, 12.0, (2, 40))
    rs = 10.0 ** rng.uniform(-3.0, -0.5, (2, 40))
    w = rng.normal(size=(2, 40, 7))
    mat = np.concatenate([np.stack([rs[:, :24], c[:, :24]], -1),
                          w[:, :24, :2]], -1)
    gal = np.concatenate([np.stack([rs[:, 24:], c[:, 24:], rs[:, 24:] * 1.3,
                                    c[:, 24:] * 0.8], -1), w[:, 24:, 2:]], -1)
    k_max = 4.0 / np.max((1.0 + c) * rs * 1.3)
    k = np.geomspace(1e-4, k_max, 90)
    return (torch.tensor(k), torch.tensor(mat), torch.tensor(gal))


@pytest.mark.parametrize("nodes", ["main", "feedback", "small_route"])
def test_halo_contract_bwd_ref_matches_autograd(nodes, statics):
    """The plain backward (moment series for b <= 4, auxiliary functions
    beyond; the kernel's routes) against autograd of halo_contract_ref
    under a seeded cotangent: within 1e-9 of each gradient field's peak
    (measured ~1e-13)."""
    if nodes == "small_route":
        k, mat, gal = _small_route_nodes()
        b = (1.0 + torch.cat([mat[..., 1], gal[..., 1], gal[..., 3]], 1)
             ) * torch.cat([mat[..., 0], gal[..., 0], gal[..., 2]], 1)
        assert float(b.max()) * float(k.max()) <= hc.SMALL_B
    else:
        mat, gal = _nodes(statics, nodes == "feedback")
        k = statics.lattice_k[::3].contiguous()
    rng = np.random.default_rng(5)
    g = torch.tensor(rng.normal(size=(mat.shape[0], hc.N_OUT, len(k))))
    m = mat.detach().clone().requires_grad_(True)
    q = gal.detach().clone().requires_grad_(True)
    want = torch.autograd.grad((hc.halo_contract_ref(k, m, q) * g).sum(),
                               (m, q))
    got = hc.halo_contract_bwd_ref(k, mat.detach(), gal.detach(),
                                   statics.cheb, g)
    for a, r in zip(got, want):
        err = (a - r).abs().amax((0, 1)) / r.abs().amax((0, 1))
        assert float(err.max()) < 1e-9, err


def test_small_route_derivatives_at_the_edge():
    """profile_nd (N, dN/dx, dN/dc) on both sides of the route edge b = 4
    against autograd of special.nfw_n: rtol 1e-10 of each quantity's
    scale at c from 0.87 to 12."""
    from chomp_tpu_torch.special import nfw_n

    c = torch.tensor(np.repeat([0.87, 2.3, 6.5, 12.0], 6), **KW)
    b = torch.tensor(np.tile(4.0 * (1.0 + np.array(
        [-1e-3, -1e-9, 0.0, 1e-9, 1e-3, 0.05])), 4), **KW)
    x = b / (1.0 + c)
    coeffs = hc.moment_coeffs(c, hc.n_moments(torch.float64))
    n, dx, dc = hc.profile_nd(x, c, coeffs)
    xr = x.clone().requires_grad_(True)
    cr = c.clone().requires_grad_(True)
    nr = nfw_n(xr, cr)
    dxr, dcr = torch.autograd.grad(nr.sum(), (xr, cr))
    for got, ref in ((n, nr.detach()), (dx, dxr), (dc, dcr)):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-10


def _port_jacobian(method, i):
    """The port's float64 Jacobian (16, 2) at cosmology i of the parity
    batch, through inference.make_theory_fn + inference.jacobian."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    cosmo0 = dataclasses.replace(batch, **{
        f: v[i] for f, v in batch.fields().items()})
    pipe = sweep.make_pipeline(
        convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW),
        convert.dndz_gaussian(tp.jax_dist(), **KW), power_spec="power_gg",
        grid=tp.GRID, include_lensing=True, z_pivot=tp.Z_PIVOT,
        method=method, **KW)
    fn, p0 = inference.make_theory_fn(pipe, cosmo0)
    return fn, p0, inference.jacobian(fn, p0)


def test_grad_reference_is_current():
    """The committed reference was written for this grid and these
    cosmologies."""
    assert REF["tiny_grid"]["grid"] == dataclasses.asdict(tp.GRID)
    assert REF["tiny_grid"]["cosmo"] == tp.COSMO
    assert REF["default_grid"]["grid"] == dataclasses.asdict(DEFAULT_GRID)
    assert REF["p_gg_k1"]["grid"] == dataclasses.asdict(tp.GRID)


# A CPU Jacobian costs 3-11 s (16 replicas; the lattice route's plain
# kernel A dominates), so each route is held here at the cosmologies with
# and without the extra knobs; tests/test_torch_inference.py holds the
# lattice route at the fiducial one through make_theory_fn.
@pytest.mark.parametrize("method, i", [("fft", 2), ("table", 0),
                                       ("table", 2)])
def test_jacobian_matches_jax(method, i):
    """d(w, gamma_t)/d(omega_m0, sigma_8) of the port (reverse mode by
    replicas, float64, tiny grid) against the JAX package's jacfwd:
    within 1e-8 of each column's peak; the value to 1e-10."""
    ref = REF["tiny_grid"][method]
    fn, p0, jac = _port_jacobian(method, i)
    assert jac.shape == (2 * tp.GRID.n_theta, 2)
    assert _col_peak_err(jac.numpy(), ref["jacobian"][i]) < 1e-8
    with torch.no_grad():
        val = fn(p0)[0].numpy()
    np.testing.assert_allclose(val, ref["value"][i], rtol=1e-10, atol=0)


def test_p_gg_gradient_matches_jax(statics):
    """dP_gg(k = 1)/d omega_m0 at z = 0 (the quantity of the JAX
    package's test_jit_grad_through_halo_power) against jax.grad: rtol
    1e-8; the value to 1e-10."""
    ref = REF["p_gg_k1"]
    om = torch.tensor([ref["omega_m0"]], **KW, requires_grad=True)
    c = sweep.broadcast_cosmo(default_cosmo(**KW), omega_m0=om,
                              omega_l0=1.0 - om)
    hp = convert.halo_params(default_halo(), **KW)
    model = halo.build_halo_model(c, hp, convert.hod_zheng(default_hod(),
                                                           **KW),
                                  torch.zeros(1, **KW), statics)
    p = halo.powers(c, hp, model, torch.ones(1, **KW), statics)["power_gg"]
    (g,) = torch.autograd.grad(p.sum(), om)
    np.testing.assert_allclose(float(p.detach()), ref["value"], rtol=1e-10)
    np.testing.assert_allclose(float(g), ref["d_domega_m0"], rtol=1e-8)


def _grad_of(fn, statics):
    om = torch.tensor([0.278], **KW, requires_grad=True)
    c = sweep.broadcast_cosmo(default_cosmo(**KW), omega_m0=om,
                              omega_l0=1.0 - om)
    (g,) = torch.autograd.grad(fn(c, statics).sum(), om)
    return float(g)


def _growth(c, st):
    return background.growth_factor(c, torch.ones(1, **KW), st)


def _cl100(c, st):
    win = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(), **KW))
    pt = projection.power_table_linear(c, st)
    return projection.limber_cl(c, win, win, torch.tensor([100.0], **KW), pt,
                                st)


def _w01(c, st):
    win = projection.WindowGalaxy(convert.dndz_gaussian(tp.jax_dist(), **KW))
    return correlation.wtheta(c, win, win, projection.power_table_linear(c,
                                                                          st),
                              st, np.array([0.1]))


@pytest.mark.parametrize("fn", [_growth, _cl100, _w01],
                         ids=["growth", "limber_cl", "wtheta"])
def test_gradients_finite_and_nonzero(fn, statics):
    """Gradients with respect to omega_m0 (omega_l0 = 1 - omega_m0) of
    D(z=1), Limber C_ell(100) and w(0.1 deg) are finite and nonzero, as
    the JAX package's test_background / test_projection /
    test_correlation require of jax.grad; the growth also matches a
    central difference to 1e-7."""
    g = _grad_of(fn, statics)
    assert np.isfinite(g) and g != 0.0
    if fn is _growth:
        def d(om):
            c = dataclasses.replace(default_cosmo(**KW),
                                    omega_m0=torch.tensor(om, **KW),
                                    omega_l0=torch.tensor(1.0 - om, **KW))
            return float(_growth(c, statics))

        fd = (d(0.278 + 1e-5) - d(0.278 - 1e-5)) / 2e-5
        assert abs(g / fd - 1.0) < 1e-7


@pytest.mark.parametrize("op", ["hankel_matmul", "df_contract_f32",
                                "df_contract_f64"])
def test_bc_autograd_on_cpu_is_the_plain_backward(op):
    """On CPU tensors the autograd Functions of kernels B and C run the
    plain forward and the plain backward: the gradient equals the
    operator product of the cotangent (float64 exact; the float32 split
    to its float32 rounding), and no launch is counted."""
    rng = np.random.default_rng(6)
    before = (hm.hankel_matmul.bwd_launches, df32.df_contract.bwd_launches)
    g = rng.normal(size=(5, 8))
    if op == "hankel_matmul":
        op_t = torch.tensor(rng.normal(size=(30, 8)))
        x = torch.tensor(rng.normal(size=(5, 30)), requires_grad=True)
        out = hm.hankel_matmul(x, op_t)
        want = torch.tensor(g) @ op_t.T
    else:
        a = rng.normal(size=(8, 30))
        if op == "df_contract_f64":
            args = (torch.tensor(a),)
            x = torch.tensor(rng.lognormal(size=(5, 30)), requires_grad=True)
        else:
            args = tuple(torch.tensor(v) for v in df32.split_operator(a))
            x = torch.tensor(rng.lognormal(size=(5, 30)), dtype=torch.float32,
                             requires_grad=True)
        out = df32.df_contract(x, *args)
        want = torch.tensor(g) @ torch.tensor(a)
    (got,) = torch.autograd.grad(out, x, torch.tensor(g).to(out.dtype))
    tol = 1e-14 if got.dtype == torch.float64 else 1e-6
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) < tol
    assert (hm.hankel_matmul.bwd_launches,
            df32.df_contract.bwd_launches) == before


def test_static_operands_refuse_gradients(statics):
    """The table and the operators are static buffers: asking for their
    gradient raises.  k is not static any more (the Gauss-Legendre exact-z
    C_ell's k moves with the cosmology): it takes kernel A's grad_k, the
    plain backward's on the CPU."""
    k = statics.lattice_k[:10].clone().requires_grad_(True)
    mat = torch.ones(1, 3, 4, **KW)
    gal = torch.ones(1, 2, 9, **KW)
    out = hc.halo_contract(k, mat, gal, statics.cheb)
    (g_k,) = torch.autograd.grad(out.sum(), k)
    assert torch.equal(g_k, hc.halo_contract_bwd_ref(
        k.detach(), mat, gal, statics.cheb, torch.ones_like(out),
        grad_k=True)[2])
    cheb = statics.cheb.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="static"):
        hc.halo_contract(k.detach(), mat, gal, cheb)
    op = torch.ones(4, 3, **KW, requires_grad=True)
    with pytest.raises(ValueError, match="static"):
        hm.hankel_matmul(torch.ones(2, 4, **KW), op)
    with pytest.raises(ValueError, match="static"):
        df32.df_contract(torch.ones(2, 3, **KW), op)


@pytest.mark.parametrize("shape", [(512, 64, 1024), (512, 64, 2220)])
def test_backward_products_need_no_cluster_split(shape):
    """At the main path's backward shapes, G (512, 64) times the operator
    transposed (B: 1024 columns; C: 2220), the output tiles alone fill
    the card: split_k keeps one CTA per tile, K = 64 deep."""
    geo = split_k(*shape)
    assert geo.cluster == 1 and geo.kc == 64 and geo.bounds == ((0, 64),)
    assert geo.ctas >= 132


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the backward kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_halo_contract_bwd_kernel_matches_plain(cuda, statics):
    """Kernel A's backward on the card against its plain version: float64
    to 1e-12 of each field's peak, float32 within 2e-5 of the plain
    version evaluated in float64 on the same float32 inputs; bit for bit
    on a repeat."""
    mat, gal = _nodes(statics, feedback=False)
    k = statics.lattice_k
    g = torch.tensor(np.random.default_rng(7).normal(
        size=(mat.shape[0], hc.N_OUT, len(k))))
    args = [t.to(cuda) for t in (k, mat.detach(), gal.detach(), statics.cheb,
                                 g)]
    got = hc.halo_contract_bwd(*args)
    ref = hc.halo_contract_bwd_ref(*args)
    for a, r in zip(got, ref):
        assert float(((a - r).abs().amax((0, 1))
                      / r.abs().amax((0, 1))).max()) < 1e-12
    a32 = [t.float() for t in args]
    got32 = hc.halo_contract_bwd(*a32)
    exact = hc.halo_contract_bwd_ref(*[t.double() for t in a32])
    for a, r in zip(got32, exact):
        assert float(((a.double() - r).abs().amax((0, 1))
                      / r.abs().amax((0, 1))).max()) < 2e-5
    for a, b in zip(got32, hc.halo_contract_bwd(*a32)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["hankel_matmul", "df_contract"])
def test_bc_bwd_kernels_match_plain(op, cuda):
    """B's and C's backward kernels on the card: float64 to 1e-12 of the
    peak of the float64 product, float32 no worse than twice the float32
    torch.matmul against the exact product; bit for bit on a repeat."""
    rng = np.random.default_rng(8)
    g64 = torch.tensor(rng.normal(size=(512, 64)), device=cuda)
    if op == "hankel_matmul":
        op64 = torch.tensor(rng.normal(size=(1024, 64)), device=cuda)
        bwd, ops64 = hm.hankel_matmul_bwd, (op64,)
        ops32 = (op64.float(),)
        exact = g64.float().double() @ op64.float().double().T
        lib = g64.float() @ op64.float().T
    else:
        a = rng.normal(size=(64, 2220))
        bwd, ops64 = df32.df_contract_bwd, (torch.tensor(a, device=cuda),)
        ops32 = tuple(torch.tensor(v, device=cuda)
                      for v in df32.split_operator(a))
        exact = g64.float().double() @ (ops32[0].double() + ops32[1].double())
        lib = g64.float() @ ops32[0]
    got64 = bwd(g64, *ops64)
    ref64 = g64 @ (ops64[0].T if op == "hankel_matmul" else ops64[0])
    assert float((got64 - ref64).abs().max() / ref64.abs().max()) < 1e-12
    got32 = bwd(g64.float(), *ops32)
    err = float((got32.double() - exact).abs().max())
    assert err <= 2.0 * float((lib.double() - exact).abs().max())
    assert torch.equal(got32, bwd(g64.float(), *ops32))
