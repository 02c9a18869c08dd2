"""chomp_tpu_torch.correlation and kernel B's plain version against the
JAX package: the zero-crossing-safe interpolation, the Hankel transforms
(plain and fused, both engines), the correlation functions and the ASCII
writer (float64 CPU, tiny grid of tests/torch_parity.py, rtol 1e-10), and
``hankel_matmul_ref`` on float32 inputs against the Pallas kernel in
interpret mode (rtol 2e-5, the JAX package's own tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import correlation as jcorr
from chomp_tpu.ops.fftlog_pallas import hankel_matmul_pallas
from chomp_tpu_torch import correlation
from chomp_tpu_torch.ops import hankel_matmul as hm
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10
THETA = np.array([0.002, 0.01, 0.05, 0.2, 0.7])
#: correlation function -> (C_ell row of the reference, mu, prefactor).
FUNCTIONS = {"wtheta": ("cl.gg", 0.0, 1.0), "gamma_t": ("cl.kg", 2.0, 1.0),
             "xi_plus": ("cl.kk", 0.0, 1.0), "xi_minus": ("cl.kk", 4.0, 1.0),
             "magnification_correlation": ("cl.kg", 0.0, 3.0)}


@pytest.fixture(scope="module")
def ref():
    return tp.jax_reference()


def _t(a):
    return torch.tensor(np.asarray(a), **KW)


def _crossing():
    """The sign-crossing case of tests/test_correlation.py: a smooth w
    through zero mid-grid, queried across the crossing."""
    theta = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), 128))
    w = np.sin(1.5 * (np.log(theta) - np.log(3e-3)))
    q = np.exp(np.linspace(np.log(2e-3), np.log(5e-2), 41))
    return theta, w, q


@pytest.mark.parametrize("case", ["sign_crossing", "batched"])
def test_interp_to_theta_matches_jax(case, ref):
    """Sign-crossing single row, and a (2, 3, n) batch of positive and
    sign-changing rows from the tiny grid's Hankel transforms."""
    if case == "sign_crossing":
        theta, w, q = _crossing()
    else:
        theta, w_op = jcorr.wtheta_operator(tp.GRID, 2.0)
        rows = np.concatenate([ref["cl.gg"], ref["cl.kk"]]) @ w_op.T
        w = np.stack([rows[:3], -rows[3:]]) * [[[1.0]], [[1e3]]]
        q = np.radians(np.geomspace(1e-3, 1.0, 9))
    want = np.asarray(jcorr._interp_to_theta(
        jnp.asarray(theta), jnp.asarray(w), jnp.asarray(q)))
    got = correlation._interp_to_theta(_t(theta), _t(w), _t(q))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


def test_interp_to_theta_sign_crossing():
    """The assertions of the JAX package's own sign-crossing test: right
    sign away from the crossing, < 1e-3 absolute error through it."""
    theta, w, q = _crossing()
    got = correlation._interp_to_theta(_t(theta), _t(w), _t(q)).numpy()
    want = np.sin(1.5 * (np.log(q) - np.log(3e-3)))
    away = np.abs(want) > 0.05
    assert np.all(np.sign(got[away]) == np.sign(want[away]))
    assert np.max(np.abs(got - want)) < 1e-3


@pytest.mark.parametrize("mu", [0.0, 2.0, 4.0])
def test_wtheta_from_cl_matches_jax(mu, ref):
    cl = ref["cl.gg"]
    want = np.asarray(jcorr.wtheta_from_cl(jnp.asarray(cl), THETA, tp.GRID,
                                           mu))
    got = correlation.wtheta_from_cl(_t(cl), THETA, tp.GRID, mu)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("rows", [2, 1])
def test_wtheta_from_cl_fused_matches_jax(engine, rows, ref):
    """Both engines in float64 against the JAX "xla" engine (the JAX
    Pallas kernel always rounds to float32; the port's "pallas" keeps
    float64 rows in float64), for a batch and for one 1-D row."""
    cl = ref["cl.kg"] if rows == 2 else ref["cl.kg"][0]
    want = np.asarray(jcorr.wtheta_from_cl_fused(jnp.asarray(cl), THETA,
                                                 tp.GRID, 2.0))
    got = correlation.wtheta_from_cl_fused(_t(cl), THETA, tp.GRID, 2.0,
                                           engine=engine)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_hankel_matmul_ref_matches_pallas_interpret(ref):
    """Kernel B's plain version on float32 inputs (C_ell rows and the
    fused operator, rounded to float32) against the JAX package's Pallas
    kernel in interpret mode: rtol 2e-5 (tests/test_correlation.py)."""
    cl = np.concatenate([ref["cl.gg"], 1.5 * ref["cl.kg"]]).astype(np.float32)
    op = jcorr.wtheta_bins_operator(tuple(THETA.tolist()), tp.GRID, 0.0)
    op_t = np.ascontiguousarray(op.T).astype(np.float32)
    want = np.asarray(hankel_matmul_pallas(jnp.asarray(cl),
                                           jnp.asarray(op_t), interpret=True))
    got = hm.hankel_matmul_ref(torch.tensor(cl), torch.tensor(op_t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


def test_float64_accumulation_no_worse_than_plain_version(ref):
    """Kernel B's arithmetic on the card (exact products of the float32
    inputs, a float64 sum, one rounding) against the exact product: no
    worse than the plain version's float32 matmul, and within one
    rounding (2^-24 of each row's peak)."""
    cl = np.concatenate([ref["cl.gg"], 1.5 * ref["cl.kg"]]).astype(np.float32)
    op_t = np.ascontiguousarray(jcorr.wtheta_bins_operator(
        tuple(THETA.tolist()), tp.GRID, 0.0).T).astype(np.float32)
    exact = cl.astype(np.longdouble) @ op_t.astype(np.longdouble)
    ours = (torch.tensor(cl).double() @ torch.tensor(op_t).double()).float()
    plain = hm.hankel_matmul_ref(torch.tensor(cl), torch.tensor(op_t))

    def err(x):
        d = np.abs(x.numpy().astype(np.longdouble) - exact).max(1)
        return float(np.max(d / np.abs(exact).max(1)))

    assert err(ours) <= err(plain)
    assert err(ours) <= 2.0 ** -24


def test_hankel_matmul_takes_plain_version_on_cpu(ref):
    """A CPU tensor takes the plain version: equal to it, no launch."""
    cl = torch.tensor(ref["cl.gg"])
    op_t = torch.tensor(np.ascontiguousarray(jcorr.wtheta_bins_operator(
        tuple(THETA.tolist()), tp.GRID, 0.0).T))
    before = hm.hankel_matmul.launches
    assert torch.equal(hm.hankel_matmul(cl, op_t),
                       hm.hankel_matmul_ref(cl, op_t))
    assert hm.hankel_matmul.launches == before


@pytest.mark.parametrize("case", ["shape", "dtype", "half", "device"])
def test_hankel_matmul_rejects_bad_inputs(case):
    cl, op_t = torch.ones(4, 8, **KW), torch.ones(8, 3, **KW)
    bad, err = {
        "shape": ((cl, torch.ones(7, 3, **KW)), ValueError),
        "dtype": ((cl, op_t.float()), TypeError),
        "half": ((cl.half(), op_t.half()), TypeError),
        "device": ((cl.to("meta"), op_t.to("meta")), ValueError),
    }[case]
    with pytest.raises(err):
        hm.hankel_matmul(*bad)


def test_full_fp32_matmul_restores_the_setting():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with hm.full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_fused_engine_must_be_known():
    with pytest.raises(ValueError, match="engine"):
        correlation.wtheta_from_cl_fused(torch.ones(2, tp.GRID.n_ell, **KW),
                                         THETA, tp.GRID, engine="mxu")


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_correlation_functions_match_jax(name, ref):
    """wtheta, gamma_t, xi_plus, xi_minus and magnification_correlation
    (alpha 2.5) on the port's tables, against the JAX package's
    composition of the same function (its C_ell through
    ``wtheta_from_cl``, correlation.py:165-233) at the default bins."""
    port = tp.port_table_inputs()
    key, mu, pref = FUNCTIONS[name]
    win_a, win_b, table = {
        "cl.gg": (port.win_g, port.win_g, "power_gg"),
        "cl.kg": (port.win_g, port.win_k, "power_gg"),
        "cl.kk": (port.win_k, port.win_k, "linear")}[key]
    kw = dict(alpha_slope=2.5) if name.startswith("magnification") else {}
    got = getattr(correlation, name)(port.cosmo, win_a, win_b,
                                     port.tables[table], port.st, **kw)
    want = pref * np.asarray(jcorr.wtheta_from_cl(
        jnp.asarray(ref[key]), jcorr.theta_bins_deg(tp.GRID), tp.GRID, mu))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_write_ascii_matches_jax(tmp_path):
    theta = jcorr.theta_bins_deg(tp.GRID)
    w = np.linspace(1.0, 2.0, len(theta)) * 1e-3
    jcorr.write_ascii(tmp_path / "jax.txt", theta, w)
    correlation.write_ascii(tmp_path / "port.txt", _t(theta), _t(w))
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text())
