"""chomp_tpu_torch.emulator against the JAX package (float64 CPU).

Mirrors tests/test_emulator.py:
- the Latin hypercube's strata;
- an emulator converted from a JAX ``Emulator`` (``utils.convert.
  emulator``) gives the JAX ``emu(p)`` and ``jax.jacfwd(emu)`` at 1e-12
  (the tanh GELU of ``jax.nn.gelu``), and the training's GELU-and-
  derivative autograd Function passes gradcheck;
- training on the JAX tests' analytic target reaches their gates: value
  training max_rel < 4e-2, rms < 5e-3 and a loss that falls by 1e4;
  Sobolev training a holdout Jacobian < 2e-2, max_rel < 5e-3 and Fisher
  entries within 5% of the exact target's.  The port trains with
  torch.optim.Adam one minibatch at a time, so these runs use smaller
  settings than the JAX test's 8000 Sobolev epochs of 4 minibatches of
  (128, 128): 512 nodes, (64, 64) and a 1e-2 rate for 750 epochs; 128
  nodes, (32, 32), full batch and a 5e-2 rate for 8000 epochs;
- the PCA basis, its rank with ``n_pca`` and with ``pca_tol``, and the
  Sobolev standardized, Jacobian-augmented basis equal the JAX package's
  on the same precomputed sweep;
- the save / load round trip (and a file of the JAX package's
  ``utils.io.save_pytree``), and the argument checks.

The JAX values (the converted emulator's outputs and Jacobians, and the
JAX ``train_emulator``'s scalings, basis and rank on each PCA case) are
computed from this file's inputs by ``tools/torch_slice_reference.py``
and read from ``tests/data/torch_emulator_reference.json``, so no test
here compiles a JAX program.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chomp_tpu_torch import emulator, inference
from chomp_tpu_torch.utils import convert, io
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)
BOUNDS = np.array([[-1.0, 1.0], [-1.0, 1.0]])
TAIL = ("x_mu", "x_sd", "y_mu", "basis", "c_sd")
PCA_CASES = [dict(n_pca=3), dict(pca_tol=0.05), dict(pca_tol=1e-10),
             dict(n_pca=None), dict(n_pca=3, jac_weight=1.0)]
REF_FILE = Path(__file__).parent / "data" / "torch_emulator_reference.json"


def reference():
    return json.loads(REF_FILE.read_text())


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def one_thread():
    """Training steps of these small MLPs are bound by per-operation
    overhead, which more CPU threads only raise: train on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def target(p):
    """The JAX tests' smooth map R^2 -> R^12, over rows of p."""
    t = torch.linspace(0.0, 1.0, 12, dtype=p.dtype)
    return (torch.sin(2.0 * p[:, :1] + 3.0 * t) * (1.0 + 0.5 * p[:, 1:2])
            + p[:, :1] * p[:, 1:2] * t * t)


def test_latin_hypercube_stratification():
    bounds = np.array([[0.0, 1.0], [-2.0, 4.0]])
    x = emulator.latin_hypercube(gen(0), 64, bounds)
    assert x.shape == (64, 2)
    for d in range(2):
        lo, hi = bounds[d]
        assert x[:, d].min() >= lo and x[:, d].max() <= hi
        strata = np.floor((x[:, d] - lo) / (hi - lo) * 64).astype(int)
        assert np.array_equal(np.sort(strata), np.arange(64))


def emulator_leaves(seed=0, sizes=(3, 16, 16, 5), n_out=9):
    """Seeded weights ((w, b), ...) and scalings of an emulator, numpy."""
    rng = np.random.default_rng(seed)
    weights = [(rng.normal(size=(a, b)) / np.sqrt(a), rng.normal(size=b) * 0.1)
               for a, b in zip(sizes[:-1], sizes[1:])]
    basis = np.linalg.qr(rng.normal(size=(n_out, sizes[-1])))[0].T
    return SimpleNamespace(weights=weights, x_mu=rng.normal(size=sizes[0]),
                           x_sd=rng.uniform(0.5, 2, sizes[0]),
                           y_mu=rng.normal(size=n_out), basis=basis,
                           c_sd=rng.uniform(0.5, 2, sizes[-1]))


def converted_points():
    return np.random.default_rng(1).normal(size=(6, 3)) * 2.0


def jax_emulator(seed=0):
    """The JAX package's Emulator of :func:`emulator_leaves`."""
    import jax.numpy as jnp

    from chomp_tpu import emulator as jemu

    src = emulator_leaves(seed)
    return jemu.Emulator(
        weights=tuple((jnp.asarray(w), jnp.asarray(b))
                      for w, b in src.weights),
        **{name: jnp.asarray(getattr(src, name)) for name in TAIL})


def test_converted_emulator_matches_jax():
    ref_ = reference()["converted"]
    emu = convert.emulator(emulator_leaves(), **KW)
    p = converted_points()
    np.testing.assert_array_equal(p, ref_["p"])
    ref = np.asarray(ref_["emu"])
    got = emu(torch.tensor(p, **KW)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    jref = np.asarray(ref_["jacfwd"])
    jgot = emu.jacobian(torch.tensor(p, **KW)).detach().numpy()
    np.testing.assert_allclose(jgot, jref, rtol=1e-12,
                               atol=1e-12 * np.abs(jref).max())
    # One point, and the autograd Jacobian of the module itself.
    np.testing.assert_allclose(emu(torch.tensor(p[0], **KW)).detach(),
                               ref[0], rtol=1e-12)
    jac = inference.jacobian(emu, torch.tensor(p[0], **KW))
    np.testing.assert_allclose(jac.numpy(), jref[0], rtol=1e-11,
                               atol=1e-12 * np.abs(jref).max())


def test_gelu_tangent_gradcheck():
    """The training's GELU and derivative: the values of torch's tanh
    GELU and of its derivative, and a backward that gradcheck accepts
    (the Sobolev loss differentiates the derivative)."""
    z = torch.tensor(np.random.default_rng(2).normal(size=(5, 7)) * 3.0,
                     **KW, requires_grad=True)
    h, g = emulator._GeluTangent.apply(z)
    np.testing.assert_allclose(
        h.detach(), torch.nn.functional.gelu(z, approximate="tanh").detach(),
        rtol=1e-14, atol=1e-15)
    ref = torch.autograd.grad(
        torch.nn.functional.gelu(z, approximate="tanh").sum(), z)[0]
    np.testing.assert_allclose(g.detach(), ref, rtol=1e-13, atol=1e-15)
    assert torch.autograd.gradcheck(emulator._GeluTangent.apply, (z,))


def test_emulator_accuracy_and_grad(one_thread):
    emu, rep = emulator.train_emulator(
        target, BOUNDS, gen(1), device="cpu", n_train=512, n_val=64,
        n_pca=None, hidden=(64, 64), n_epochs=750, batch_size=128,
        learning_rate=1e-2)
    assert rep.max_rel_err < 4e-2, (rep.max_err, rep.max_rel_err)
    assert rep.rms_err < 5e-3, rep.rms_err
    assert rep.loss[-1] < 1e-4 * rep.loss[0]
    assert rep.jac_max_rel_err is None and rep.n_pca == 12
    p = torch.tensor([[0.3, -0.4]], **KW)
    np.testing.assert_allclose(emu(p).detach().numpy(), target(p).numpy(),
                               atol=0.05)
    g = inference.jacobian(emu, p[0])
    ref = inference.jacobian(target, p[0])
    assert (g - ref).abs().max() < 0.5
    assert emu(torch.cat([p, 2 * p])).shape == (2, 12)


def test_sobolev_training_fixes_jacobian(one_thread):
    emu, rep = emulator.train_emulator(
        target, BOUNDS, gen(1), device="cpu", jac_weight=1.0, n_train=128,
        n_val=32, n_pca=None, hidden=(32, 32), n_epochs=8000,
        batch_size=128, learning_rate=5e-2)
    assert rep.jac_max_rel_err < 0.02, rep.jac_max_rel_err
    assert rep.max_rel_err < 5e-3, rep.max_rel_err
    p0 = torch.tensor([0.2, -0.3], **KW)
    d0 = target(p0[None])[0].numpy()
    cov = np.diag((0.05 * np.abs(d0) + 1e-3 * np.abs(d0).max()) ** 2)
    f_ex = inference.fisher_matrix(target, cov, p0).numpy()
    f_em = inference.fisher_matrix(emu, cov, p0).detach().numpy()
    assert np.abs(f_em - f_ex).max() / np.abs(f_ex).max() < 0.05


def sweep_data():
    """The JAX tests' pca_tol data: 3 strong modes and a weak 4th."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 20)
    modes = np.stack([np.sin(3 * t), np.cos(5 * t), t * t,
                      0.01 * np.sin(9 * t)])
    amps = rng.normal(size=(300, 4)) * np.array([1.0, 0.5, 0.25, 1.0])
    return rng.uniform(-1, 1, size=(300, 2)), amps @ modes + 2.0


def sweep_jacobians():
    return np.random.default_rng(5).normal(size=(300, 20, 2))


@pytest.mark.parametrize("kw", PCA_CASES)
def test_pca_basis_matches_jax(kw):
    """The same precomputed sweep gives the JAX package's scalings,
    basis and rank (training itself draws from another generator)."""
    jref = reference()["pca"][PCA_CASES.index(kw)]
    assert jref["kw"] == kw
    x, y = sweep_data()
    if "jac_weight" in kw:
        kw = dict(kw, j_train=sweep_jacobians())
    emu, rep = emulator.train_emulator(None, BOUNDS, gen(1), x_train=x,
                                       y_train=y, n_epochs=1, hidden=(8,),
                                       device="cpu",
                                       **kw)
    assert rep.n_pca == jref["n_pca"]
    assert (rep.n_train, rep.n_val) == (jref["n_train"], jref["n_val"])
    for name in TAIL:
        ref = np.asarray(jref[name])
        np.testing.assert_allclose(getattr(emu, name).numpy(), ref,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max(),
                                   err_msg=name)
    if kw.get("pca_tol") == 0.05:
        assert rep.n_pca <= 3
    if kw.get("pca_tol") == 1e-10:
        assert rep.n_pca >= 4


def test_precomputed_sweep_path(one_thread):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(200, 2))
    y = target(torch.tensor(x, **KW)).numpy()
    _, rep = emulator.train_emulator(
        None, BOUNDS, gen(4), device="cpu", x_train=x, y_train=y,
        n_pca=None, hidden=(48, 48), n_epochs=600, batch_size=64,
        learning_rate=5e-3)
    assert rep.n_train == 175 and rep.n_val == 25
    assert rep.max_rel_err < 0.25 and rep.rms_err < 0.03, rep


def test_save_load_roundtrip(tmp_path):
    emu, _ = emulator.train_emulator(
        target, BOUNDS, gen(5), device="cpu", n_train=64, n_val=8, n_pca=4,
        hidden=(16,), n_epochs=50, batch_size=32)
    p = torch.tensor([[0.2, 0.7]], **KW)
    f = tmp_path / "emu.npz"
    io.save_emulator(str(f), emu)
    back = io.load_emulator(str(f), **KW)
    assert torch.equal(back(p), emu(p))
    # A file of the JAX package's save_pytree, and the port's file read by
    # the JAX package's load_pytree: the same leaves, bit for bit.
    import jax

    from chomp_tpu.utils import io as jio

    jax_emu = jax_emulator(seed=2)
    jio.save_pytree(str(tmp_path / "jax.npz"), jax_emu)
    q = np.random.default_rng(0).normal(size=(3, 3))
    np.testing.assert_array_equal(
        io.load_emulator(str(tmp_path / "jax.npz"), **KW)(
            torch.tensor(q, **KW)).detach().numpy(),
        convert.emulator(jax_emu, **KW)(torch.tensor(q, **KW)).detach())
    io.save_emulator(str(tmp_path / "port.npz"),
                     convert.emulator(jax_emu, **KW))
    again = jio.load_pytree(str(tmp_path / "port.npz"), jax_emu)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jax_emu), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_argument_checks():
    x = np.zeros((8, 2))
    with pytest.raises(ValueError, match="BOTH x_train and y_train"):
        emulator.train_emulator(target, BOUNDS, gen(0), x_train=x)
    with pytest.raises(ValueError, match="BOTH x_train and y_train"):
        emulator.train_emulator(target, BOUNDS, gen(0),
                                y_train=np.zeros((8, 12)))
    with pytest.raises(ValueError, match="theory_fn=None"):
        emulator.train_emulator(None, BOUNDS, gen(0))
    with pytest.raises(ValueError, match="j_train"):
        emulator.train_emulator(None, BOUNDS, gen(0),
                                x_train=np.zeros((16, 2)),
                                y_train=np.zeros((16, 3)), jac_weight=1.0)
