"""chomp_tpu_torch.inference against the algebra and the JAX package.

Mirrors tests/test_inference.py: closed-form identities on a linear
Gaussian toy model (chi^2, the Fisher matrix, the MAP point), HMC moments
on a correlated Gaussian and the multi-chain shapes, with inputs from
numpy and a seed (the port's chains draw from a torch.Generator, so they
are held to statistics, not to the JAX chains' bits); the diagnostics
against the JAX package's own functions on the same chains; and
make_theory_fn on the tiny-grid lattice pipeline against the pipeline
and the committed JAX Jacobian (tests/data/torch_grad_reference.json).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chomp_tpu import default_halo
from chomp_tpu import inference as jinf
from chomp_tpu.hod import default_hod
from chomp_tpu_torch import inference
from chomp_tpu_torch.parallel import sweep
from chomp_tpu_torch.utils import convert
from tests import torch_parity as tp
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)


def _toy(seed=0, n_data=7, n_par=3):
    """t(p) = A p + b over rows of p, with a well-conditioned covariance."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_data, n_par))
    b = rng.normal(size=n_data)
    m = rng.normal(size=(n_data, n_data))
    cov = m @ m.T + n_data * np.eye(n_data)
    at, bt = torch.tensor(a), torch.tensor(b)

    def theory(p):
        return torch.atleast_2d(p) @ at.T + bt

    return a, b, cov, theory


def test_gaussian_likelihood_chi2_exact():
    """chi2 through the Cholesky solve equals r C^-1 r by direct algebra,
    row by row of a batch; log_like = -chi2/2."""
    a, b, cov, theory = _toy()
    data = b + 0.3
    like = inference.GaussianLikelihood(theory, data, cov, device="cpu")
    p = torch.tensor([[0.2, -0.5, 1.1], [0.0, 0.3, -0.7]], **KW)
    r = theory(p).numpy() - data
    expect = np.einsum("ni,ni->n", r, np.linalg.solve(cov, r.T).T)
    np.testing.assert_allclose(like.chi2(p).numpy(), expect, rtol=1e-12)
    np.testing.assert_allclose(like.log_like(p).numpy(), -0.5 * expect,
                               rtol=1e-12)


def test_fisher_matrix_linear_exact():
    """For a linear model the Fisher matrix is exactly A^T C^-1 A, through
    fisher_matrix (Jacobian by replicas) and through GaussianLikelihood's
    prior-curvature path; the Jacobian itself is A."""
    a, b, cov, theory = _toy(seed=1)
    p0 = torch.zeros(a.shape[1], **KW)
    np.testing.assert_allclose(inference.jacobian(theory, p0).numpy(), a,
                               rtol=1e-14)
    expect = a.T @ np.linalg.solve(cov, a)
    got = inference.fisher_matrix(theory, cov, p0).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-10)
    sig = np.array([0.5, np.inf, 2.0])
    like = inference.GaussianLikelihood(theory, b, cov, prior_sigma=sig,
                                        device="cpu")
    np.testing.assert_allclose(
        like.fisher(p0).numpy(), expect + np.diag([1 / 0.25, 0.0, 1 / 4.0]),
        rtol=1e-10)
    batch = like.fisher(torch.stack([p0, p0 + 1.0]))
    assert batch.shape == (2, 3, 3)
    np.testing.assert_allclose(batch[1].numpy(), batch[0].numpy(),
                               rtol=1e-12)


def test_neg_log_post_priors_and_box():
    """A Gaussian prior adds 0.5 ((p - mu)/sigma)^2 and the box 1e6 per
    violated bound; both leave the chi2 term untouched."""
    a, b, cov, theory = _toy(seed=2)
    like = inference.GaussianLikelihood(
        theory, b, cov, prior_mean=[0.1, 0.0, 0.0],
        prior_sigma=[0.2, np.inf, np.inf],
        lower=[-1.0, -1.0, -1.0], upper=[1.0, 1.0, 1.0], device="cpu")
    p = torch.tensor([[0.3, 0.0, 0.0], [0.3, -1.5, 2.0]], **KW)
    u = like.neg_log_post(p).numpy()
    chi2 = like.chi2(p).numpy()
    np.testing.assert_allclose(u[0], 0.5 * chi2[0] + 0.5 * (0.2 / 0.2) ** 2,
                               rtol=1e-12)
    np.testing.assert_allclose(u[1] - 0.5 * chi2[1] - 0.5, 2e6, rtol=1e-12)


def test_templates_marginalize_like_the_inflated_covariance():
    """Finite template priors equal the explicitly inflated covariance C +
    T^T diag(sigma^2) T up to the constant; an improper (inf) prior
    removes the template direction from the Fisher matrix."""
    a, b, cov, theory = _toy(seed=3)
    rng = np.random.default_rng(11)
    t = rng.normal(size=(2, 7))
    sig = np.array([0.7, 1.3])
    like = inference.GaussianLikelihood(theory, b, cov, templates=t,
                                        template_sigma=sig, device="cpu")
    inflated = inference.GaussianLikelihood(theory, b,
                                            cov + (t.T * sig**2) @ t,
                                            device="cpu")
    p = torch.tensor([[0.2, -0.1, 0.4], [1.0, 0.5, -0.3]], **KW)
    np.testing.assert_allclose(like.chi2(p).numpy(),
                               inflated.chi2(p).numpy(), rtol=1e-10)
    flat = inference.GaussianLikelihood(theory, b, cov, templates=[a[:, 0]],
                                        template_sigma=[np.inf], device="cpu")
    f = flat.fisher(torch.zeros(3, **KW)).numpy()
    np.testing.assert_allclose(f[0], 0.0, atol=1e-10)
    with pytest.raises(ValueError):
        inference.GaussianLikelihood(theory, b, cov, templates=t,
                                     template_sigma=[0.0, 1.0], device="cpu")


def test_map_fit_recovers_gls():
    """MAP of the linear Gaussian likelihood is generalized least squares;
    the objective falls."""
    a, b, cov, theory = _toy(seed=3)
    p_true = np.random.default_rng(7).normal(size=a.shape[1])
    data = theory(torch.tensor(p_true))[0].numpy()
    like = inference.GaussianLikelihood(theory, data, cov, device="cpu")
    p_best, info = inference.map_fit(like.neg_log_post,
                                     torch.zeros(a.shape[1], **KW),
                                     n_steps=1500, learning_rate=0.05)
    np.testing.assert_allclose(p_best.numpy(), p_true, atol=2e-3)
    assert info["u"].shape == (1500,)
    assert float(info["u"][-1]) < float(info["u"][0])


def _gaussian_target():
    cov = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.5]])
    prec = torch.tensor(np.linalg.inv(cov))
    mu = torch.tensor([1.0, -2.0, 0.5], **KW)

    def u(p):
        d = p - mu
        return 0.5 * ((d @ prec) * d).sum(-1)

    return cov, prec, mu, u


def test_hmc_gaussian_moments():
    """HMC on a correlated 3-D Gaussian, 64 chains x 300 steps: healthy
    acceptance, and the pooled mean and covariance match the target
    within the reference test's bands (0.25, 0.35 max|cov|)."""
    cov, prec, mu, u = _gaussian_target()
    gen = torch.Generator().manual_seed(0)
    p0 = torch.zeros(64, 3, **KW)
    qs, acc = inference.hmc(u, prec, p0, gen, n_steps=300, n_leap=6,
                            eps=0.7)
    qs = qs[:, 50:].reshape(-1, 3).numpy()
    assert float(acc.double().mean()) > 0.6
    np.testing.assert_allclose(qs.mean(axis=0), mu.numpy(), atol=0.25)
    np.testing.assert_allclose(np.cov(qs.T), cov, atol=0.35 * cov.max())


def test_hmc_multichain_shapes():
    """(n_chains, dim) starts give per-chain samples and acceptances, and
    each chain explores; a (dim,) start gives one chain."""
    u = lambda p: 0.5 * (p * p).sum(-1)
    gen = torch.Generator().manual_seed(1)
    p0 = torch.tensor([[0.0, 0.0], [2.0, -2.0], [-1.0, 1.0]], **KW)
    qs, acc = inference.hmc(u, torch.eye(2, **KW), p0, gen, n_steps=200,
                            n_leap=4, eps=0.8)
    assert qs.shape == (3, 200, 2) and acc.shape == (3, 200)
    assert acc.dtype == torch.bool
    assert float(acc.double().mean()) > 0.6
    assert np.all(qs.std(dim=1).numpy() > 0.3)
    q1, a1 = inference.hmc(u, torch.eye(2, **KW), p0[1], gen, n_steps=5,
                           n_leap=2, eps=0.5)
    assert q1.shape == (5, 2) and a1.shape == (5,)


@pytest.mark.parametrize("fn", ["split_rhat", "effective_sample_size"])
def test_diagnostics_match_jax_package(fn):
    """split_rhat and effective_sample_size against the JAX package's
    numpy functions on the same AR(1) chains (one chain offset, so R-hat
    is above 1): rtol 1e-12."""
    rng = np.random.default_rng(9)
    x = np.zeros((4, 400, 3))
    e = rng.normal(size=x.shape)
    for t in range(1, 400):
        x[:, t] = 0.8 * x[:, t - 1] + e[:, t]
    x[0] += 0.5
    got = getattr(inference, fn)(torch.tensor(x))
    np.testing.assert_allclose(got, getattr(jinf, fn)(x), rtol=1e-12)


@pytest.fixture(scope="module")
def lattice_pipe():
    return sweep.make_pipeline(
        convert.halo_params(default_halo(), **KW),
        convert.hod_zheng(default_hod(), **KW),
        convert.dndz_gaussian(tp.jax_dist(), **KW), power_spec="power_gg",
        grid=tp.GRID, include_lensing=True, z_pivot=tp.Z_PIVOT, **KW)


def test_make_theory_fn_on_the_lattice_pipeline(lattice_pipe):
    """At the parity batch's fiducial cosmology (index 1): p0 is the
    fiducial vector, theory_fn(p0) is the pipeline's (w, gamma_t) bit for
    bit, flatness is applied, and the Jacobian through jacobian()
    matches the JAX package's jacfwd within 1e-8 of each column's peak."""
    batch = convert.cosmo_batch(tp.jax_batch(), **KW)
    cosmo0 = dataclasses.replace(batch, **{
        f: v[1] for f, v in batch.fields().items()})
    fn, p0 = inference.make_theory_fn(lattice_pipe, cosmo0)
    np.testing.assert_array_equal(p0.numpy(), [0.278, 0.811])
    with torch.no_grad():
        got = fn(p0)
        out = lattice_pipe(batch.rows(1, 2))
        p1 = p0 + torch.tensor([0.01, 0.0], **KW)
        shifted = fn(p1)
        want = lattice_pipe(dataclasses.replace(
            batch.rows(1, 2), omega_m0=p1[:1], omega_l0=1.0 - p1[:1]))
    assert got.shape == (1, 2 * tp.GRID.n_theta)
    assert torch.equal(got, torch.cat([out["w_theta"], out["gamma_t"]], -1))
    assert torch.equal(shifted, torch.cat([want["w_theta"],
                                           want["gamma_t"]], -1))
    ref = json.loads((Path(__file__).parent / "data"
                      / "torch_grad_reference.json").read_text())
    jac = inference.jacobian(fn, p0, chunk=8).numpy()
    want = np.asarray(ref["tiny_grid"]["fft"]["jacobian"][1])
    assert float(np.max(np.max(np.abs(jac - want), axis=0)
                        / np.max(np.abs(want), axis=0))) < 1e-8


def test_make_theory_fn_refuses_nuisance_and_unknown_fields(lattice_pipe):
    """Nuisance slots without a fiducial nuisance point raise, and so do
    unknown cosmology and nuisance field names (the slots themselves are
    held in tests/test_torch_tomographic.py)."""
    cosmo0 = convert.cosmo_params(tp.jax_batch(), **KW)
    with pytest.raises(ValueError, match="nuisance0"):
        inference.make_theory_fn(lattice_pipe, cosmo0, nuisance_names=("m",))
    with pytest.raises(AttributeError):
        inference.make_theory_fn(
            lattice_pipe, cosmo0, nuisance0=sweep.default_nuisance(1, 1, **KW),
            nuisance_names=("dz_x",))
    with pytest.raises(AttributeError):
        inference.make_theory_fn(lattice_pipe, cosmo0,
                                 cosmo_names=("omega_x",))


def test_likelihood_device():
    """numpy data lands on the package's default device, the card, unless
    ``device=`` names another; tensor data keeps its device (a different
    ``device=`` raises)."""
    from chomp_tpu_torch import inference

    assert inference._data_device(np.zeros(3), None) == torch.device("cuda")
    assert inference._data_device(np.zeros(3), "cpu") == torch.device("cpu")
    t = torch.zeros(3, dtype=torch.float64)
    assert inference._data_device(t, None) == t.device
    like = inference.PoissonLikelihood(lambda p: p, np.ones(2),
                                       device="cpu")
    assert like.data.device == torch.device("cpu")
    with pytest.raises(ValueError, match="device"):
        inference.GaussianLikelihood(lambda p: p, t, np.eye(3),
                                     device="meta")


@pytest.mark.cuda
def test_likelihood_device_cuda():
    """Tensor data on the card is accepted with device="cuda" as with
    "cuda:0" (the current card), and kept there."""
    from chomp_tpu_torch import inference

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the data must lie on the card")
    t = torch.zeros(3, dtype=torch.float64, device="cuda:0")
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        like = inference.GaussianLikelihood(lambda p: p, t, np.eye(3),
                                            device=dev)
        assert like.data.device == t.device
        assert like._chol.device == t.device
