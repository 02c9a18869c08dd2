"""The rest of chomp_tpu_torch.inference against the JAX package.

Mirrors tests/test_inference.py:231-693 on the port (float64 CPU, inputs
from numpy and a seed):

- ``PoissonLikelihood`` and ``CompositeLikelihood``: values and Fisher
  matrices against the JAX classes at 1e-12 on a nonlinear counts model,
  and the JAX tests' identities (zero score at the truth, the analytic
  Fisher, the large-count Gaussian limit, the MAP point, the sums);
- ``moped_compression``: its rows against the JAX rows at 1e-12,
  Cov(y) = I and the lossless Fisher;
- the template and scale-cut helpers against the JAX functions (exact
  arrays), the Woodbury identity, the brute-force marginal and the
  improper-prior invariance;
- ``adaptive_hmc`` and ``ensemble_sample`` by their statistics at the
  JAX tests' gates (R-hat, the mean within 5 sigma of its MC error, the
  covariance, the step-size and acceptance bands), and the two
  reference defects the port does not copy: a non-finite objective at
  p0 raises after ONE evaluation, and a non-finite start walker raises;
- ``external_loglike``'s contract (numpy in, float / numpy out, -inf for
  non-finite values, the vectorized shape in one call).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu import inference as jinf
from chomp_tpu_torch import inference
from torch_threads import capped_threads  # noqa: F401 (autouse)

F64 = torch.float64


def t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _toy(seed=0, n_data=7, n_par=3):
    """t(p) = A p + b: the JAX tests' toy model, for both packages."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_data, n_par))
    b = rng.normal(size=n_data)
    m = rng.normal(size=(n_data, n_data))
    cov = m @ m.T + n_data * np.eye(n_data)
    at, bt = t64(a), t64(b)
    return a, b, cov, (lambda p: p @ at.T + bt), (
        lambda p: jnp.asarray(a) @ p + jnp.asarray(b))


# -- Poisson and composite likelihoods ----------------------------------

T_COUNTS = np.array([40.0, 400.0, 4000.0, 120.0])
S_COUNTS = np.array([0.1, -0.3, 0.5, 1.2])


def lam_port(p):
    return p[:, :1] * t64(T_COUNTS) * torch.exp(p[:, 1:2] * t64(S_COUNTS))


def lam_jax(p):
    return p[0] * jnp.asarray(T_COUNTS) * jnp.exp(p[1] * jnp.asarray(
        S_COUNTS))


def poisson_pair(**kw):
    data = np.array([37.0, 410.0, 3950.0, 131.0])
    return (inference.PoissonLikelihood(lam_port, data, **kw, device="cpu"),
            jinf.PoissonLikelihood(lam_jax, data, **kw))


@pytest.mark.parametrize("kw", [{}, dict(prior_mean=[1.0, 0.0],
                                         prior_sigma=[0.5, np.inf],
                                         lower=[0.0, -1.0],
                                         upper=[2.0, 1.0])])
def test_poisson_likelihood_matches_jax(kw):
    port, ref = poisson_pair(**kw)
    ps = np.array([[1.1, 0.05], [0.9, -0.2], [2.5, 0.1]])
    got = port.neg_log_post(t64(ps)).numpy()
    want = [float(ref.neg_log_post(jnp.asarray(p))) for p in ps]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(port.log_like(t64(ps)).numpy(),
                               [float(ref.log_like(jnp.asarray(p)))
                                for p in ps], rtol=1e-12)
    np.testing.assert_allclose(port.fisher(t64(ps[0])).numpy(),
                               np.asarray(ref.fisher(jnp.asarray(ps[0]))),
                               rtol=1e-12)
    # A batch of points gives a batch of Fisher matrices.
    f = port.fisher(t64(ps[:2])).numpy()
    np.testing.assert_allclose(f[1], np.asarray(ref.fisher(jnp.asarray(
        ps[1]))), rtol=1e-12)


def test_poisson_likelihood_exact():
    """Zero score at the truth, the analytic Fisher of a linear model,
    the large-count Gaussian limit and the MAP point (the JAX test)."""
    t = t64([40.0, 400.0, 4000.0])

    def lam(p):
        return p[:, :1] * t

    data = lam(t64([[1.3]]))[0]
    like = inference.PoissonLikelihood(lam, data, device="cpu")
    p = t64([[1.3]]).requires_grad_(True)
    (g,) = torch.autograd.grad(like.neg_log_post(p).sum(), p)
    assert abs(g.item()) < 1e-9
    assert abs(like.fisher(t64([1.3]))[0, 0].item()
               - t.sum().item() / 1.3) < 1e-8
    glike = inference.GaussianLikelihood(lam, data, np.diag(data.numpy()),
                                         device="cpu")

    def hess(fn):
        return torch.autograd.functional.hessian(
            lambda q: fn(q[None, :]).sum(), t64([1.3]))[0, 0].item()

    assert abs(hess(like.neg_log_post) / hess(glike.neg_log_post) - 1) < 0.03
    p_fit, _ = inference.map_fit(like.neg_log_post, t64([0.9]), n_steps=400,
                                 learning_rate=3e-2)
    assert abs(p_fit[0].item() - 1.3) < 1e-3


def test_composite_likelihood_sums_and_matches_jax():
    tp_ = np.array([50.0, 500.0])

    def lam(p):
        return p[:, :1] * t64(tp_)

    def gvec(p):
        return torch.cat([2.0 * p[:, :1], 3.0 * p[:, :1]], dim=-1)

    data_p, data_g = tp_, np.array([2.0, 3.0])
    lp = inference.PoissonLikelihood(lam, data_p, device="cpu")
    lg = inference.GaussianLikelihood(gvec, data_g, np.eye(2) * 0.1,
                                      device="cpu")
    comp = inference.CompositeLikelihood([lp, lg])
    p = t64([[1.07], [0.93]])
    torch.testing.assert_close(comp.neg_log_post(p), lp.neg_log_post(p)
                               + lg.neg_log_post(p), rtol=0, atol=0)
    torch.testing.assert_close(comp.log_like(p), lp.log_like(p)
                               + lg.log_like(p), rtol=0, atol=0)
    torch.testing.assert_close(comp.fisher(t64([1.0])), lp.fisher(
        t64([1.0])) + lg.fisher(t64([1.0])), rtol=1e-12, atol=0)
    jcomp = jinf.CompositeLikelihood([
        jinf.PoissonLikelihood(lambda q: q[0] * jnp.asarray(tp_), data_p),
        jinf.GaussianLikelihood(lambda q: jnp.stack([2 * q[0], 3 * q[0]]),
                                data_g, np.eye(2) * 0.1)])
    np.testing.assert_allclose(comp.neg_log_post(p).numpy(), [
        float(jcomp.neg_log_post(jnp.asarray(q))) for q in p.numpy()],
        rtol=1e-12)
    np.testing.assert_allclose(comp.fisher(t64([1.0])).numpy(),
                               np.asarray(jcomp.fisher(jnp.asarray([1.0]))),
                               rtol=1e-12)
    q = t64([[1.0]]).requires_grad_(True)
    (g,) = torch.autograd.grad(comp.neg_log_post(q).sum(), q)
    assert abs(g.item()) < 1e-9
    with pytest.raises(ValueError, match=">= 1 block"):
        inference.CompositeLikelihood([])


# -- MOPED ---------------------------------------------------------------

def test_moped_lossless_fisher_and_jax_rows():
    rng = np.random.default_rng(3)
    n_d, n_p = 40, 3
    jac = rng.normal(size=(n_d, n_p))
    a = rng.normal(size=(n_d, n_d))
    cov = a @ a.T + n_d * np.eye(n_d)
    t0 = rng.normal(size=n_d)
    p0 = np.array([0.1, -0.2, 0.3])

    def theory(p):
        return t64(t0) + p @ t64(jac).T + 0.1 * (p @ t64(jac).T) ** 2

    b, compress = inference.moped_compression(theory, cov, t64(p0))
    jb, _ = jinf.moped_compression(
        lambda p: jnp.asarray(t0) + jnp.asarray(jac) @ p
        + 0.1 * (jnp.asarray(jac) @ p) ** 2, cov, jnp.asarray(p0))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jb)).max())
    np.testing.assert_allclose(b.numpy() @ cov @ b.numpy().T, np.eye(n_p),
                               atol=1e-10)
    f_full = inference.fisher_matrix(theory, cov, t64(p0)).numpy()
    f_comp = inference.fisher_matrix(lambda p: compress(theory(p)),
                                     np.eye(n_p), t64(p0)).numpy()
    np.testing.assert_allclose(f_comp, f_full, rtol=1e-10)
    # A data vector and a batch of them.
    v = theory(t64(p0)[None])
    np.testing.assert_allclose(compress(v[0]).numpy(),
                               compress(v.numpy())[0].numpy(), rtol=1e-15)


# -- templates and scale cuts -------------------------------------------

def test_template_marginalization_woodbury_identity():
    a, b, cov, theory, _ = _toy(seed=5)
    rng = np.random.default_rng(7)
    t = rng.normal(size=(2, b.size))
    sig = np.array([0.7, 2.3])
    data = b + rng.normal(size=b.size)
    lk_t = inference.GaussianLikelihood(theory, data, cov, templates=t,
                                        template_sigma=sig, device="cpu")
    cov_inf = inference.marginalized_covariance(cov, t, sig)
    np.testing.assert_allclose(cov_inf, jinf.marginalized_covariance(
        cov, t, sig), rtol=1e-15)
    lk_i = inference.GaussianLikelihood(theory, data, cov_inf, device="cpu")
    p = t64(np.random.default_rng(0).normal(size=(2, 3)))
    np.testing.assert_allclose(lk_t.chi2(p).numpy(), lk_i.chi2(p).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(lk_t.fisher(torch.zeros(3, dtype=F64)),
                               lk_i.fisher(torch.zeros(3, dtype=F64)),
                               rtol=1e-9)
    with pytest.raises(ValueError, match="sigmas length"):
        inference.marginalized_covariance(cov, t, [0.5, 0.5, 0.5])
    with pytest.raises(ValueError, match="finite sigmas"):
        inference.marginalized_covariance(cov, t, [0.5, np.inf])
    np.testing.assert_allclose(inference.marginalized_covariance(cov, t, 0.5),
                               inference.marginalized_covariance(
                                   cov, t, [0.5, 0.5]), rtol=1e-14)


def test_template_marginalization_brute_force():
    a, b, cov, theory, _ = _toy(seed=11, n_data=5)
    rng = np.random.default_rng(2)
    t = rng.normal(size=5)
    sig = 1.7
    data = b + 0.4 * t + rng.normal(size=5) * 0.2
    lk = inference.GaussianLikelihood(theory, data, cov,
                                      templates=t[None, :],
                                      template_sigma=[sig], device="cpu")
    cinv = np.linalg.inv(cov)

    def neg2ln_marg(p):
        r0 = theory(t64(p)[None])[0].numpy() - data
        al = np.linspace(-40, 40, 20001)
        chi2 = np.array([(r0 + x * t) @ cinv @ (r0 + x * t) + x * x / sig**2
                         for x in al])
        c0 = chi2.min()
        return c0 - 2.0 * np.log(np.trapezoid(np.exp(-(chi2 - c0) / 2), al))

    p1, p2 = np.array([0.1, -0.2, 0.5]), np.array([1.0, 0.3, -0.7])
    d = lk.chi2(t64([p1, p2])).numpy()
    np.testing.assert_allclose(d[1] - d[0], neg2ln_marg(p2) - neg2ln_marg(p1),
                               rtol=1e-6)


def test_template_improper_prior_invariance():
    a, b, cov, theory, _ = _toy(seed=9)
    t = a[:, 0]
    data = b + 0.25
    lk0 = inference.GaussianLikelihood(theory, data, cov,
                                       templates=t[None, :], device="cpu")
    lk1 = inference.GaussianLikelihood(theory, data + 17.3 * t, cov,
                                       templates=t[None, :], device="cpu")
    p = t64([[0.4, -1.0, 0.2]])
    np.testing.assert_allclose(lk0.chi2(p).numpy(), lk1.chi2(p).numpy(),
                               rtol=1e-8, atol=1e-8)
    f = lk0.fisher(p[0]).numpy()
    assert abs(f[0, 0]) < 1e-7 * abs(inference.fisher_matrix(
        theory, cov, p[0]).numpy()[0, 0])


@pytest.mark.parametrize("kw", [dict(), dict(cmb_lensing=True, n_counts=4),
                                dict(mode="lens",
                                     beta=np.arange(6.0).reshape(2, 3) + 1)])
def test_point_mass_templates_match_jax(kw):
    theta = np.array([0.5, 1.0, 2.0])
    got = inference.point_mass_templates(2, 3, theta, **kw)
    np.testing.assert_array_equal(got, jinf.point_mass_templates(
        2, 3, theta, **kw))
    from chomp_tpu.covariance import tomographic_probes

    assert inference._probe_names(2, 3, True) == [
        q[0] for q in tomographic_probes(2, 3, cmb_lensing=True)]
    with pytest.raises(ValueError, match="mode"):
        inference.point_mass_templates(2, 3, theta, mode="both")
    with pytest.raises(ValueError, match="needs beta"):
        inference.point_mass_templates(2, 3, theta, mode="lens")


def test_theta_cut_mask_and_apply_match_jax():
    n_lens, n_src = 1, 2
    theta = np.array([0.3, 1.0, 3.0, 9.0])
    cuts = {"w": (0.5, np.inf), "gt": (0.9, 5.0), "xim_01": (2.5, np.inf),
            "xip": (0.0, np.inf), "xim": (0.0, np.inf)}
    keep = inference.theta_cut_mask(n_lens, n_src, theta, cuts, n_counts=2)
    np.testing.assert_array_equal(keep, jinf.theta_cut_mask(
        n_lens, n_src, theta, cuts, n_counts=2))
    keep = keep[:-2]
    names = inference._probe_names(n_lens, n_src)
    nb = theta.size
    rng = np.random.default_rng(0)
    n_d = len(names) * nb
    jac = rng.normal(size=(n_d, 2))
    t0 = rng.normal(size=n_d)

    def theory(p):
        return t64(t0) + p @ t64(jac).T

    m = rng.normal(size=(n_d, n_d))
    cov = m @ m.T + n_d * np.eye(n_d)
    data = t0 + rng.normal(size=n_d)
    tpl = inference.point_mass_templates(n_lens, n_src, theta)
    dead = np.zeros((1, n_d))
    dead[0, names.index("w_0") * nb] = 1.0          # cut away: dropped
    fn2, d2, c2, t2 = inference.apply_scale_cuts(
        keep, theory, data, cov, templates=np.vstack([tpl, dead]))
    assert t2.shape[0] == tpl.shape[0]
    lk_cut = inference.GaussianLikelihood(fn2, d2, c2, templates=t2,
                                          device="cpu")
    kk = np.nonzero(keep)[0]
    manual = inference.GaussianLikelihood(
        lambda p: theory(p)[:, kk], data[keep], cov[np.ix_(keep, keep)],
        templates=tpl[:, keep], device="cpu")
    p = t64([[0.3, -0.8], [0.1, 0.2]])
    np.testing.assert_allclose(lk_cut.chi2(p).numpy(), manual.chi2(p).numpy(),
                               rtol=1e-12)
    # template_sigma stays aligned with the surviving templates.
    t = np.zeros((2, n_d))
    t[0, names.index("w_0") * nb] = 1.0
    t[1, -1] = 1.0
    fn3, d3, c3, t3, s3 = inference.apply_scale_cuts(
        keep, theory, data, cov, templates=t, template_sigma=[0.7, 1.9])
    assert t3.shape == (1, keep.sum()) and list(s3) == [1.9]
    inference.GaussianLikelihood(fn3, d3, c3, templates=t3,
                                 template_sigma=s3, device="cpu")
    with pytest.raises(ValueError, match="without templates"):
        inference.apply_scale_cuts(keep, theory, data, cov,
                                   template_sigma=[0.7])
    with pytest.raises(ValueError, match="mask length"):
        inference.apply_scale_cuts(keep[:-1], theory, data, cov)


# -- samplers ------------------------------------------------------------

def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_adaptive_hmc_gaussian_recovery():
    cov = np.array([[1.0, 0.85, 0.0], [0.85, 1.0, 0.3], [0.0, 0.3, 2.0]])
    prec = t64(np.linalg.inv(cov))
    mean = t64([1.0, -2.0, 0.5])

    def nlp(p):
        d = p - mean
        return 0.5 * ((d @ prec) * d).sum(-1)

    out = inference.adaptive_hmc(nlp, torch.zeros(3, dtype=F64), gen(0),
                                 n_warmup=400, n_samples=800, n_chains=4,
                                 n_leap=12, dense_mass=True)
    assert out["samples"].shape == (4, 800, 3)
    assert out["warmup_accept"].shape == (400, 4)
    s = out["samples"].numpy().reshape(-1, 3)
    assert np.all(inference.split_rhat(out["samples"]) < 1.02)
    ess = inference.effective_sample_size(out["samples"])
    se = np.sqrt(np.diag(cov) / ess)
    assert np.all(np.abs(s.mean(0) - mean.numpy()) < 5.0 * se)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)
    assert 0.05 < out["step_size"] < 5.0
    assert 0.6 < float(out["accept"].mean()) < 0.99
    mass_cov = np.linalg.inv(out["mass"])
    rho = mass_cov[0, 1] / np.sqrt(mass_cov[0, 0] * mass_cov[1, 1])
    assert abs(rho - 0.85) < 0.25


def test_adaptive_hmc_diag_mass_scaling():
    var = t64([1.0, 100.0])

    def nlp(p):
        return 0.5 * (p * p / var).sum(-1)

    out = inference.adaptive_hmc(nlp, torch.zeros(2, dtype=F64), gen(3),
                                 n_warmup=500, n_samples=600, n_chains=4,
                                 n_leap=12)
    md = out["mass_diag"]
    assert 0.3 < (md[0] / md[1]) / 100.0 < 3.0, md
    s = out["samples"].numpy().reshape(-1, 2)
    np.testing.assert_allclose(s.var(axis=0), var.numpy(), rtol=0.3)


def test_adaptive_hmc_nonfinite_starts():
    """Chains whose jittered start is outside a barrier restart at p0
    with a warning and every chain moves; a non-finite objective at p0
    raises after one evaluation, before any sweep (the reference runs
    the whole chain first)."""
    calls = []

    def nlp(p):
        calls.append(p.shape[0])
        return torch.where(p[:, 0] > -0.1, 0.5 * (p * p).sum(-1),
                           torch.full_like(p[:, 0], float("inf")))

    with pytest.warns(UserWarning, match="re-initialized at p0"):
        out = inference.adaptive_hmc(nlp, torch.zeros(2, dtype=F64), gen(3),
                                     n_warmup=100, n_samples=100,
                                     n_chains=8, n_leap=8, init_jitter=0.5)
    per_chain_var = out["samples"].numpy().var(axis=1).sum(axis=1)
    assert np.all(per_chain_var > 1e-4), per_chain_var
    calls.clear()
    with pytest.raises(ValueError, match="non-finite"):
        inference.adaptive_hmc(nlp, t64([-5.0, 0.0]), gen(0), n_warmup=10,
                               n_samples=10, n_chains=2)
    assert calls == [1]


def test_external_loglike_contract():
    cov = np.diag([0.5, 2.0])
    like = inference.GaussianLikelihood(lambda p: p,
                                        torch.zeros(2, dtype=F64), cov,
                                        device="cpu")
    lp = inference.external_loglike(like)
    p = np.array([0.3, -0.4])
    expect = -0.5 * float(p @ np.linalg.inv(cov) @ p)
    assert isinstance(lp(p), float)
    np.testing.assert_allclose(lp(p), expect, rtol=1e-12)

    def nlp(q):
        return torch.where(q[:, 0] > 0, 0.5 * (q * q).sum(-1),
                           torch.full_like(q[:, 0], float("nan")))

    lp2 = inference.external_loglike(nlp)
    assert lp2(np.array([-1.0, 0.0])) == -np.inf
    np.testing.assert_allclose(lp2(np.array([1.0, 0.0])), -0.5)
    calls = []

    def counted(q):
        calls.append(q.shape)
        return like.neg_log_post(q)

    lpv = inference.external_loglike(counted, vectorized=True)
    out = lpv(np.array([[0.3, -0.4], [0.0, 0.0], [1.0, 1.0]]))
    assert out.shape == (3,) and calls == [(3, 2)]
    np.testing.assert_allclose(out[0], expect, rtol=1e-12)
    np.testing.assert_allclose(out[1], 0.0, atol=1e-12)
    assert inference.external_loglike(nlp, vectorized=True)(
        np.array([[-1.0, 0.0], [1.0, 0.0]]))[0] == -np.inf


def test_ensemble_sample_gaussian():
    cov = np.array([[1.0, 0.6], [0.6, 1.0]])
    prec = np.linalg.inv(cov)

    def log_prob(p):
        return float(-0.5 * p @ prec @ p)

    p0 = 0.1 * np.random.default_rng(0).normal(size=(12, 2))
    chain, acc = inference.ensemble_sample(log_prob, p0, 1500, seed=1)
    assert chain.shape == (1500, 12, 2)
    assert 0.2 < acc < 0.9, acc
    flat = chain[500:].reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.25)
    # The batch form takes the same moves (one call per half-ensemble).
    chain_v, acc_v = inference.ensemble_sample(
        lambda ps: -0.5 * np.einsum("ni,ij,nj->n", ps, prec, ps), p0, 50,
        seed=1, vectorized=True)
    np.testing.assert_allclose(chain_v, chain[:50], rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="walkers"):
        inference.ensemble_sample(log_prob, p0[:3], 10)


def test_ensemble_sample_refuses_a_nonfinite_start():
    """The reference leaves a walker whose start is -inf frozen; the port
    refuses the start ensemble instead."""
    def log_prob(p):
        return -np.inf if p[0] < 0 else float(-0.5 * p @ p)

    p0 = np.abs(np.random.default_rng(0).normal(size=(8, 2)))
    p0[3, 0] = -1.0
    with pytest.raises(ValueError, match="non-finite log_prob"):
        inference.ensemble_sample(log_prob, p0, 10)
    p0[3, 0] = 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        chain, _ = inference.ensemble_sample(log_prob, p0, 200, seed=2)
    assert np.all(chain[:, :, 0] >= 0.0)
    assert np.all(chain[-1] != chain[0])

