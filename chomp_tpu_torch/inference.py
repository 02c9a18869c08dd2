"""Inference on top of the pipelines: theory map, Gaussian likelihood,
Fisher matrix, MAP fit, HMC and chain diagnostics.

PyTorch counterpart of the gradient core of the JAX package's
``inference.py`` (``make_theory_fn``, ``GaussianLikelihood``,
``fisher_matrix``, ``map_fit``, ``hmc``, ``split_rhat``,
``effective_sample_size``).  A leading chain / cosmology axis takes the
place of ``vmap``: a parameter batch ``p`` is ``(n, n_par)``, the theory
map returns ``(n, n_data)`` and every likelihood method returns ``(n,)``.
Rows are independent, so the gradient of a summed objective is the
per-row gradient; that gives:

- :func:`jacobian`: reverse mode by replicas, in place of ``jax.jacfwd``:
  n_data copies of one parameter point and one backward pass of the
  diagonal sum give the whole (n_data, n_par) Jacobian (the kernels
  need no forward-mode rule);
- :func:`hmc`: one ``torch.autograd.grad`` of the summed objective per
  leapfrog step moves every chain.

Random numbers come from an explicit ``torch.Generator``, so chains are
held to the reference by their statistics, not their bits.  The rest of
the JAX module (Poisson and composite likelihoods, MOPED, the template
helpers, adaptive HMC, the ensemble sampler, ``external_loglike``) is
ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chomp_tpu_torch.parallel.sweep import broadcast_cosmo


def make_theory_fn(pipeline, cosmo0, cosmo_names=("omega_m0", "sigma_8"),
                   flat: bool = True, output=("w_theta", "gamma_t"),
                   nuisance0=None, nuisance_names=()):
    """(theory_fn, p0): ``theory_fn(p)`` maps a parameter batch ``p``
    (n, n_par) to the data vector (n, n_data), the ``output`` entries of
    ``pipeline(cosmo)`` concatenated in order (w(theta), then gamma_t by
    default; ``"vector"`` for the tomographic pipeline); ``p0`` (n_par,)
    is the fiducial vector, on ``cosmo0``'s device and in its dtype.

    ``cosmo0`` is a single cosmology (0-d fields); the named fields are
    replaced by the columns of ``p`` through :func:`broadcast_cosmo`,
    with omega_l0 = 1 - omega_m0 when ``flat`` and omega_m0 is sampled
    (and omega_l0 is not).  A ``p`` of another dtype is cast to the
    pipeline's, differentiably.

    ``nuisance0`` (e.g. ``sweep.default_nuisance``, fields without a
    batch axis) makes the map ``pipeline(cosmo, nuisance)``: the fields
    in ``nuisance_names`` follow the cosmology block in ``p`` and are
    replaced whole, a (k,) field taking k consecutive columns, each row
    of ``p`` its own nuisance point; the other fields stay at
    ``nuisance0``."""
    cosmo_names = tuple(cosmo_names)
    nuisance_names = tuple(nuisance_names)
    for name in cosmo_names:
        if not hasattr(cosmo0, name):
            raise AttributeError(f"CosmoParams has no field {name!r}")
    if nuisance_names and nuisance0 is None:
        raise ValueError("nuisance_names need nuisance0")
    output = (output,) if isinstance(output, str) else tuple(output)
    apply_flat = (flat and "omega_m0" in cosmo_names
                  and "omega_l0" not in cosmo_names)
    n_cos = len(cosmo_names)
    shapes = [tuple(getattr(nuisance0, n).shape) for n in nuisance_names]
    offs = np.concatenate([[0], np.cumsum([int(np.prod(sh))
                                           for sh in shapes])]).astype(int)

    def theory_fn(p):
        p = torch.atleast_2d(p)
        upd = {name: p[:, i] for i, name in enumerate(cosmo_names)}
        if apply_flat:
            upd["omega_l0"] = 1.0 - upd["omega_m0"]
        cosmo = broadcast_cosmo(cosmo0, **upd)
        if nuisance0 is None:
            out = pipeline(cosmo)
        else:
            nupd = {name: p[:, n_cos + offs[i]:n_cos + offs[i + 1]]
                    .reshape(p.shape[0], *shapes[i])
                    .to(getattr(nuisance0, name).dtype)
                    for i, name in enumerate(nuisance_names)}
            out = pipeline(cosmo, dataclasses.replace(nuisance0, **nupd))
        return torch.cat([out[key] for key in output], dim=-1)

    ref = cosmo0.omega_m0
    p0 = torch.cat([torch.stack([getattr(cosmo0, name).reshape(()).to(ref)
                                 for name in cosmo_names])]
                   + [getattr(nuisance0, name).reshape(-1).to(ref)
                      for name in nuisance_names])
    return theory_fn, p0


def jacobian(theory_fn, p, chunk: int | None = None):
    """d theory / d p by reverse mode over replicas: ``p`` (n_par,) gives
    (n_data, n_par), ``p`` (m, n_par) gives (m, n_data, n_par).  Replica
    r of point i is evaluated as its own row and differentiated through
    output r only (one backward pass of the diagonal sum); ``chunk``
    bounds the replica rows of one pass (default: all m n_data)."""
    single = p.dim() == 1
    p = torch.atleast_2d(p).detach()
    m, n_par = p.shape
    with torch.no_grad():
        n_data = theory_fn(p[:1]).shape[-1]
    rows = p.repeat_interleave(n_data, dim=0)               # (m n_data, n_par)
    which = torch.arange(n_data, device=p.device).repeat(m)
    step = rows.shape[0] if chunk is None else max(1, int(chunk))
    parts = []
    for lo in range(0, rows.shape[0], step):
        x = rows[lo:lo + step].clone().requires_grad_(True)
        out = theory_fn(x)
        sel = out.gather(1, which[lo:lo + step, None])
        (g,) = torch.autograd.grad(sel.sum(), x)
        parts.append(g)
    jac = torch.cat(parts).reshape(m, n_data, n_par)
    return jac[0] if single else jac


def _as64(v, device):
    return None if v is None else torch.as_tensor(
        np.asarray(v, dtype=np.float64) if not torch.is_tensor(v) else v,
        dtype=torch.float64, device=device)


class GaussianLikelihood:
    """-2 ln L = (t(p) - d)^T C^{-1} (t(p) - d) with a fixed covariance,
    optional Gaussian priors, a box and analytically marginalized linear
    templates: the JAX package's ``GaussianLikelihood``
    (inference.py:125-264) over a leading batch axis.

    The covariance is Cholesky-factored once, in float64, on the device
    of ``data`` (a tensor; numpy data stays on the CPU); every residual
    is solved in float64, whatever the theory's dtype.  ``prior_sigma``
    entries that are inf/NaN (or <= 0) leave that parameter unconstrained;
    outside ``lower``/``upper`` the negative log posterior gains 1e6 per
    violated bound.  ``templates`` (n_t, n_data) are marginalized in
    closed form (chi2_marg = r C^-1 r - b^T A^-1 b, b = T C^-1 r, A = T
    C^-1 T^T + diag(1/sigma_a^2)); ``template_sigma`` inf/NaN entries are
    the improper flat prior, and 0 raises."""

    def __init__(self, theory_fn, data, cov, prior_mean=None,
                 prior_sigma=None, lower=None, upper=None, templates=None,
                 template_sigma=None):
        self.theory_fn = theory_fn
        dev = data.device if torch.is_tensor(data) else torch.device("cpu")
        self.data = _as64(data, dev).reshape(-1)
        n = self.data.numel()
        cov = np.asarray(cov.cpu() if torch.is_tensor(cov) else cov,
                         dtype=np.float64)
        if cov.shape != (n, n):
            raise ValueError(f"cov shape {cov.shape} does not match data "
                             f"length {n}")
        chol = np.linalg.cholesky(cov)
        self._chol = _as64(chol, dev)
        self._yt = self._a_chol = None
        if templates is not None:
            t = np.atleast_2d(np.asarray(templates, dtype=np.float64))
            if t.shape[1] != n:
                raise ValueError(f"templates shape {t.shape} does not match "
                                 f"data length {n}")
            import scipy.linalg as sla

            yt = sla.solve_triangular(chol, t.T, lower=True)     # L^-1 T^T
            a = yt.T @ yt
            if template_sigma is not None:
                ts = np.asarray(template_sigma, dtype=float).reshape(-1)
                if ts.size != t.shape[0]:
                    raise ValueError("template_sigma length != n_t")
                if np.any(ts == 0.0):
                    raise ValueError(
                        "template_sigma == 0 pins a template to zero "
                        "amplitude: remove that template instead; only "
                        "inf/NaN entries mean the improper flat prior")
                a = a + np.diag(np.where(np.isfinite(ts), 1.0 / ts**2, 0.0))
            self._yt = _as64(yt, dev)
            self._a_chol = _as64(np.linalg.cholesky(a), dev)
        self.prior_mean = _as64(prior_mean, dev)
        self._prior_w = None
        if prior_sigma is not None:
            ps = np.asarray(prior_sigma, dtype=float)
            self._prior_w = _as64(np.where(np.isfinite(ps) & (ps > 0),
                                           1.0 / ps**2, 0.0), dev)
        self.lower = _as64(lower, dev)
        self.upper = _as64(upper, dev)

    def _whiten(self, x):
        """L^-1 x for x (..., n_data, k)."""
        return torch.linalg.solve_triangular(self._chol, x, upper=False)

    def chi2(self, p):
        """(n,) chi^2 of the parameter batch ``p`` (n, n_par)."""
        r = self.theory_fn(p).to(torch.float64) - self.data
        y = self._whiten(r.T).T                               # (n, n_data)
        out = (y * y).sum(-1)
        if self._yt is not None:
            b = y @ self._yt                                  # (n, n_t)
            z = torch.cholesky_solve(b.T, self._a_chol).T
            out = out - (b * z).sum(-1)
        return out

    def log_like(self, p):
        return -0.5 * self.chi2(p)

    def _penalty(self, p):
        p = torch.atleast_2d(p).to(torch.float64)
        u = torch.zeros(p.shape[0], dtype=torch.float64, device=p.device)
        if self._prior_w is not None:
            d = p - (self.prior_mean if self.prior_mean is not None else 0.0)
            u = u + 0.5 * (self._prior_w * d * d).sum(-1)
        if self.lower is not None:
            u = u + torch.where(p < self.lower, 1e6, 0.0).sum(-1)
        if self.upper is not None:
            u = u + torch.where(p > self.upper, 1e6, 0.0).sum(-1)
        return u

    def neg_log_post(self, p):
        """(n,) 0.5 chi^2 + prior + box penalty."""
        return 0.5 * self.chi2(p) + self._penalty(p)

    def fisher(self, p0):
        """Fisher matrix at ``p0`` (n_par,) with the prior curvature (the
        natural HMC mass matrix); with templates, the marginalized metric
        M = C^-1 - C^-1 T^T A^-1 T C^-1.  ``p0`` (m, n_par) gives (m,
        n_par, n_par).  The Jacobian is :func:`jacobian`."""
        jac = jacobian(self.theory_fn, p0).to(torch.float64)
        yj = self._whiten(jac)                         # (..., n_data, n_par)
        f = yj.transpose(-1, -2) @ yj
        if self._yt is not None:
            bj = self._yt.T @ yj                       # (..., n_t, n_par)
            zj = torch.cholesky_solve(bj, self._a_chol)
            f = f - bj.transpose(-1, -2) @ zj
        if self._prior_w is not None:
            f = f + torch.diag(self._prior_w)
        return f


def fisher_matrix(theory_fn, cov, p0):
    """F = J^T C^-1 J (float64) at ``p0`` (n_par,) or for each row of
    ``p0`` (m, n_par), with J from :func:`jacobian` and a Cholesky solve
    of the float64 covariance (no explicit inverse)."""
    jac = jacobian(theory_fn, p0).to(torch.float64)
    cov = torch.as_tensor(cov, dtype=torch.float64, device=jac.device)
    y = torch.linalg.solve_triangular(torch.linalg.cholesky(cov), jac,
                                      upper=False)
    return y.transpose(-1, -2) @ y


def map_fit(neg_log_post, p0, n_steps: int = 500, learning_rate=3e-3):
    """Maximum a posteriori with ``torch.optim.Adam`` on the summed
    objective of the batch ``p0`` (n, n_par) (or one point (n_par,)):
    Adam is elementwise, so each row follows its own trajectory.

    Returns (p_best, info): p_best is each row's lowest-objective iterate
    visited (Adam is not monotone), ``info["u"]`` the per-step objective
    (n_steps, n) (or (n_steps,)) and ``info["p_last"]`` the final
    iterate."""
    single = p0.dim() == 1
    p = torch.atleast_2d(p0).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=learning_rate)
    us, best = [], p.detach().clone()
    u_best = torch.full((p.shape[0],), float("inf"), dtype=torch.float64,
                        device=p.device)
    for _ in range(n_steps):
        opt.zero_grad()
        u = neg_log_post(p)
        u.sum().backward()
        u = u.detach().to(torch.float64)
        better = u < u_best
        best = torch.where(better[:, None], p.detach(), best)
        u_best = torch.where(better, u, u_best)
        us.append(u)
        opt.step()
    us = torch.stack(us)
    p_last = p.detach()
    if single:
        return best[0], {"u": us[:, 0], "p_last": p_last[0]}
    return best, {"u": us, "p_last": p_last}


def _value_and_grad(neg_log_post, q):
    q = q.detach().requires_grad_(True)
    u = neg_log_post(q)
    (g,) = torch.autograd.grad(u.sum(), q)
    return u.detach().to(torch.float64), g.to(q.dtype)


def hmc(neg_log_post, mass, p0, generator, n_steps: int = 200,
        n_leap: int = 5, eps: float = 0.6):
    """Fixed-mass-matrix Hamiltonian Monte Carlo over a batch of chains:
    momenta ~ N(0, ``mass``) (pass the Fisher matrix for a locally
    unit-condition chain; ``eps`` is then in preconditioned units),
    ``n_leap`` leapfrog steps and a Metropolis test per step.

    ``p0`` (n_chains, dim) or (dim,) for one chain.  Every chain moves at
    once: the gradient is ``torch.autograd.grad`` of the summed
    objective, which is per chain because the chains are independent
    (``neg_log_post`` maps (n, dim) to (n,)).  Each step costs n_leap + 1
    gradient evaluations (the gradient at the start point, one per
    leapfrog position; the objective at the end point comes with the
    last).  ``generator`` (a ``torch.Generator`` on the chains' device)
    draws the momenta and the uniforms.

    Returns (samples, accept): (n_chains, n_steps, dim) and (n_chains,
    n_steps) boolean, without the chain axis for a (dim,) ``p0``."""
    single = p0.dim() == 1
    q = torch.atleast_2d(p0).detach().clone()
    dev, dt = q.device, q.dtype
    mass = torch.as_tensor(mass, dtype=dt, device=dev)
    m_inv = torch.linalg.inv(mass)
    chol = torch.linalg.cholesky(mass)

    def kinetic(p):
        return 0.5 * ((p @ m_inv) * p).sum(-1).to(torch.float64)

    u_q, g_q = _value_and_grad(neg_log_post, q)
    qs, accs = [], []
    for _ in range(n_steps):
        z = torch.randn(q.shape, generator=generator, device=dev, dtype=dt)
        p = z @ chol.T
        q_new, p_new, g = q, p, g_q
        for _ in range(n_leap):
            p_new = p_new - 0.5 * eps * g
            q_new = q_new + eps * (p_new @ m_inv)
            u_new, g = _value_and_grad(neg_log_post, q_new)
            p_new = p_new - 0.5 * eps * g
        dh = u_new - u_q + kinetic(p_new) - kinetic(p)
        uni = torch.rand(q.shape[0], generator=generator, device=dev,
                         dtype=torch.float64)
        accept = uni < torch.exp(-dh)
        q = torch.where(accept[:, None], q_new, q)
        u_q = torch.where(accept, u_new, u_q)
        g_q = torch.where(accept[:, None], g, g_q)
        qs.append(q)
        accs.append(accept)
    samples = torch.stack(qs, dim=1)
    accept = torch.stack(accs, dim=1)
    return (samples[0], accept[0]) if single else (samples, accept)


def split_rhat(chains):
    """Split potential-scale-reduction diagnostic (BDA3 / Vehtari et al.
    2021 without rank normalization): each chain split in half, R-hat =
    sqrt(var_plus / W), var_plus = W (h-1)/h + B/h.  ``chains`` (n_chains,
    n_samples, dim), numpy or tensor -> (dim,) numpy; values <~ 1.01
    indicate convergence."""
    x = _np64(chains)
    m, n, dim = x.shape
    h = n // 2
    x = np.concatenate([x[:, :h], x[:, h:2 * h]], axis=0)     # (2m, h, d)
    w = x.var(axis=1, ddof=1).mean(axis=0)
    b = h * x.mean(axis=1).var(axis=0, ddof=1)
    return np.sqrt((w * (h - 1) / h + b / h) / w)


def effective_sample_size(chains):
    """Effective sample size per dimension: Stan's cross-chain
    autocovariance estimator with Geyer's initial-positive-sequence
    truncation.  ``chains`` (n_chains, n_samples, dim) -> (dim,) numpy."""
    x = _np64(chains)
    m, n, dim = x.shape
    cm = x.mean(axis=1, keepdims=True)
    npad = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x - cm, n=npad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=npad, axis=1)[:, :n].real / n
    within = acov[:, 0, :].mean(axis=0) * n / (n - 1.0)
    b_over_n = cm[:, 0, :].var(axis=0, ddof=1) if m > 1 else 0.0
    var_plus = within * (n - 1.0) / n + b_over_n
    rho = 1.0 - (within[None, :] - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    ess = np.empty(dim)
    for d in range(dim):
        # tau = -1 + 2 sum of the lag pairs (rho_2k + rho_2k+1), cut at the
        # first negative pair.
        tau, t = -1.0, 0
        while t + 1 < n:
            pair = rho[t, d] + rho[t + 1, d]
            if pair < 0.0:
                break
            tau += 2.0 * pair
            t += 2
        ess[d] = m * n / max(tau, 1e-12)
    return ess


def _np64(x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)
