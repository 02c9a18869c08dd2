"""Inference on top of the pipelines: theory map, likelihoods, Fisher
matrix, MOPED, templates and scale cuts, MAP fit, HMC (fixed and
self-tuning), the external-sampler bridge and chain diagnostics.

PyTorch counterpart of the JAX package's ``inference.py``.  A leading
chain / cosmology axis takes the place of ``vmap``: a parameter batch
``p`` is ``(n, n_par)``, the theory map returns ``(n, n_data)`` and every
likelihood method returns ``(n,)``.  Rows are independent, so the
gradient of a summed objective is the per-row gradient; that gives:

- :func:`jacobian`: reverse mode by replicas, in place of ``jax.jacfwd``:
  n_data copies of one parameter point and one backward pass of the
  diagonal sum give the whole (n_data, n_par) Jacobian (the kernels
  need no forward-mode rule);
- :func:`hmc` and :func:`adaptive_hmc`: one ``torch.autograd.grad`` of
  the summed objective per leapfrog step moves every chain.

Random numbers come from an explicit ``torch.Generator`` (a numpy seed
for the host-side :func:`ensemble_sample`), so chains are held to the
reference by their statistics, not their bits.  Two documented defects
of the reference are not copied: :func:`adaptive_hmc` evaluates the
objective at ``p0`` and raises before any sweep, and
:func:`ensemble_sample` refuses a start ensemble with a non-finite
walker instead of freezing it.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

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


def _same_device(a, b) -> bool:
    """Whether devices ``a`` and ``b`` are one: "cuda" without an index is
    the current card, so it equals "cuda:0" where that is current."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False

    def index(d):
        if d.index is None and d.type == "cuda":
            return torch.cuda.current_device()
        return d.index

    return index(a) == index(b)


def _data_device(data, device):
    """The device of a likelihood's tensors: that of tensor ``data``,
    else ``device``, else the package's default, the card (as
    :class:`grids.Statics`)."""
    if torch.is_tensor(data):
        if device is not None and not _same_device(device, data.device):
            raise ValueError(f"data is on {data.device}, device={device!r}: "
                             f"move the data or drop device=")
        return data.device
    return torch.device("cuda" if device is None else device)


def _as64(v, device):
    return None if v is None else torch.as_tensor(
        np.asarray(v, dtype=np.float64) if not torch.is_tensor(v) else v,
        dtype=torch.float64, device=device)


class _PriorBox:
    """Gaussian priors and a box on the parameters: ``prior_sigma``
    entries that are inf/NaN (or <= 0) leave that parameter
    unconstrained; outside ``lower``/``upper`` the negative log posterior
    gains 1e6 per violated bound."""

    def _set_prior(self, dev, prior_mean, prior_sigma, lower, upper):
        self.prior_mean = _as64(prior_mean, dev)
        self._prior_w = None
        if prior_sigma is not None:
            ps = np.asarray(prior_sigma, dtype=float)
            self._prior_w = _as64(np.where(np.isfinite(ps) & (ps > 0),
                                           1.0 / ps**2, 0.0), dev)
        self.lower = _as64(lower, dev)
        self.upper = _as64(upper, dev)

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



class GaussianLikelihood(_PriorBox):
    """-2 ln L = (t(p) - d)^T C^{-1} (t(p) - d) with a fixed covariance,
    optional Gaussian priors, a box and analytically marginalized linear
    templates: the JAX package's ``GaussianLikelihood``
    (inference.py:125-264) over a leading batch axis.

    The covariance is Cholesky-factored once, in float64, on the device
    of ``data`` (a tensor), or of ``device`` for numpy data (default: the
    card, as every entry point; CPU callers pass ``device="cpu"``); every
    residual is solved in float64, whatever the theory's dtype.
    ``prior_sigma`` entries that are inf/NaN (or <= 0) leave that parameter unconstrained;
    outside ``lower``/``upper`` the negative log posterior gains 1e6 per
    violated bound.  ``templates`` (n_t, n_data) are marginalized in
    closed form (chi2_marg = r C^-1 r - b^T A^-1 b, b = T C^-1 r, A = T
    C^-1 T^T + diag(1/sigma_a^2)); ``template_sigma`` inf/NaN entries are
    the improper flat prior, and 0 raises."""

    def __init__(self, theory_fn, data, cov, prior_mean=None,
                 prior_sigma=None, lower=None, upper=None, templates=None,
                 template_sigma=None, *, device=None):
        self.theory_fn = theory_fn
        dev = _data_device(data, device)
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
        self._set_prior(dev, prior_mean, prior_sigma, lower, upper)

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


class PoissonLikelihood(_PriorBox):
    """-ln L = sum [lambda(p) - N ln lambda(p)] (+ a data-only constant)
    for counts data, with the Gaussian priors and box of
    :class:`GaussianLikelihood`: the JAX package's ``PoissonLikelihood``
    over a leading batch axis.  ``theory_fn(p)`` gives the expected
    counts (n, n_data); a 1e-300 floor keeps the log finite.  Its tensors
    live on the device of tensor ``data``, or of ``device`` for numpy data
    (default: the card)."""

    def __init__(self, theory_fn, data, prior_mean=None, prior_sigma=None,
                 lower=None, upper=None, *, device=None):
        self.theory_fn = theory_fn
        dev = _data_device(data, device)
        self.data = _as64(data, dev).reshape(-1)
        self._set_prior(dev, prior_mean, prior_sigma, lower, upper)

    def _lam(self, p):
        return torch.clamp_min(self.theory_fn(p).to(torch.float64), 1e-300)

    def log_like(self, p):
        lam = self._lam(p)
        return (self.data * torch.log(lam) - lam).sum(-1)

    def neg_log_post(self, p):
        return -self.log_like(p) + self._penalty(p)

    def fisher(self, p0):
        """Expected information J^T diag(1/lambda) J (+ the prior
        curvature) at ``p0`` (n_par,), or (m, n_par) for (m, n_par,
        n_par)."""
        with torch.no_grad():
            lam = self._lam(torch.atleast_2d(p0))
        jac = jacobian(self.theory_fn, p0).to(torch.float64)
        lam = lam[0] if p0.dim() == 1 else lam
        f = (jac / lam[..., :, None]).transpose(-1, -2) @ jac
        if self._prior_w is not None:
            f = f + torch.diag(self._prior_w)
        return f


class CompositeLikelihood:
    """The sum of independent likelihood blocks over one shared
    parameter vector (for example a Gaussian 3x2pt block and a Poisson
    counts block), with the same ``log_like`` / ``neg_log_post`` /
    ``fisher`` surface."""

    def __init__(self, likes):
        self.likes = tuple(likes)
        if not self.likes:
            raise ValueError("CompositeLikelihood needs >= 1 block")

    def log_like(self, p):
        return sum(lk.log_like(p) for lk in self.likes)

    def neg_log_post(self, p):
        return sum(lk.neg_log_post(p) for lk in self.likes)

    def fisher(self, p0):
        return sum(lk.fisher(p0) for lk in self.likes)


def moped_compression(theory_fn, cov, p0):
    """MOPED (Heavens, Jimenez & Lahav 2000) lossless linear compression
    at ``p0`` (n_par,): (b_matrix (n_par, n_data) float64, compress).
    The rows are Gram-Schmidt over the Fisher metric, so y = B v carries
    the whole Fisher information of the data vector and Cov(y) = I.
    ``compress`` maps a data vector (n_data,) or a batch (n, n_data) (a
    tensor or numpy) to (n_par,) / (n, n_par) in float64."""
    jac = jacobian(theory_fn, p0).to(torch.float64).cpu().numpy()
    cov = np.asarray(cov.cpu() if torch.is_tensor(cov) else cov,
                     dtype=np.float64)
    cinv_j = np.linalg.solve(cov, jac)                       # C^-1 J
    rows = []
    for a in range(jac.shape[1]):
        b = cinv_j[:, a]
        for r in rows:
            b = b - (jac[:, a] @ r) * r
        rows.append(b / np.sqrt(b @ cov @ b))
    b_mat = torch.as_tensor(np.stack(rows), dtype=torch.float64,
                            device=p0.device)

    def compress(vec):
        v = torch.as_tensor(vec, device=b_mat.device).to(torch.float64)
        return v @ b_mat.T

    return b_mat, compress


def marginalized_covariance(cov, templates, sigmas):
    """C + T^T diag(sigma^2) T (numpy float64): the matrix-level
    equivalent of ``GaussianLikelihood(templates=, template_sigma=)``
    for finite amplitude priors (Sherman-Morrison-Woodbury)."""
    cov = np.asarray(cov, dtype=np.float64)
    t = np.atleast_2d(np.asarray(templates, dtype=np.float64))
    s2 = np.asarray(sigmas, dtype=float).reshape(-1) ** 2
    if s2.size not in (1, t.shape[0]):
        raise ValueError(f"sigmas length {s2.size} != n_templates "
                         f"{t.shape[0]} (scalar broadcast is allowed)")
    if not np.all(np.isfinite(s2)):
        raise ValueError("marginalized_covariance needs finite sigmas; "
                         "use GaussianLikelihood(templates=) for the "
                         "improper flat prior")
    return cov + (t.T * s2) @ t


def _probe_names(n_lens: int, n_src: int, cmb_lensing: bool = False):
    """The probe names of the tomographic data vector, in its order:
    w_i, gt_ij, xip_jk and xim_jk (j <= k), then wgk_i with
    ``cmb_lensing`` (the names of the JAX package's
    ``covariance.tomographic_probes``)."""
    pairs = [f"{j}{k}" for j in range(n_src) for k in range(j, n_src)]
    return ([f"w_{i}" for i in range(n_lens)]
            + [f"gt_{i}{j}" for i in range(n_lens) for j in range(n_src)]
            + [f"xip_{q}" for q in pairs] + [f"xim_{q}" for q in pairs]
            + ([f"wgk_{i}" for i in range(n_lens)] if cmb_lensing else []))


def point_mass_templates(n_lens, n_src, theta_deg, mode: str = "pair",
                         beta=None, cmb_lensing: bool = False,
                         n_counts: int = 0):
    """Point-mass templates 1/theta^2 on the gamma_t rows of the
    tomographic data vector (:func:`_probe_names` order,
    ``len(theta_deg)`` points a probe, ``n_counts`` zero entries after
    it), (n_t, n_data) numpy.  ``mode="pair"``: one amplitude per (lens
    i, source j) pair; ``mode="lens"``: one per lens bin, the source
    scaling fixed by ``beta`` (n_lens, n_src)."""
    theta = np.asarray(theta_deg, dtype=float).reshape(-1)
    nb = theta.size
    shape = 1.0 / theta**2
    names = _probe_names(n_lens, n_src, cmb_lensing)
    n_data = len(names) * nb + int(n_counts)

    def gt_block(i, j):
        return (n_lens + i * n_src + j) * nb

    if mode == "pair":
        out = np.zeros((n_lens * n_src, n_data))
        for i in range(n_lens):
            for j in range(n_src):
                s = gt_block(i, j)
                out[i * n_src + j, s:s + nb] = shape
    elif mode == "lens":
        if beta is None:
            raise ValueError("mode='lens' needs beta (n_lens, n_src) "
                             "∝ <Sigma_crit^-1> per pair")
        beta = np.asarray(beta, dtype=float)
        if beta.shape != (n_lens, n_src):
            raise ValueError(f"beta shape {beta.shape} != "
                             f"({n_lens}, {n_src})")
        out = np.zeros((n_lens, n_data))
        for i in range(n_lens):
            for j in range(n_src):
                s = gt_block(i, j)
                out[i, s:s + nb] = beta[i, j] * shape
    else:
        raise ValueError(f"mode must be 'pair' or 'lens', got {mode!r}")
    return out


def theta_cut_mask(n_lens, n_src, theta_deg, cuts, cmb_lensing: bool = False,
                   n_counts: int = 0, default=(0.0, np.inf)):
    """Boolean keep-mask (n_data,) over the tomographic data vector from
    per-probe angular cuts: ``cuts`` maps probe names ("gt_01") or
    families ("w", "gt", "xip", "xim", "wgk") to (theta_min, theta_max)
    in degrees (a name overrides its family, ``default`` applies
    otherwise); points in the closed interval stay; the ``n_counts``
    count bins after the probes always stay."""
    theta = np.asarray(theta_deg, dtype=float).reshape(-1)
    keep = []
    for name in _probe_names(n_lens, n_src, cmb_lensing):
        lo, hi = cuts.get(name, cuts.get(name.split("_")[0], default))
        keep.append((theta >= lo) & (theta <= hi))
    keep.append(np.ones(int(n_counts), dtype=bool))
    return np.concatenate(keep)


def apply_scale_cuts(keep, theory_fn, data, cov, templates=None,
                     template_sigma=None):
    """(theory_fn, data, cov [, templates [, template_sigma]]) restricted
    to the kept entries of the boolean ``keep``: the cut theory map
    gathers the kept columns of ``theory_fn(p)`` (n, n_data); templates
    that are all zero after the cut are dropped, with their
    ``template_sigma`` entries."""
    keep = np.asarray(keep, dtype=bool).reshape(-1)
    data = data.cpu().numpy() if torch.is_tensor(data) else np.asarray(data)
    if keep.size != data.size:
        raise ValueError(f"mask length {keep.size} != data {data.size}")
    idx_np = np.nonzero(keep)[0]
    idx = {}

    def cut_fn(p):
        out = theory_fn(p)
        if out.device not in idx:
            idx[out.device] = torch.as_tensor(idx_np, device=out.device)
        return out.index_select(-1, idx[out.device])

    cov = np.asarray(cov)[np.ix_(keep, keep)]
    if templates is None:
        if template_sigma is not None:
            raise ValueError("template_sigma given without templates")
        return cut_fn, data[keep], cov
    t = np.atleast_2d(np.asarray(templates))[:, keep]
    row_keep = np.any(t != 0.0, axis=1)
    t = t[row_keep]
    if template_sigma is None:
        return cut_fn, data[keep], cov, t
    ts = np.asarray(template_sigma, dtype=float).reshape(-1)
    if ts.size != row_keep.size:
        raise ValueError(f"template_sigma length {ts.size} != "
                         f"n_templates {row_keep.size}")
    return cut_fn, data[keep], cov, t, ts[row_keep]


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


def adaptive_hmc(neg_log_post, p0, generator, n_warmup: int = 500,
                 n_samples: int = 1000, n_chains: int = 4,
                 target_accept: float = 0.8, n_leap: int = 16,
                 jitter: float = 0.5, init_step: float = 0.1,
                 init_jitter: float = 0.1, dense_mass: bool = False):
    """Self-tuning Hamiltonian Monte Carlo over ``n_chains`` chains: the
    JAX package's ``adaptive_hmc`` (dual-averaging step size, Hoffman &
    Gelman 2014; a metric estimated in the warmup; jittered trajectory
    lengths), with every chain moved by one ``torch.autograd.grad`` of the
    summed objective per leapfrog step.

    ``neg_log_post`` maps (n, dim) to (n,); ``p0`` (dim,) is the centre
    the chains start from, scattered by N(0, init_jitter^2).  Warmup is
    two dual-averaging windows of n_warmup / 2 sweeps: the first under
    the identity metric, the second under the posterior covariance
    estimated from the first window's second half (all chains pooled,
    shrunk toward 1e-3 as Stan does; diagonal, or the full matrix with
    ``dense_mass``).  Sampling then runs at the tuned step with
    trajectories of L ~ Uniform{ceil((1 - jitter) n_leap), ..., n_leap}
    steps, applied by masked leapfrog (every sweep takes n_leap steps;
    a chain past its L keeps its state).  Each leapfrog step costs one
    gradient evaluation (the gradient at the end of a step is the next
    step's start).  A non-finite objective at ``p0`` raises before any
    sweep; chains whose jittered start is non-finite restart at ``p0``
    with a warning.

    Returns a dict: ``samples`` (n_chains, n_samples, dim), ``accept``
    (n_chains, n_samples) acceptance probabilities, ``step_size``,
    ``mass_diag`` (or ``mass`` with ``dense_mass``) as numpy, and
    ``warmup_accept`` (n_warmup, n_chains)."""
    p0 = p0.detach().reshape(-1)
    dev, dt = p0.device, p0.dtype
    dim = p0.shape[0]
    with torch.no_grad():
        u_center = neg_log_post(p0[None, :])[0].to(torch.float64)
    if not torch.isfinite(u_center):
        raise ValueError(
            "adaptive_hmc: neg_log_post(p0) is non-finite: the chain start "
            "point itself is outside the posterior support.")

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dt)

    def uniform(n):
        return torch.rand(n, generator=generator, device=dev,
                          dtype=torch.float64)

    q = p0[None, :] + init_jitter * randn((n_chains, dim))
    u_q, g_q = _value_and_grad(neg_log_post, q)
    bad0 = ~torch.isfinite(u_q)
    n_bad0 = int(bad0.sum())
    if n_bad0:
        warnings.warn(
            f"adaptive_hmc: {n_bad0}/{n_chains} chains had a non-finite "
            f"neg_log_post at their jittered start (outside a prior "
            f"barrier?) and were re-initialized at p0.  Consider a smaller "
            f"init_jitter.", stacklevel=2)
        q = torch.where(bad0[:, None], p0[None, :], q)
        u_q, g_q = _value_and_grad(neg_log_post, q)

    def sweep(state, eps, m_inv_mul, m_chol_mul, n_active):
        """One HMC transition of every chain: (new state, alpha (n,))."""
        q, u_q, g_q = state
        p = m_chol_mul(randn(q.shape))
        qn, pn, un, gn = q, p, u_q, g_q
        for i in range(n_leap):
            live = (i < n_active)[:, None]
            p_half = pn - 0.5 * eps * gn
            q_new = qn + eps * m_inv_mul(p_half)
            u_new, g_new = _value_and_grad(neg_log_post, q_new)
            p_new = p_half - 0.5 * eps * g_new
            qn = torch.where(live, q_new, qn)
            pn = torch.where(live, p_new, pn)
            gn = torch.where(live, g_new, gn)
            un = torch.where(live[:, 0], u_new, un)
        kin = (0.5 * (pn * m_inv_mul(pn)).sum(-1)
               - 0.5 * (p * m_inv_mul(p)).sum(-1)).to(torch.float64)
        dh = un - u_q + kin
        alpha = torch.where(torch.isfinite(dh),
                            torch.clamp_max(torch.exp(-dh), 1.0),
                            torch.zeros_like(dh))
        acc = uniform(q.shape[0]) < alpha
        return ((torch.where(acc[:, None], qn, q),
                 torch.where(acc, un, u_q),
                 torch.where(acc[:, None], gn, g_q)), alpha)

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def window(state, eps0, m_inv_mul, m_chol_mul, n_iter):
        """Dual averaging of the step over ``n_iter`` sweeps: (state,
        the averaged step, the positions (n_iter, n, dim), the
        alphas (n_iter, n))."""
        mu = math.log(10.0 * eps0)
        ln_e = ln_eb = math.log(eps0)
        h_bar, t = 0.0, 0.0
        full = torch.full((n_chains,), n_leap, device=dev)
        qs, alphas = [], []
        for _ in range(n_iter):
            state, alpha = sweep(state, math.exp(ln_e), m_inv_mul,
                                 m_chol_mul, full)
            t += 1.0
            eta_h = 1.0 / (t + t0)
            h_bar = ((1.0 - eta_h) * h_bar
                     + eta_h * (target_accept - float(alpha.mean())))
            ln_e = mu - math.sqrt(t) / gamma * h_bar
            eta = t ** (-kappa)
            ln_eb = eta * ln_e + (1.0 - eta) * ln_eb
            qs.append(state[0])
            alphas.append(alpha)
        return state, math.exp(ln_eb), torch.stack(qs), torch.stack(alphas)

    def ident(x):
        return x

    n_w1 = max(n_warmup // 2, 1)
    n_w2 = max(n_warmup - n_w1, 1)
    state = (q, u_q, g_q)
    state, eps1, qs1, a1 = window(state, init_step, ident, ident, n_w1)
    half = qs1[n_w1 // 2:].reshape(-1, dim).to(torch.float64)
    n_est = half.shape[0]
    cen = half - half.mean(0)
    shrink = n_est / (n_est + 5.0)
    if dense_mass:
        cov = cen.T @ cen / (n_est - 1.0)
        cov = shrink * cov + (1.0 - shrink) * 1e-3 * torch.eye(
            dim, dtype=torch.float64, device=dev)
        chol_t = torch.linalg.cholesky(cov).T.to(dt)
        cov_t = cov.to(dt)

        def m_inv_mul(p):
            return p @ cov_t.T

        def m_chol_mul(z):
            # p ~ N(0, cov^-1): solve L^T p = z.
            return torch.linalg.solve_triangular(chol_t, z.T,
                                                 upper=True).T
        metric = cov
    else:
        var = shrink * cen.var(0) + (1.0 - shrink) * 1e-3
        var_t, sd_t = var.to(dt), var.sqrt().to(dt)

        def m_inv_mul(p):
            return p * var_t

        def m_chol_mul(z):
            return z / sd_t
        metric = var
    state, eps2, _, a2 = window(state, eps1, m_inv_mul, m_chol_mul, n_w2)

    l_min = max(int(math.ceil((1.0 - jitter) * n_leap)), 1)
    qs, alphas = [], []
    for _ in range(n_samples):
        n_act = torch.randint(l_min, n_leap + 1, (n_chains,),
                              generator=generator, device=dev)
        state, alpha = sweep(state, eps2, m_inv_mul, m_chol_mul, n_act)
        qs.append(state[0])
        alphas.append(alpha)
    metric = metric.cpu().numpy()
    out = {"samples": torch.stack(qs, dim=1),
           "accept": torch.stack(alphas, dim=1), "step_size": eps2,
           "warmup_accept": torch.cat([a1, a2])}
    if dense_mass:
        out["mass"] = np.linalg.inv(metric)
    else:
        out["mass_diag"] = 1.0 / metric
    return out


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


def external_loglike(like, vectorized: bool = False,
                     bad_value: float = -np.inf, *, device=None):
    """A numpy-in / numpy-out ln-posterior for external samplers (emcee,
    Cobaya, zeus, dynesty): ``like.neg_log_post`` (or a bare callable
    giving the negative log posterior of an (n, n_par) batch) with the
    sign flipped, evaluated without autograd, and non-finite values
    mapped to ``bad_value`` (-inf, emcee's reject convention).

    The scalar form maps (n_par,) to a float; ``vectorized=True`` maps
    (n_walkers, n_par) to (n_walkers,) in ONE call of the objective
    (one batched pipeline call over the walkers).  Points go to
    ``device`` (default: that of ``like.data``, else the CPU) in
    float64."""
    nlp = like.neg_log_post if hasattr(like, "neg_log_post") else like
    if device is None:
        data = getattr(like, "data", None)
        device = data.device if torch.is_tensor(data) else "cpu"

    def batch(ps):
        x = torch.as_tensor(np.atleast_2d(np.asarray(ps, dtype=np.float64)),
                            device=device)
        with torch.no_grad():
            out = (-nlp(x)).to(torch.float64).cpu().numpy()
        return np.where(np.isfinite(out), out, bad_value)

    if vectorized:
        return batch

    def log_prob(p, *args):
        return float(batch(np.asarray(p, dtype=np.float64)[None, :])[0])

    return log_prob


def ensemble_sample(log_prob, p0_walkers, n_steps: int, seed: int = 0,
                    a: float = 2.0, vectorized: bool = False):
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch
    move, the emcee algorithm) over a numpy ``log_prob``, on the host:
    the JAX package's ``ensemble_sample``.  ``vectorized=True`` takes a
    ``log_prob`` of (n, n_dim) -> (n,) (:func:`external_loglike`'s batch
    form) and calls it once per half-ensemble move.

    Every start walker must have a finite ``log_prob``: one that has not
    raises, where the reference would leave it frozen for the chain (its
    -inf - -inf acceptance ratio is NaN).  Returns the samples (n_steps,
    n_walkers, n_dim) and the acceptance fraction."""
    rng = np.random.default_rng(seed)
    walkers = np.array(p0_walkers, dtype=np.float64, copy=True)
    n_w, n_dim = walkers.shape
    if n_w < 2 * n_dim:
        raise ValueError(f"need >= {2 * n_dim} walkers for {n_dim} "
                         f"dims, got {n_w}")

    def lp_of(ps):
        if vectorized:
            return np.asarray(log_prob(ps), dtype=np.float64).reshape(-1)
        return np.array([log_prob(w) for w in ps], dtype=np.float64)

    lp = lp_of(walkers)
    bad = ~np.isfinite(lp)
    if bad.any():
        raise ValueError(
            f"ensemble_sample: {int(bad.sum())}/{n_w} start walkers have a "
            f"non-finite log_prob; start every walker inside the support")
    chain = np.empty((n_steps, n_w, n_dim))
    n_acc = 0
    half = n_w // 2
    for t in range(n_steps):
        for sel, other in ((slice(0, half), slice(half, n_w)),
                           (slice(half, n_w), slice(0, half))):
            idx = np.arange(n_w)[sel]
            comp = walkers[other]
            z = ((a - 1.0) * rng.random(len(idx)) + 1.0) ** 2 / a
            partners = comp[rng.integers(0, comp.shape[0], len(idx))]
            prop = partners + z[:, None] * (walkers[idx] - partners)
            lp_prop = lp_of(prop)
            ln_ratio = (n_dim - 1.0) * np.log(z) + lp_prop - lp[idx]
            acc = np.log(rng.random(len(idx))) < ln_ratio
            walkers[idx[acc]] = prop[acc]
            lp[idx[acc]] = lp_prop[acc]
            n_acc += int(acc.sum())
        chain[t] = walkers
    return chain, n_acc / (n_steps * n_w)


def _np64(x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)
