"""Neural emulator of a theory map p -> data vector.

PyTorch counterpart of the JAX package's ``emulator.py``: a Latin-
hypercube design over the prior box, ONE batched call of the theory map
over its nodes (the pipelines take the nodes as a cosmology batch), a
PCA basis of the outputs and a small GELU MLP fitted with Adam under a
cosine-decayed rate.  ``jac_weight > 0`` is Sobolev training: the exact
Jacobians at the design nodes (from :func:`chomp_tpu_torch.inference.
jacobian`, reverse mode by replicas) enter the loss, the design gains
the box's vertices and faces, and the PCA runs in per-output-
standardized coordinates on the values and the Jacobian rows together.

The trained :class:`Emulator` is an ``nn.Module``: ``emu(p)`` maps (n,
n_dim) (or (n_dim,)) to (n, n_out) (or (n_out,)) and differentiates with
autograd, so it drops into ``inference.GaussianLikelihood(theory_fn=emu)``
and the samplers; :meth:`Emulator.jacobian` gives its exact Jacobian by
forward tangents.  The MLP's products are plain matrix products.  Its
GELU is the tanh approximation, the default of ``jax.nn.gelu``, so a
converted JAX emulator (``utils.convert.emulator``) computes the same
``emu(p)``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
from torch import nn

__all__ = ["latin_hypercube", "design_nodes", "Emulator", "train_emulator",
           "TrainReport"]

_BLOCK = 64  # epochs of permutations per host-to-device copy
_GELU_C, _GELU_A = math.sqrt(2.0 / math.pi), 0.044715


def latin_hypercube(generator, n: int, bounds):
    """n points in the box ``bounds`` ((n_dim, 2) rows [lo, hi]), one
    stratum per point per dimension, each dimension's strata permuted
    independently; (n, n_dim) float64 numpy.  ``generator`` is a CPU
    ``torch.Generator``."""
    bounds = np.asarray(bounds, dtype=np.float64)
    n_dim = bounds.shape[0]
    u = torch.rand((n, n_dim), generator=generator,
                   dtype=torch.float64).numpy()
    out = np.empty((n, n_dim))
    for d in range(n_dim):
        perm = torch.randperm(n, generator=generator).numpy()
        strata = (perm + u[:, d]) / n
        out[:, d] = bounds[d, 0] + strata * (bounds[d, 1] - bounds[d, 0])
    return out


def _gelu(z):
    return nn.functional.gelu(z, approximate="tanh")


class _GeluTangent(torch.autograd.Function):
    """(gelu(z), d gelu / dz) of the tanh approximation.  Its backward
    takes both in one pass: autograd's own would record each of the
    dozen elementwise operations of the derivative, and those records
    cost a small MLP's training most of its time."""

    @staticmethod
    def forward(ctx, z):
        z2 = z * z
        t = torch.tanh(_GELU_C * z * (1.0 + _GELU_A * z2))
        du = _GELU_C * (1.0 + 3.0 * _GELU_A * z2)
        half = 0.5 * (1.0 + t)
        s = 1.0 - t * t
        g = half + 0.5 * z * s * du
        ctx.save_for_backward(z, z2, t, s, du, g)
        return z * half, g

    @staticmethod
    def backward(ctx, gh, gg):
        z, z2, t, s, du, g = ctx.saved_tensors
        d2 = s * (du - z * t * du * du + 3.0 * _GELU_C * _GELU_A * z2)
        return gh * g + gg * d2


def _mlp(ws, bs, x):
    """The MLP on whitened inputs ``x`` (n, n_dim)."""
    h = x
    for w, b in zip(ws[:-1], bs[:-1]):
        h = _gelu(h @ w + b)
    return h @ ws[-1] + bs[-1]


def _mlp_jacobian(ws, bs, x):
    """(outputs (n, n_out), d outputs / d x (n, n_out, n_dim)) by forward
    tangents (rows (n, n_dim, width): one matrix product a layer),
    differentiable in the weights."""
    n, d = x.shape
    h = x
    tan = torch.eye(d, dtype=x.dtype, device=x.device).expand(n, d, d)
    for w, b in zip(ws[:-1], bs[:-1]):
        h, g = _GeluTangent.apply(h @ w + b)
        tan = (tan @ w) * g[:, None, :]
    return h @ ws[-1] + bs[-1], (tan @ ws[-1]).transpose(1, 2)


class Emulator(nn.Module):
    """MLP surrogate: inputs standardized by (x_mu, x_sd), GELU hidden
    layers, a linear head giving whitened PCA coefficients c, and y =
    y_mu + (c * c_sd) @ basis.  ``weights`` is ((w (n_in, n_out), b),
    ...), the head last (the JAX package's layout)."""

    def __init__(self, weights, x_mu, x_sd, y_mu, basis, c_sd):
        super().__init__()
        self.ws = nn.ParameterList([nn.Parameter(w) for w, _ in weights])
        self.bs = nn.ParameterList([nn.Parameter(b) for _, b in weights])
        for name, v in (("x_mu", x_mu), ("x_sd", x_sd), ("y_mu", y_mu),
                        ("basis", basis), ("c_sd", c_sd)):
            self.register_buffer(name, v)

    @property
    def weights(self):
        return tuple(zip(self.ws, self.bs))

    def forward(self, p):
        single = p.dim() == 1
        x = (torch.atleast_2d(p).to(self.x_mu) - self.x_mu) / self.x_sd
        y = self.y_mu + (_mlp(list(self.ws), list(self.bs), x)
                         * self.c_sd) @ self.basis
        return y[0] if single else y

    def jacobian(self, p):
        """d emu / d p: (n, n_out, n_dim) for ``p`` (n, n_dim), (n_out,
        n_dim) for (n_dim,)."""
        single = p.dim() == 1
        x = (torch.atleast_2d(p).to(self.x_mu) - self.x_mu) / self.x_sd
        _, jc = _mlp_jacobian(list(self.ws), list(self.bs), x)
        jac = torch.einsum("po,npd->nod", self.basis,
                           jc * self.c_sd[:, None]) / self.x_sd
        return jac[0] if single else jac


@dataclasses.dataclass(frozen=True)
class TrainReport:
    """Holdout record of :func:`train_emulator`: ``max_err`` / ``rms_err``
    in data-vector units on the validation split, ``max_rel_err``
    relative to each entry's RMS signal over the training set, the
    per-epoch training ``loss``; with Sobolev training the worst holdout
    Jacobian entry relative to that entry's RMS over the training
    Jacobians (``jac_max_rel_err``); and the PCA rank used."""

    max_err: float
    rms_err: float
    max_rel_err: float
    n_train: int
    n_val: int
    loss: np.ndarray
    jac_max_rel_err: float | None = None
    n_pca: int | None = None


def design_nodes(generator, bounds, n_train: int, n_val: int,
                 sobolev: bool = False):
    """The design of :func:`train_emulator`'s fresh sweep, (n_train +
    n_val, n_dim) float64 numpy, training nodes first: a Latin hypercube
    of the box; with ``sobolev`` its first training nodes (at most
    n_train / 4) replaced by the box's vertices (when 2^n_dim <= n_train
    / 8) and a Latin hypercube of max(n_train / (16 n_dim), 2) nodes on
    each face, where the MLP's Jacobian errors concentrate."""
    bounds = np.asarray(bounds, dtype=np.float64)
    x_all = latin_hypercube(generator, n_train + n_val, bounds)
    if not sobolev:
        return x_all
    n_dim = bounds.shape[0]
    extras = []
    if 2 ** n_dim <= max(n_train // 8, 1):
        extras.extend(np.asarray(list(itertools.product(*bounds)),
                                 dtype=np.float64))
    n_face = max(n_train // (16 * n_dim), 2)
    for d in range(n_dim):
        sub = np.delete(np.arange(n_dim), d)
        for v in bounds[d]:
            pts = np.empty((n_face, n_dim))
            pts[:, d] = v
            if sub.size:
                pts[:, sub] = latin_hypercube(generator, n_face, bounds[sub])
            extras.append(pts)
    extras = np.concatenate([np.atleast_2d(e) for e in extras])
    n_x = min(len(extras), n_train // 4)
    return np.concatenate([extras[:n_x], x_all[n_x:]])


def _evaluate(fn, x_all, step, device):
    """``fn`` over the rows of ``x_all`` in chunks of ``step``, float64
    numpy."""
    parts = []
    for i in range(0, x_all.shape[0], step):
        x = torch.as_tensor(x_all[i:i + step], dtype=torch.float64,
                            device=device)
        parts.append(fn(x).detach().to(torch.float64).cpu().numpy())
    return np.concatenate(parts, axis=0)


def train_emulator(theory_fn, bounds, generator, n_train: int = 512,
                   n_val: int = 64, n_pca: int | None = 64,
                   hidden=(128, 128), n_epochs: int = 2000,
                   batch_size: int = 128, learning_rate: float = 3e-3,
                   x_train=None, y_train=None, x_val=None, y_val=None,
                   eval_batch: int | None = None, jac_weight: float = 0.0,
                   j_train=None, j_val=None, pca_tol: float | None = None,
                   *, device="cuda", dtype=torch.float64,
                   jac_chunk: int | None = None):
    """Fit an :class:`Emulator` to ``theory_fn`` ((n, n_dim) tensor ->
    (n, n_out)) over the box ``bounds`` ((n_dim, 2)); returns (emulator,
    :class:`TrainReport`).  The arguments are the JAX package's, with a
    CPU ``torch.Generator`` in place of the key, and: ``device`` (the
    design's and the training's: the card unless the caller asks for the
    CPU), ``dtype`` (of the
    MLP and its training) and ``jac_chunk`` (replica rows of one
    backward pass of the Sobolev Jacobians, :func:`inference.jacobian`).

    The design (:func:`design_nodes`, with the box's vertices and faces
    when ``jac_weight > 0``) goes through
    ``theory_fn`` in chunks of ``eval_batch`` rows (default: one call).
    Pass ``x_train`` / ``y_train`` (and ``x_val`` / ``y_val``, else the
    last eighth is held out; with ``jac_weight`` also ``j_train`` (n,
    n_out, n_dim)) to reuse a precomputed sweep.  Outputs are centred and
    compressed on ``n_pca`` principal directions (None or >= the rank
    keeps them all), or on the smallest rank whose per-output RMS
    residual is below ``pca_tol`` of that output's RMS; the MLP fits the
    whitened coefficients with Adam and cosine decay over ``n_epochs``
    passes of permuted minibatches."""
    from chomp_tpu_torch.inference import jacobian

    bounds = np.asarray(bounds, dtype=np.float64)
    device = torch.device(device)
    if (x_train is None) != (y_train is None):
        raise ValueError(
            "train_emulator: pass BOTH x_train and y_train to reuse a "
            "precomputed sweep, or neither to run a fresh LHS sweep "
            f"(got x_train={'set' if x_train is not None else 'None'}, "
            f"y_train={'set' if y_train is not None else 'None'}).")
    if y_train is None and theory_fn is None:
        raise ValueError("train_emulator: theory_fn=None requires a "
                         "precomputed x_train/y_train sweep.")
    sobolev = jac_weight > 0.0
    if sobolev and y_train is not None and j_train is None:
        raise ValueError(
            "train_emulator: jac_weight > 0 with a precomputed sweep "
            "needs j_train (n, n_out, n_dim) Jacobians as well.")

    if y_train is None:
        x_all = design_nodes(generator, bounds, n_train, n_val, sobolev)
        step = eval_batch or x_all.shape[0]
        with torch.no_grad():
            y_all = _evaluate(theory_fn, x_all, step, device)
        x_train, y_train = x_all[:n_train], y_all[:n_train]
        x_val, y_val = x_all[n_train:], y_all[n_train:]
        if sobolev:
            j_all = _evaluate(lambda x: jacobian(theory_fn, x,
                                                 chunk=jac_chunk),
                              x_all, step, device)
            j_train, j_val = j_all[:n_train], j_all[n_train:]
    else:
        x_train = np.asarray(x_train, dtype=np.float64)
        y_train = np.asarray(y_train, dtype=np.float64)
        if sobolev:
            j_train = np.asarray(j_train, dtype=np.float64)
        if x_val is None:
            n_v = max(x_train.shape[0] // 8, 1)
            x_val, y_val = x_train[-n_v:], y_train[-n_v:]
            x_train, y_train = x_train[:-n_v], y_train[:-n_v]
            if sobolev:
                j_val = j_train[-n_v:]
                j_train = j_train[:-n_v]
        n_train = x_train.shape[0]
    x_val = np.asarray(x_val, dtype=np.float64)
    y_val = np.asarray(y_val, dtype=np.float64)

    n_dim, n_out = x_train.shape[1], y_train.shape[1]
    x_mu = x_train.mean(axis=0)
    x_sd = x_train.std(axis=0) + 1e-12
    y_mu = y_train.mean(axis=0)
    scale = np.sqrt((y_train ** 2).mean(axis=0)) + 1e-30
    # Sobolev runs compress in per-output-standardized coordinates, on
    # the values and the Jacobian rows (in whitened-input units)
    # together, so that truncation keeps the derivative directions; the
    # standardization folds into the stored basis.
    o_scale = scale if sobolev else np.ones(n_out)
    ycs = (y_train - y_mu) / o_scale
    svd_mat = ycs
    if sobolev:
        svd_mat = np.concatenate(
            [ycs] + [j_train[:, :, d] * x_sd[d] / o_scale
                     for d in range(n_dim)], axis=0)
    if pca_tol is not None:
        # The residual of a rank-r reconstruction, per output; the
        # value rows measure the tolerance.
        vh = np.linalg.svd(svd_mat, full_matrices=False)[2]
        contrib = np.empty((vh.shape[0], n_out))
        acc = ycs
        for r_i in range(vh.shape[0]):
            contrib[r_i] = (acc ** 2).mean(axis=0)
            acc = acc - np.outer(acc @ vh[r_i], vh[r_i])
        rel = np.sqrt(contrib) / (scale / o_scale)[None, :]
        ranks = np.nonzero(np.max(rel, axis=1) <= pca_tol)[0]
        r = int(ranks[0]) if ranks.size else vh.shape[0]
        basis_s = vh[:max(r, 1)]
    elif n_pca is None or n_pca >= min(n_out, n_train):
        basis_s = np.eye(n_out)
    else:
        basis_s = np.linalg.svd(svd_mat, full_matrices=False)[2][:n_pca]
    basis = basis_s * o_scale[None, :]
    c_train = ycs @ basis_s.T
    c_sd = c_train.std(axis=0) + 1e-30
    n_c = basis.shape[0]

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    xw = tensor((x_train - x_mu) / x_sd)
    cw = tensor(c_train / c_sd)
    jw = None
    if sobolev:
        # dcw/dxw = (basis_s @ (dy/dx / o_scale)) * x_sd / c_sd.
        jw = tensor(np.einsum("po,nod->npd", basis_s,
                              j_train / o_scale[None, :, None])
                    * x_sd[None, None, :] / c_sd[None, :, None])

    sizes = (n_dim,) + tuple(hidden) + (n_c,)
    ws, bs = [], []
    for n_in, n_o in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((n_in, n_o), generator=generator,
                        dtype=torch.float64) * math.sqrt(2.0 / n_in)
        ws.append(w.to(device=device, dtype=dtype).requires_grad_(True))
        bs.append(torch.zeros(n_o, dtype=dtype, device=device,
                              requires_grad=True))
    bsz = min(batch_size, n_train)
    n_batches = n_train // bsz
    n_total = n_epochs * n_batches
    # One fused update for all the parameters: a small MLP's step is
    # bound by the number of operations it issues.
    opt = torch.optim.Adam(ws + bs, lr=learning_rate, fused=True)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, n_total)
                                             / max(n_total, 1))))

    # Each epoch's permutation is drawn on the host, in blocks of epochs
    # that cross to the device in one copy: a copy a step would wait for
    # the device each time.
    orders = (torch.stack([torch.randperm(n_train, generator=generator)
                           for _ in range(min(_BLOCK, n_epochs - e0))]
                          )[:, :n_batches * bsz].to(device)
              for e0 in range(0, n_epochs, _BLOCK))
    losses = []
    for idx in itertools.chain.from_iterable(orders):
        ep = torch.zeros((), dtype=dtype, device=device)
        for rows in idx.reshape(n_batches, bsz):
            if sobolev:
                c, jc = _mlp_jacobian(ws, bs, xw[rows])
                r, jr = c - cw[rows], jc - jw[rows]
                loss = (r * r).mean() + jac_weight * (jr * jr).mean()
            else:
                r = _mlp(ws, bs, xw[rows]) - cw[rows]
                loss = (r * r).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
            ep = ep + loss.detach()
        losses.append(ep / n_batches)

    emu = Emulator([(w.detach(), b.detach()) for w, b in zip(ws, bs)],
                   tensor(x_mu), tensor(x_sd), tensor(y_mu), tensor(basis),
                   tensor(c_sd))
    with torch.no_grad():
        pred = emu(tensor(x_val)).to(torch.float64).cpu().numpy()
    err = pred - y_val
    jac_rel = None
    if sobolev and j_val is not None and np.shape(j_val)[0] > 0:
        with torch.no_grad():
            jpred = emu.jacobian(tensor(x_val)).to(
                torch.float64).cpu().numpy()
        jscale = np.sqrt((np.asarray(j_train) ** 2).mean(axis=0)) + 1e-30
        jac_rel = float(np.abs((jpred - np.asarray(j_val))
                               / jscale[None]).max())
    report = TrainReport(
        max_err=float(np.abs(err).max()),
        rms_err=float(np.sqrt((err ** 2).mean())),
        max_rel_err=float(np.abs(err / scale).max()),
        n_train=int(x_train.shape[0]), n_val=int(y_val.shape[0]),
        loss=torch.stack(losses).to(torch.float64).cpu().numpy(),
        jac_max_rel_err=jac_rel, n_pca=int(n_c))
    return emu, report
