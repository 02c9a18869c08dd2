"""Quadrature nodes, interpolation primitives and the static tensors of a grid.

PyTorch counterpart of the JAX package's ``grids.py``.  The node builders are
float64 numpy (copied: the JAX module imports jax); :func:`gl_integrate`
is the batched torch contraction and :func:`interp_loglog_cubic` the
batched table lookup; :func:`recompute_in_backward` keeps a quadrature's
intermediates out of the autograd graph; :class:`Statics` holds every static
numpy table of one :class:`~chomp_tpu_torch.params.GridSpec` as module
buffers on one device and dtype, so the pipeline converts them once.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """GL nodes/weights on [-1, 1] (float64 numpy, cached)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


@lru_cache(maxsize=None)
def gl_fixed(a: float, b: float, n: int):
    """GL nodes/weights mapped to the static interval [a, b] (numpy)."""
    x, w = gauss_legendre(n)
    half = 0.5 * (b - a)
    return 0.5 * (b + a) + half * x, half * w


@lru_cache(maxsize=None)
def gl_composite(a: float, b: float, panels: int, n: int):
    """Composite GL: ``panels`` equal subintervals of [a, b], ``n`` nodes
    each (numpy)."""
    edges = np.linspace(a, b, panels + 1)
    xs, ws = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        x, w = gl_fixed(float(lo), float(hi), n)
        xs.append(x)
        ws.append(w)
    return np.concatenate(xs), np.concatenate(ws)


def loggrid(lo: float, hi: float, n: int):
    """Uniform grid in ln x over [lo, hi] (numpy float64): (ln_x, dln)."""
    ln = np.linspace(np.log(lo), np.log(hi), n)
    return ln, float(ln[1] - ln[0])


def interp_loglog_cubic(ln_xq, ln_x0, dln, ln_yg):
    """Catmull-Rom cubic of ln y on a uniform ln x grid, with linear
    (power-law) extrapolation from the end slopes outside the grid.

    Batched form of the JAX function (written there for one table under
    ``vmap``): ``ln_yg`` (B|1, n) holds one table per row and ``ln_xq``
    (B|1, ...) that row's queries; the result has the broadcast shape
    (B, ...).  ``ln_x0`` and ``dln`` are scalars (floats or 0-d
    tensors)."""
    n = ln_yg.shape[-1]
    rows = max(ln_yg.shape[0], ln_xq.shape[0])
    shape = (rows,) + tuple(ln_xq.shape[1:])
    t_all = ((ln_xq - ln_x0) / dln).expand(shape).reshape(rows, -1)
    table = ln_yg.expand(rows, n)
    # Interior Catmull-Rom on the clamped index: the four stencil taps.
    i = torch.clamp(torch.floor(t_all).long(), 1, n - 3)
    t = t_all - i.to(t_all.dtype)
    ym1 = torch.gather(table, 1, i - 1)
    y0 = torch.gather(table, 1, i)
    y1 = torch.gather(table, 1, i + 1)
    y2 = torch.gather(table, 1, i + 2)
    a1 = 0.5 * (y1 - ym1)
    a2 = ym1 - 2.5 * y0 + 2.0 * y1 - 0.5 * y2
    a3 = 0.5 * (y2 - ym1) + 1.5 * (y0 - y1)
    out = y0 + t * (a1 + t * (a2 + t * a3))
    lo = table[:, :1] + (table[:, 1:2] - table[:, :1]) * t_all
    hi = table[:, -1:] + (table[:, -1:] - table[:, -2:-1]) * (t_all - (n - 1))
    out = torch.where(t_all < 0.0, lo, out)
    out = torch.where(t_all > n - 1.0, hi, out)
    return out.reshape(shape)


def catmull_rom_weights_np(n: int, t):
    """(len(t), n) Catmull-Rom weight matrix on a UNIFORM grid (numpy):
    row q interpolates grid values at fractional index t[q], with the
    4-tap stencil clipped to [1, n-3]."""
    t = np.asarray(t, dtype=np.float64)
    i = np.clip(np.floor(t).astype(int), 1, n - 3)
    f = t - i
    w = np.zeros((len(t), n))
    rows = np.arange(len(t))
    w[rows, i - 1] = 0.5 * (-f + 2 * f**2 - f**3)
    w[rows, i] = 0.5 * (2 - 5 * f**2 + 3 * f**3)
    w[rows, i + 1] = 0.5 * (f + 4 * f**2 - 3 * f**3)
    w[rows, i + 2] = 0.5 * (-(f**2) + f**3)
    return w


def gl_integrate(f, a, b, x: torch.Tensor, w: torch.Tensor):
    """``∫_a^b f`` with per-element limits ``a``/``b`` (broadcast tensors)
    on the GL rule (``x``, ``w``) of [-1, 1]: ``f`` is evaluated on
    ``broadcast(a, b).shape + (n,)`` and the last axis contracted."""
    half = 0.5 * (b - a)
    mid = 0.5 * (b + a)
    t = mid[..., None] + half[..., None] * x
    return torch.sum(f(t) * w, dim=-1) * half


def recompute_in_backward(fn, *args, track=()):
    """``fn(*args)``; when autograd records a graph through ``args`` or the
    tensors in ``track`` (those ``fn`` reads from its closure), none of
    fn's intermediates are kept for the backward pass, which runs fn
    again (``torch.utils.checkpoint``, non-reentrant).  For the wide,
    cheap integrands of the quadratures (distances, growth, sigma(R), the
    Limber sum), whose saved intermediates would otherwise hold most of
    a 512-cosmology backward's device memory.  ``fn`` must not call
    ``torch.func`` transforms."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (*args, *track)):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class Statics(nn.Module):
    """Every static table of one grid as buffers on one device and dtype:
    GL rules, the mass and sigma(R) nodes, the Limber lattices with their
    fiducial Newton seeds, the Chebyshev table of halo_contract and the k
    nodes of the ln P tables (``k_table``).  The tables land on the card
    unless ``device`` names another (the CPU tests pass ``device="cpu"``).

    ``gl(n)`` and ``gl_unit(n)`` add a GL rule the first time an order is
    asked for.  ``with_bao`` selects the linear transfer of everything
    built on these statics (the JAX package's ``with_bao`` argument, fixed
    here at construction): the EH98 form with BAO wiggles, or the
    no-wiggle shape fit (the default)."""

    def __init__(self, grid, device="cuda", dtype=torch.float64,
                 with_bao: bool = False):
        super().__init__()
        from chomp_tpu_torch import limber_fft
        from chomp_tpu_torch.ops.halo_contract import cheb_table

        self.grid = grid
        self.with_bao = bool(with_bao)
        t = self._t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                                device=device)
        self.register_buffer("ref", t(0.0), persistent=False)
        ln_m, w_m = gl_fixed(float(np.log(grid.m_min)),
                             float(np.log(grid.m_max)), grid.n_mass)
        self.register_buffer("mass_ln_m", t(ln_m), persistent=False)
        # The float64 grid of the switch-mass solve (halo._switch_lnm).
        self.register_buffer("mass_ln_m64", torch.as_tensor(
            ln_m, dtype=torch.float64, device=device), persistent=False)
        self.register_buffer("mass_w", t(w_m), persistent=False)
        ln_k, w_k = gl_composite(float(np.log(grid.sigma_k_min)),
                                 float(np.log(grid.sigma_k_max)),
                                 grid.sigma_panels, grid.sigma_n_per_panel)
        self.register_buffer("sigma_ln_k", t(ln_k), persistent=False)
        self.register_buffer("sigma_w", t(w_k), persistent=False)
        key = limber_fft._lattice_key(grid)
        lat_ln_k, lat_ln_chi = limber_fft._lattices(grid)
        self.register_buffer("lattice_k", t(np.exp(lat_ln_k)),
                             persistent=False)
        self.register_buffer("lattice_chi", t(np.exp(lat_ln_chi)),
                             persistent=False)
        self.register_buffer("z_seed", t(limber_fft._fiducial_z_seed(key)),
                             persistent=False)
        self.register_buffer("z_seed_mid",
                             t(limber_fft._fiducial_z_seed(key, mid=True)),
                             persistent=False)
        self.register_buffer("cheb", t(cheb_table()), persistent=False)
        ln_k_table, _ = loggrid(grid.k_table_min, grid.k_table_max,
                                grid.n_k_table)
        self.register_buffer("k_table", t(np.exp(ln_k_table)),
                             persistent=False)

    @property
    def device(self):
        return self.ref.device

    @property
    def dtype(self):
        return self.ref.dtype

    def _rule(self, name: str, make):
        if not hasattr(self, name + "_x"):
            x, w = make()
            self.register_buffer(name + "_x", self._t(x).to(self.ref),
                                 persistent=False)
            self.register_buffer(name + "_w", self._t(w).to(self.ref),
                                 persistent=False)
        return getattr(self, name + "_x"), getattr(self, name + "_w")

    def gl(self, n: int):
        """(x, w) GL rule of order ``n`` on [-1, 1]."""
        return self._rule(f"gl{n}", lambda: gauss_legendre(n))

    def gl_unit(self, n: int):
        """(x, w) GL rule of order ``n`` mapped to [0, 1] in float64
        before the cast (``gl_fixed(0, 1, n)``)."""
        return self._rule(f"gl_unit{n}", lambda: gl_fixed(0.0, 1.0, n))
