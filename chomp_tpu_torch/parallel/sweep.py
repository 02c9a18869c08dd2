"""Batched w(theta) + gamma_t (+ xi_+-) pipelines: the flat lattice and
table routes.

PyTorch counterpart of the JAX package's ``parallel/sweep.py``'s
``broadcast_cosmo`` and ``make_pipeline``: the fused lattice branch
(``method="fft"``, flat geometry, sweep.py:343-406, with
``_fused_probe_rows`` sweep.py:452-501), its exact-z mode
(``exact_z_anchors``, sweep.py:268-292 and 343-431) and the GL +
cubic-table branch (``method="table"``, sweep.py:303-306 and 407-411).
Each pipeline is an ``nn.Module`` whose forward takes a batch of
cosmologies (:class:`~chomp_tpu_torch.params.CosmoParams` with ``(B,)``
fields) in place of ``jit(vmap(fn))``:

    fft:   halo model -> spectra on the k lattice (kernel A; in exact-z
           mode at the Chebyshev anchors, one launch over B x J rows) ->
           lattice window weights -> one grouped direct convolution for
           every probe row -> one compensated contraction per distinct
           operator (kernel C) -> w, gamma_t, xi_+-;
    table: halo model -> ln P tables on the ln k table (kernel A) -> GL
           Limber C_ell per probe -> one Hankel + theta-binning product
           per output (kernel B) -> w, gamma_t, xi_+-.

The static numpy operators live in module buffers, on the device and in
the dtype chosen at construction (float32 is the serving precision;
float64 is the reference mode).  Options of the JAX ``make_pipeline``
outside this slice raise ``NotImplementedError`` naming their ROADMAP
item; none is silently ignored.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
from torch import nn

from chomp_tpu_torch import correlation, halo, limber_fft, projection
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.ops.df32 import df_contract, split_operator
from chomp_tpu_torch.ops.hankel_matmul import hankel_matmul
from chomp_tpu_torch.params import DEFAULT_GRID, CosmoParams, GridSpec


def broadcast_cosmo(base: CosmoParams, **param_arrays) -> CosmoParams:
    """Batch of cosmologies: named 1-D arrays override ``base`` fields,
    every other field is broadcast.  Fields are ``(B,)`` on ``base``'s
    device and dtype."""
    if not param_arrays:
        raise ValueError("need at least one varying parameter")
    ref = base.omega_m0
    arrays = {k: torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
              for k, v in param_arrays.items()}
    n = next(iter(arrays.values())).shape[0]
    full = {}
    for f in dataclasses.fields(base):
        v = arrays.get(f.name, getattr(base, f.name))
        full[f.name] = v.reshape(-1).expand(n).contiguous()
    return CosmoParams(**full)


def _warn_if_separable_bias(dist, z_pivot: float, threshold: float = 0.5):
    """Host-side warning when the separable-growth pivot is far from the
    window's mean redshift (a >10% C_ell bias for deep kernels, measured
    in the JAX package's tests/test_exact_z_lattice.py).  Skipped for a
    batched dist."""
    if dist.z_min.numel() != 1 or dist.z_max.numel() != 1:
        return
    z_lo, z_hi = float(dist.z_min), float(dist.z_max)
    zg = torch.linspace(z_lo, z_hi, 257, dtype=torch.float64,
                        device=dist.z_min.device)
    p = dist.to(dtype=torch.float64).raw_dndz(zg).cpu().numpy()
    zg = zg.cpu().numpy()
    den = float(np.trapezoid(p, zg))
    if den <= 0.0:
        return
    z_bar = float(np.trapezoid(p * zg, zg)) / den
    if abs(z_bar - z_pivot) > threshold:
        warnings.warn(
            f"make_pipeline: separable growth with z_pivot={z_pivot} but "
            f"the window's mean redshift is ~{z_bar:.2f}; the frozen "
            "halo-model shape biases C_ell at the >10% level for such "
            "deep kernels.  Pass exact_z_anchors=6..8 for exact redshift "
            "evolution, or set z_pivot near the kernel mean.", stacklevel=3)


def _unported(option: str, item: str):
    raise NotImplementedError(
        f"make_pipeline({option}) is not ported to chomp_tpu_torch yet: "
        f"ROADMAP {item}")


def make_pipeline(halo_params, hod, dist, power_spec: str = "power_gg",
                  theta_deg=None, z_pivot: float = 0.0,
                  with_bao: bool = False, grid: GridSpec = DEFAULT_GRID,
                  include_lensing: bool = True, method: str = "fft",
                  exact_z_anchors: int | None = None,
                  geometry: str = "flat", include_shear: bool = False,
                  include_cmb_lensing=False,
                  nonlimber_ell_switch: int | None = None,
                  nonlimber_rsd: bool = False, matter_power: str = "halo",
                  *, device, dtype) -> nn.Module:
    """The flagship program as an ``nn.Module``: ``pipe(cosmo)`` ->
    dict with ``theta_deg``, ``n_g`` (B,), ``w_theta`` and (with
    ``include_lensing``) ``gamma_t``, (with ``include_shear``)
    ``xi_plus`` and ``xi_minus``, each (B, n_theta).  Same arguments as
    the JAX ``make_pipeline``, plus the explicit ``device`` and ``dtype``
    every buffer and output lives in.  ``method="fft"`` builds
    :class:`Pipeline` (the lattice route), ``method="table"``
    :class:`TablePipeline` (the GL + cubic-table route).

    ``exact_z_anchors`` (e.g. 6-8; the lattice route only, as in the JAX
    package) drops the separable-growth approximation: every probe's
    halo model is expanded over that many Chebyshev redshift anchors on
    [1e-3, max(dist.z_max, 1)], a window fixed here, at construction
    (``dist.z_max`` must then be one value).  ``n_g`` still comes from
    the halo model at ``z_pivot``.  ``include_shear`` adds the
    shear-shear correlations of the source sample ``dist`` (power_mm
    through the convergence window on both sides; flat J0 / J4)."""
    if geometry not in ("flat", "curved"):
        raise ValueError(f"geometry must be 'flat' or 'curved', got "
                         f"{geometry!r}")
    if method not in ("fft", "table"):
        raise ValueError(f"method must be 'fft' or 'table', got {method!r}")
    if matter_power not in ("halo", "halofit", "linear"):
        raise ValueError(f"matter_power must be halo|halofit|linear, "
                         f"got {matter_power!r}")
    if power_spec not in ("linear_power", "power_mm", "power_gm",
                          "power_mg", "power_gg"):
        raise ValueError(f"unknown power_spec {power_spec!r}")
    if nonlimber_rsd and not nonlimber_ell_switch:
        raise ValueError("nonlimber_rsd requires nonlimber_ell_switch (the "
                         "RSD term rides the same correction operators)")
    if method == "table":
        # The JAX make_pipeline's own refusals (sweep.py:233-251).
        if geometry == "curved":
            raise ValueError("geometry='curved' requires method='fft'")
        if nonlimber_ell_switch:
            raise ValueError("nonlimber_ell_switch requires method='fft'")
        if matter_power != "halo":
            raise ValueError("matter_power overrides need method='fft'")
    options = (("include_cmb_lensing", include_cmb_lensing not in (False,
                                                                   None)),
               ("geometry='curved'", geometry == "curved"),
               ("nonlimber_ell_switch", bool(nonlimber_ell_switch)),
               ("nonlimber_rsd", nonlimber_rsd),
               (f"matter_power={matter_power!r}", matter_power != "halo"),
               ("with_bao=True", with_bao),
               ("halo_params.mass_fn != 0",
                bool(torch.any(halo_params.mass_fn != 0.0))))
    for name, on in options:
        if on:
            _unported(name, "queue 1, item 7 (make_pipeline options)")
    # As in the JAX make_pipeline, the anchors act on the lattice route
    # only: the table route ignores them (and skips the warning below).
    if not exact_z_anchors:
        _warn_if_separable_bias(dist, z_pivot)
    args = (halo_params, hod, dist, power_spec, theta_deg, z_pivot, grid,
            include_lensing, include_shear)
    if method == "table":
        return TablePipeline(*args, device=device, dtype=dtype)
    return Pipeline(*args, exact_z_anchors=exact_z_anchors, device=device,
                    dtype=dtype)


class _PipelineBase(nn.Module):
    """What both routes share: the statics, the parameters, the windows,
    the theta bins and the probes on one device and dtype, fixed at
    construction (build a second pipeline for another precision), and
    the halo model at the pivot redshift.

    ``probes``: (win_a, win_b, spectrum kind, ((mu, output key), ...)),
    w(theta) first; the shear row asks for two transforms of one C_ell.
    ``mus``: the distinct Hankel orders, in order of first request."""

    def __init__(self, halo_params, hod, dist, power_spec, theta_deg,
                 z_pivot, grid, include_lensing, include_shear, *, device,
                 dtype):
        super().__init__()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.st = Statics(grid, device=device, dtype=dtype)
        self.halo_params = halo_params.to(device, dtype)
        self.hod = hod.to(device, dtype)
        self.dist = dist.to(device, dtype)
        self.power_spec = power_spec
        self.z_pivot = float(z_pivot)
        self.win_g = projection.WindowGalaxy(dist=self.dist)
        self.win_k = projection.WindowConvergence(dist=self.dist)
        if theta_deg is None:
            theta_deg = correlation.theta_bins_deg(grid)
        theta_np = np.asarray(theta_deg, dtype=np.float64)
        self.register_buffer("theta_deg", torch.as_tensor(
            theta_np, dtype=dtype, device=device), persistent=False)
        self.theta_key = tuple(theta_np.tolist())
        self.probes = [(self.win_g, self.win_g, power_spec,
                        ((0.0, "w_theta"),))]
        if include_lensing:
            self.probes.append((self.win_k, self.win_g, "power_gm",
                                ((2.0, "gamma_t"),)))
        if include_shear:
            self.probes.append((self.win_k, self.win_k, "power_mm",
                                ((0.0, "xi_plus"), (4.0, "xi_minus"))))
        self.mus = tuple(dict.fromkeys(
            mu for *_p, specs in self.probes for mu, _key in specs))
        self.kinds = tuple(dict.fromkeys(p[2] for p in self.probes))

    def halo_model(self, cosmo: CosmoParams):
        """(the batch with (B,) fields, the halo model at z_pivot); a batch
        of another dtype or device raises."""
        st = self.st
        cosmo = cosmo.batched()
        if cosmo.omega_m0.dtype != st.dtype or \
                cosmo.omega_m0.device != st.device:
            raise ValueError(
                f"cosmology batch is {cosmo.omega_m0.dtype} on "
                f"{cosmo.omega_m0.device}; this pipeline runs {st.dtype} "
                f"on {st.device}")
        z = torch.full((1,), self.z_pivot, dtype=st.dtype, device=st.device)
        return cosmo, halo.build_halo_model(cosmo, self.halo_params,
                                            self.hod, z, st)


class Pipeline(_PipelineBase):
    """The lattice route (``method="fft"``): flat-sky w(theta) (+ gamma_t,
    + xi_+-) for a cosmology batch, separable-growth or, with
    ``exact_z_anchors``, with the halo model's exact redshift evolution
    (see :func:`make_pipeline`)."""

    def __init__(self, *args, exact_z_anchors=None, device, dtype):
        super().__init__(*args, device=device, dtype=dtype)
        grid = self.st.grid
        self.exact_z_anchors = int(exact_z_anchors or 0)
        # The anchor window's top, read once here (the JAX make_pipeline
        # fixes it at build time too): forward never reads back to the
        # host.
        self.z_hi_anchor = (max(float(self.dist.z_max), 1.0)
                            if self.exact_z_anchors else None)
        self.windows = []
        for i, mu in enumerate(self.mus):
            j_lo, j_hi, a = limber_fft.wtheta_lattice_operator(
                self.theta_key, grid, mu)
            self.windows.append((j_lo, j_hi))
            if dtype == torch.float32:
                hi, lo = split_operator(a)
            else:
                hi, lo = a, None
            self.register_buffer(f"op{i}_hi", torch.as_tensor(
                hi, device=device), persistent=False)
            self.register_buffer(f"op{i}_lo", None if lo is None else
                                 torch.as_tensor(lo, device=device),
                                 persistent=False)

    def operator(self, i: int):
        """(j_lo, j_hi, a_hi, a_lo) of the i-th operator (mu of
        ``self.mus``); ``a_lo`` is None in float64."""
        j_lo, j_hi = self.windows[i]
        return j_lo, j_hi, getattr(self, f"op{i}_hi"), \
            getattr(self, f"op{i}_lo")

    def forward(self, cosmo: CosmoParams) -> dict:
        st = self.st
        cosmo, model = self.halo_model(cosmo)
        pairs = [(wa, wb) for wa, wb, _k, _s in self.probes]
        if self.exact_z_anchors:
            anchors = limber_fft.exact_z_anchor_spectra(
                cosmo, self.halo_params, self.hod, self.kinds,
                self.exact_z_anchors, 1e-3, self.z_hi_anchor, st)
            rows = [(wa, wb, kind) for wa, wb, kind, _s in self.probes]

            def conv(j_lo, j_hi):
                return limber_fft.exact_z_conv_rows(cosmo, anchors, rows, st,
                                                    j_lo, j_hi)
        else:
            p_all = limber_fft.p_lattice_halo_all(cosmo, self.halo_params,
                                                  model, st)

            def conv(j_lo, j_hi):
                g_rows = limber_fft._lattice_g_rows(cosmo, pairs, st,
                                                    model.mass.growth)
                p_rows = torch.stack([p_all[kind] for _a, _b, kind, _s
                                      in self.probes], dim=1)
                return limber_fft._conv_direct_rows(p_rows, g_rows, j_lo,
                                                    j_hi)

        specs = [[self.mus.index(mu) for mu, _key in s]
                 for *_p, s in self.probes]
        outs = _fused_probe_rows(conv, specs, self.operator)
        out = {"theta_deg": self.theta_deg, "n_g": model.n_g}
        for (*_p, s), vals in zip(self.probes, outs):
            out.update({key: v for (_mu, key), v in zip(s, vals)})
        return out


class TablePipeline(_PipelineBase):
    """The GL + cubic-table route (``method="table"``, the JAX
    sweep.py:303-306): per probe, a ln P table on the static ln k grid
    and the Gauss-Legendre Limber C_ell on the ell grid; per output, the
    fused Hankel + theta-binning operator applied by kernel B (the
    ``"pallas"`` engine of ``correlation.wtheta_from_cl_fused``, with the
    operators held as buffers).  ``halo.powers`` runs once per forward
    for every probe."""

    def __init__(self, *args, device, dtype):
        super().__init__(*args, device=device, dtype=dtype)
        grid = self.st.grid
        self.register_buffer("ells", torch.as_tensor(
            correlation.ell_grid(grid)[0], dtype=dtype, device=device),
            persistent=False)
        for i, mu in enumerate(self.mus):
            op = correlation.wtheta_bins_operator(self.theta_key, grid, mu)
            self.register_buffer(f"op{i}_t", torch.as_tensor(
                op.T, dtype=dtype, device=device).contiguous(),
                persistent=False)

    def forward(self, cosmo: CosmoParams) -> dict:
        st = self.st
        cosmo, model = self.halo_model(cosmo)
        tables = projection.power_tables_halo(cosmo, self.halo_params, model,
                                              self.kinds, st)
        out = {"theta_deg": self.theta_deg, "n_g": model.n_g}
        for wa, wb, kind, specs in self.probes:
            cl = projection.limber_cl(cosmo, wa, wb, self.ells, tables[kind],
                                      st)
            for mu, key in specs:
                out[key] = hankel_matmul(
                    cl, getattr(self, f"op{self.mus.index(mu)}_t"))
        return out


def _fused_probe_rows(conv, specs, operator):
    """Every probe row's outputs from ONE grouped lattice convolution
    and one compensated contraction (kernel C) per distinct operator
    over every row requesting it.  ``conv(j_lo, j_hi)`` -> (B, R,
    j_hi - j_lo), the convolution of the R rows over the union of the
    operators' windows; ``specs[r]``: the operator indices row r asks
    for; ``operator(i)`` -> (j_lo, j_hi, a_hi, a_lo).  Returns, per row,
    the list of (B, n_theta) outputs matching its requests."""
    ops = {i: operator(i) for s in specs for i in s}
    j_lo = min(o[0] for o in ops.values())
    j_hi = max(o[1] for o in ops.values())
    c = conv(j_lo, j_hi)
    by_op = {}
    for r, s in enumerate(specs):
        for i in s:
            by_op.setdefault(i, []).append(r)
    res = {}
    b = c.shape[0]
    for i, rlist in by_op.items():
        lo, hi, a_hi, a_lo = ops[i]
        sub = c[:, rlist, lo - j_lo:hi - j_lo]
        vals = df_contract(sub.reshape(b * len(rlist), hi - lo).contiguous(),
                           a_hi, a_lo).reshape(b, len(rlist), -1)
        for n, r in enumerate(rlist):
            res[(r, i)] = vals[:, n]
    return [[res[(r, i)] for i in s] for r, s in enumerate(specs)]
