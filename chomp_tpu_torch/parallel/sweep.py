"""Batched w(theta) + gamma_t (+ xi_+-) pipelines: the flat lattice and
table routes, and the tomographic 3x2pt pipeline.

PyTorch counterpart of the JAX package's ``parallel/sweep.py``'s
``broadcast_cosmo`` and ``make_pipeline``: the fused lattice branch
(``method="fft"``, flat geometry, sweep.py:343-406, with
``_fused_probe_rows`` sweep.py:452-501), its exact-z mode
(``exact_z_anchors``, sweep.py:268-292 and 343-431) and the GL +
cubic-table branch (``method="table"``, sweep.py:303-306 and 407-411);
and of ``Nuisance3x2pt``, ``default_nuisance`` and the separable flat
route of ``make_tomographic_pipeline`` (sweep.py:35-63, 504-882).
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
           per output (kernel B) -> w, gamma_t, xi_+-;
    tomographic: the fft route over every lens / source bin pair (per-bin
           HODs: one kernel A launch over B x n_lens rows), with the
           nuisance windows, the magnification rows and the shear
           calibration.

The static numpy operators live in module buffers, on the device and in
the dtype chosen at construction (float32 is the serving precision;
float64 is the reference mode).  Options of the JAX pipelines outside
these routes raise ``NotImplementedError`` naming their ROADMAP item;
none is silently ignored.
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


def _checked_batch(cosmo: CosmoParams, st) -> CosmoParams:
    """The batch with (B,) fields; one of another dtype or device than
    the pipeline's raises."""
    cosmo = cosmo.batched()
    if cosmo.omega_m0.dtype != st.dtype or \
            cosmo.omega_m0.device != st.device:
        raise ValueError(
            f"cosmology batch is {cosmo.omega_m0.dtype} on "
            f"{cosmo.omega_m0.device}; this pipeline runs {st.dtype} on "
            f"{st.device}")
    return cosmo


def _unported(option: str, item: str, where: str = "make_pipeline"):
    raise NotImplementedError(
        f"{where}({option}) is not ported to chomp_tpu_torch yet: "
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
        cosmo = _checked_batch(cosmo, st)
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
        _register_operators(self, grid, device, dtype)

    def operator(self, i: int):
        """(j_lo, j_hi, a_hi, a_lo) of the i-th operator (mu of
        ``self.mus``); ``a_lo`` is None in float64."""
        return _operator(self, i)

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


#: Rank of each Nuisance3x2pt field without a batch axis.
_NUISANCE_RANK = dict(dz_lens=1, dz_src=1, m=1, a_ia=0, eta_ia=0, z0_ia=0,
                      alpha_lens=1)


@dataclasses.dataclass(frozen=True)
class Nuisance3x2pt:
    """The tomographic 3x2pt nuisance set of the JAX package: per-bin
    photo-z shifts (``projection.DNdzShifted``), per-source-bin shear
    calibration m (gamma_t rows x (1+m_j), xi_+- rows x (1+m_j)(1+m_k)),
    NLA intrinsic alignments (``projection.WindowConvergenceIA``) and the
    lens magnification slopes alpha (1 = off).  Each field is a tensor
    with the shape in its comment, or that shape behind a leading batch
    axis (B, ...): one nuisance point per cosmology row."""

    dz_lens: torch.Tensor     # (n_lens,)
    dz_src: torch.Tensor      # (n_src,)
    m: torch.Tensor           # (n_src,)
    a_ia: torch.Tensor        # ()
    eta_ia: torch.Tensor      # ()
    z0_ia: torch.Tensor       # ()
    alpha_lens: torch.Tensor  # (n_lens,)

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def batched(self, b: int) -> "Nuisance3x2pt":
        """Every field broadcast to a leading batch axis of ``b``."""
        out = {}
        for name, v in self.fields().items():
            rank = _NUISANCE_RANK[name]
            if v.dim() == rank + 1 and v.shape[0] in (1, b):
                v = v.expand(b, *v.shape[1:])
            elif v.dim() == rank:
                v = v.expand(b, *v.shape)
            else:
                raise ValueError(f"Nuisance3x2pt.{name} has shape "
                                 f"{tuple(v.shape)}; want rank {rank}, or "
                                 f"rank {rank + 1} with {b} (or 1) rows")
            out[name] = v
        return Nuisance3x2pt(**out)


def default_nuisance(n_lens: int, n_src: int, *, device,
                     dtype) -> Nuisance3x2pt:
    """The zero nuisance point: no shifts, identity calibration, no IA
    (A_ia = 0, pivot z0 = 0.62) and alpha = 1; the pipeline with
    ``with_nuisance=True`` reduces to the plain one there."""
    kw = dict(device=device, dtype=dtype)
    return Nuisance3x2pt(
        dz_lens=torch.zeros(n_lens, **kw), dz_src=torch.zeros(n_src, **kw),
        m=torch.zeros(n_src, **kw), a_ia=torch.zeros((), **kw),
        eta_ia=torch.zeros((), **kw), z0_ia=torch.tensor(0.62, **kw),
        alpha_lens=torch.ones(n_lens, **kw))


def make_tomographic_pipeline(halo_params, hod, lens_dists, src_dists,
                              theta_deg=None, z_pivot: float = 0.0,
                              with_bao: bool = False,
                              grid: GridSpec = DEFAULT_GRID,
                              geometry: str = "flat",
                              exact_z_anchors: int | None = None,
                              with_nuisance: bool = False,
                              include_magnification: bool = False,
                              include_cmb_lensing=False,
                              nonlimber_ell_switch: int | None = None,
                              nonlimber_rsd: bool = False,
                              matter_power: str = "halo", *, device,
                              dtype) -> nn.Module:
    """Tomographic 3x2pt prediction as an ``nn.Module``
    (:class:`TomographicPipeline`): ``pipe(cosmo)`` (``pipe(cosmo,
    nuisance)`` with ``with_nuisance``) -> dict with ``theta_deg``,
    ``w_theta`` (B, n_lens, n_theta), ``gamma_t`` (B, n_lens n_src,
    n_theta), ``xi_plus`` / ``xi_minus`` (B, n_src (n_src+1)/2, n_theta),
    ``n_g`` ((B,), or (B, n_lens) with per-bin HODs) and ``vector`` (B,
    n_data): w, gamma_t, xi_+, xi_- rows concatenated in that order.
    Same arguments as the JAX ``make_tomographic_pipeline``, plus the
    explicit ``device`` and ``dtype``; the separable flat route.

    ``hod`` is one HOD shared by every lens bin or a list of one HOD per
    lens bin (one mass-table build, and every bin's galaxy pack in one
    kernel A launch).  ``with_nuisance``: per-bin photo-z shifts, shear
    calibration and NLA intrinsic alignments from a
    :class:`Nuisance3x2pt`; ``include_magnification`` (needs it) adds the
    lens magnification rows with slopes alpha.  Every probe row, the
    magnification rows included, rides one grouped convolution and one
    kernel C launch per distinct operator (mu = 0, 2, 4)."""
    # The JAX function's own refusals (sweep.py:595-613).
    if geometry not in ("flat", "curved"):
        raise ValueError(f"geometry must be 'flat' or 'curved', got "
                         f"{geometry!r}")
    if with_nuisance and exact_z_anchors:
        raise NotImplementedError(
            "with_nuisance shifts dN/dz per call; the exact-z anchor window "
            "needs a z_max fixed at construction: use the separable route")
    if include_magnification and not with_nuisance:
        raise ValueError("include_magnification needs with_nuisance=True "
                         "(the slopes live in Nuisance3x2pt.alpha_lens)")
    if nonlimber_rsd and not nonlimber_ell_switch:
        raise ValueError("nonlimber_rsd requires nonlimber_ell_switch (the "
                         "RSD term rides the same correction operators)")
    if matter_power not in ("halo", "halofit", "linear"):
        raise ValueError(f"matter_power must be halo|halofit|linear, "
                         f"got {matter_power!r}")
    if isinstance(hod, (list, tuple)) and len(hod) != len(lens_dists):
        raise ValueError(f"per-bin HODs: got {len(hod)} HODs for "
                         f"{len(lens_dists)} lens bins")
    where = "make_tomographic_pipeline"
    if exact_z_anchors:
        _unported("exact_z_anchors", "queue 1, item 8 (exact-z "
                  "tomography)", where)
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
            _unported(name, "queue 1, item 7 (make_pipeline options)", where)
    for d in (*lens_dists, *src_dists):
        _warn_if_separable_bias(d, z_pivot)
    return TomographicPipeline(halo_params, hod, lens_dists, src_dists,
                               theta_deg, z_pivot, grid, with_nuisance,
                               include_magnification, device=device,
                               dtype=dtype)


class TomographicPipeline(nn.Module):
    """The separable flat route of the JAX ``make_tomographic_pipeline``
    (sweep.py:723-783 and 855-879; see :func:`make_tomographic_pipeline`).
    Parameters, dN/dz, windows, theta bins and the three operators live
    on one device and dtype, fixed at construction."""

    def __init__(self, halo_params, hod, lens_dists, src_dists, theta_deg,
                 z_pivot, grid, with_nuisance, include_magnification, *,
                 device, dtype):
        super().__init__()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.st = Statics(grid, device=device, dtype=dtype)
        self.halo_params = halo_params.to(device, dtype)
        self.per_bin = isinstance(hod, (list, tuple))
        self.hods = [h.to(device, dtype)
                     for h in (hod if self.per_bin else [hod])]
        self.lens = [d.to(device, dtype) for d in lens_dists]
        self.src = [d.to(device, dtype) for d in src_dists]
        self.z_pivot = float(z_pivot)
        self.with_nuisance = bool(with_nuisance)
        self.include_magnification = bool(include_magnification)
        self.wins_g = [projection.WindowGalaxy(dist=d) for d in self.lens]
        self.wins_k = [projection.WindowConvergence(dist=d) for d in self.src]
        n_src = len(self.src)
        self.pairs_xi = [(j, k) for j in range(n_src)
                         for k in range(j, n_src)]
        if theta_deg is None:
            theta_deg = correlation.theta_bins_deg(grid)
        theta_np = np.asarray(theta_deg, dtype=np.float64)
        self.register_buffer("theta_deg", torch.as_tensor(
            theta_np, dtype=dtype, device=device), persistent=False)
        self.theta_key = tuple(theta_np.tolist())
        self.mus = (0.0, 2.0, 4.0)
        _register_operators(self, grid, device, dtype)

    def operator(self, i: int):
        """(j_lo, j_hi, a_hi, a_lo) of the i-th operator (mu of
        ``self.mus``); ``a_lo`` is None in float64."""
        return _operator(self, i)

    def windows_at(self, nu):
        """(lens galaxy windows, source windows, lens convergence windows
        or None) at the batched nuisance point ``nu`` (None: the plain
        windows)."""
        if nu is None:
            return self.wins_g, self.wins_k, None
        lens = [projection.DNdzShifted(base=d, dz=nu.dz_lens[:, i])
                for i, d in enumerate(self.lens)]
        wins_k = [projection.WindowConvergenceIA(
            dist=projection.DNdzShifted(base=d, dz=nu.dz_src[:, j]),
            a_ia=nu.a_ia, eta_ia=nu.eta_ia, z0_ia=nu.z0_ia)
            for j, d in enumerate(self.src)]
        wk_lens = ([projection.WindowConvergence(dist=d) for d in lens]
                   if self.include_magnification else None)
        return ([projection.WindowGalaxy(dist=d) for d in lens], wins_k,
                wk_lens)

    def halo_models(self, cosmo: CosmoParams):
        """The halo model of every HOD (one, or one per lens bin) at
        z_pivot, on one mass-table build."""
        st = self.st
        z = torch.full((1,), self.z_pivot, dtype=st.dtype, device=st.device)
        return halo.build_halo_models(cosmo, self.halo_params, self.hods, z,
                                      st)

    def contraction_rows(self, cosmo: CosmoParams):
        """Kernel A's inputs as :meth:`spectra` launches it: [(mat rows,
        gal rows)], one pair a launch; with per-bin HODs, row b L + i is
        cosmology b with lens bin i's galaxy pack."""
        cosmo = _checked_batch(cosmo, self.st)
        models = self.halo_models(cosmo)
        if not self.per_bin:
            return [halo.contraction_nodes(cosmo, self.halo_params,
                                           models[0])]
        mat, gals, _ = halo.tomographic_nodes(cosmo, self.halo_params,
                                              models, self.st,
                                              with_cross=False)
        return [(m, g) for _i, m, g in halo.fold_rows(mat, gals)]

    def spectra(self, cosmo: CosmoParams):
        """(models, p_gg per lens bin, p_gm per lens bin, p_mm) on the k
        lattice: one kernel A launch for every lens bin's HOD."""
        st = self.st
        n_l = len(self.lens)
        models = self.halo_models(cosmo)
        if self.per_bin:
            p = limber_fft.p_lattice_tomographic(cosmo, self.halo_params,
                                                 models, st, with_cross=False)
            return (models, [p[("power_gg", i, i)] for i in range(n_l)],
                    [p[("power_gm", i)] for i in range(n_l)], p["power_mm"])
        p = limber_fft.p_lattice_halo_all(cosmo, self.halo_params, models[0],
                                          st)
        return (models, [p["power_gg"]] * n_l, [p["power_gm"]] * n_l,
                p["power_mm"])

    def probe_rows(self, cosmo: CosmoParams,
                   nuisance: Nuisance3x2pt | None = None):
        """(batch, batched nuisance point or None, halo models, rows): the
        probe rows (win_a, win_b, spectrum on the k lattice, operator
        indices) in the JAX order: w, gamma_t, xi (mu 0 and 4 of one
        convolution), then the magnification rows."""
        st = self.st
        cosmo = _checked_batch(cosmo, st)
        nu = None
        if self.with_nuisance:
            if nuisance is None:
                raise ValueError("with_nuisance=True: call pipe(cosmo, "
                                 "nuisance)")
            if any(v.dtype != st.dtype or v.device != st.device
                   for v in nuisance.fields().values()):
                raise ValueError(f"nuisance point is not {st.dtype} on "
                                 f"{st.device}, as this pipeline")
            nu = nuisance.batched(cosmo.batch)
        wins_g, wins_k, wk_lens = self.windows_at(nu)
        models, p_gg, p_gm, p_mm = self.spectra(cosmo)
        rows = ([(w, w, p_gg[i], [0]) for i, w in enumerate(wins_g)]
                + [(wk, wg, p_gm[i], [1]) for i, wg in enumerate(wins_g)
                   for wk in wins_k]
                + [(wins_k[j], wins_k[k], p_mm, [0, 2])
                   for j, k in self.pairs_xi])
        if wk_lens is not None:
            rows += [r for i in range(len(wins_g)) for r in
                     ((wins_g[i], wk_lens[i], p_gm[i], [0]),
                      (wk_lens[i], wk_lens[i], p_mm, [0]))]
            rows += [(wk, wk_lens[i], p_mm, [1]) for i in range(len(wins_g))
                     for wk in wins_k]
        return cosmo, nu, models, rows

    def conv_rows(self, cosmo, models, rows, j_lo: int, j_hi: int):
        """The grouped lattice convolution of ``rows`` over conv-output
        positions [j_lo, j_hi): (B, R, j_hi - j_lo), float64 sums."""
        g_rows = limber_fft._lattice_g_rows(
            cosmo, [(wa, wb) for wa, wb, _p, _s in rows], self.st,
            models[0].mass.growth)
        p_rows = torch.stack([p for _a, _b, p, _s in rows], dim=1)
        return limber_fft._conv_direct_rows(p_rows, g_rows, j_lo, j_hi)

    def forward(self, cosmo: CosmoParams, nuisance: Nuisance3x2pt | None = None
                ) -> dict:
        cosmo, nu, models, rows = self.probe_rows(cosmo, nuisance)
        n_l, n_s, n_xi = len(self.lens), len(self.src), len(self.pairs_xi)
        n_gt = n_l * n_s
        outs = _fused_probe_rows(
            lambda j_lo, j_hi: self.conv_rows(cosmo, models, rows, j_lo,
                                              j_hi),
            [r[3] for r in rows], self.operator)
        w_rows = [o[0] for o in outs[:n_l]]
        gt_rows = [o[0] for o in outs[n_l:n_l + n_gt]]
        xi = outs[n_l + n_gt:n_l + n_gt + n_xi]
        xip_rows, xim_rows = [o[0] for o in xi], [o[1] for o in xi]
        if self.include_magnification:
            # delta_obs = delta_g + c kappa, c = 2 (alpha - 1): each term
            # with its own spectrum.
            c = 2.0 * (nu.alpha_lens - 1.0)
            b0 = n_l + n_gt + n_xi
            w_rows = [w_rows[i] + 2.0 * c[:, i, None] * outs[b0 + 2 * i][0]
                      + c[:, i, None] ** 2 * outs[b0 + 2 * i + 1][0]
                      for i in range(n_l)]
            b1 = b0 + 2 * n_l
            gt_rows = [gt_rows[i * n_s + j]
                       + c[:, i, None] * outs[b1 + i * n_s + j][0]
                       for i in range(n_l) for j in range(n_s)]
        if nu is not None:
            cal = 1.0 + nu.m
            gt_rows = [gt_rows[i * n_s + j] * cal[:, j, None]
                       for i in range(n_l) for j in range(n_s)]
            xip_rows = [row * (cal[:, j] * cal[:, k])[:, None]
                        for (j, k), row in zip(self.pairs_xi, xip_rows)]
            xim_rows = [row * (cal[:, j] * cal[:, k])[:, None]
                        for (j, k), row in zip(self.pairs_xi, xim_rows)]
        return {
            "theta_deg": self.theta_deg,
            "w_theta": torch.stack(w_rows, dim=1),
            "gamma_t": torch.stack(gt_rows, dim=1),
            "xi_plus": torch.stack(xip_rows, dim=1),
            "xi_minus": torch.stack(xim_rows, dim=1),
            "n_g": (torch.stack([m.n_g for m in models], dim=1)
                    if self.per_bin else models[0].n_g),
            "vector": torch.cat(w_rows + gt_rows + xip_rows + xim_rows,
                                dim=-1),
        }


def _register_operators(mod: nn.Module, grid, device, dtype):
    """The composed lattice -> Hankel -> theta-bins operator of each mu in
    ``mod.mus`` as buffers ``op{i}_hi`` / ``op{i}_lo`` (float32: the hi/lo
    split of the float64 operator; float64: the operator, lo None), and
    their conv-output windows in ``mod.windows``."""
    mod.windows = []
    for i, mu in enumerate(mod.mus):
        j_lo, j_hi, a = limber_fft.wtheta_lattice_operator(mod.theta_key,
                                                           grid, mu)
        mod.windows.append((j_lo, j_hi))
        hi, lo = split_operator(a) if dtype == torch.float32 else (a, None)
        mod.register_buffer(f"op{i}_hi", torch.as_tensor(hi, device=device),
                            persistent=False)
        mod.register_buffer(f"op{i}_lo", None if lo is None else
                            torch.as_tensor(lo, device=device),
                            persistent=False)


def _operator(mod: nn.Module, i: int):
    j_lo, j_hi = mod.windows[i]
    return j_lo, j_hi, getattr(mod, f"op{i}_hi"), getattr(mod, f"op{i}_lo")


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
