"""Batched w(theta) + gamma_t (+ xi_+-, + w_gk_cmb) pipelines: the lattice
and table routes, and the tomographic 3x2pt pipeline.

PyTorch counterpart of the JAX package's ``parallel/sweep.py``'s
``broadcast_cosmo`` and ``make_pipeline``: the fused lattice branch
(``method="fft"``, flat or curved, sweep.py:343-406, with
``_fused_probe_rows`` sweep.py:452-501), its exact-z mode
(``exact_z_anchors``, sweep.py:268-292 and 343-431) and the GL +
cubic-table branch (``method="table"``, sweep.py:303-306 and 407-411);
and of ``Nuisance3x2pt``, ``default_nuisance`` and
``make_tomographic_pipeline`` with its exact-z mode (sweep.py:35-63,
504-882).  Every
physics option of the JAX functions is carried: ``with_bao``,
``HaloParams.mass_fn``, ``matter_power``, ``include_cmb_lensing``,
``geometry="curved"``, ``nonlimber_ell_switch`` and ``nonlimber_rsd``.
Each pipeline is an ``nn.Module`` whose forward takes a batch of
cosmologies (:class:`~chomp_tpu_torch.params.CosmoParams` with ``(B,)``
fields) in place of ``jit(vmap(fn))``:

    fft:   halo model -> spectra on the k lattice (kernel A; in exact-z
           mode at the Chebyshev anchors, one launch over B x J rows) ->
           lattice window weights -> one grouped direct convolution for
           every probe row -> one compensated contraction per distinct
           operator (kernel C; flat Hankel or curved multipole sums) ->
           w, gamma_t, xi_+-, w_gk_cmb; then the additive non-Limber
           repair of w and gamma_t (FFTLog transfers, float64 sums);
    table: halo model -> ln P tables on the ln k table (kernel A) -> GL
           Limber C_ell per probe -> one Hankel + theta-binning product
           per output (kernel B) -> w, gamma_t, xi_+-, w_gk_cmb;
    tomographic: the fft route over every lens / source bin pair (per-bin
           HODs: one kernel A launch over B x n_lens rows; in exact-z
           mode over B x J x n_lens anchor rows), with the nuisance
           windows, the magnification and kappa_CMB rows and the shear
           calibration.

The static numpy operators live in module buffers, on the device and in
the dtype chosen at construction (float32 is the serving precision;
float64 is the reference mode).  Nothing is silently ignored: what the
JAX functions refuse, the port refuses.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
from torch import nn

from chomp_tpu_torch import (cmblens, correlation, curved, halo,
                             limber_fft, nonlimber, projection)
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


def _cmb_window(include_cmb_lensing, device, dtype):
    """The kappa_CMB window of ``include_cmb_lensing`` (True or a
    ``cmblens.CMBLensingSpec``), or None when it is False / None."""
    if include_cmb_lensing is False or include_cmb_lensing is None:
        return None
    return cmblens.as_cmb_spec(include_cmb_lensing).window(device=device,
                                                           dtype=dtype)


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
    ``xi_plus`` and ``xi_minus``, (with ``include_cmb_lensing``)
    ``w_gk_cmb``, each (B, n_theta).  Same arguments as the JAX
    ``make_pipeline``, plus the explicit ``device`` and ``dtype`` every
    buffer and output lives in.  ``method="fft"`` builds :class:`Pipeline`
    (the lattice route), ``method="table"`` :class:`TablePipeline` (the
    GL + cubic-table route).

    ``exact_z_anchors`` (e.g. 6-8; the lattice route only, as in the JAX
    package) drops the separable-growth approximation: every probe's
    halo model is expanded over that many Chebyshev redshift anchors on
    [1e-3, max(dist.z_max, 1)], a window fixed here, at construction
    (``dist.z_max`` must then be one value).  ``n_g`` still comes from
    the halo model at ``z_pivot``.

    The options, as in the JAX package: ``with_bao`` (the EH98 transfer
    with wiggles), ``halo_params.mass_fn = 1`` (Tinker), ``include_shear``
    (xi_+- of the source sample ``dist``), ``include_cmb_lensing`` (the
    kappa_CMB cross w_gk_cmb, one more convolution row),
    ``matter_power`` "halofit" / "linear" (the mm legs only),
    ``geometry="curved"`` (exact sphere multipole operators, lattice
    route), ``nonlimber_ell_switch`` (the additive exact low-ell repair
    of w and gamma_t; with ``exact_z_anchors`` it runs separably off one
    more pivot halo evaluation, a second kernel A launch) and
    ``nonlimber_rsd`` (the linear RSD term of the galaxy leg with it).
    The table route takes ``with_bao``, ``mass_fn`` and the kappa_CMB
    row, and refuses the lattice-only options as the JAX package does."""
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
    # As in the JAX make_pipeline, the anchors act on the lattice route
    # only: the table route ignores them (and skips the warning below).
    if not exact_z_anchors:
        _warn_if_separable_bias(dist, z_pivot)
    args = (halo_params, hod, dist, power_spec, theta_deg, z_pivot, grid,
            include_lensing, include_shear)
    kw = dict(with_bao=with_bao, include_cmb_lensing=include_cmb_lensing,
              device=device, dtype=dtype)
    if method == "table":
        return TablePipeline(*args, **kw)
    return Pipeline(*args, exact_z_anchors=exact_z_anchors,
                    geometry=geometry, matter_power=matter_power,
                    nonlimber_ell_switch=nonlimber_ell_switch,
                    nonlimber_rsd=nonlimber_rsd, **kw)


def _distinct(items):
    return tuple(dict.fromkeys(items))


class _PipelineBase(nn.Module):
    """What both routes share: the statics, the parameters, the windows,
    the theta bins and the probes on one device and dtype, fixed at
    construction (build a second pipeline for another precision), and
    the halo model at the pivot redshift.

    ``probes``: (win_a, win_b, spectrum kind, (((mu, stat), output key),
    ...)), w(theta) first; the shear row asks for two transforms of one
    C_ell.  ``specs``: the distinct operators (mu, stat) in order of
    first request (stat "xip" / "xim" on the curved route's shear row,
    else None); ``mus`` their Hankel orders."""

    def __init__(self, halo_params, hod, dist, power_spec, theta_deg,
                 z_pivot, grid, include_lensing, include_shear, *,
                 with_bao=False, include_cmb_lensing=False,
                 geometry="flat", device, dtype):
        super().__init__()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.st = Statics(grid, device=device, dtype=dtype,
                          with_bao=with_bao)
        self.halo_params = halo_params.to(device, dtype)
        self.hod = hod.to(device, dtype)
        self.dist = dist.to(device, dtype)
        self.power_spec = power_spec
        self.z_pivot = float(z_pivot)
        self.geometry = geometry
        self.include_lensing = bool(include_lensing)
        self.win_g = projection.WindowGalaxy(dist=self.dist)
        self.win_k = projection.WindowConvergence(dist=self.dist)
        self.win_kcmb = _cmb_window(include_cmb_lensing, device, dtype)
        if theta_deg is None:
            theta_deg = correlation.theta_bins_deg(grid)
        theta_np = np.asarray(theta_deg, dtype=np.float64)
        self.register_buffer("theta_deg", torch.as_tensor(
            theta_np, dtype=dtype, device=device), persistent=False)
        self.theta_key = tuple(theta_np.tolist())
        curved = geometry == "curved"
        self.probes = [(self.win_g, self.win_g, power_spec,
                        (((0.0, None), "w_theta"),))]
        if include_lensing:
            self.probes.append((self.win_k, self.win_g, "power_gm",
                                (((2.0, None), "gamma_t"),)))
        if include_shear:
            self.probes.append((self.win_k, self.win_k, "power_mm", (
                ((0.0, "xip" if curved else None), "xi_plus"),
                ((4.0, "xim" if curved else None), "xi_minus"))))
        if self.win_kcmb is not None:
            self.probes.append((self.win_g, self.win_kcmb, "power_gm",
                                (((0.0, None), "w_gk_cmb"),)))
        self.specs = _distinct(spec for *_p, specs in self.probes
                               for spec, _key in specs)
        self.mus = tuple(mu for mu, _stat in self.specs)
        self.kinds = _distinct(p[2] for p in self.probes)

    def halo_model(self, cosmo: CosmoParams):
        """(the batch with (B,) fields, the halo model at z_pivot); a batch
        of another dtype or device raises."""
        st = self.st
        cosmo = _checked_batch(cosmo, st)
        return cosmo, halo.build_halo_model(cosmo, self.halo_params,
                                            self.hod, self.z_pivot_t(), st)

    def z_pivot_t(self):
        st = self.st
        return torch.full((1,), self.z_pivot, dtype=st.dtype,
                          device=st.device)


class Pipeline(_PipelineBase):
    """The lattice route (``method="fft"``): w(theta) (+ gamma_t, + xi_+-,
    + w_gk_cmb) for a cosmology batch, flat or curved, separable-growth
    or, with ``exact_z_anchors``, with the halo model's exact redshift
    evolution, and the non-Limber repair (see :func:`make_pipeline`)."""

    def __init__(self, *args, exact_z_anchors=None, geometry="flat",
                 matter_power="halo", nonlimber_ell_switch=None,
                 nonlimber_rsd=False, device, dtype, **kw):
        super().__init__(*args, geometry=geometry, device=device,
                         dtype=dtype, **kw)
        grid = self.st.grid
        self.exact_z_anchors = int(exact_z_anchors or 0)
        self.matter_power = matter_power
        # The anchor window's top, read once here (the JAX make_pipeline
        # fixes it at build time too): forward never reads back to the
        # host.
        self.z_hi_anchor = (max(float(self.dist.z_max), 1.0)
                            if self.exact_z_anchors else None)
        _register_operators(self, grid, device, dtype)
        self.nonlimber = (_NonLimber(
            self, nonlimber_ell_switch, nonlimber_rsd,
            (0.0, 2.0) if self.include_lensing else (0.0,))
            if nonlimber_ell_switch else None)

    def operator(self, i: int):
        """(j_lo, j_hi, a_hi, a_lo) of the i-th operator (of
        ``self.specs``); ``a_lo`` is None in float64."""
        return _operator(self, i)

    def forward(self, cosmo: CosmoParams) -> dict:
        st = self.st
        cosmo, model = self.halo_model(cosmo)
        piv = model.mass.growth
        pairs = [(wa, wb) for wa, wb, _k, _s in self.probes]
        p_all = lat = None
        if self.exact_z_anchors:
            anchors = limber_fft.exact_z_anchor_spectra(
                cosmo, self.halo_params, self.hod, self.kinds,
                self.exact_z_anchors, 1e-3, self.z_hi_anchor, st,
                matter_power=self.matter_power)
            rows = [(wa, wb, kind) for wa, wb, kind, _s in self.probes]

            def conv(j_lo, j_hi):
                return limber_fft.exact_z_conv_rows(cosmo, anchors, rows, st,
                                                    j_lo, j_hi)
        else:
            p_all, h = self._separable_spectra(cosmo, model)
            lat = limber_fft.LatticeState(cosmo, st, piv)

            def conv(j_lo, j_hi):
                p_rows = torch.stack([p_all[kind] for _a, _b, kind, _s
                                      in self.probes], dim=1)
                return limber_fft._conv_direct_rows(p_rows, lat.g_rows(pairs),
                                                    j_lo, j_hi)

        specs = [[self.specs.index(spec) for spec, _key in s]
                 for *_p, s in self.probes]
        outs = _fused_probe_rows(conv, specs, self.operator)
        out = {"theta_deg": self.theta_deg, "n_g": model.n_g}
        for (*_p, s), vals in zip(self.probes, outs):
            out.update({key: v for (_spec, key), v in zip(s, vals)})
        if self.nonlimber is not None:
            if self.exact_z_anchors:
                # The correction runs separably, off one more pivot halo
                # evaluation (a second kernel A launch), as in the JAX
                # package.
                p_all, h = self._separable_spectra(cosmo, model)
                lat = limber_fft.LatticeState(cosmo, st, piv)
            for key, term in self._nonlimber_terms(model, p_all, h,
                                                   lat).items():
                out[key] = out[key] + term.to(st.dtype)
        return out

    def _separable_spectra(self, cosmo, model):
        """(spectra, (h_m, h_g)) on the k lattice at the pivot from one
        kernel A launch, with the mm row of ``matter_power`` where a
        probe reads it."""
        p_all, h = halo.powers_and_two_halo(cosmo, self.halo_params, model,
                                            self.st.lattice_k, self.st)
        if "power_mm" in self.kinds and self.matter_power != "halo":
            p_all = dict(p_all, power_mm=limber_fft.mm_override(
                cosmo, self.z_pivot_t(), self.matter_power, self.st))
        return p_all, h

    def _nonlimber_terms(self, model, p_all, h, lat):
        kk = self.nonlimber.lensing_kind
        rows = [(self.win_g, self.win_g, p_all[self.power_spec], ("d", "d"))]
        if self.include_lensing:
            rows.append((self.win_g, self.win_k, p_all["power_gm"],
                         ("d", kk)))
        d = self.nonlimber.delta(lat, model.mass.growth, rows,
                                 [h] * len(rows))
        return {key: self.nonlimber.term(d_r, key == "gamma_t")
                for key, d_r in zip(("w_theta", "gamma_t"), d)}

    def nonlimber_terms(self, cosmo: CosmoParams) -> dict:
        """The non-Limber corrections that forward adds to w_theta (and
        gamma_t), (B, n_theta) each in float64, before the rounding to
        the pipeline's dtype."""
        cosmo, model = self.halo_model(cosmo)
        return self._nonlimber_terms(
            model, *self._separable_spectra(cosmo, model),
            limber_fft.LatticeState(cosmo, self.st, model.mass.growth))


class TablePipeline(_PipelineBase):
    """The GL + cubic-table route (``method="table"``, the JAX
    sweep.py:303-306): per probe, a ln P table on the static ln k grid
    and the Gauss-Legendre Limber C_ell on the ell grid; per output, the
    fused Hankel + theta-binning operator applied by kernel B (the
    ``"pallas"`` engine of ``correlation.wtheta_from_cl_fused``, with the
    operators held as buffers).  ``halo.powers`` runs once per forward
    for every probe."""

    def __init__(self, *args, device, dtype, **kw):
        super().__init__(*args, device=device, dtype=dtype, **kw)
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
            for spec, key in specs:
                out[key] = hankel_matmul(
                    cl, getattr(self, f"op{self.specs.index(spec)}_t"))
        return out


class _NonLimber(nn.Module):
    """The non-Limber repair of a lattice pipeline: the node multipoles,
    the correction operators of w (mu 0) and gamma_t (mu 2) as float64
    buffers, and the RSD switch.  :meth:`delta` gives each row's dC (with
    the RSD term) at the nodes, :meth:`term` its correction of a row."""

    N_NODES = 20

    def __init__(self, mod, ell_switch: int, rsd: bool, mus):
        super().__init__()
        st = mod.st
        self.ell_switch = int(ell_switch)
        self.rsd = bool(rsd)
        self.ells = nonlimber.ell_nodes(self.ell_switch, self.N_NODES)
        self.lensing_kind = "k_E" if mod.geometry == "curved" else "k_flat"
        for mu in mus:
            op = nonlimber.correction_operator(
                mod.theta_key, float(mu), self.ell_switch, self.N_NODES,
                mod.geometry)
            self.register_buffer(f"op_mu{int(mu)}", torch.as_tensor(
                op, dtype=torch.float64, device=st.device), persistent=False)
        if self.rsd:
            # The RSD term takes h_m and h_g from the forward's own kernel
            # A launch on the k lattice: its k subset must be those
            # lattice nodes bit for bit.
            _kern, i_lo, n_use, _npad = nonlimber._nl_static(
                limber_fft._lattice_key(st.grid),
                tuple(self.ells.tolist()), "d", nonlimber.K_LO_CUT,
                nonlimber.K_HI_CUT)
            ln_k, _ = limber_fft._lattices(st.grid)
            if not np.array_equal(np.exp(ln_k)[i_lo:i_lo + n_use],
                                  np.exp(ln_k[i_lo:i_lo + n_use])):
                raise RuntimeError("non-Limber k subset is not the lattice's "
                                   "k bit for bit")

    def delta(self, lat, piv, rows, h):
        """dC (+ the RSD term) at the nodes, (B, L) float64, for each row
        (win_g, win_b, p_lattice, (kind_g, kind_b)) of ``rows``; ``h``:
        per row, the (h_m, h_g) on the k lattice of the row's galaxy
        sample."""
        nl = nonlimber.Corrections(lat, self.ells)
        d = nl.delta(rows)
        if self.rsd:
            p_lin = nl.p_lin(piv)
            d = [dr + nl.rsd(wg, wb, kinds[1], h_m, h_g, p_lin)
                 for dr, (wg, wb, _p, kinds), (h_m, h_g) in zip(d, rows, h)]
        return d

    def term(self, d, lensing: bool):
        """The correction operator of w (mu 0) or gamma_t (mu 2) on ``d``
        (B, L): (B, n_theta) float64."""
        return d @ (self.op_mu2 if lensing else self.op_mu0).T


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
    with ``include_cmb_lensing`` ``w_gk_cmb`` (B, n_lens, n_theta), ``n_g``
    ((B,), or (B, n_lens) with per-bin HODs) and ``vector`` (B, n_data):
    the w, gamma_t, xi_+, xi_- (and w_gk_cmb) rows concatenated in that
    order, the JAX package's ``covariance.tomographic_probes`` order.
    Same arguments as the JAX ``make_tomographic_pipeline``, plus the
    explicit ``device`` and ``dtype``.

    ``hod`` is one HOD shared by every lens bin or a list of one HOD per
    lens bin (one mass-table build, and every bin's galaxy pack in one
    kernel A launch).

    ``exact_z_anchors`` (e.g. 6-10) drops the separable-growth
    approximation for every bin pair: each lens bin's gg and gm spectra
    and the shared mm are expanded over that many Chebyshev redshift
    anchors on [1e-3, max(1, every bin's z_max)], a window fixed here, at
    construction (each z_max must be one value).  The anchors' halo
    models are one model over B x J rows (per-bin HODs: every bin's
    galaxy pack folded in, one kernel A launch over B x J x n_lens rows),
    and every probe row rides one J-channel convolution.  The halo
    models at ``z_pivot`` still give ``n_g`` and the separable pieces of
    the non-Limber repair (a second kernel A launch).  Not combinable
    with ``with_nuisance``, as in the JAX package.

    ``with_nuisance``: per-bin photo-z shifts, shear
    calibration and NLA intrinsic alignments from a
    :class:`Nuisance3x2pt`; ``include_magnification`` (needs it) adds the
    lens magnification rows with slopes alpha.  Every probe row, the
    magnification and kappa_CMB rows included, rides one grouped
    convolution and one kernel C launch per distinct operator (flat: mu
    = 0, 2, 4; curved: P_l, d^l_20, d^l_22, d^l_2-2).  ``with_bao``,
    ``halo_params.mass_fn``, ``matter_power`` (the mm legs: xi_+-, the
    magnification mm rows and their kappa_CMB crosses),
    ``nonlimber_ell_switch`` / ``nonlimber_rsd`` (every w and gamma_t row,
    before the shear calibration) and ``geometry`` act as in
    :func:`make_pipeline`."""
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
    if not exact_z_anchors:
        for d in (*lens_dists, *src_dists):
            _warn_if_separable_bias(d, z_pivot)
    return TomographicPipeline(
        halo_params, hod, lens_dists, src_dists, theta_deg, z_pivot, grid,
        with_nuisance, include_magnification, with_bao=with_bao,
        geometry=geometry, exact_z_anchors=exact_z_anchors,
        include_cmb_lensing=include_cmb_lensing,
        nonlimber_ell_switch=nonlimber_ell_switch,
        nonlimber_rsd=nonlimber_rsd, matter_power=matter_power,
        device=device, dtype=dtype)


class TomographicPipeline(nn.Module):
    """The JAX ``make_tomographic_pipeline`` (sweep.py:504-882; see
    :func:`make_tomographic_pipeline`), separable or exact-z.
    Parameters, dN/dz, windows, theta bins and the operators live on one
    device and dtype, fixed at construction."""

    def __init__(self, halo_params, hod, lens_dists, src_dists, theta_deg,
                 z_pivot, grid, with_nuisance, include_magnification, *,
                 with_bao=False, geometry="flat", exact_z_anchors=None,
                 include_cmb_lensing=False, nonlimber_ell_switch=None,
                 nonlimber_rsd=False, matter_power="halo", device, dtype):
        super().__init__()
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.st = Statics(grid, device=device, dtype=dtype,
                          with_bao=with_bao)
        self.halo_params = halo_params.to(device, dtype)
        self.per_bin = isinstance(hod, (list, tuple))
        self.hods = [h.to(device, dtype)
                     for h in (hod if self.per_bin else [hod])]
        self.lens = [d.to(device, dtype) for d in lens_dists]
        self.src = [d.to(device, dtype) for d in src_dists]
        self.z_pivot = float(z_pivot)
        self.with_nuisance = bool(with_nuisance)
        self.include_magnification = bool(include_magnification)
        self.geometry = geometry
        self.matter_power = matter_power
        self.exact_z_anchors = int(exact_z_anchors or 0)
        # The anchor window's top, read once here (the JAX function fixes
        # it at build time too): forward never reads back to the host.
        self.z_hi_anchor = (max(1.0, *(float(d.z_max)
                                       for d in (*self.lens, *self.src)))
                            if self.exact_z_anchors else None)
        self.wins_g = [projection.WindowGalaxy(dist=d) for d in self.lens]
        self.wins_k = [projection.WindowConvergence(dist=d) for d in self.src]
        self.win_kcmb = _cmb_window(include_cmb_lensing, device, dtype)
        n_src = len(self.src)
        self.pairs_xi = [(j, k) for j in range(n_src)
                         for k in range(j, n_src)]
        if theta_deg is None:
            theta_deg = correlation.theta_bins_deg(grid)
        theta_np = np.asarray(theta_deg, dtype=np.float64)
        self.register_buffer("theta_deg", torch.as_tensor(
            theta_np, dtype=dtype, device=device), persistent=False)
        self.theta_key = tuple(theta_np.tolist())
        # Operator i of each probe kind: w (and every mu = 0 row), gamma_t,
        # then xi_+ and xi_-.
        self.specs = (((0.0, None), (2.0, None), (0.0, "xip"), (4.0, "xim"))
                      if geometry == "curved" else
                      ((0.0, None), (2.0, None), (4.0, None)))
        self.mus = tuple(mu for mu, _stat in self.specs)
        self.ops_xi = [2, 3] if geometry == "curved" else [0, 2]
        _register_operators(self, grid, device, dtype)
        self.nonlimber = (_NonLimber(self, nonlimber_ell_switch,
                                     nonlimber_rsd, (0.0, 2.0))
                          if nonlimber_ell_switch else None)

    def operator(self, i: int):
        """(j_lo, j_hi, a_hi, a_lo) of the i-th operator (of
        ``self.specs``); ``a_lo`` is None in float64."""
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

    def z_pivot_t(self):
        st = self.st
        return torch.full((1,), self.z_pivot, dtype=st.dtype,
                          device=st.device)

    def halo_models(self, cosmo: CosmoParams):
        """The halo model of every HOD (one, or one per lens bin) at
        z_pivot, on one mass-table build."""
        return halo.build_halo_models(cosmo, self.halo_params, self.hods,
                                      self.z_pivot_t(), self.st)

    def contraction_rows(self, cosmo: CosmoParams):
        """Kernel A's inputs as :meth:`spectra` launches it: [(mat rows,
        gal rows)], one pair a launch; with per-bin HODs, row b L + i is
        cosmology b with lens bin i's galaxy pack.  In exact-z mode the
        rows are the anchors' (cosmology b at anchor j is row b J + j;
        per-bin HODs: row (b J + j) L + i)."""
        cosmo = _checked_batch(cosmo, self.st)
        hp = self.halo_params
        if self.exact_z_anchors:
            cosmo, hp, models, *_z = limber_fft.exact_z_anchor_models(
                cosmo, hp, self.hods if self.per_bin else self.hods[0],
                self.exact_z_anchors, 1e-3, self.z_hi_anchor, self.st)
        else:
            models = self.halo_models(cosmo)
        if not self.per_bin:
            return [halo.contraction_nodes(cosmo, hp, models[0])]
        mat, gals, _ = halo.tomographic_nodes(cosmo, hp, models, self.st,
                                              with_cross=False)
        return [(m, g) for _i, m, g in halo.fold_rows(mat, gals)]

    def anchors(self, cosmo: CosmoParams):
        """The exact-z anchor spectra (:func:`~chomp_tpu_torch.limber_fft.
        exact_z_anchor_spectra`) of every lens bin's HOD: one kernel A
        launch over B x J (x n_lens with per-bin HODs) rows, the mm row of
        ``matter_power`` at the anchors."""
        return limber_fft.exact_z_anchor_spectra(
            cosmo, self.halo_params,
            self.hods if self.per_bin else self.hods[0],
            ("power_gg", "power_gm", "power_mm"), self.exact_z_anchors,
            1e-3, self.z_hi_anchor, self.st, matter_power=self.matter_power)

    def spectra(self, cosmo: CosmoParams):
        """(models, p_gg per lens bin, p_gm per lens bin, p_mm, h, anchors):
        the halo models at z_pivot and the spectra the probe rows read.
        Separable: on the k lattice at the pivot, (B, n_k) each, from one
        kernel A launch for every lens bin's HOD; ``p_mm`` is
        ``matter_power``'s; ``h`` is (h_m, [h_g per lens bin]), the
        two-halo integrals of that launch; ``anchors`` None.  Exact-z: each
        at the anchors, (B, J, n_k), from :meth:`anchors` (returned too),
        and ``h`` None."""
        models = self.halo_models(cosmo)
        if self.exact_z_anchors:
            anchors = self.anchors(cosmo)
            p = anchors["p_j"]
            n_l = len(self.lens)
            if self.per_bin:
                p_gg = [p[("power_gg", i, i)] for i in range(n_l)]
                p_gm = [p[("power_gm", i)] for i in range(n_l)]
            else:
                p_gg, p_gm = [p["power_gg"]] * n_l, [p["power_gm"]] * n_l
            return models, p_gg, p_gm, p["power_mm"], None, anchors
        return (models, *self.pivot_spectra(cosmo, models), None)

    def pivot_spectra(self, cosmo: CosmoParams, models, with_mm=True):
        """(p_gg per lens bin, p_gm per lens bin, p_mm or None, h) on the k
        lattice at the pivot (see :meth:`spectra`), from one kernel A
        launch."""
        st = self.st
        n_l = len(self.lens)
        if self.per_bin:
            p, h = halo.tomographic_powers_and_two_halo(
                cosmo, self.halo_params, models, st.lattice_k, st,
                with_cross=False)
            p_gg = [p[("power_gg", i, i)] for i in range(n_l)]
            p_gm = [p[("power_gm", i)] for i in range(n_l)]
        else:
            p, (h_m, h_g) = halo.powers_and_two_halo(
                cosmo, self.halo_params, models[0], st.lattice_k, st)
            p_gg, p_gm = [p["power_gg"]] * n_l, [p["power_gm"]] * n_l
            h = (h_m, [h_g] * n_l)
        p_mm = (None if not with_mm else p["power_mm"]
                if self.matter_power == "halo" else
                limber_fft.mm_override(cosmo, self.z_pivot_t(),
                                       self.matter_power, st))
        return p_gg, p_gm, p_mm, h

    def probe_rows(self, cosmo: CosmoParams,
                   nuisance: Nuisance3x2pt | None = None):
        """(batch, batched nuisance point or None, halo models, rows, the
        windows, spectra and anchors): the probe rows (win_a, win_b,
        spectrum on the k lattice, or at the anchors in exact-z mode,
        operator indices) in the JAX order: w, gamma_t, xi (xi_+ and xi_-
        of one convolution), the magnification rows, then the kappa_CMB
        rows (and their magnification rows)."""
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
        models, p_gg, p_gm, p_mm, h, anchors = self.spectra(cosmo)
        n_l = len(wins_g)
        rows = ([(w, w, p_gg[i], [0]) for i, w in enumerate(wins_g)]
                + [(wk, wg, p_gm[i], [1]) for i, wg in enumerate(wins_g)
                   for wk in wins_k]
                + [(wins_k[j], wins_k[k], p_mm, self.ops_xi)
                   for j, k in self.pairs_xi])
        if wk_lens is not None:
            rows += [r for i in range(n_l) for r in
                     ((wins_g[i], wk_lens[i], p_gm[i], [0]),
                      (wk_lens[i], wk_lens[i], p_mm, [0]))]
            rows += [(wk, wk_lens[i], p_mm, [1]) for i in range(n_l)
                     for wk in wins_k]
        if self.win_kcmb is not None:
            rows += [(wins_g[i], self.win_kcmb, p_gm[i], [0])
                     for i in range(n_l)]
            if wk_lens is not None:
                rows += [(wk_lens[i], self.win_kcmb, p_mm, [0])
                         for i in range(n_l)]
        return cosmo, nu, models, rows, (wins_g, wins_k, p_gg, p_gm, h,
                                         anchors)

    def _nonlimber_terms(self, lat, models, wins_g, wins_k, p_gg, p_gm, h):
        """The corrections of the w rows, then the gamma_t rows (lens-major),
        (B, n_theta) float64 each."""
        kk = self.nonlimber.lensing_kind
        h_m, h_g = h
        n_l, n_s = len(wins_g), len(wins_k)
        rows = ([(wins_g[i], wins_g[i], p_gg[i], ("d", "d"))
                 for i in range(n_l)]
                + [(wins_g[i], wins_k[j], p_gm[i], ("d", kk))
                   for i in range(n_l) for j in range(n_s)])
        hs = ([(h_m, h_g[i]) for i in range(n_l)]
              + [(h_m, h_g[i]) for i in range(n_l) for _j in range(n_s)])
        d = self.nonlimber.delta(lat, models[0].mass.growth, rows, hs)
        return [self.nonlimber.term(d_r, r >= n_l) for r, d_r in enumerate(d)]

    def nonlimber_terms(self, cosmo: CosmoParams,
                        nuisance: Nuisance3x2pt | None = None) -> dict:
        """The non-Limber corrections that forward adds (before the shear
        calibration): {"w_theta": (B, n_lens, n_theta), "gamma_t": (B,
        n_lens n_src, n_theta)}, float64."""
        cosmo, _nu, models, _rows, (wins_g, wins_k, p_gg, p_gm, h,
                                    anchors) = self.probe_rows(cosmo,
                                                               nuisance)
        if anchors is not None:
            p_gg, p_gm, _mm, h = self.pivot_spectra(cosmo, models,
                                                    with_mm=False)
        terms = self._nonlimber_terms(self.lattice(cosmo, models), models,
                                      wins_g, wins_k, p_gg, p_gm, h)
        n_l = len(wins_g)
        return {"w_theta": torch.stack(terms[:n_l], dim=1),
                "gamma_t": torch.stack(terms[n_l:], dim=1)}

    def lattice(self, cosmo: CosmoParams, models):
        """The forward's :class:`~chomp_tpu_torch.limber_fft.LatticeState`
        (separable growth at the pivot)."""
        return limber_fft.LatticeState(cosmo, self.st,
                                       models[0].mass.growth)

    def conv_rows(self, cosmo, models, rows, j_lo: int, j_hi: int,
                  lat=None, anchors=None):
        """The grouped lattice convolution of ``rows`` over conv-output
        positions [j_lo, j_hi): (B, R, j_hi - j_lo), float64 sums; with
        ``anchors`` (exact-z) the J-channel anchored convolution."""
        if anchors is not None:
            return limber_fft.exact_z_conv_rows(
                cosmo, anchors, [(wa, wb, p) for wa, wb, p, _s in rows],
                self.st, j_lo, j_hi)
        lat = lat or self.lattice(cosmo, models)
        g_rows = lat.g_rows([(wa, wb) for wa, wb, _p, _s in rows])
        p_rows = torch.stack([p for _a, _b, p, _s in rows], dim=1)
        return limber_fft._conv_direct_rows(p_rows, g_rows, j_lo, j_hi)

    def forward(self, cosmo: CosmoParams, nuisance: Nuisance3x2pt | None = None
                ) -> dict:
        cosmo, nu, models, rows, (wins_g, wins_k, p_gg, p_gm, h,
                                  anchors) = self.probe_rows(cosmo, nuisance)
        n_l, n_s, n_xi = len(self.lens), len(self.src), len(self.pairs_xi)
        n_gt = n_l * n_s
        lat = self.lattice(cosmo, models) if anchors is None else None
        outs = _fused_probe_rows(
            lambda j_lo, j_hi: self.conv_rows(cosmo, models, rows, j_lo,
                                              j_hi, lat, anchors),
            [r[3] for r in rows], self.operator)
        w_rows = [o[0] for o in outs[:n_l]]
        gt_rows = [o[0] for o in outs[n_l:n_l + n_gt]]
        xi = outs[n_l + n_gt:n_l + n_gt + n_xi]
        xip_rows, xim_rows = [o[0] for o in xi], [o[1] for o in xi]
        i_cmb = n_l + n_gt + n_xi
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
            i_cmb = b1 + n_gt
        tail = []
        if self.win_kcmb is not None:
            tail = [outs[i_cmb + i][0] for i in range(n_l)]
            if self.include_magnification:
                tail = [tail[i] + c[:, i, None] * outs[i_cmb + n_l + i][0]
                        for i in range(n_l)]
        if self.nonlimber is not None:
            # The exact low-ell repair of every w and gamma_t row, before
            # the (1+m) calibration; the xi, magnification and kappa_CMB
            # rows keep plain Limber, as in the JAX package.  In exact-z
            # mode it runs separably, off one more pivot evaluation (a
            # second kernel A launch).
            if anchors is not None:
                p_gg, p_gm, _mm, h = self.pivot_spectra(cosmo, models,
                                                        with_mm=False)
                lat = self.lattice(cosmo, models)
            terms = self._nonlimber_terms(lat, models, wins_g, wins_k, p_gg,
                                          p_gm, h)
            dtype = self.st.dtype
            w_rows = [w + t.to(dtype) for w, t in zip(w_rows, terms[:n_l])]
            gt_rows = [g + t.to(dtype) for g, t in zip(gt_rows, terms[n_l:])]
        if nu is not None:
            cal = 1.0 + nu.m
            gt_rows = [gt_rows[i * n_s + j] * cal[:, j, None]
                       for i in range(n_l) for j in range(n_s)]
            xip_rows = [row * (cal[:, j] * cal[:, k])[:, None]
                        for (j, k), row in zip(self.pairs_xi, xip_rows)]
            xim_rows = [row * (cal[:, j] * cal[:, k])[:, None]
                        for (j, k), row in zip(self.pairs_xi, xim_rows)]
        out = {
            "theta_deg": self.theta_deg,
            "w_theta": torch.stack(w_rows, dim=1),
            "gamma_t": torch.stack(gt_rows, dim=1),
            "xi_plus": torch.stack(xip_rows, dim=1),
            "xi_minus": torch.stack(xim_rows, dim=1),
            "n_g": (torch.stack([m.n_g for m in models], dim=1)
                    if self.per_bin else models[0].n_g),
        }
        if tail:
            out["w_gk_cmb"] = torch.stack(tail, dim=1)
        out["vector"] = torch.cat(w_rows + gt_rows + xip_rows + xim_rows
                                  + tail, dim=-1)
        return out


def _register_operators(mod: nn.Module, grid, device, dtype):
    """The composed lattice -> Hankel (flat) or multipole-sum (curved) ->
    theta operator of each (mu, stat) in ``mod.specs`` as buffers
    ``op{i}_hi`` / ``op{i}_lo`` (float32: the hi/lo split of the float64
    operator; float64: the operator, lo None), and their conv-output
    windows in ``mod.windows``.  The operators are built once here."""
    mod.windows = []
    for i, (mu, stat) in enumerate(mod.specs):
        if mod.geometry == "curved":
            j_lo, j_hi, a = curved.curved_lattice_operator(
                mod.theta_key, grid, mu, stat=stat)
        else:
            j_lo, j_hi, a = limber_fft.wtheta_lattice_operator(
                mod.theta_key, grid, mu)
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
