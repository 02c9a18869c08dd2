"""Conversion of parameters between the JAX package and the port.

The inputs are any objects (or mappings) carrying the JAX package's
field names with array-like values — a JAX-package pytree dataclass
works as is, since ``np.asarray`` reads its leaves — so this module
needs no jax.  :func:`to_numpy` goes the other way, to a dict of numpy
arrays that the JAX package's constructors accept as keywords.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chomp_tpu_torch.cmblens import CMBLensingSpec
from chomp_tpu_torch.hod import (HODKravtsov, HODMandelbaum, HODPoisson,
                                 HODZheng)
from chomp_tpu_torch.parallel.sweep import Nuisance3x2pt
from chomp_tpu_torch.params import CosmoParams, HaloParams
from chomp_tpu_torch.projection import (DNdzGaussian, DNdzInterpolation,
                                        DNdzMagLim, DNdzShifted, PowerTable)


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _convert(cls, src, device, dtype):
    return cls(**{f.name: torch.as_tensor(np.array(_get(src, f.name),
                                                   dtype=np.float64),
                                          dtype=dtype, device=device)
                  for f in dataclasses.fields(cls)})


def cosmo_params(src, *, device, dtype) -> CosmoParams:
    """CosmoParams (all 14 leaves) from a JAX-package CosmoParams."""
    return _convert(CosmoParams, src, device, dtype)


def cosmo_batch(src, *, device, dtype) -> CosmoParams:
    """A cosmology batch: every field broadcast to one ``(B,)`` shape."""
    return cosmo_params(src, device=device, dtype=dtype).batched()


def halo_params(src, *, device, dtype) -> HaloParams:
    """HaloParams from a JAX-package HaloParams, ``mass_fn`` (0
    Sheth-Tormen, 1 Tinker) included."""
    return _convert(HaloParams, src, device, dtype)


def hod_zheng(src, *, device, dtype) -> HODZheng:
    return _convert(HODZheng, src, device, dtype)


_HODS = {cls.__name__: cls for cls in (HODZheng, HODPoisson, HODMandelbaum,
                                       HODKravtsov)}


def hod(src, *, device, dtype):
    """Any of the JAX package's four HOD families, by its class name (a
    mapping of Zheng's fields converts as Zheng)."""
    cls = HODZheng if isinstance(src, dict) else _HODS.get(
        type(src).__name__)
    if cls is None:
        raise TypeError(f"no converter for {type(src).__name__}")
    return _convert(cls, src, device, dtype)


def dndz_gaussian(src, *, device, dtype) -> DNdzGaussian:
    return _convert(DNdzGaussian, src, device, dtype)


def hod_list(srcs, *, device, dtype) -> list:
    """Per-lens-bin HODs from a list of JAX-package HODs of any mix of
    families (:func:`hod`)."""
    return [hod(h, device=device, dtype=dtype) for h in srcs]


def dndz_maglim(src, *, device, dtype) -> DNdzMagLim:
    return _convert(DNdzMagLim, src, device, dtype)


def dndz_interpolation(src, *, device, dtype) -> DNdzInterpolation:
    return _convert(DNdzInterpolation, src, device, dtype)


def dndz_shifted(src, *, device, dtype) -> DNdzShifted:
    """DNdzShifted from a JAX-package DNdzShifted; its base is converted
    by :func:`dndz`."""
    return DNdzShifted(base=dndz(_get(src, "base"), device=device,
                                 dtype=dtype),
                       dz=torch.as_tensor(np.array(_get(src, "dz"),
                                                   dtype=np.float64),
                                          dtype=dtype, device=device))


def dndz(src, *, device, dtype):
    """Any of the JAX package's dN/dz objects, by its class name."""
    conv = {"DNdzGaussian": dndz_gaussian, "DNdzMagLim": dndz_maglim,
            "DNdzInterpolation": dndz_interpolation,
            "DNdzShifted": dndz_shifted}.get(type(src).__name__)
    if conv is None:
        raise TypeError(f"no converter for {type(src).__name__}")
    return conv(src, device=device, dtype=dtype)


def nuisance_3x2pt(src, *, device, dtype) -> Nuisance3x2pt:
    """Nuisance3x2pt from a JAX-package Nuisance3x2pt (a vmapped one
    keeps its leading batch axis)."""
    return _convert(Nuisance3x2pt, src, device, dtype)


def power_table(src, *, device, dtype) -> PowerTable:
    """PowerTable from a JAX-package PowerTable (one table, ``ln_p``
    (n_k_table,), or a vmapped batch, (B, n_k_table)): ``ln_p`` becomes
    (B, n_k_table), ``growth_pivot`` (B,) or 0-d, and the grid's
    ``ln_k0`` / ``dln`` (repeated per row by vmap) 0-d."""
    table = _convert(PowerTable, src, device, dtype)
    return dataclasses.replace(table, ln_k0=table.ln_k0.reshape(-1)[0],
                               dln=table.dln.reshape(-1)[0],
                               ln_p=torch.atleast_2d(table.ln_p))


def cmb_spec(src) -> CMBLensingSpec:
    """CMBLensingSpec (the pipelines' ``include_cmb_lensing``) from a JAX
    CMBLensingSpec: z_star, z_support and the noise table, if any."""
    if src._ln_l is None:
        return CMBLensingSpec(src.z_star, src.z_support)
    return CMBLensingSpec(src.z_star, src.z_support,
                          nl_ell=np.exp(np.asarray(src._ln_l)),
                          nl=np.exp(np.asarray(src._ln_n)))


def disc_mask(src):
    """DiscMask from a JAX-package DiscMask (numpy geometry: no device)."""
    from chomp_tpu_torch.mask import DiscMask

    return DiscMask(float(src.radius))


def uniform_mask(src):
    """UniformMask from a JAX-package UniformMask."""
    from chomp_tpu_torch.mask import UniformMask

    return UniformMask(float(src.omega_s_sr))


def pixel_mask(src):
    """PixelMask from a JAX-package PixelMask: the FFT-derived areas,
    pair functions, mask-power shells and the content hash are copied
    (the map itself is not kept by either class)."""
    from chomp_tpu_torch.mask import PixelMask

    return _copy_state(PixelMask, src)


def spherical_cap_mask(src):
    """SphericalCapMask from a JAX-package SphericalCapMask."""
    from chomp_tpu_torch.curved import SphericalCapMask

    return SphericalCapMask(float(src.radius_rad))


def uniform_sphere_mask(src):
    """UniformSphereMask from a JAX-package UniformSphereMask."""
    from chomp_tpu_torch.curved import UniformSphereMask

    return UniformSphereMask()


def _copy_state(cls, src):
    """An instance of ``cls`` carrying ``src``'s attributes (numpy arrays
    copied): the curved masks keep their numpy geometry and content hash
    in plain attributes, identical in both packages."""
    out = cls.__new__(cls)
    out.__dict__.update({k: (np.array(v, dtype=np.float64)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in vars(src).items()})
    return out


def profile_curved_mask(src):
    """ProfileCurvedMask from a JAX-package ProfileCurvedMask: its
    Legendre coefficients, areas, Parseval scale and hash."""
    from chomp_tpu_torch.curved import ProfileCurvedMask

    return _copy_state(ProfileCurvedMask, src)


def pixel_sphere_mask(src):
    """PixelSphereMask from a JAX-package PixelSphereMask: the ring-pair
    pair functions, areas, grid size and content hash (the map itself is
    not kept by either class)."""
    from chomp_tpu_torch.curved import PixelSphereMask

    return _copy_state(PixelSphereMask, src)


def mask(src):
    """Any of the JAX package's flat-sky or curved masks, by its class
    name."""
    conv = {"DiscMask": disc_mask, "UniformMask": uniform_mask,
            "PixelMask": pixel_mask, "SphericalCapMask": spherical_cap_mask,
            "UniformSphereMask": uniform_sphere_mask,
            "ProfileCurvedMask": profile_curved_mask,
            "PixelSphereMask": pixel_sphere_mask}.get(type(src).__name__)
    if conv is None:
        raise TypeError(f"no converter for {type(src).__name__}")
    return conv(src)


def emulator(src, *, device, dtype):
    """An :class:`~chomp_tpu_torch.emulator.Emulator` with a JAX-package
    ``Emulator``'s weights, scalings and basis: the two compute the same
    ``emu(p)``."""
    from chomp_tpu_torch.emulator import Emulator

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype,
                               device=device)

    return Emulator([(t(w), t(b)) for w, b in src.weights],
                    *(t(getattr(src, name)) for name in
                      ("x_mu", "x_sd", "y_mu", "basis", "c_sd")))


def to_numpy(params) -> dict:
    """Field name -> float64 numpy array, for any of the port's
    parameter dataclasses."""
    return {f.name: getattr(params, f.name).detach().cpu().numpy().astype(
        np.float64) for f in dataclasses.fields(params)}
