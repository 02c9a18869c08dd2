"""Kernel A: the fused NFW-profile mass contraction of ``halo.powers``.

For every lattice k and mass node the NFW transform is evaluated in the
cancellation-free form N(x, c) = g(x) + sin(cx) fm((1+c)x) - cos(cx)
g((1+c)x), x = k r_s, and contracted against per-node weights into the
five halo-model integrals, without a (k, M) matrix in device memory:

    h_m   = sum_mat N_m wa            pp_mm = sum_mat N_m^2 wb
    h_g   = sum_gal N_g a_hg          pp_gg = sum_gal N_g a_gg + N_g^2 b_gg
    pp_gm = sum_gal N_m a_gm + N_m N_g b_gm

``mat`` (B, NM, 4) holds per mass-table node (rs, c, wa, wb); ``gal``
(B, NG, 9) per galaxy-pack node (rs_m, c_m, rs_g, c_g, a_hg, a_gg, b_gg,
a_gm, b_gm): the matter profile (feedback hooks folded into rs_m, c_m)
and the NFW galaxy profile, with 1/mu(c), the quadrature weight and the
Scranton y / y^2 select folded into the weights.  Output (B, 5, NK):
h_m, h_g, pp_mm, pp_gg, pp_gm.

Replaces the JAX package's ``ops/halo_pallas.py::fused_contractions`` and the
XLA contraction block of the JAX package's ``halo.py::powers``; the CUDA source
is ``chomp_tpu_torch/csrc/halo_contract.cu``.  :func:`halo_contract_ref`
is the plain PyTorch version of the same function.  Where b = (1+c)x <=
:data:`SMALL_B` the kernel evaluates N from its moment series instead
(:func:`moment_coeffs`, :func:`nfw_n_small` mirror that route).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import _special_coeffs as _cf
from chomp_tpu_torch.ops.build import device_index, load, raw_stream
from chomp_tpu_torch.special import _trim, n_g_asym, n_series, nfw_n

N_OUT = 5
MAT_FIELDS = 4
GAL_FIELDS = 9

# Packed Chebyshev/series table: must match the offsets in halo_contract.cu.
_TABLES = (("sici_a_fm", 0), ("sici_a_g", 32), ("sici_b_fm", 64),
           ("sici_b_g", 96))
_OFF_SI, _OFF_CI, _OFF_FMA, _OFF_GA, _N_PACK = 128, 144, 160, 168, 176


def cheb_table() -> np.ndarray:
    """The kernel's constant table (float64): the four Si/Ci auxiliary
    Chebyshev tables, the Si/Ci power-series coefficients, and the
    asymptotic fm and g coefficients, in the order of special.py."""
    t = np.zeros(_N_PACK)
    for name, off in _TABLES:
        coeffs = getattr(_cf, name)
        t[off:off + len(coeffs)] = coeffs
    for k in range(16):
        t[_OFF_SI + k] = (-1.0) ** k / ((2 * k + 1)
                                        * math.factorial(2 * k + 1))
        if k >= 1:
            t[_OFF_CI + k] = (-1.0) ** k / ((2 * k) * math.factorial(2 * k))
    for k in range(1, 7):
        t[_OFF_FMA + k] = (-1.0) ** k * math.factorial(2 * k)
    for k in range(7):
        t[_OFF_GA + k] = (-1.0) ** k * math.factorial(2 * k + 1)
    return t


def _lens(dtype) -> list[int]:
    """Terms kept per table (float32 trimming as special.py), then the
    series and asymptotic-g term counts."""
    probe = torch.zeros((), dtype=dtype)
    return ([len(_trim(getattr(_cf, name), probe)) for name, _ in _TABLES]
            + [n_series(dtype), n_g_asym(dtype)])


#: The kernel's small-argument route: b = (1+c)x <= SMALL_B.
SMALL_B = 4.0


def n_moments(dtype) -> int:
    """Moment-series terms of the small-argument route: 16 in float64
    (truncation below 4^32/33! = 2e-18 of mu(c)), 10 in float32 (2e-8)."""
    return 10 if dtype == torch.float32 else 16


def moment_coeffs(c, n_terms: int):
    """Coefficients a_n = (-1)^n M_n(c) / (2n+1)!, n < ``n_terms``, of the
    small-argument series N(x, c) = sum_n a_n x^2n, in float64 (..., n):
    M_n = I_(2n+1), I_m(c) = int_0^c t^m / (1+t)^2 dt by the recurrence
    I_m = c^(m-1)/(m-1) - 2 I_(m-1) - I_(m-2) from I_0 = c/(1+c) and
    I_1 = mu(c), the one the kernel runs per staged node."""
    c = c.double()
    i2 = c / (1.0 + c)
    i1 = torch.log1p(c) - i2
    pw, inv_fact, out = c, 1.0, [i1]
    for n in range(1, n_terms):
        for m in (2 * n, 2 * n + 1):
            i2, i1 = i1, pw * (1.0 / (m - 1)) - 2.0 * i1 - i2
            pw = pw * c
        inv_fact *= 1.0 / ((2 * n) * (2 * n + 1))
        out.append((-i1 if n % 2 else i1) * inv_fact)
    return torch.stack(out, dim=-1)


def nfw_n_small(x, coeffs):
    """N(x, c) = mu(c) y from the moment series (valid for (1+c)x <=
    :data:`SMALL_B`), Horner in x^2 in the dtype of ``x``: the kernel's
    small-argument route."""
    a = coeffs.to(x.dtype)
    x2 = x * x
    n = a[..., -1]
    for j in range(a.shape[-1] - 2, -1, -1):
        n = n * x2 + a[..., j]
    return n


_REF_K_BLOCK = 256


def halo_contract_ref(k, mat, gal):
    """Plain PyTorch version of the kernel (same inputs and output),
    evaluated in blocks of 256 k so that its (B, k, node) temporaries
    stay small at the main path's widths."""
    return torch.cat([_ref_block(k[i:i + _REF_K_BLOCK], mat, gal)
                      for i in range(0, max(len(k), 1), _REF_K_BLOCK)],
                     dim=-1)


def _ref_block(k, mat, gal):
    kk = k[None, :, None]
    n_m = nfw_n(kk * mat[:, None, :, 0], mat[:, None, :, 1])
    gm = gal[:, None, :, :]
    n_gm = nfw_n(kk * gm[..., 0], gm[..., 1])
    n_g = nfw_n(kk * gm[..., 2], gm[..., 3])

    def dot(n, w):
        return torch.matmul(n, w[..., None])[..., 0]

    return torch.stack([
        dot(n_m, mat[..., 2]),
        dot(n_g, gal[..., 4]),
        dot(n_m * n_m, mat[..., 3]),
        dot(n_g, gal[..., 5]) + dot(n_g * n_g, gal[..., 6]),
        dot(n_gm, gal[..., 7]) + dot(n_gm * n_g, gal[..., 8]),
    ], dim=1)


def _check(k, mat, gal, cheb):
    if k.dim() != 1 or mat.dim() != 3 or gal.dim() != 3:
        raise ValueError("halo_contract: need k (NK,), mat (B, NM, 4), "
                         "gal (B, NG, 9)")
    if mat.shape[-1] != MAT_FIELDS or gal.shape[-1] != GAL_FIELDS:
        raise ValueError(f"halo_contract: node fields must be {MAT_FIELDS} "
                         f"and {GAL_FIELDS}, got {mat.shape} and {gal.shape}")
    if mat.shape[0] != gal.shape[0]:
        raise ValueError("halo_contract: mat and gal batch sizes differ")
    ts = (k, mat, gal, cheb)
    if any(t.dtype != k.dtype for t in ts) or k.dtype not in (
            torch.float32, torch.float64):
        raise TypeError("halo_contract: k, mat, gal and the table must share "
                        "one dtype, float32 or float64")
    if any(t.device != k.device for t in ts):
        raise ValueError("halo_contract: all inputs must be on one device")
    if cheb.shape != (_N_PACK,):
        raise ValueError(f"halo_contract: table must have {_N_PACK} entries")


@lru_cache(maxsize=None)
def _lib():
    lib = load("halo_contract")
    lib.halo_contract_launch.restype = ctypes.c_int
    lib.halo_contract_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.halo_contract_error.restype = ctypes.c_char_p
    lib.halo_contract_error.argtypes = [ctypes.c_int]
    return lib


def halo_contract(k, mat, gal, cheb):
    """Kernel A on CUDA tensors; the plain version for CPU tensors.

    ``cheb`` is :func:`cheb_table` on the inputs' device and dtype (the
    kernel copies it to constant memory).  Forward only: a CUDA input
    that requires grad raises."""
    _check(k, mat, gal, cheb)
    if k.device.type == "cpu":
        return halo_contract_ref(k, mat, gal)
    if k.device.type != "cuda":
        raise ValueError(f"halo_contract: unsupported device {k.device}")
    if any(t.requires_grad for t in (k, mat, gal)):
        raise NotImplementedError(
            "halo_contract: the CUDA kernel is forward-only (backward "
            "kernel: ROADMAP queue 2, kernel A)")
    if not all(t.is_contiguous() for t in (k, mat, gal, cheb)):
        raise ValueError("halo_contract: inputs must be contiguous")
    lib = _lib()
    b, nm, ng, nk = mat.shape[0], mat.shape[1], gal.shape[1], k.shape[0]
    out = torch.empty((b, N_OUT, nk), dtype=k.dtype, device=k.device)
    if b == 0 or nk == 0:
        return out
    idx = device_index(k)
    rc = lib.halo_contract_launch(
        idx, int(k.dtype == torch.float64), k.data_ptr(), nk,
        mat.data_ptr(), nm, gal.data_ptr(), ng, out.data_ptr(), b,
        cheb.data_ptr(), *_lens(k.dtype), raw_stream(idx))
    if rc != 0:
        raise RuntimeError("halo_contract launch failed: "
                           + lib.halo_contract_error(rc).decode())
    halo_contract.launches += 1
    return out


halo_contract.launches = 0
