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
Scranton y / y^2 select folded into the weights.  ``k`` is (NK,), shared
by every row, or (B, NK), a k row per cosmology row (the Gauss-Legendre
exact-z C_ell evaluates each projection node at its own k).  Output (B, 5,
NK): h_m, h_g, pp_mm, pp_gg, pp_gm.

Replaces the JAX package's ``ops/halo_pallas.py::fused_contractions`` and the
XLA contraction block of the JAX package's ``halo.py::powers``; the CUDA source
is ``chomp_tpu_torch/csrc/halo_contract.cu``.  :func:`halo_contract_ref`
is the plain PyTorch version of the same function.  Where b = (1+c)x <=
:data:`SMALL_B` the kernel evaluates N from its moment series instead
(:func:`moment_coeffs`, :func:`nfw_n_small` mirror that route).

Gradients: :func:`halo_contract` is differentiable in ``mat``, ``gal``
and ``k`` (the table is static).  Its backward is a second kernel of the
same source (:func:`halo_contract_bwd`; plain version
:func:`halo_contract_bwd_ref`, the same formulas and routes in torch),
which recomputes N and its derivatives from the saved node arrays, and
gives grad_k, when it is asked for, from the same dN/dx.  The JAX package
has no backward kernel: its gradients are autodiff of the XLA path, which
autograd of :func:`halo_contract_ref` reproduces.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch import _special_coeffs as _cf
from chomp_tpu_torch.ops.build import device_index, load, raw_stream
from chomp_tpu_torch.special import (_trim, aux_fm, aux_g, n_g_asym,
                                     n_series, nfw_n)

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


def dc_coeffs(c, n_terms: int):
    """Coefficients e_n = (-1)^n c^(2n+1) / ((2n+1)! (1+c)^2), n <
    ``n_terms``, of the small-argument series dN/dc = c sinc(cx) / (1+c)^2
    = sum_n e_n x^2n (|cx| < 4 where b = (1+c)x <= :data:`SMALL_B`), in
    float64 (..., n), by e_n = -c^2 e_(n-1) / ((2n)(2n+1)): the recurrence
    the backward kernel runs per staged node."""
    c = c.double()
    e = c / ((1.0 + c) * (1.0 + c))
    out = [e]
    for n in range(1, n_terms):
        e = e * (-c * c) * (1.0 / ((2 * n) * (2 * n + 1)))
        out.append(e)
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


def _k_block(k, i):
    """k[..., i:i + 256] as (B|1, K, 1): the shared row or each row's."""
    kb = k[..., i:i + _REF_K_BLOCK]
    return (kb[None] if kb.dim() == 1 else kb)[..., None]


def halo_contract_ref(k, mat, gal):
    """Plain PyTorch version of the kernel (same inputs and output),
    evaluated in blocks of 256 k so that its (B, k, node) temporaries
    stay small at the main path's widths."""
    return torch.cat([_ref_block(_k_block(k, i), mat, gal)
                      for i in range(0, max(k.shape[-1], 1), _REF_K_BLOCK)],
                     dim=-1)


def _ref_block(kk, mat, gal):
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


def profile_nd(x, c, coeffs):
    """(N, dN/dx, dN/dc) at x = k r_s by the kernel's routes: where b =
    (1+c)x <= :data:`SMALL_B` the moment series (``coeffs`` =
    :func:`moment_coeffs` of ``c``), its derivative, and dN/dc = sum_n e_n
    x^2n (:func:`dc_coeffs`); else the auxiliary functions:

        dN/dx = fm(x) - cos(cx) fm(b) - sin(cx) g(b) + sin(cx) / (x b),
        dN/dc = sin(cx) / (x (1+c)^2) = sin(cx) / (b (1+c)),

    from N(x, c) = int_0^c sin(xt) / (x (1+t)^2) dt, f' = -g and g' = f -
    1/x.  Every branch is evaluated on clamped arguments and selected with
    ``torch.where``, in the dtype of ``x``."""
    c1 = 1.0 + c
    b = c1 * x
    small = b <= SMALL_B
    # Moment series, on arguments clamped into its route.
    xs = torch.where(small, x, SMALL_B / c1)
    a = coeffs.to(x.dtype)
    e = dc_coeffs(c, a.shape[-1]).to(x.dtype)
    x2 = xs * xs
    n_s = a[..., -1]
    d_s = (2 * (a.shape[-1] - 1)) * a[..., -1]
    c_s = e[..., -1]
    for j in range(a.shape[-1] - 2, -1, -1):
        n_s = n_s * x2 + a[..., j]
        c_s = c_s * x2 + e[..., j]
        if j >= 1:
            d_s = d_s * x2 + (2 * j) * a[..., j]
    d_s = d_s * xs
    # Auxiliary functions.
    cx = c * x
    s, co = torch.sin(cx), torch.cos(cx)
    u = 1.0 / b
    fm_b, g_b = aux_fm(b), aux_g(b)
    n_l = aux_g(x) + s * fm_b - co * g_b
    d_l = aux_fm(x) - co * fm_b - s * g_b + s * (1.0 / x) * u
    return (torch.where(small, n_s, n_l), torch.where(small, d_s, d_l),
            torch.where(small, c_s, s * u / c1))


def halo_contract_bwd_ref(k, mat, gal, cheb, grad_out, grad_k=False):
    """Plain version of the backward kernel: (grad_mat (B, NM, 4),
    grad_gal (B, NG, 9)) of ``sum(grad_out * halo_contract(k, mat,
    gal))``, and with ``grad_k`` its gradient in k as a third member, (B,
    NK) for a k row per cosmology and (NK,) for a shared k: the formulas
    of :func:`profile_nd` summed over k in blocks of 256, in the inputs'
    dtype.  grad_k sums S r_s dN/dx over the nodes (d out / d k = r_s
    dN/dx at x = k r_s)."""
    _check(k, mat, gal, cheb)
    _check_grad(k, mat, grad_out)
    m_coef = moment_coeffs(mat[..., 1], n_moments(k.dtype))[:, None]
    gm_coef = moment_coeffs(gal[..., 1], n_moments(k.dtype))[:, None]
    gg_coef = moment_coeffs(gal[..., 3], n_moments(k.dtype))[:, None]
    g_mat = torch.zeros_like(mat)
    g_gal = torch.zeros_like(gal)
    g_k = []
    for i in range(0, k.shape[-1], _REF_K_BLOCK):
        kk = _k_block(k, i)
        g = grad_out[:, :, i:i + _REF_K_BLOCK, None]   # (B, 5, K, 1)
        g_hm, g_hg, g_mm, g_gg, g_gm = g.unbind(1)
        m = mat[:, None]
        n, dx, dc = profile_nd(kk * m[..., 0], m[..., 1], m_coef)
        sv = g_hm * m[..., 2] + 2.0 * g_mm * m[..., 3] * n
        g_mat += torch.stack([(sv * (kk * dx)).sum(1), (sv * dc).sum(1),
                              (g_hm * n).sum(1), (g_mm * n * n).sum(1)], -1)
        q = gal[:, None]
        n_m, dx_m, dc_m = profile_nd(kk * q[..., 0], q[..., 1], gm_coef)
        n_g, dx_g, dc_g = profile_nd(kk * q[..., 2], q[..., 3], gg_coef)
        s_g = (g_hg * q[..., 4] + g_gg * (q[..., 5] + 2.0 * q[..., 6] * n_g)
               + g_gm * q[..., 8] * n_m)
        s_m = g_gm * (q[..., 7] + q[..., 8] * n_g)
        g_gal += torch.stack([
            (s_m * (kk * dx_m)).sum(1), (s_m * dc_m).sum(1),
            (s_g * (kk * dx_g)).sum(1), (s_g * dc_g).sum(1),
            (g_hg * n_g).sum(1), (g_gg * n_g).sum(1),
            (g_gg * n_g * n_g).sum(1), (g_gm * n_m).sum(1),
            (g_gm * n_m * n_g).sum(1)], -1)
        if grad_k:
            g_k.append((sv * dx * m[..., 0]).sum(-1)
                       + (s_m * dx_m * q[..., 0] + s_g * dx_g * q[..., 2]
                          ).sum(-1))
    if not grad_k:
        return g_mat, g_gal
    g_k = torch.cat(g_k, dim=-1) if g_k else grad_out.new_zeros(
        mat.shape[0], 0)
    return g_mat, g_gal, (g_k if k.dim() == 2 else g_k.sum(0))


def _check_grad(k, mat, grad_out):
    want = (mat.shape[0], N_OUT, k.shape[-1])
    if tuple(grad_out.shape) != want:
        raise ValueError(f"halo_contract backward: cotangent must be {want}, "
                         f"got {tuple(grad_out.shape)}")
    if grad_out.dtype != k.dtype or grad_out.device != k.device:
        raise TypeError("halo_contract backward: the cotangent must share "
                        "the inputs' dtype and device")


def _check(k, mat, gal, cheb):
    if k.dim() not in (1, 2) or mat.dim() != 3 or gal.dim() != 3:
        raise ValueError("halo_contract: need k (NK,) or (B, NK), mat (B, "
                         "NM, 4), gal (B, NG, 9)")
    if k.dim() == 2 and k.shape[0] != mat.shape[0]:
        raise ValueError(f"halo_contract: a k row per cosmology needs "
                         f"{mat.shape[0]} rows, got {k.shape[0]}")
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


_TABLE_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p]


@lru_cache(maxsize=None)
def _lib():
    return _lib_argtypes(load("halo_contract"))


def _lib_argtypes(lib):
    """``lib`` (the built halo_contract library) with its C functions'
    argument and result types set."""
    lib.halo_contract_launch.restype = ctypes.c_int
    lib.halo_contract_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + _TABLE_ARGS)
    lib.halo_contract_bwd_launch.restype = ctypes.c_int
    lib.halo_contract_bwd_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_void_p] + _TABLE_ARGS)
    lib.halo_contract_bwd_geometry.restype = ctypes.c_int
    lib.halo_contract_bwd_geometry.argtypes = [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.halo_contract_error.restype = ctypes.c_char_p
    lib.halo_contract_error.argtypes = [ctypes.c_int]
    return lib


def _cuda_inputs(name, ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    return _lib(), device_index(ts[0])


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.halo_contract_error(rc).decode())


def _forward(k, mat, gal, cheb):
    """The forward kernel (CUDA) or the plain version (CPU)."""
    if k.device.type == "cpu":
        return halo_contract_ref(k, mat, gal)
    lib, idx = _cuda_inputs("halo_contract", (k, mat, gal, cheb))
    b, nm, ng, nk = mat.shape[0], mat.shape[1], gal.shape[1], k.shape[-1]
    out = torch.empty((b, N_OUT, nk), dtype=k.dtype, device=k.device)
    if b == 0 or nk == 0:
        return out
    rc = lib.halo_contract_launch(
        idx, int(k.dtype == torch.float64), k.data_ptr(), _k_stride(k), nk,
        mat.data_ptr(), nm, gal.data_ptr(), ng, out.data_ptr(), b,
        cheb.data_ptr(), *_lens(k.dtype), raw_stream(idx))
    _raise_on(rc, lib, "halo_contract")
    halo_contract.launches += 1
    return out


def _k_stride(k) -> int:
    """The kernels' k row stride: 0 for a shared k, NK per row."""
    return k.shape[-1] if k.dim() == 2 else 0


def halo_contract_bwd(k, mat, gal, cheb, grad_out, grad_k=False):
    """The backward kernel on CUDA tensors, :func:`halo_contract_bwd_ref`
    on CPU tensors: (grad_mat, grad_gal) for the cotangent ``grad_out``
    (B, 5, NK), and with ``grad_k`` the gradient in k as a third member
    ((B, NK), or (NK,) for a shared k): the kernel's per-unit float64
    partials (B, units, NK), summed in unit order by a second kernel of
    the launch."""
    from chomp_tpu_torch.ops.tiles import bwd_geometry

    if k.device.type == "cpu":
        return halo_contract_bwd_ref(k, mat, gal, cheb, grad_out, grad_k)
    _check(k, mat, gal, cheb)
    _check_grad(k, mat, grad_out)
    lib, idx = _cuda_inputs("halo_contract_bwd",
                            (k, mat, gal, cheb, grad_out))
    g_mat, g_gal = torch.empty_like(mat), torch.empty_like(gal)
    b, nm, ng, nk = mat.shape[0], mat.shape[1], gal.shape[1], k.shape[-1]
    g_k = part = None
    if grad_k:
        g_k = torch.zeros((b, nk), dtype=k.dtype, device=k.device)
        units = bwd_geometry(b, nm, ng, nk, k.element_size(),
                             with_grad_k=True).grid[0]
        part = torch.empty((b, units, nk), dtype=torch.float64,
                           device=k.device)
    if b == 0 or nm + ng == 0 or nk == 0:
        g_mat.zero_()
        g_gal.zero_()
    else:
        rc = lib.halo_contract_bwd_launch(
            idx, int(k.dtype == torch.float64), k.data_ptr(), _k_stride(k),
            nk, mat.data_ptr(), nm, gal.data_ptr(), ng, grad_out.data_ptr(),
            g_mat.data_ptr(), g_gal.data_ptr(),
            None if part is None else part.data_ptr(),
            None if g_k is None else g_k.data_ptr(), b, cheb.data_ptr(),
            *_lens(k.dtype), raw_stream(idx))
        _raise_on(rc, lib, "halo_contract_bwd")
        halo_contract.bwd_launches += 1
    if not grad_k:
        return g_mat, g_gal
    return g_mat, g_gal, (g_k if k.dim() == 2 else g_k.sum(0))


_BWD_REPORT = ("units", "block", "unit_m", "unit_g", "kt", "tiles",
               "dyn_smem", "static_smem", "registers", "local_bytes",
               "blocks_per_sm")


def bwd_launch_report(nm, ng, nk, dtype, device=0,
                      with_grad_k=False) -> dict:
    """What the built backward kernel launches at this shape, from the
    CUDA library itself: the geometry (:func:`~chomp_tpu_torch.ops.tiles.
    bwd_geometry` mirrors it), the static shared memory, registers and
    local (spill) bytes of the compiled kernel (the one with grad_k when
    ``with_grad_k``) and its resident blocks per SM."""
    lib = _lib()
    out = (ctypes.c_int * len(_BWD_REPORT))()
    _raise_on(lib.halo_contract_bwd_geometry(
        device, int(dtype == torch.float64), nm, ng, nk, int(with_grad_k),
        out), lib, "halo_contract_bwd geometry")
    return dict(zip(_BWD_REPORT, out))


class HaloContract(torch.autograd.Function):
    """Kernel A with its backward kernel: saves k, mat, gal and the table,
    and recomputes N in the backward (grad_k only when k needs it)."""

    @staticmethod
    def forward(ctx, k, mat, gal, cheb):
        ctx.save_for_backward(k, mat, gal, cheb)
        return _forward(k, mat, gal, cheb)

    @staticmethod
    def backward(ctx, grad_out):
        k, mat, gal, cheb = ctx.saved_tensors
        need_k = ctx.needs_input_grad[0]
        grads = halo_contract_bwd(k, mat, gal, cheb, grad_out.contiguous(),
                                  grad_k=need_k)
        return (grads[2] if need_k else None,
                grads[0] if ctx.needs_input_grad[1] else None,
                grads[1] if ctx.needs_input_grad[2] else None, None)


def halo_contract(k, mat, gal, cheb):
    """Kernel A on CUDA tensors; the plain version for CPU tensors.

    ``k`` is (NK,) or (B, NK) (a row per cosmology row); ``cheb`` is
    :func:`cheb_table` on the inputs' device and dtype (the kernel copies
    it to constant memory).  Differentiable in ``mat``, ``gal`` and ``k``
    (:class:`HaloContract`: the backward kernel on CUDA, its plain version
    on the CPU); ``cheb`` is static, and raises if it requires grad."""
    _check(k, mat, gal, cheb)
    if k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"halo_contract: unsupported device {k.device}")
    if cheb.requires_grad:
        raise ValueError("halo_contract: the table is static; k, mat and "
                         "gal take gradients")
    if torch.is_grad_enabled() and (k.requires_grad or mat.requires_grad
                                    or gal.requires_grad):
        return HaloContract.apply(k, mat, gal, cheb)
    return _forward(k, mat, gal, cheb)


halo_contract.launches = 0
halo_contract.bwd_launches = 0
