"""Kernel C: the compensated contraction with a static float64 operator.

``out = c @ A.T`` with ``A`` a static float64 operator whose rows
oscillate through sign (the fused lattice -> Hankel -> theta-bins map of
the w(theta) pipeline), so a plain float32 sum loses ~eps x the ~100x
cancellation.  ``A`` is split once, by :func:`split_operator`, into
float32 hi + lo.  The CUDA kernel multiplies float32 ``c`` by hi + lo on
the FP64 tensor cores and sums in float64 (~2^-53; launch geometry from
:func:`ops.tiles.split_k`); float64 inputs take a plain float64 sum.

Replaces the JAX package's ``ops/df32.py::df_contract``; the CUDA source is
``chomp_tpu_torch/csrc/df_contract.cu``.  :func:`df_contract_ref` is the
plain PyTorch version, the JAX module's two-float arithmetic (~2^-48):
Dekker two_prod and the balanced-tree ``df_sum`` (each eager op is its
own launch, so the error-free transforms stay exact on CPU and GPU alike).

Gradients: :func:`df_contract` is differentiable in ``c`` (the operator
is a static buffer).  The backward, grad_c = G @ (a_hi + a_lo), is the
same tile with A read as (T, n) rows and hi + lo summed exactly
(:func:`df_contract_bwd`, plain version :func:`df_contract_bwd_ref`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from chomp_tpu_torch.ops.build import device_index, load, raw_stream
from chomp_tpu_torch.ops.hankel_matmul import full_fp32_matmul
from chomp_tpu_torch.ops.tiles import split_k, vec16

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for float32


def split_operator(a_np: np.ndarray):
    """(hi, lo) float32 numpy pair with hi + lo == A to ~2^-48."""
    a_np = np.asarray(a_np, dtype=np.float64)
    hi = a_np.astype(np.float32)
    lo = (a_np - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def two_sum(a, b):
    """Error-free a + b: (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b (Dekker): (p, e) with p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _df_add(s1, e1, s2, e2):
    s, e = two_sum(s1, s2)
    return s, e + (e1 + e2)


def df_sum(hi, lo):
    """Balanced-tree two-float reduction over the last axis; returns the
    rounded sum hi + lo."""
    n = hi.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        hi = torch.nn.functional.pad(hi, (0, m - n))
        lo = torch.nn.functional.pad(lo, (0, m - n))
    while m > 1:
        m //= 2
        hi, lo = _df_add(hi[..., :m], lo[..., :m], hi[..., m:], lo[..., m:])
    return (hi + lo)[..., 0]


def df_contract_ref(c, a_hi, a_lo=None):
    """Plain version: ``c`` (R, n); float64 ``c`` with the float64
    operator ``a_hi`` (T, n) is a plain matmul, float32 ``c`` with the
    float32 split (``a_hi``, ``a_lo``) the two-float contraction."""
    if c.dtype == torch.float64:
        return torch.matmul(c, a_hi.T)
    ce = c[..., None, :]
    p, e = two_prod(ce, a_hi)
    e = e + ce * a_lo
    return df_sum(p, e)


def _check(c, a_hi, a_lo):
    if c.dim() != 2 or a_hi.dim() != 2 or c.shape[1] != a_hi.shape[1]:
        raise ValueError(f"df_contract: need c (R, n) and A (T, n), got "
                         f"{tuple(c.shape)} and {tuple(a_hi.shape)}")
    if c.dtype == torch.float64:
        if a_hi.dtype != torch.float64 or a_lo is not None:
            raise TypeError("df_contract: float64 c takes the float64 "
                            "operator and no lo part")
    elif c.dtype == torch.float32:
        if (a_lo is None or a_hi.dtype != torch.float32
                or a_lo.dtype != torch.float32 or a_lo.shape != a_hi.shape):
            raise TypeError("df_contract: float32 c takes the float32 "
                            "hi/lo split of the operator")
    else:
        raise TypeError(f"df_contract: unsupported dtype {c.dtype}")
    ts = (c, a_hi) + ((a_lo,) if a_lo is not None else ())
    if any(t.device != c.device for t in ts):
        raise ValueError("df_contract: all inputs must be on one device")
    return ts


@lru_cache(maxsize=None)
def _lib():
    lib = load("df_contract")
    for fn in (lib.df_contract_launch, lib.df_contract_bwd_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.df_contract_error.restype = ctypes.c_char_p
    lib.df_contract_error.argtypes = [ctypes.c_int]
    for fn in (lib.df_contract_smem_bytes, lib.df_contract_bwd_smem_bytes):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
    return lib


def _launch(entry, x, a_hi, a_lo, out, n, t):
    """``out (R, t) = x (R, n) @ B`` through ``entry`` of the library: the
    forward (B = A^T, A (t, n)) or the backward (B = A, A (n, t)); the
    launch geometry from :func:`split_k`.  Empty shapes launch nothing and
    return False."""
    ts = (x, a_hi) + (() if a_lo is None else (a_lo,))
    if x.device.type != "cuda":
        raise ValueError(f"df_contract: unsupported device {x.device}")
    if not all(v.is_contiguous() for v in ts):
        raise ValueError("df_contract: inputs must be contiguous")
    rows = x.shape[0]
    if rows == 0 or t == 0:
        return False
    lib = _lib()
    geo = split_k(rows, n, t)
    idx = device_index(x)
    size = x.element_size()
    p_x, p_hi = x.data_ptr(), a_hi.data_ptr()
    p_lo = a_lo.data_ptr() if a_lo is not None else None
    rc = getattr(lib, entry)(
        idx, int(size == 8), p_x, p_hi, p_lo, out.data_ptr(), rows, n, t,
        *geo.grid, geo.kc, vec16(n * size, p_x),
        vec16(a_hi.shape[1] * size, p_hi, p_lo or 0), raw_stream(idx))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.df_contract_error(rc).decode())
    return True


def _forward(c, a_hi, a_lo):
    if c.device.type == "cpu":
        return df_contract_ref(c, a_hi, a_lo)
    t, n = a_hi.shape
    out = torch.empty((c.shape[0], t), dtype=c.dtype, device=c.device)
    if _launch("df_contract_launch", c, a_hi, a_lo, out, n, t):
        df_contract.launches += 1
    return out


def df_contract_bwd_ref(grad, a_hi, a_lo=None):
    """Plain version of the backward: ``grad @ A`` with the float64
    operator, or ``grad @ a_hi + grad @ a_lo`` at full float32 precision
    with the split."""
    with full_fp32_matmul():
        out = torch.matmul(grad, a_hi)
        return out if a_lo is None else out + torch.matmul(grad, a_lo)


def df_contract_bwd(grad, a_hi, a_lo=None):
    """grad_c (R, n) = ``grad`` (R, T) @ (a_hi + a_lo): the backward kernel
    on CUDA tensors, :func:`df_contract_bwd_ref` on CPU tensors."""
    _check(grad, a_hi.T, None if a_lo is None else a_lo.T)
    if grad.device.type == "cpu":
        return df_contract_bwd_ref(grad, a_hi, a_lo)
    t, n = a_hi.shape
    out = torch.empty((grad.shape[0], n), dtype=grad.dtype,
                      device=grad.device)
    if _launch("df_contract_bwd_launch", grad, a_hi, a_lo, out, t, n):
        df_contract.bwd_launches += 1
    return out


class DfContract(torch.autograd.Function):
    """Kernel C with its backward kernel (grad_c = G @ (a_hi + a_lo))."""

    @staticmethod
    def forward(ctx, c, a_hi, a_lo):
        ctx.save_for_backward(a_hi, a_lo)
        return _forward(c, a_hi, a_lo)

    @staticmethod
    def backward(ctx, grad):
        a_hi, a_lo = ctx.saved_tensors
        return df_contract_bwd(grad.contiguous(), a_hi, a_lo), None, None


def df_contract(c, a_hi, a_lo=None):
    """Kernel C on CUDA tensors; the plain version for CPU tensors.
    ``c`` (R, n); ``a_hi``/``a_lo`` as :func:`df_contract_ref`.  Returns
    (R, T).  Differentiable in ``c`` (:class:`DfContract`); the operator
    is static and raises if it requires grad."""
    ts = _check(c, a_hi, a_lo)
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"df_contract: unsupported device {c.device}")
    if any(t.requires_grad for t in ts[1:]):
        raise ValueError("df_contract: the operator is a static buffer and "
                         "takes no gradient")
    if torch.is_grad_enabled() and c.requires_grad:
        return DfContract.apply(c, a_hi, a_lo)
    return _forward(c, a_hi, a_lo)


df_contract.launches = 0
df_contract.bwd_launches = 0
