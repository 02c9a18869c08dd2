"""Kernel B: the Hankel-operator product of the ``method="table"`` route.

``out (R, T) = cl (R, N) @ op_t (N, T)``: C_ell rows on the static ell grid
times the transposed composed FFTLog Hankel + theta-binning operator
(``correlation.wtheta_bins_operator``), the JAX public layout of
``hankel_matmul_pallas``.  The operator's rows oscillate through sign, so
the kernel multiplies on the FP64 tensor cores (no TF32, no bf16): the
float32 output is the float64 sum of exact products, rounded once.
float64 input takes the float64 instantiation (the reference mode; the JAX
Pallas kernel always rounds to float32).  The launch geometry (split of N
over a thread-block cluster) comes from :func:`ops.tiles.split_k`.

Replaces the JAX package's ``ops/fftlog_pallas.py::hankel_matmul_pallas``;
the CUDA source is ``chomp_tpu_torch/csrc/hankel_matmul.cu``.
:func:`hankel_matmul_ref` is the plain PyTorch version: ``torch.matmul``
with TF32 switched off for the call.

Gradients: :func:`hankel_matmul` is differentiable in ``cl`` (the
operator is a static buffer).  The backward, grad_cl = G @ op_t^T, is the
same tile with the operator read as (N, K) rows (:func:`hankel_matmul_bwd`,
plain version :func:`hankel_matmul_bwd_ref`).
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache

import torch

from chomp_tpu_torch.ops.build import device_index, load, raw_stream
from chomp_tpu_torch.ops.tiles import split_k, vec16


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matmuls of the block in full FP32 (no TF32), restoring
    the caller's process-wide setting afterwards."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def hankel_matmul_ref(cl, op_t):
    """Plain version: ``cl @ op_t`` at full float32 (or float64)
    precision; any leading dimensions of ``cl``."""
    with full_fp32_matmul():
        return torch.matmul(cl, op_t)


def _check(cl, op_t):
    if cl.dim() != 2 or op_t.dim() != 2 or cl.shape[1] != op_t.shape[0]:
        raise ValueError(f"hankel_matmul: need cl (R, N) and op_t (N, T), "
                         f"got {tuple(cl.shape)} and {tuple(op_t.shape)}")
    if cl.dtype != op_t.dtype or cl.dtype not in (torch.float32,
                                                  torch.float64):
        raise TypeError(f"hankel_matmul: cl and op_t must share one dtype, "
                        f"float32 or float64, got {cl.dtype} and "
                        f"{op_t.dtype}")
    if cl.device != op_t.device:
        raise ValueError("hankel_matmul: cl and op_t must be on one device")


@lru_cache(maxsize=None)
def _lib():
    lib = load("hankel_matmul")
    for fn in (lib.hankel_matmul_launch, lib.hankel_matmul_bwd_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.hankel_matmul_error.restype = ctypes.c_char_p
    lib.hankel_matmul_error.argtypes = [ctypes.c_int]
    for fn in (lib.hankel_matmul_smem_bytes, lib.hankel_matmul_bwd_smem_bytes):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
    return lib


def _launch(entry, a, b, out, n, t):
    """``out (R, t) = a (R, n) @ B`` through ``entry`` of the library: the
    forward (B = ``b`` (n, t)) or the backward (B = ``b``^T, ``b`` (t, n));
    the launch geometry from :func:`split_k`.  Empty shapes launch nothing
    and return False."""
    if a.device.type != "cuda":
        raise ValueError(f"hankel_matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("hankel_matmul: inputs must be contiguous")
    rows = a.shape[0]
    if rows == 0 or t == 0:
        return False
    lib = _lib()
    geo = split_k(rows, n, t)
    idx = device_index(a)
    size = a.element_size()
    p_a, p_b = a.data_ptr(), b.data_ptr()
    rc = getattr(lib, entry)(
        idx, int(size == 8), p_a, p_b, out.data_ptr(), rows, n, t,
        *geo.grid, geo.kc, vec16(n * size, p_a),
        vec16(b.shape[1] * size, p_b), raw_stream(idx))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.hankel_matmul_error(rc).decode())
    return True


def _forward(cl, op_t):
    if cl.device.type == "cpu":
        return hankel_matmul_ref(cl, op_t)
    n, t = op_t.shape
    out = torch.empty((cl.shape[0], t), dtype=cl.dtype, device=cl.device)
    if _launch("hankel_matmul_launch", cl, op_t, out, n, t):
        hankel_matmul.launches += 1
    return out


def hankel_matmul_bwd_ref(grad, op_t):
    """Plain version of the backward: ``grad @ op_t.T`` at full float32
    (or float64) precision."""
    with full_fp32_matmul():
        return torch.matmul(grad, op_t.T)


def hankel_matmul_bwd(grad, op_t):
    """grad_cl (R, N) = ``grad`` (R, T) @ ``op_t``^T: the backward kernel
    on CUDA tensors, :func:`hankel_matmul_bwd_ref` on CPU tensors."""
    _check(grad, op_t.T)
    if grad.device.type == "cpu":
        return hankel_matmul_bwd_ref(grad, op_t)
    n_ell, t = op_t.shape
    out = torch.empty((grad.shape[0], n_ell), dtype=grad.dtype,
                      device=grad.device)
    if _launch("hankel_matmul_bwd_launch", grad, op_t, out, t, n_ell):
        hankel_matmul.bwd_launches += 1
    return out


class HankelMatmul(torch.autograd.Function):
    """Kernel B with its backward kernel (grad_cl = G @ op_t^T)."""

    @staticmethod
    def forward(ctx, cl, op_t):
        ctx.save_for_backward(op_t)
        return _forward(cl, op_t)

    @staticmethod
    def backward(ctx, grad):
        (op_t,) = ctx.saved_tensors
        return hankel_matmul_bwd(grad.contiguous(), op_t), None


def hankel_matmul(cl, op_t):
    """Kernel B on CUDA tensors; the plain version for CPU tensors.
    ``cl`` (R, N), ``op_t`` (N, T), one dtype (float32 or float64).
    Returns (R, T).  Differentiable in ``cl`` (:class:`HankelMatmul`);
    the operator is static and raises if it requires grad."""
    _check(cl, op_t)
    if cl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hankel_matmul: unsupported device {cl.device}")
    if op_t.requires_grad:
        raise ValueError("hankel_matmul: the operator is a static buffer "
                         "and takes no gradient")
    if torch.is_grad_enabled() and cl.requires_grad:
        return HankelMatmul.apply(cl, op_t)
    return _forward(cl, op_t)


hankel_matmul.launches = 0
hankel_matmul.bwd_launches = 0
