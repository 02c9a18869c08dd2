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
    lib.hankel_matmul_launch.restype = ctypes.c_int
    lib.hankel_matmul_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.hankel_matmul_error.restype = ctypes.c_char_p
    lib.hankel_matmul_error.argtypes = [ctypes.c_int]
    lib.hankel_matmul_smem_bytes.restype = ctypes.c_int
    lib.hankel_matmul_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def hankel_matmul(cl, op_t):
    """Kernel B on CUDA tensors; the plain version for CPU tensors.
    ``cl`` (R, N), ``op_t`` (N, T), one dtype (float32 or float64).
    Returns (R, T).  Forward only: a CUDA input that requires grad
    raises."""
    _check(cl, op_t)
    dev = cl.device
    if dev.type == "cpu":
        return hankel_matmul_ref(cl, op_t)
    if dev.type != "cuda":
        raise ValueError(f"hankel_matmul: unsupported device {dev}")
    if cl.requires_grad or op_t.requires_grad:
        raise NotImplementedError(
            "hankel_matmul: the CUDA kernel is forward-only (backward "
            "kernel: ROADMAP queue 2, kernel B)")
    if not (cl.is_contiguous() and op_t.is_contiguous()):
        raise ValueError("hankel_matmul: inputs must be contiguous")
    lib = _lib()
    rows, n = cl.shape
    t = op_t.shape[1]
    out = torch.empty((rows, t), dtype=cl.dtype, device=dev)
    if rows == 0 or t == 0:
        return out
    geo = split_k(rows, n, t)
    idx = device_index(cl)
    size = cl.element_size()
    p_cl, p_op = cl.data_ptr(), op_t.data_ptr()
    rc = lib.hankel_matmul_launch(
        idx, int(size == 8), p_cl, p_op, out.data_ptr(), rows, n, t,
        *geo.grid, geo.kc, vec16(n * size, p_cl), vec16(t * size, p_op),
        raw_stream(idx))
    if rc != 0:
        raise RuntimeError("hankel_matmul launch failed: "
                           + lib.hankel_matmul_error(rc).decode())
    hankel_matmul.launches += 1
    return out


hankel_matmul.launches = 0
