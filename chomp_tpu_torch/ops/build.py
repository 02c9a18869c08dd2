"""Build and load the hand-written CUDA kernels of ``chomp_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/`` at the repository root (the
file name carries a hash of the source, so an edited kernel is rebuilt)
and loaded with ``ctypes``.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "",
            os.path.join("/usr/local/cuda", "bin", "nvcc")]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the chomp_tpu_torch CUDA kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(ARCH).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` (if not built yet); returns the library
    path and nvcc's register/shared-memory report (``-Xptxas -v``)."""
    return build_all([name])[name]


def build_all(names) -> dict[str, tuple[Path, str]]:
    """:func:`build` for several sources, one ``nvcc`` each, all started
    together and then waited for.  A failed build raises, naming every
    failure, once all compilers have ended."""
    done, running = {}, {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            done[name] = out, log.read_text() if log.exists() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running[name] = out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failed = []
    for name, (out, tmp, proc) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}.cu (rc "
                          f"{proc.returncode}):\n{err}")
            continue
        out.with_suffix(".log").write_text(err)
        os.replace(tmp, out)
        done[name] = out, err
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


def device_index(t) -> int:
    """CUDA device index of tensor ``t`` (the current device for a bare
    "cuda" device)."""
    import torch

    idx = t.device.index
    return torch.cuda.current_device() if idx is None else idx
