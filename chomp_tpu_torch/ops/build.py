"""Build and load the hand-written CUDA kernels of ``chomp_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/`` at the repository root (the
file name carries a hash of the source and of the ``csrc/*.cuh`` headers
it includes, so an edited kernel or header is rebuilt) and loaded with
``ctypes``.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/*.cuh`` it includes, directly
    or through another header, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    """Build path of ``csrc/<name>.cu``; its name hashes the source, the
    headers it includes and the target, so editing any of them rebuilds."""
    h = hashlib.sha256(" ".join(ARCH).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def raw_stream(idx: int) -> int:
    """The current CUDA stream of device ``idx`` as an integer handle.
    ``torch.cuda.current_stream(d).cuda_stream`` builds a Stream object
    first, which costs more host time than a small kernel's launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(idx)
