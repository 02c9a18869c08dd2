"""Launch geometry of the split-K f64 tensor-core kernels B and C.

Both kernels (``csrc/dmma_tile.cuh``) compute ``out (R, T) = A (R, K) @ B``
in BM x BN output tiles, each tile split along K over a thread-block
cluster of S CTAs.  :func:`split_k` chooses S, the depth of each rank and
the grid here, where the CPU tests reach it; the CUDA source obeys what it
is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

BM, BN = 32, 64     # output tile of one CTA (csrc/dmma_tile.cuh)
MAX_CLUSTER = 8     # the portable thread-block cluster size
K_ALIGN = 4         # rank bounds fall on whole 16-byte float32 copies
MIN_DEPTH = 64      # the least depth worth a CTA of its own
SMS = 132           # streaming multiprocessors of the H100 SXM
MAX_GRID_YZ = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SplitK:
    """``grid`` = (cluster, column tiles, row tiles), launched in clusters
    of (cluster, 1, 1); rank r covers ``bounds[r]`` = [r kc, min((r+1) kc,
    K)) of the contraction."""

    grid: tuple[int, int, int]
    cluster: int
    kc: int
    bounds: tuple[tuple[int, int], ...]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@lru_cache(maxsize=1024)
def split_k(rows: int, n: int, t: int) -> SplitK:
    """Geometry of ``(rows, n) @ (n, t)``: the largest cluster S <= 8 that
    keeps the CTAs within one wave of the card's SMS and every rank at least
    MIN_DEPTH deep, with K split in whole K_ALIGN chunks and no empty
    rank.  Cached: the wrappers ask for it at every launch."""
    tiles_n, tiles_m = _cdiv(t, BN), _cdiv(rows, BM)
    if tiles_n > MAX_GRID_YZ or tiles_m > MAX_GRID_YZ:
        raise ValueError(f"split_k: ({rows}, {n}) @ ({n}, {t}) needs more "
                         f"than {MAX_GRID_YZ} tiles along one side")
    s = max(1, min(MAX_CLUSTER, SMS // max(1, tiles_n * tiles_m),
                   _cdiv(n, MIN_DEPTH)))
    kc = _cdiv(_cdiv(n, K_ALIGN), s) * K_ALIGN or K_ALIGN
    s = max(1, _cdiv(n, kc))
    bounds = tuple((r * kc, min(n, (r + 1) * kc)) for r in range(s))
    return SplitK((s, tiles_n, tiles_m), s, kc, bounds)


def vec16(row_bytes: int, *ptrs: int) -> int:
    """1 where rows of ``row_bytes`` bytes starting at these addresses may
    be copied in 16-byte pieces (every row start 16-byte aligned); else 0
    (one copy per element)."""
    return int(row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs))
