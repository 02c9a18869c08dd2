"""Launch geometry of the split-K f64 tensor-core kernels B and C, and of
kernel A's backward.

Both kernels B and C (``csrc/dmma_tile.cuh``) compute ``out (R, T) = A (R,
K) @ B`` in BM x BN output tiles, each tile split along K over a
thread-block cluster of S CTAs.  :func:`split_k` chooses S, the depth of
each rank and the grid here, where the CPU tests reach it; the CUDA source
obeys what it is given.  :func:`bwd_geometry` mirrors the work split that
``csrc/halo_contract.cu`` computes for its backward kernel A' (the C entry
point keeps its arguments, so the source chooses; ``chip_smoke.py`` holds
the two to each other on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from chomp_tpu_torch.ops.halo_contract import GAL_FIELDS, MAT_FIELDS, N_OUT

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


# Kernel A' (csrc/halo_contract.cu): a block of BWD_BLOCK threads is one
# cosmology and one work unit of BWD_UNIT_M mat and BWD_UNIT_G gal nodes.
BWD_BLOCK = 256
BWD_WARPS = BWD_BLOCK // 32
BWD_UNIT_M, BWD_UNIT_G = 16, 16
GAL_WEIGHTS = 5
#: Dynamic shared memory a k tile may take (staged k and cotangent rows).
BWD_TILE_BYTES = {4: 61440, 8: 73728}
#: Bytes of one staged profile (ProfileB: 4 scalars + 3 series of 10 terms
#: in float32, 16 in float64, aligned to 16 bytes).
BWD_PROFILE_BYTES = {4: 144, 8: 416}
SMEM_PER_BLOCK = 232448  # 227 KB, the most one block may take
SMEM_PER_SM = 233472     # 228 KB
SMEM_RESERVED = 1024     # the runtime's share of each resident block


@dataclass(frozen=True)
class BwdGeometry:
    """``grid`` = (units, batch) blocks of ``block`` threads; block u takes
    mat nodes ``mat_nodes(u)`` and gal nodes ``gal_nodes(u)`` of its
    cosmology, and the k grid in ``tiles`` tiles of ``kt``."""

    grid: tuple[int, int]
    block: int
    unit_m: int
    unit_g: int
    nm: int
    ng: int
    kt: int
    tiles: int
    dyn_smem: int
    static_smem: int

    def mat_nodes(self, u: int) -> range:
        return range(min(self.nm, u * self.unit_m),
                     min(self.nm, (u + 1) * self.unit_m))

    def gal_nodes(self, u: int) -> range:
        return range(min(self.ng, u * self.unit_g),
                     min(self.ng, (u + 1) * self.unit_g))

    @property
    def smem(self) -> int:
        return self.dyn_smem + self.static_smem

    @property
    def blocks_per_sm_by_smem(self) -> int:
        return SMEM_PER_SM // (self.smem + SMEM_RESERVED)


def bwd_geometry(batch: int, nm: int, ng: int, nk: int,
                 itemsize: int = 4, with_grad_k: bool = False) -> BwdGeometry:
    """Kernel A' at (batch, nm, ng, nk) in float32 (``itemsize`` 4) or
    float64 (8): units of 16 + 16 nodes, and k tiles of the most k (a
    multiple of 32) whose k and five cotangent rows (and, ``with_grad_k``,
    each warp's float64 grad_k row) fit the tile's bytes.  The static
    shared memory is the sum of the kernel's arrays: 48 staged profiles,
    the weights, the same-profile flags and the double totals."""
    per_k = (N_OUT + 1) * itemsize + (8 * BWD_WARPS if with_grad_k else 0)
    kt_max = BWD_TILE_BYTES[itemsize] // per_k // 32 * 32
    kt = max(32, min(kt_max, _cdiv(nk, 32) * 32))
    units = max(_cdiv(nm, BWD_UNIT_M), _cdiv(ng, BWD_UNIT_G))
    static = ((BWD_UNIT_M + 2 * BWD_UNIT_G) * BWD_PROFILE_BYTES[itemsize]
              + (2 * BWD_UNIT_M + GAL_WEIGHTS * BWD_UNIT_G) * itemsize
              + BWD_UNIT_G
              + 8 * (MAT_FIELDS * BWD_UNIT_M + GAL_FIELDS * BWD_UNIT_G))
    return BwdGeometry((units, batch), BWD_BLOCK, BWD_UNIT_M, BWD_UNIT_G,
                       nm, ng, kt, _cdiv(nk, kt), kt * per_k, static)


def vec16(row_bytes: int, *ptrs: int) -> int:
    """1 where rows of ``row_bytes`` bytes starting at these addresses may
    be copied in 16-byte pieces (every row start 16-byte aligned); else 0
    (one copy per element)."""
    return int(row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs))
