"""The launch geometry of kernels B and C (``ops/tiles.py``), the build's
source hash, and the default device of ``grids.Statics``: the parts of
the split-K redesign that run on the host."""

import shutil

import pytest
import torch

from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.ops import build, tiles
from chomp_tpu_torch.params import DEFAULT_GRID
from torch_threads import capped_threads  # noqa: F401 (autouse)

#: (rows, K, T) of the main paths and of chip_smoke.py's ragged cases.
MAIN = [(512, 1024, 64), (512, 2220, 64)]
RAGGED = [(37, 1000, 13), (1, 1024, 64), (8, 2220, 64), (1, 1024, 8)]


@pytest.mark.parametrize("shape", MAIN + RAGGED)
def test_split_k_tiles_the_contraction(shape):
    """Rank bounds cover [0, K) exactly, in order, with no empty rank, on
    whole 16-byte float32 copies; S <= 8 divides the grid's first axis;
    the other two axes hold every output tile."""
    rows, n, t = shape
    g = tiles.split_k(rows, n, t)
    assert 1 <= g.cluster <= tiles.MAX_CLUSTER
    assert g.grid[0] % g.cluster == 0
    assert g.grid[1:] == (-(-t // tiles.BN), -(-rows // tiles.BM))
    assert len(g.bounds) == g.cluster
    assert g.bounds[0][0] == 0 and g.bounds[-1][1] == n
    for (a, b), (c, _) in zip(g.bounds, g.bounds[1:]):
        assert b == c
    assert all(b > a for a, b in g.bounds)
    assert all(a % tiles.K_ALIGN == 0 for a, _ in g.bounds)
    assert all(b - a <= g.kc for a, b in g.bounds)


@pytest.mark.parametrize("shape", MAIN)
def test_split_k_fills_the_card_at_the_main_shapes(shape):
    g = tiles.split_k(*shape)
    assert g.cluster == 8
    assert 100 <= g.ctas <= tiles.SMS


def test_split_k_without_room_to_split():
    """More output tiles than SMs: one CTA per tile, the whole depth."""
    g = tiles.split_k(10000, 2220, 64)
    assert g.cluster == 1 and g.bounds == ((0, 2220),)
    with pytest.raises(ValueError, match="tiles"):
        tiles.split_k(32 * 65536, 8, 8)


@pytest.mark.parametrize("row_bytes, ptrs, want", [
    (4096, (0, 256), 1), (52, (0,), 0), (4096, (8,), 0), (8880, (), 1)])
def test_vec16(row_bytes, ptrs, want):
    assert tiles.vec16(row_bytes, *ptrs) == want


def test_library_hash_follows_the_included_header(tmp_path, monkeypatch):
    """Editing csrc/dmma_tile.cuh renames (so rebuilds) both libraries
    that include it, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    for name in ("hankel_matmul", "df_contract"):
        assert [p.name for p in build.sources(name)] == [
            f"{name}.cu", "dmma_tile.cuh"]
    assert [p.name for p in build.sources("halo_contract")] == [
        "halo_contract.cu"]
    names = ("hankel_matmul", "df_contract", "halo_contract")
    before = {n: build.library_path(n) for n in names}
    header = csrc / "dmma_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["hankel_matmul"] != before["hankel_matmul"]
    assert after["df_contract"] != before["df_contract"]
    assert after["halo_contract"] == before["halo_contract"]


def test_statics_default_to_the_card():
    """No device named: the tables land on CUDA; without a card the
    construction raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert Statics(DEFAULT_GRID).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Statics(DEFAULT_GRID)


#: (batch, NM, NG, NK) of kernel A''s main paths and chip_smoke.py's
#: ragged case.
BWD_SHAPES = [(512, 256, 256, 3542), (512, 256, 256, 4096),
              (512, 37, 5, 1000), (8, 256, 256, 3542), (1, 3, 40, 17)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_geometry_covers_every_node_once(shape, itemsize):
    """Kernel A''s work units: across the grid's first axis every mat and
    every gal node of a cosmology falls in exactly one block, in order;
    the k tiles cover [0, NK) with the last one non-empty."""
    batch, nm, ng, nk = shape
    g = tiles.bwd_geometry(batch, nm, ng, nk, itemsize)
    assert g.grid[1] == batch and g.block == tiles.BWD_BLOCK
    mat = [j for u in range(g.grid[0]) for j in g.mat_nodes(u)]
    gal = [j for u in range(g.grid[0]) for j in g.gal_nodes(u)]
    assert mat == list(range(nm)) and gal == list(range(ng))
    assert len(g.mat_nodes(g.grid[0] - 1)) + len(g.gal_nodes(g.grid[0] - 1))
    assert g.kt % 32 == 0 and (g.tiles - 1) * g.kt < nk <= g.tiles * g.kt


@pytest.mark.parametrize("itemsize", [4, 8])
def test_bwd_geometry_units_as_designed(itemsize):
    """At the main shape every block is one cosmology's unit of 16 mat
    and 16 gal nodes, two of each per warp of the 256-thread block: 16
    units a cosmology, 8192 blocks."""
    g = tiles.bwd_geometry(512, 256, 256, 3542, itemsize)
    assert (g.unit_m, g.unit_g) == (16, 16)
    assert g.unit_m % (g.block // 32) == 0 and g.unit_g % (g.block // 32) == 0
    assert g.unit_m // (g.block // 32) == 2 == g.unit_g // (g.block // 32)
    assert g.grid == (16, 512)
    assert all(len(g.mat_nodes(u)) == len(g.gal_nodes(u)) == 16
               for u in range(g.grid[0]))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nk", [17, 1000, 3542, 4096, 20000])
def test_bwd_geometry_shared_memory_fits(nk, itemsize):
    """A block's shared memory (the staged unit and one k tile) stays
    under the card's 227 KB at any NK; in float32 three blocks fit on an
    SM at the main paths' k (3542 lattice, 4096 table), in two tiles."""
    g = tiles.bwd_geometry(512, 256, 256, nk, itemsize)
    assert g.smem <= tiles.SMEM_PER_BLOCK
    assert g.dyn_smem <= tiles.BWD_TILE_BYTES[itemsize]
    assert g.dyn_smem == g.kt * (tiles.N_OUT + 1) * itemsize
    if itemsize == 4 and nk in (3542, 4096):
        assert g.blocks_per_sm_by_smem == 3 and g.tiles == 2
