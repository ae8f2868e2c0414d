"""The order-energy kernels' launch plan, on the CPU: which kernel each D
takes, that the tile walk of each route covers every output once, the
grid's limits, and that the CPU path neither builds nor loads the CUDA
library. The kernels themselves run in tests/test_torch_cuda.py, on a
card."""

import pathlib

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch.ops import pairwise_order as k3

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: ragged (M, N) shapes around the tile edges (16 × 128 and 64 × 64), and
#: the eval's (Butterfly200's 344 and ETHEC's 723 labels against the val
#: and test splits)
WALK_SHAPES = [(1, 1), (15, 127), (16, 128), (17, 129), (33, 255),
               (64, 64), (65, 4097), (344, 5286), (344, 344), (723, 5049)]
#: (SMs, blocks an SM holds): one block in all, fewer blocks than tiles
#: (each block walks several), and the card's 132 SMs
GRIDS = [(1, 1), (3, 2), (132, 24)]


@pytest.mark.parametrize("D,route", [(0, "generic"), (1, "exact_d"),
                                     (2, "exact_d"), (10, "exact_d"),
                                     (16, "exact_d"), (17, "generic"),
                                     (131, "generic")])
def test_route_follows_from_d_alone(D, route):
    assert k3.route_for(D) == route
    assert k3.launch_plan(344, 5286, D, 132, 24).route == route
    assert (D == k3.EXACT_D_MAX) == (route == "exact_d"
                                     and k3.route_for(D + 1) == "generic")


def _coverage(plan, M, N):
    """Times each output of (M, N) is written by the plan's tile walk, and
    the tiles each block takes."""
    seen = np.zeros((M, N), np.int32)
    per_block = {}
    for block, rows, cols in k3.tile_walk(plan):
        seen[rows.start:min(rows.stop, M), cols.start:min(cols.stop, N)] += 1
        per_block[block] = per_block.get(block, 0) + 1
        # a tile starts inside the output: no block walks past it
        assert rows.start < M and cols.start < N
    return seen, per_block


@pytest.mark.parametrize("sms,bps", GRIDS, ids=str)
@pytest.mark.parametrize("M,N", WALK_SHAPES, ids=str)
def test_exact_d_walk_covers_every_output_once(M, N, sms, bps):
    plan = k3.launch_plan(M, N, 10, sms, bps)
    tiles = -(-M // 16) * -(-N // 128)
    assert plan.tile == k3.EXACT_TILE == (16, 128)
    assert (plan.tiles_m, plan.tiles_n) == (-(-M // 16), -(-N // 128))
    assert plan.grid == (min(tiles, sms * bps), 1)
    seen, per_block = _coverage(plan, M, N)
    assert (seen == 1).all()
    # the persistent grid: every block works, and their tile counts differ
    # by at most one
    assert sorted(per_block) == list(range(plan.grid[0]))
    assert max(per_block.values()) - min(per_block.values()) <= 1


@pytest.mark.parametrize("M,N", WALK_SHAPES, ids=str)
def test_generic_walk_covers_every_output_once(M, N):
    for D in (10, 131):   # the generic kernel at a small D, and its own
        plan = k3.launch_plan(M, N, D, route="generic")
        assert plan.route == "generic" and plan.tile == (64, 64)
        assert plan.grid == (-(-N // 64), -(-M // 64))
        seen, per_block = _coverage(plan, M, N)
        assert (seen == 1).all() and set(per_block.values()) == {1}


def test_eval_shapes_fill_the_card():
    """344 labels: 22 × 42 tiles of 16 × 128 at 5286 images, 7 a SM on
    132 SMs (the generic route's 64-row tiles made 498 blocks, 3.77 a SM);
    and 16-row tiles waste 2.3% of M = 344 and 1.8% of M = 723."""
    plan = k3.launch_plan(344, 5286, 10, 132, 24)
    assert (plan.tiles_m, plan.tiles_n, plan.grid) == (22, 42, (924, 1))
    assert 924 % 132 == 0
    for M in (344, 723):
        assert k3.launch_plan(M, 5049, 10, 132, 24).tiles_m * 16 <= 1.025 * M
    assert k3.launch_plan(344, 5286, 131).grid == (83, 6)


def test_grid_limits():
    big = 2**31 - 1
    # exact_d: the grid is capped at blocks a SM × SMs, whatever M and N
    plan = k3.launch_plan(big, big, 10, 132, 24)
    assert plan.grid == (132 * 24, 1)
    assert plan.tiles_m * plan.tiles_n > 2**48   # a 64-bit tile index
    # generic: 65535 row tiles (grid.y) of 64 rows
    assert k3.launch_plan(65535 * 64, 5, 131).grid == (1, 65535)
    with pytest.raises(ValueError, match="generic kernel's grid"):
        k3.launch_plan(65535 * 64 + 1, 5, 131)
    with pytest.raises(ValueError, match="generic kernel's grid"):
        k3.launch_plan(65535 * 64 + 1, 5, 10, route="generic")
    # both: M, N and D are C ints
    for shape in ((big + 1, 5, 10), (5, big + 1, 10), (5, 5, big + 1)):
        with pytest.raises(ValueError, match="int range"):
            k3.launch_plan(*shape, 132, 24)
    with pytest.raises(ValueError, match="no exact_d instance"):
        k3.launch_plan(5, 5, 17, 132, 24, route="exact_d")
    with pytest.raises(ValueError, match="empty"):
        k3.launch_plan(0, 5, 10, 132, 24)
    with pytest.raises(ValueError, match="blocks a SM"):
        k3.launch_plan(5, 5, 10, 132, 0)


@pytest.fixture
def no_library(monkeypatch):
    """Makes any build or load of the CUDA library fail the test."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build or load the "
                             "CUDA library")

    monkeypatch.setattr(k3, "build_library", refuse)
    monkeypatch.setattr(k3, "_library", refuse)
    monkeypatch.setattr(k3.subprocess, "run", refuse)


@pytest.mark.parametrize("D", [1, 10, 16, 17, 131])
def test_cpu_path_never_builds_or_loads_the_library(no_library, D):
    rng = np.random.RandomState(D)
    u = torch.from_numpy(rng.randn(19, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(130, D).astype(np.float32))
    counts = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES)
    out = k3.pairwise_order(u, v)
    torch.testing.assert_close(out, k3.pairwise_order_plain(u, v),
                               rtol=0, atol=0)
    # the generic route's own entry runs no plain version
    with pytest.raises(ValueError, match="no path for cpu"):
        k3.pairwise_order_generic(u, v)
    assert k3._LIB is None
    assert (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES) == counts


def test_variant_tool_cuts_the_current_source(monkeypatch):
    """k3_variants.py finds every statement it cuts in the kernel source,
    and each variant is a different source."""
    monkeypatch.syspath_prepend(str(ROOT))
    import k3_variants

    src = pathlib.Path(k3._SOURCE).read_text()
    variants = k3_variants.variant_sources(src)
    assert variants["kernel"] == src
    assert len(set(variants.values())) == len(variants) == 5
    assert "fake_row<D>(u + " in variants["no_load"]
    assert "load_row<D>(" not in variants["no_load"].split(
        "pairwise_order_exact_kernel(")[1].split("launch_exact")[0]
    with pytest.raises(SystemExit, match="has no"):
        k3_variants.variant_sources(src.replace("orow[j] = acc",
                                                "orow[j]= acc"))


def test_python_plan_matches_the_kernel_source():
    """The launch plan's tile shapes and D range are the constants the
    kernels are compiled with."""
    import re

    src = pathlib.Path(k3._SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxExactD") == k3.EXACT_D_MAX
    assert (const("kTileRows"), const("kTileCols")) == k3.EXACT_TILE
    assert (const("kTile"), const("kTile")) == k3.GENERIC_TILE
    assert const("kTileRows") <= 32   # a lane holds one u row of the tile
