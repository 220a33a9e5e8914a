"""The wgmma matmul kernel's plan on the CPU: the tile shape, block count
and raster group that ``kernels/matmul.py::plan`` picks, and the tile walk
of its persistent blocks (``tile_walk``, through ``tile_coords``, the
formula the kernel in ``csrc/matmul_wgmma.cu`` uses for a tile's place).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``);
what these tests hold is that every output tile is computed by exactly one
block, whatever the shape, so no element is missed or written twice.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import matmul as mm  # noqa: E402

H100_SMS = 132      # one block an SM: the blocks an H100 runs at once


@pytest.mark.parametrize("M,N,K,tile_n,blocks", [
    (4096, 4096, 4096, 256, 132),    # 512 tiles of 128x256: 3.9 waves
    (1000, 1528, 776, 128, 96),      # 96 tiles of 128x128 in one wave
])
def test_plan_picks_the_tile_with_the_fewest_waves_times_work(M, N, K,
                                                              tile_n, blocks):
    p = mm.plan(M, N, H100_SMS)
    assert (p.tile_n, p.blocks) == (tile_n, blocks)
    assert (p.tiles_m, p.tiles_n) == (-(-M // mm.TILE_M), -(-N // tile_n))


# K enters no plan: a K = 0 launch still stores every tile (zeros)
SHAPES = [(1, 8, 64), (1, 4096, 8), (100, 8, 16), (127, 120, 0),
          (4096 + 8, 4096, 4096), (4096, 4096, 0), (1000, 1528, 776),
          (2560, 3840, 64), (129, 257, 8), (100000, 8, 64), (8, 100000, 64),
          (777, 336, 1024)]


@pytest.mark.parametrize("resident", [H100_SMS, 7, 2])
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_tile_walk_covers_every_tile_once(M, N, K, resident):
    p = mm.plan(M, N, resident)
    assert p.tile_n in mm.TILE_NS
    assert p.blocks == min(p.tiles_m * p.tiles_n, resident)
    assert 1 <= p.group <= p.tiles_m
    walk = mm.tile_walk(p)
    assert len(walk) == p.blocks and all(walk)
    seen = [cell for block in walk for cell in block]
    assert sorted(seen) == [(r, c) for r in range(p.tiles_m)
                            for c in range(p.tiles_n)]
    # each block takes a tile more than another at most
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


def test_group_walks_its_rows_down_each_column():
    # 5 rows of tiles by 3 columns in groups of 2: rows 0-1 column by
    # column, then rows 2-3, then the last row alone
    order = [mm.tile_coords(t, 5, 3, 2) for t in range(15)]
    assert order == [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2),
                     (2, 0), (3, 0), (2, 1), (3, 1), (2, 2), (3, 2),
                     (4, 0), (4, 1), (4, 2)]
    # group 1 is row-major order, a group of every row column-major order
    assert [mm.tile_coords(t, 2, 3, 1) for t in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [mm.tile_coords(t, 2, 3, 2) for t in range(6)] == [
        (0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2)]


@pytest.mark.parametrize("M,N", [(4096, 4096), (8192, 8192), (4096 + 8, 4096),
                                 (16384, 2048), (2048, 16384)])
def test_group_reads_no_more_than_row_major_order(M, N):
    # the first wave's rows of x and columns of y, as the plan counts them:
    # the chosen group never reads more than plain row-major order (group 1)
    p = mm.plan(M, N, H100_SMS)
    span = mm._first_wave_span(p.tiles_m, p.tiles_n, p.tile_n, p.blocks,
                               p.group)
    assert span <= mm._first_wave_span(p.tiles_m, p.tiles_n, p.tile_n,
                                       p.blocks, 1)
    if (M, N) == (4096, 4096):
        # 132 blocks on 16 rows of tiles by 9 columns: 16 * 128 + 9 * 256
        # rows and columns, against 9 rows of tiles by all 16 columns in
        # row-major order
        assert (p.group, span) == (16, 16 * 128 + 9 * 256)
        assert mm._first_wave_span(p.tiles_m, p.tiles_n, p.tile_n, p.blocks,
                                   1) == 9 * 128 + 16 * 256


@pytest.mark.parametrize("M,N,resident", [(0, 8, 132), (8, 0, 132),
                                          (8, 8, 0)])
def test_plan_refuses_an_empty_shape_or_card(M, N, resident):
    with pytest.raises(ValueError):
        mm.plan(M, N, resident)
