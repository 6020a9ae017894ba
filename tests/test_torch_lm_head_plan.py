"""The lm_head kernel's deal over its persistent grid, on the CPU.

``lm_head_argmax``'s CUDA kernel (csrc/lm_head_argmax.cu) runs only on the
card (tests/test_torch_gpu.py holds it against its plain version there,
and ``smem_bytes`` against the kernel's own layout); ``ops/lm_head.py``
mirrors its deal, computed from the shapes. Here: the deal covers every
(row group, vocab tile, weight chunk) once, each warpgroup's ring is
filled in the order it is consumed, and the shared memory fits at every
row count and width it takes. No JAX.
"""
import numpy as np
import pytest

from flamingo_mini_tpu_torch.ops import lm_head as lh

H100_SMEM = 232448   # shared memory a block may opt in to on an H100


# (Vp, D, B, blocks): the main path's head, OPT-1.3B's, the odd w8a8 batch,
# past one row group, a grid wider than the tiles
HEADS = [(51200, 1024, 32, 132), (51200, 2048, 8, 132), (51200, 1024, 3, 132),
         (51200, 1024, 65, 132), (51200, 2048, 33, 132), (2048, 1024, 5, 132),
         (4096, 4096, 17, 7)]


@pytest.mark.parametrize("Vp,D,B,blocks", HEADS)
def test_head_deal_covers_every_tile_once(Vp, D, B, blocks):
    """``lm_head_argmax``'s persistent grid (one block per SM, at most one
    per tile): every (row group, vocab tile, weight chunk) is streamed once
    and consumed once, each by one warpgroup; each warpgroup's ring is
    filled in the order the warpgroup consumes it; the shares are
    contiguous and in block order."""
    n_tiles = Vp // lh.TILE
    grid = min(blocks, n_tiles)
    nk, rows = D // lh.TILE, lh.group_rows(D)
    groups = -(-B // rows)
    seen = np.zeros((groups, n_tiles, nk), dtype=np.int64)
    last = -1
    for block in range(grid):
        producer, consumers = lh.schedule(block, grid, n_tiles, D, B)
        t0 = block * n_tiles // grid
        for w, entries in enumerate(consumers):
            assert [e for e in producer if e[0] == w] == entries, (block, w)
            assert [e[1] for e in entries] == list(range(len(entries)))
            assert all((tile - t0) % lh.GROUPS == w for _w, _j, _r0, tile, _c in entries)
        assert len(producer) == sum(len(e) for e in consumers)
        for _w, _j, r0, tile, c in producer:
            seen[r0 // rows, tile, c] += 1
        tiles = sorted({tile for _w, _j, _r, tile, _c in producer})
        if tiles:
            assert tiles[0] == last + 1 and tiles == list(range(tiles[0], tiles[-1] + 1))
            last = tiles[-1]
    assert (seen == 1).all()


@pytest.mark.parametrize("D", [1024, 2048, 4096, 6144])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 33, 64, 65, 128])
def test_head_shared_memory_fits(D, B):
    """The head kernel's shared memory fits the card at every width it
    takes, and its groups hold at least 8 rows."""
    assert lh.group_rows(D) >= 8
    assert lh.smem_bytes(D, B) <= H100_SMEM
