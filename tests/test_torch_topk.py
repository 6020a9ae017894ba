"""The port's ``ops/topk.exact_topk`` against the JAX package's.

Values and indices must be identical: the blockwise decomposition is exact,
and ties go to the lower index on both sides (``lax.top_k``; the port's
stable sort). Inputs come from a numpy seed; small blocks put the short
rows through the blockwise path.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax
import torch

from flamingo_mini_tpu.ops import topk as jtopk

from flamingo_mini_tpu_torch.ops import topk as ptopk


def _check(x: np.ndarray, k: int, block: int):
    wv, wi = jtopk.exact_topk(jnp.asarray(x), k, block=block)
    gv, gi = ptopk.exact_topk(torch.from_numpy(x), k, block=block)
    assert gv.dtype == torch.from_numpy(x).dtype and gv.shape == (x.shape[0], k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # and both are one top k over the whole row
    fv, fi = lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(fi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(fv))


def _rows(kind: str, dtype: str, b: int, n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if kind == "random":
        x = rs.randn(b, n) * 100
    else:                       # ties: few distinct values, spread over blocks
        x = rs.randint(-3, 4, (b, n))
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n,k,block", [(1024, 8, 64), (1000, 5, 64), (777, 32, 32)],
                         ids=["divisible", "ragged", "k_equals_block"])
def test_blockwise_matches_jax(kind, dtype, n, k, block):
    """Rows far longer than two blocks: the blockwise path, on lengths that
    are and are not a multiple of the block (the tail padded with -inf or
    the integer minimum)."""
    _check(_rows(kind, dtype, 4, n, seed=n + k), k, block)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,k,block", [(128, 6, 64), (100, 6, 64), (1000, 70, 64)],
                         ids=["two_blocks", "short_row", "k_past_block"])
def test_fallback_matches_jax(dtype, n, k, block):
    """A row of at most two blocks, or k above the block: the plain top k."""
    _check(_rows("ties", dtype, 3, n, seed=k), k, block)


def test_ties_keep_the_lower_index():
    """Equal values across blocks come back in index order."""
    x = np.zeros((2, 300), np.float32)
    x[:, [5, 70, 140, 299]] = 1.0
    gv, gi = ptopk.exact_topk(torch.from_numpy(x), 6, block=32)
    assert gi[0].tolist() == [5, 70, 140, 299, 0, 1]
    assert gv[0].tolist() == [1.0, 1.0, 1.0, 1.0, 0.0, 0.0]
    _check(x, 6, 32)
