"""The port's stream probe (``flamingo_mini_tpu_torch.tools.probe_stream``)
against the TPU probe's kernel.

``stream_sum`` runs its plain PyTorch version on CPU tensors; here it is
held against ``tools/probe_stream.py::pallas_stream`` (loaded by path: the
tools are not a package) in Pallas interpret mode, on the same numpy
buffer. Tolerance: float32 within 1e-5 relative (the two sum 64 x 128
values in another order). The CUDA kernel is held against the plain
version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from flamingo_mini_tpu_torch.tools import probe_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_stream", os.path.join(REPO, "tools", "probe_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,chunk_rows,acc", [(64, 16, 3.0), (64, 64, 0.0),
                                                 (96, 8, -2.5e5), (32, 32, 7e28)])
def test_stream_sum_matches_pallas_stream(tpu_probe, rows, chunk_rows, acc):
    """A seeded (rows, 1024) buffer; a carry of 7e28 makes its term (steps x
    128 x acc x 1e-30) as large as the sum itself."""
    x = np.random.RandomState(rows + chunk_rows).randn(rows, 1024).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = float(tpu_probe.pallas_stream(jnp.asarray(x, jnp.bfloat16),
                                             jnp.float32(acc), chunk_rows))
    got = probe_stream.stream_sum(torch.tensor(x).to(torch.bfloat16),
                                  torch.tensor(acc, dtype=torch.float32), chunk_rows)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_stream_sum_reads_only_the_first_128_columns_into_the_sum():
    """Columns 128.. are read but do not enter the sum, as on the TPU."""
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    x[:, 128:] = 1000.0
    x[:, :128] = 1.0
    got = probe_stream.stream_sum(x, torch.tensor(0.0), 4)
    assert float(got) == 8 * 128


def test_stream_sum_refuses_bad_input():
    acc = torch.tensor(0.0)
    for x, chunk in ((torch.zeros((8, 512), dtype=torch.bfloat16), 4),
                     (torch.zeros((8, 1024), dtype=torch.float32), 4),
                     (torch.zeros((8, 1024), dtype=torch.bfloat16), 3)):
        with pytest.raises(ValueError):
            probe_stream.stream_sum(x, acc, chunk)


def test_cli_needs_the_card():
    """Without a CUDA device the CLI exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe_stream.main([]) == 1
