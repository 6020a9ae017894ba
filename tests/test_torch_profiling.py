"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's, and the ``utils`` exports.

* ``PhaseTimer.summary()`` has JAX's keys and counts for the same sequence
  of phases, fenced values included;
* ``annotate`` spans appear by name in the Chrome trace ``trace`` writes;
* ``debug_nans``: on, ``torch.log(torch.tensor(-1.))`` raises
  ``FloatingPointError`` as JAX's ``jnp.log(-1.)`` does, and so does a NaN
  born in the backward; a kernel wrapper's float output with a NaN is
  refused by ``cuda_build.check``, which every launch site calls with its
  outputs, and which reads them only behind the flag; a tiny generate runs clean, and one with a NaN planted
  in its pixels raises; off, nothing raises and no mode is left installed.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

import flamingo_mini_tpu.utils as jax_utils
from flamingo_mini_tpu.utils import profiling as jprof

import flamingo_mini_tpu_torch as port
import flamingo_mini_tpu_torch.utils as port_utils
from flamingo_mini_tpu_torch.ops import cuda_build
from flamingo_mini_tpu_torch.utils import profiling as pprof

TINY = dict(
    lm="gpt2", dim=64, dim_visual=32, xattn_every=1, xattn_dim_head=16,
    xattn_heads=2, resampler_depth=1, resampler_dim_head=16, resampler_heads=2,
    resampler_num_latents=4, compute_dtype="bfloat16",
    lm_arch_overrides=dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2,
                           n_head=2),
    vision_arch_overrides=dict(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=1, num_attention_heads=2,
                               image_size=32, patch_size=16))


@pytest.fixture
def nans_off():
    """debug_nans is process-wide: every test leaves it off."""
    yield
    pprof.debug_nans(False)


def test_utils_exports_match_jax():
    assert port_utils.__all__ == jax_utils.__all__
    for name in jax_utils.__all__:
        assert callable(getattr(port_utils, name)), name


def test_phase_timer_summary_matches_jax():
    phases = ("encode", "prefill", "decode", "decode", "decode", "encode")
    summaries = []
    for prof, value in ((jprof, lambda: jnp.ones(4) * 2), (pprof, lambda: torch.ones(4) * 2)):
        timer = prof.PhaseTimer()
        for name in phases:
            with timer.phase(name):
                out = timer.fence(value())
            assert timer._last_result is None
        assert float(out.sum()) == 8.0
        summaries.append(timer.summary())
    want, got = summaries
    assert list(got) == list(want) == ["encode", "prefill", "decode"]
    for name in want:
        assert sorted(got[name]) == sorted(want[name]) == ["count", "mean_ms", "total_s"]
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["total_s"] >= 0
        assert got[name]["mean_ms"] == pytest.approx(
            1e3 * got[name]["total_s"] / got[name]["count"])


def test_annotate_spans_appear_in_the_trace(tmp_path):
    with pprof.trace(str(tmp_path)):
        with pprof.annotate("encode"):
            x = torch.randn(16, 16) @ torch.randn(16, 16)
        with pprof.annotate("decode"):
            x = torch.softmax(x, dim=-1)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"encode", "decode"} <= spans, spans
    assert any(e.get("name") == "aten::softmax" for e in events)


def test_debug_nans_raises_like_jax(nans_off):
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jnp.log(-1.0).block_until_ready()
    finally:
        jax.config.update("jax_debug_nans", False)
    pprof.debug_nans(True)
    assert cuda_build.nan_checks and torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="log"):
        torch.log(torch.tensor(-1.0))
    # finite values, ints, infinities and uninitialised buffers pass
    torch.log(torch.tensor(0.0))
    torch.empty(1024)
    torch.arange(5) // 2
    # a NaN born in the backward: 0 * d|x|^0.5 at 0 is 0 * inf
    x = torch.zeros(3, requires_grad=True)
    y = (x.abs() ** 0.5 * 0.0).sum()
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan"):
        y.backward()
    pprof.debug_nans(False)
    assert not cuda_build.nan_checks and not torch.is_anomaly_enabled()
    assert _get_current_dispatch_mode() is None
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))


def test_kernel_outputs_are_checked_behind_the_flag(nans_off):
    """The hand-written kernels are launched through ctypes, out of the
    dispatcher's sight: every launch site passes its float outputs to
    ``cuda_build.check``, which looks for NaN in them when ``debug_nans``
    is on, and does not touch them when it is off."""
    bad = torch.tensor([0.5, float("nan")])
    unreadable = torch.empty(2, device="meta")      # any read of its values raises
    cuda_build.check(0, "decode_attention", torch.zeros(2), bad, unreadable)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cuda_build.check(700, "decode_attention", bad)
    pprof.debug_nans(True)
    with pytest.raises(FloatingPointError, match="decode_attention"):
        cuda_build.check(0, "decode_attention", torch.zeros(2), bad)
    cuda_build.check(0, "lm_head_argmax", torch.tensor([3, 4], dtype=torch.int32),
                     torch.tensor([float("inf")]))
    cuda_build.check(0, "grid_sync_test")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cuda_build.check(700, "decode_attention", bad)
    pprof.debug_nans(False)
    cuda_build.check(0, "decode_attention", bad, unreadable)


def test_debug_nans_on_a_generate(nans_off):
    """A tiny bf16 + int8 generate runs clean with the checks on; a NaN
    planted in its pixels raises; off, the same call returns."""
    model = port.FlamingoModel(port.FlamingoConfig(**TINY), device="cpu", seed=0)
    model.quantize_int8().to_bf16()
    for blk in model.params["xattn"].values():
        blk["alpha_attn"].fill_(0.5)
        blk["alpha_ffw"].fill_(0.5)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 100, (2, 3))
    media = np.zeros((2, 3), np.int32)
    media[:, 0] = 1
    pixels = torch.tensor(rs.randn(2, 1, 3, 32, 32), dtype=torch.float32)
    bad = pixels.clone()
    bad[0, 0, 0, 5, 5] = float("nan")

    def run(px):
        return model.generate(ids, media_locations=media, pixel_values=px,
                              max_length=8, eos_token_id=999, pad_token_id=0,
                              prefix_block=4)
    pprof.debug_nans(True)
    clean = run(pixels)
    with pytest.raises(FloatingPointError):
        run(bad)
    pprof.debug_nans(False)
    assert torch.equal(run(pixels), clean)
    assert run(bad).shape == (2, 8)
