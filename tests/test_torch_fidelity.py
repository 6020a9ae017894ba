"""The port's int8 fidelity tool (``tools/int8_fidelity.py``) against the
JAX package's ``tools/int8_fidelity.py``.

* ``PairStats.report()`` on fixed token arrays: the hand-computed
  percentages and the first-divergence histogram over JAX's edges;
* the ``--smoke`` measurement on JAX's ``init_flamingo(PRNGKey(0), smoke
  config)`` weights, bridged with ``from_jax_numpy``, for one batch of the
  tool's prompts (``RandomState(1000)``), against JAX's ``_generate_impl``
  on the same inputs, bf16 and int8 weight-only per layer, the JAX tool's
  ``DecodeConfig``: the port's tokens equal JAX's in every row, except from
  a near-tie onward (``tests/test_torch_slice.py``'s rule: JAX's own top two
  logits within 2 bf16 ulps at the first difference, the port's pick within
  2 ulps of JAX's top);
* the command line's modes and refusals.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.generation import DecodeConfig as JaxDecodeConfig, _generate_impl
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq

from flamingo_mini_tpu_torch.ops.quant import cast_params_bf16
from flamingo_mini_tpu_torch.tools import int8_fidelity as fid
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

# the JAX tool's --smoke config (tools/int8_fidelity.py:73-91)
SMOKE = dict(
    lm="gpt2", clip_model_type="openai/clip-vit-base-patch32",
    dim=64, dim_visual=64, xattn_every=1, xattn_dim_head=16,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    compute_dtype="bfloat16",
    lm_arch_overrides=dict(vocab_size=256, n_positions=512, n_embd=64,
                           n_layer=4, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
BATCH, TOKENS = 8, 16


def test_pair_stats_report_by_hand():
    stats = fid.PairStats(4)
    a = np.array([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]])
    stats.add(a, np.array([[1, 2, 3, 4], [1, 9, 3, 4], [0, 2, 3, 9]]))
    assert stats.report() == {
        "captions": 3, "identical_captions_pct": 33.33, "identical_tokens_pct": 75.0,
        "first_divergence_hist": {"[0,1)": 1, "[1,2)": 1, "[2,4)": 0}}
    # JAX's edges at 64 tokens; several batches accumulate
    stats = fid.PairStats(64)
    a = np.zeros((4, 64), np.int64)
    b = a.copy()
    b[0, 63], b[1, 5], b[2, 40:] = 1, 1, 7
    stats.add(a, b)
    stats.add(a, a)
    rep = stats.report()
    assert rep["captions"] == 8 and rep["identical_captions_pct"] == 62.5
    assert rep["identical_tokens_pct"] == round(100.0 * (512 - 26) / 512, 3)
    assert rep["first_divergence_hist"] == {
        "[0,1)": 0, "[1,2)": 0, "[2,4)": 0, "[4,8)": 1, "[8,16)": 0, "[16,32)": 0,
        "[32,64)": 2}


def test_configs_match_the_jax_tool():
    assert fid.smoke_config().to_dict() == JaxConfig(**SMOKE).to_dict()
    head = fid.headline_config()
    assert (head.lm, head.dim, head.lm_arch.n_layer, head.vision_arch.image_size) == (
        "gpt2-medium", 1024, 24, 224)


@functools.partial(jax.jit, static_argnames=("jc",))
def _jax_logits(params, ids, media, px, *, jc):
    """JAX's logits at every position of ``ids`` (the uncached forward)."""
    return jflam.forward(params, jc, ids, media_locations=media, pixel_values=px,
                         policy=jl.FAST).logits


def _held_to_jax(jc, jparams, got, want, inputs):
    """Rows equal up to their first difference, and there a near-tie of
    JAX's own logits -> the number of tokens compared."""
    ids, media, _, px = inputs
    L = fid.PROMPT_LEN
    logits, compared = None, 0
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            compared += TOKENS
            continue
        t = int(diff[0])
        compared += t
        if logits is None:
            full = np.concatenate([ids, want], axis=1)
            logits = np.asarray(_jax_logits(
                jparams, jnp.asarray(full), jnp.asarray(np.pad(media, ((0, 0), (0, TOKENS)))),
                jnp.asarray(px), jc=jc), np.float32)
        row = logits[r, L + t - 1]
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= 2 * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - 2 * ulp, (r, t, got[r, t])
    return compared


def test_smoke_measurement_matches_jax(monkeypatch):
    jc = JaxConfig(**SMOKE)
    config = fid.smoke_config()
    jparams = jflam.init_flamingo(jax.random.PRNGKey(0), jc)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    # the tool's measurement of one batch, its two decodes recorded
    decoded = []
    decode = fid.decode
    monkeypatch.setattr(fid, "decode", lambda *a, **kw: decoded.append(decode(*a, **kw))
                        or decoded[-1])
    stats = fid.compare(config, cast_params_bf16(tp), fid.quantize(tp, config),
                        captions=BATCH, batch=BATCH, decode_tokens=TOKENS, device="cpu")
    assert len(decoded) == 2
    want_stats = fid.PairStats(TOKENS)
    want_stats.add(*decoded)
    assert stats["int8_vs_bf16"].report() == want_stats.report()
    inputs = fid.batch_inputs(config, 0, BATCH, "cpu")
    np_inputs = [t.float().numpy() if t.is_floating_point() else t.numpy() for t in inputs]
    ids, media, mask, px = np_inputs
    # the JAX tool's prompts: RandomState(1000 + bi), 4 tokens below 255
    rs = np.random.RandomState(1000)
    np.testing.assert_array_equal(ids, rs.randint(0, 255, (BATCH, fid.PROMPT_LEN)))
    assert (media[:, 0] == 1).all() and media[:, 1:].sum() == 0 and mask.all()
    # each decode held to JAX's _generate_impl on the same weights and inputs
    dc = JaxDecodeConfig(max_length=fid.PROMPT_LEN + TOKENS, eos_token_id=10**9,
                         pad_token_id=0, prefix_block=32)
    jquant = jq.cast_params_bf16({**jparams, "lm": jq.quantize_gpt2_lm(jparams["lm"]),
                                  "xattn": jq.quantize_xattn_blocks(jparams["xattn"])})
    for name, jp, got in (("bf16", jq.cast_params_bf16(jparams), decoded[0]),
                          ("int8", jquant, decoded[1])):
        out, n, _, _ = _generate_impl(jp, jc, dc, jl.FAST, *(jnp.asarray(x) for x in (
            ids, media, mask)), None, jnp.asarray(px, jnp.bfloat16), jax.random.PRNGKey(0))
        assert int(n) == fid.PROMPT_LEN + TOKENS
        want = np.asarray(out)[:, fid.PROMPT_LEN:]
        assert got.shape == want.shape == (BATCH, TOKENS)
        compared = _held_to_jax(jc, jp, got, want, np_inputs)
        # the near-tie rule must not carry the test
        assert compared >= 0.5 * BATCH * TOKENS, (name, compared)


def test_command_line_modes():
    args = fid.parse_args([])
    assert (args.captions, args.batch, args.decode_tokens, args.device) == (1024, 32, 64, "cuda")
    args = fid.parse_args(["--smoke"])
    assert (args.captions, args.batch, args.decode_tokens) == (64, 8, 16)
    args = fid.parse_args(["--trained-smoke"])
    assert args.smoke and (args.captions, args.batch, args.decode_tokens) == (512, 8, 16)
    args = fid.parse_args(["--trained-full", "--w8a8", "--captions", "2000"])
    assert not args.smoke and args.captions == 2000 and args.train_steps == 400
    for argv in (["--smoke", "--w8a8"], ["--trained-smoke", "--w8a8"]):
        with pytest.raises(SystemExit):
            fid.parse_args(argv)
