"""The port's w8a8 tier (``generate(megakernel=True, w8a8=True)``) against
the JAX package.

``decode_step_megakernel(..., act_quant=True)`` runs its plain PyTorch
version on CPU tensors; here it is held against
``pallas_megadecode.decode_step_megakernel(..., act_quant=True)``, which
runs in interpret mode on the CPU, on the same weights (the JAX package
initialises them, ``from_jax_numpy`` carries them over) and the same numpy
inputs. The CUDA mode itself is held against the plain version on the card
by tests/test_torch_gpu.py and chip_smoke.py.

Models: test_torch_megakernel.py's small GPT-2 (D=128, 4 heads, 2 layers,
XI=128, 8 latents, vocab 256; xattn every layer or every other layer) and
test_torch_opt.py's small pre-norm OPT (D=128, ffn 512, ReLU, xattn every
other layer), int8 trunk and xattn, bf16, gates open unless stated.

Tolerances.

* The exact case is bitwise: one OPT layer with the gates closed, every row
  with one live cache slot, so that attention returns V exactly and every
  step is a deterministic function of identical inputs. JAX's interpret
  run is compiled there with ``xla_allow_excess_precision`` off: XLA's CPU
  compiler otherwise keeps the residual ``x + out_proj(...)`` in float32
  inside its fused program and skips the bf16 rounding that the TPU and
  the port apply before the second LayerNorm (measured on this case: 123
  of 512 hidden elements part by up to 2 bf16 ulps with it on, 0 with it
  off; K/V rows 0 either way).
* One step at 1 and 2 layers, JAX compiled as its own tests run it: the
  hidden row and the written K/V rows within 2e-2 normwise, three times
  the largest measured (these inputs: hidden rows 2.1e-3 to 2.8e-3, K/V
  rows 3.5e-3 to 6.7e-3). XLA's excess precision and float32 sums in
  another order part single bf16 elements, and a parted element can move
  a row's quantization scale, which moves every element of the next
  linear's output.
* Greedy tokens: identical, or a row parts where the port's own top two
  w8a8 logits lie within 2 bf16 ulps (checked at the first difference of
  each row; the two runs share the prefix up to there). Measured: every
  row identical.
* Beams (k=2, b=4: 8 rows, so JAX takes its megakernel beam path): tokens
  identical, the sequence scores within 2e-2 (test_torch_beam.py's score
  envelope). Measured: every row identical, scores within 1.3e-3.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import beam_search as jbs
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _generate_impl)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import pallas_megadecode as jmega
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import generation as pgen
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

GPT2 = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8, compute_dtype="bfloat16",
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
OPT_ARCH = dict(vocab_size=256, max_position_embeddings=64, hidden_size=128,
                ffn_dim=512, num_hidden_layers=2, num_attention_heads=4,
                word_embed_proj_dim=128)
OPT = dict(
    lm="facebook/opt-1.3b", dim=128, dim_visual=64, xattn_every=2,
    xattn_dim_head=32, xattn_heads=4, resampler_depth=1, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8, compute_dtype="bfloat16",
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=16))
MAX_LENGTH, PREFIX_BLOCK, EOS = 20, 8, 999   # EOS unreachable (vocab 257)
D, XH, DH, NV = 128, 4, 32, 8


def _build(kind, n_layer=2, gates=(0.5, 0.3), seed=0):
    """(jax config, port config, jax params, port params): int8 trunk and
    xattn, bf16, the gates' alphas as given."""
    if kind == "opt":
        kw = dict(OPT, lm_arch_overrides=dict(OPT_ARCH, num_hidden_layers=n_layer))
    else:
        kw = dict(GPT2, xattn_every=int(kind[-1]))
    jc, pc = JaxConfig(**kw), port.FlamingoConfig(**kw)
    params = jflam.init_flamingo(jax.random.PRNGKey(seed), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), gates[0], jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), gates[1], jnp.float32)
    quantize = jq.quantize_opt_lm if kind == "opt" else jq.quantize_gpt2_lm
    params["lm"] = quantize(params["lm"])
    params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
    params = jq.cast_params_bf16(params)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


@pytest.fixture(scope="module")
def models():
    """(kind, n_layer, gates) -> ``_build(...)``, filled on first use."""
    return {}


def _model(models, kind, n_layer=2, gates=(0.5, 0.3)):
    key = (kind, n_layer, gates)
    if key not in models:
        models[key] = _build(kind, n_layer, gates)
    return models[key]


def _step_inputs(L, b, T, cur, npad, text_time, xattn_every, seed):
    rs = np.random.RandomState(seed)
    x_emb = rs.randn(b, D).astype(np.float32)
    kc, vc = ((rs.randn(L, T, b, D) * 0.5).astype(np.float32) for _ in range(2))
    kv = {str(l): tuple((rs.randn(b, XH, 2 * NV, DH) * 0.5).astype(np.float32)
                        for _ in range(2)) for l in range(0, L, xattn_every)}
    return dict(x_emb=x_emb, kc=kc, vc=vc, kv=kv, cur=cur,
                npad=np.asarray(npad, np.int32),
                text_time=np.asarray(text_time, np.int32))


def _jax_step(jc, params, inp, kv_limit, *, exact=False):
    """JAX's megakernel with act_quant -> [hidden, kc, vc] as float32 numpy;
    ``exact``: compiled with xla_allow_excess_precision off."""
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    L = inp["kc"].shape[0]
    jp = jmega.pack_decode_weights(params, jc)
    jxk, jxv = jmega.pack_xattn_kv_flat(
        {k: (bf(a), bf(c)) for k, (a, c) in inp["kv"].items()}, L)
    args = (jxk, jxv, bf(inp["kc"]), bf(inp["vc"]), bf(inp["x_emb"]),
            jnp.asarray(inp["npad"]), jnp.asarray(inp["text_time"]),
            jnp.int32(inp["cur"]))
    fn = jax.jit(lambda *a: jmega.decode_step_megakernel(
        jp, *a, config=jc, kv_limit=kv_limit, act_quant=True))
    opts = {"xla_allow_excess_precision": False} if exact else None
    out = fn.lower(*args).compile(compiler_options=opts)(*args)
    return [np.asarray(w.astype(jnp.float32)) for w in out]


def _port_step(pc, tp, inp, kv_limit):
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    L = inp["kc"].shape[0]
    packed = pmega.pack_decode_weights(tp, pc)
    xk, xv = pmega.pack_xattn_kv_flat(
        {k: (tb(a), tb(c)) for k, (a, c) in inp["kv"].items()}, L)
    kc, vc = tb(inp["kc"]), tb(inp["vc"])
    hidden = pmega.decode_step_megakernel(
        packed, xk, xv, kc, vc, tb(inp["x_emb"]), torch.tensor(inp["npad"]),
        torch.tensor(inp["text_time"]), inp["cur"], config=pc, kv_limit=kv_limit,
        act_quant=True)
    return [hidden.float().numpy(), kc.float().numpy(), vc.float().numpy()]


def _rows_at_cur(out, cur):
    return {"hidden": out[0], "k rows": out[1][:, cur], "v rows": out[2][:, cur]}


# ---------------------------------------------------------------------------
# the exact case
# ---------------------------------------------------------------------------


EXACT_CUR = 9


@pytest.fixture(scope="module")
def exact_case(models):
    """One OPT layer, gates closed, each row's only live slot at ``cur``
    (npad == cur), row 2 without an image -> (port model, inputs, JAX's
    bitwise-comparable result)."""
    jc, pc, params, tp = _model(models, "opt", n_layer=1, gates=(0.0, 0.0))
    inp = _step_inputs(1, 4, 32, EXACT_CUR, [EXACT_CUR] * 4, [1, 1, 0, 1], 2, seed=1)
    return pc, tp, inp, _rows_at_cur(_jax_step(jc, params, inp, 16, exact=True),
                                     EXACT_CUR)


def _parted(got, want):
    """{name: (number of parted elements, the first few (index, port, JAX))}."""
    out = {}
    for name in want:
        idx = np.argwhere(got[name] != want[name])
        out[name] = (len(idx), [(tuple(i), float(got[name][tuple(i)]),
                                 float(want[name][tuple(i)])) for i in idx[:5]])
    return out


def test_exact_case_is_bitwise(exact_case):
    """The K/V rows at ``cur`` and the hidden row equal JAX's bit for bit;
    a parting prints where (module docstring)."""
    pc, tp, inp, want = exact_case
    got = _rows_at_cur(_port_step(pc, tp, inp, 16), EXACT_CUR)
    parted = _parted(got, want)
    assert all(n == 0 for n, _ in parted.values()), parted


def test_exact_case_sees_per_slice_scales(exact_case, monkeypatch):
    """The row form's per-slice scales are what the exact case checks:
    quantizing each row of fc2's input (512 wide, 4 slices of D=128) with
    one scale instead parts the hidden row."""
    pc, tp, inp, want = exact_case
    lin = pmega._lin_w8a8
    monkeypatch.setattr(pmega, "_lin_w8a8",
                        lambda x, w, s, b=None, *, width=None: lin(x, w, s, b))
    got = _rows_at_cur(_port_step(pc, tp, inp, 16), EXACT_CUR)
    parted = _parted(got, want)
    assert parted["hidden"][0] > 0, parted
    assert parted["k rows"][0] == parted["v rows"][0] == 0, parted


def test_quantize_rows_is_aquant():
    """``quantize_rows`` against ``aquant``'s formula in numpy float32:
    a zero row, values on a .5 boundary (round half to even), extremes."""
    rs = np.random.RandomState(4)
    x = (rs.randn(5, 64) * 3).astype(np.float32)
    x[1] = 0.0
    x[2, :4] = [127.0, 0.5, 1.5, -2.5]     # amax 127: s = 1, q = x rounded
    x[2, 4:] = 0.0
    xb = torch.tensor(x).to(torch.bfloat16)
    q, s = pmega.quantize_rows(xb)
    x32 = xb.float().numpy()
    amax = np.abs(x32).max(axis=1, keepdims=True)
    s_want = np.maximum(amax, np.float32(1e-30)) * np.float32(1.0 / 127.0)
    q_want = np.round(x32 * (np.float32(1.0) / s_want)).astype(np.int8)
    np.testing.assert_array_equal(s.numpy(), s_want)
    np.testing.assert_array_equal(q.numpy(), q_want)
    assert q.dtype == torch.int8 and q[1].abs().sum() == 0
    assert q[2, :4].tolist() == [127, 0, 2, -2]


def test_int_dot_is_exact_past_2_24():
    """An int8 dot whose sum passes 2^24 (K = 2048: OPT-1.3B's D) is exact,
    where a float32 product would round."""
    q = torch.full((1, 2048), 127, dtype=torch.int8)
    w = torch.full((8, 2048), 127, dtype=torch.int8)
    w[1, 0] = 126                                     # sum 127^2 * 2048 - 127
    got = pmega._int_dot(q, w)
    assert got.dtype == torch.float32
    exact = [127 * 127 * 2048, 127 * 127 * 2048 - 127]
    assert got[0, :2].double().tolist() == [float(np.float32(v)) for v in exact]


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n_layer", [("gpt21", 2), ("gpt22", 2), ("opt", 2),
                                          ("opt", 1)])
def test_one_step_matches_jax(models, kind, n_layer):
    """GPT-2 with xattn every layer and every other layer, OPT at 2 and 1
    layers. Two images (16 latents); row 2 has no image yet (text_time 0),
    row 3 sees the second; rows left-padded by 0-3 slots; the live prefix
    ends before the cache does. Normwise within 2e-2 (module docstring)."""
    jc, pc, params, tp = _model(models, kind, n_layer=n_layer)
    inp = _step_inputs(n_layer, 4, 64, 10, [0, 2, 3, 1], [1, 1, 0, 2], jc.xattn_every,
                       seed=7)
    want = _rows_at_cur(_jax_step(jc, params, inp, 16), 10)
    got = _rows_at_cur(_port_step(pc, tp, inp, 16), 10)
    for name in want:
        assert np.isfinite(got[name]).all(), name
        rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(want[name])
        print(f"{kind} layers={n_layer} {name}: normwise {rel}")
        assert rel <= 2e-2, (name, rel)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _prompts(b=4, seed=0, L=5, size=64):
    """Row 1 (when b > 1) is left-padded and its image comes at slot 2."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    if b > 1:
        ids[1, :2], mask[1, :2] = 0, 0
        media[1] = 0
        media[1, 2] = 1
    return ids, media, mask, rs.randn(b, 1, 3, size, size).astype(np.float32)


def _port_generate(pc, tp, ids, media, mask, pixels, **kw):
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    return model.generate(ids, media_locations=media, attention_mask=mask,
                          pixel_values=pixels, max_length=MAX_LENGTH,
                          eos_token_id=EOS, pad_token_id=0,
                          prefix_block=PREFIX_BLOCK, megakernel=True, w8a8=True,
                          **kw)


def _recording_head(monkeypatch):
    """Record, at each greedy step, each row's top-2 gap of the port's own
    w8a8 logits in bf16 ulps of its top logit (the fused head's plain
    version computes them)."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax
    gaps = []

    def head(w8, scale, x, *, n_valid):
        logits = (torch.matmul(x.float(), w8.float().t()) * scale)[:, :n_valid]
        top2 = logits.to(torch.bfloat16).float().topk(2).values
        ulp = 2.0 ** (torch.floor(torch.log2(top2[:, 0].abs())) - 7)
        gaps.append(((top2[:, 0] - top2[:, 1]) / ulp).numpy())
        return lm_head_argmax(w8, scale, x, n_valid=n_valid)
    monkeypatch.setattr(pgen, "lm_head_argmax", head)
    return gaps


def test_greedy_w8a8_matches_jax(models, monkeypatch):
    """Batch 4 with a left-padded row whose image comes late, through JAX's
    w8a8 megakernel (interpret mode) and the port's."""
    jc, pc, params, tp = _model(models, "gpt21")
    ids, media, mask, pixels = _prompts()
    L = ids.shape[1]
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, megakernel=True, w8a8=True)
    calls = []
    mega = jmega.decode_step_megakernel
    monkeypatch.setattr(jmega, "decode_step_megakernel",
                        lambda *a, **k: calls.append(k.get("act_quant")) or mega(*a, **k))
    want, n, _, _ = _generate_impl(
        params, jc, dc, jl.FAST, jnp.asarray(ids), jnp.asarray(media),
        jnp.asarray(mask), None, jnp.asarray(pixels), jax.random.PRNGKey(0))
    want = np.asarray(want)
    assert int(n) == MAX_LENGTH and calls and all(calls), calls
    gaps = _recording_head(monkeypatch)
    got = _port_generate(pc, tp, ids, media, mask, pixels).numpy()
    print(f"greedy w8a8: {int((got == want).all(axis=1).sum())}/{len(got)} rows identical")
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if len(diff):
            step = int(diff[0]) - 1        # gaps[j]: decode step j (token L + 1 + j)
            assert step >= 0 and gaps[step][r] <= 2.0, (r, int(diff[0]), gaps[step][r])


def test_odd_batch_runs_w8a8_unpadded(models, monkeypatch):
    """b=3 runs the w8a8 megakernel as given, every step, and its tokens
    equal those of the same three rows inside a batch of 4: quantization
    is per row."""
    jc, pc, params, tp = _model(models, "gpt22")
    ids, media, mask, pixels = _prompts(b=4, seed=11)
    calls = []
    plain = pmega.decode_step_megakernel_plain
    monkeypatch.setattr(pmega, "decode_step_megakernel_plain",
                        lambda *a, **k: calls.append((a[5].shape[0], k["act_quant"]))
                        or plain(*a, **k))
    even = _port_generate(pc, tp, ids, media, mask, pixels).numpy()
    odd = _port_generate(pc, tp, ids[1:], media[1:], mask[1:], pixels[1:]).numpy()
    steps = MAX_LENGTH - ids.shape[1] - 1
    assert calls == [(4, True)] * steps + [(3, True)] * steps
    np.testing.assert_array_equal(odd, even[1:])


def test_beams_w8a8_match_jax(models, monkeypatch):
    """k=2 beams over b=4 rows (8 rows: lcm(8, 2) divides them, so JAX runs
    its megakernel beam path and does not drop w8a8)."""
    jc, pc, params, tp = _model(models, "opt")
    ids, media, mask, pixels = _prompts(seed=3, size=32)
    kw = dict(max_length=MAX_LENGTH, pad_token_id=0, eos_token_id=EOS,
              prefix_block=PREFIX_BLOCK, num_beams=2, megakernel=True, w8a8=True,
              return_scores=True)
    calls = []
    mega = jmega.decode_step_megakernel
    monkeypatch.setattr(jmega, "decode_step_megakernel",
                        lambda *a, **k: calls.append(k.get("act_quant")) or mega(*a, **k))
    want = jbs.beam_generate(params, jc, JaxDecodeConfig(**kw), jl.FAST,
                             jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
                             None, pixel_values=jnp.asarray(pixels))
    want = [np.asarray(w) for w in want]
    assert calls and all(calls), calls
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    got = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, **kw)
    got = [t.numpy() for t in got]
    print(f"beams w8a8: {int((got[0] == want[0]).all(axis=1).sum())}/{len(got[0])} rows "
          f"identical, scores within {np.abs(got[1] - want[1]).max()}")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_w8a8_refusals(models):
    """w8a8 without the megakernel, and with diverse beams (which run per
    layer), raise ValueError, as JAX's DecodeConfig does for the first."""
    jc, pc, params, tp = _model(models, "gpt21")
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    ids = np.ones((2, 3), np.int32)
    with pytest.raises(ValueError):
        JaxDecodeConfig(w8a8=True)
    for knob in (dict(w8a8=True), dict(w8a8=True, megakernel=True, num_beams=4,
                                       num_beam_groups=2)):
        with pytest.raises(ValueError):
            m.generate(ids, max_length=8, **knob)


def test_shared_memory_decision():
    """The refusal's decision, on given bytes and limit: opt-6.7b's D=4096
    stages min(b, 32) * D * 2 bytes plus the 8,192-byte reduction buffer
    (and 128 bytes of amax words in the w8a8 mode); on a 232,448-byte limit
    27 rows fit and 28 do not, in both modes."""
    limit = 232_448
    for extra in (0, 128):
        pmega.refuse_unless_fits(27, 27 * 4096 * 2 + 8192 + extra, limit)
        with pytest.raises(ValueError, match="28 rows need 237568"):
            pmega.refuse_unless_fits(28, 28 * 4096 * 2 + 8192, limit)
    pmega.check_fits(port.FlamingoConfig(lm="facebook/opt-1.3b", dim=2048), 4096,
                     128, 64, act_quant=True, device="cpu")   # the CPU takes any size


def test_refusal_comes_before_vision_and_prefill(models, monkeypatch):
    """generate and beam search ask ``check_fits`` (given the rows b or
    b * k, the flat cache's 64 slots for max_length 12, and the media's
    latents) before they encode the images or run the prompt."""
    jc, pc, params, tp = _model(models, "gpt21")
    asked, ran = [], []

    def refuse(config, rows, t_lim, n_lat, *, act_quant, device):
        asked.append((rows, t_lim, n_lat, act_quant))
        raise ValueError("too wide")
    monkeypatch.setattr(pmega, "check_fits", refuse)
    monkeypatch.setattr(pgen.flamingo, "encode_resample_visuals",
                        lambda *a, **k: ran.append("vision"))
    monkeypatch.setattr(pgen, "_prefill", lambda *a, **k: ran.append("prefill"))
    ids, media, mask, pixels = _prompts(b=2)
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    for kw in (dict(), dict(num_beams=3)):
        with pytest.raises(ValueError, match="too wide"):
            m.generate(ids, media_locations=media, attention_mask=mask,
                       pixel_values=pixels, max_length=12, megakernel=True,
                       w8a8=True, **kw)
    assert asked == [(2, 64, NV, True), (6, 64, NV, True)] and not ran
