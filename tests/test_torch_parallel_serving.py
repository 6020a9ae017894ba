"""Data- and tensor-parallel ``generate`` of the port against JAX's meshes.

The port's ranks are 4 gloo processes on the CPU (``torch_parallel_worker``,
which imports no JAX); JAX runs on the conftest's 8 virtual devices. Both get
the same seeded weights: the JAX package initialises them and
``from_jax_numpy`` carries them over.

* DP (test_torch_megakernel.py's SMALL model: D=128, int8 trunk and xattn,
  bf16, gates open, xattn every 2 layers; 8 prompts, a left-padded row and a
  late image): greedy per layer (with the fused head) and on the megakernel
  over a (4, 1) mesh, against JAX's ``generate(mesh=create_mesh((8, 1)))``
  under test_torch_megakernel.py's near-tie rule (2 bf16 ulps), and equal to
  the port's one-process run (each data rank runs the one-device program on
  its rows). Top-k sampling from one seeded generator: equal to the
  one-process run (each rank draws the whole batch's noise and keeps its
  rows; JAX folds the shard index into its key, which a ``torch.Generator``
  cannot reproduce, so JAX's samples are not compared).
* TP on a (2, 2) mesh (tests/test_tp_serving.py's OPT-1.3B-shaped tiny model,
  float32, vocab 126 padded to 128, and a GPT-2 of the same size, whose fused
  ``c_attn`` a rank holds head-aligned): greedy and 3 beams in float32,
  greedy in int8 (weight-only trunk; the GPT-2 also int8 xattn), tokens
  equal to JAX on one device, and for greedy to JAX's TP on (2, 4) (JAX's
  own tests hold its TP beams to its one device). bf16 with ``use_pallas`` (int8 trunk
  and xattn: the ViT, resampler and media-xattn kernels' plain versions on
  the local heads): against the port's one-process run, equal up to a near
  tie within 8 bf16 ulps of the one-process logits (a rank sums float32
  partial products before the rounding, the one device sums them in one
  product).
* Refusals: a batch the data axis does not divide, TP without a model axis,
  a model holding its TP slice asked for the one-device path.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.generation import DecodeConfig as JaxDecodeConfig
from flamingo_mini_tpu.generation import generate as jax_generate
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq
from flamingo_mini_tpu.parallel import create_mesh

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

from test_torch_megakernel import (EOS, MAX_LENGTH, PREFIX_BLOCK, SMALL,
                                   _agree_up_to_near_ties, _build, _extend,
                                   _jax_logits, _prompts)
from torch_parallel_worker import pack_model, run_ranks

TINY_OPT = dict(vocab_size=125, max_position_embeddings=64, hidden_size=64,
                ffn_dim=128, num_hidden_layers=4, num_attention_heads=4,
                word_embed_proj_dim=64)
TINY_GPT2 = dict(vocab_size=125, n_positions=64, n_embd=64, n_layer=4, n_head=4)
TINY_VIT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, image_size=32, patch_size=8)
TP_KW = {"opt": dict(max_length=16), "opt_int8": dict(max_length=14),
         "gpt2": dict(max_length=16), "gpt2_int8": dict(max_length=14),
         "gpt2_pallas": dict(max_length=14)}


def _tiny(lm):
    return dict(lm=lm, clip_model_type="openai/clip-vit-base-patch32", dim=64,
                dim_visual=32, xattn_every=2, xattn_dim_head=16, xattn_heads=4,
                resampler_depth=1, resampler_dim_head=16, resampler_heads=2,
                resampler_num_latents=4, vision_arch_overrides=TINY_VIT,
                lm_arch_overrides=TINY_OPT if lm.startswith("facebook") else TINY_GPT2)


_INITS = {}


def _tp_model(name):
    """(config kwargs, JAX params) of a TP case (test_tp_serving.py's init,
    once per trunk)."""
    lm = "facebook/opt-1.3b" if name.startswith("opt") else "gpt2"
    kw = _tiny(lm)
    if lm not in _INITS:
        _INITS[lm] = jflam.init_flamingo(jax.random.PRNGKey(0), JaxConfig(**kw))
    params = dict(_INITS[lm])
    if name == "gpt2_pallas":
        kw.update(compute_dtype="bfloat16", use_pallas=True)
    if name.endswith("int8") or name == "gpt2_pallas":
        quant = jq.quantize_opt_lm if lm != "gpt2" else jq.quantize_gpt2_lm
        params = dict(params, lm=quant(params["lm"]))
        if lm == "gpt2":
            xattn = jq.quantize_xattn_blocks(params["xattn"])
            for blk in xattn.values():
                blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
                blk["alpha_ffw"] = jnp.full((1,), 0.3, jnp.float32)
            params["xattn"] = xattn
    if name == "gpt2_pallas":
        params = jq.cast_params_bf16(params)
    return kw, params


def _tp_inputs():
    rs = np.random.RandomState(5)
    b, n = 4, 6
    ids = rs.randint(0, 100, (b, n)).astype(np.int64)
    media = np.zeros((b, n), np.int32)
    media[:, 0] = 1
    mask = np.ones((b, n), np.int32)
    px = rs.randn(b, 1, 3, 32, 32).astype(np.float32)
    return dict(ids=ids, media=media, mask=mask, px=px)


def _port(kw, params):
    return port.FlamingoModel(port.FlamingoConfig(**kw), params=from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """JAX's DP, TP and one-device runs, the port's one-process runs, and
    every rank's outputs."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jc, pc, params, tparams = _build(2)
    ids, media, mask, px = _prompts(b=8, seed=3)
    small_kw = dict(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                    prefix_block=PREFIX_BLOCK)
    inputs = {**pack_model("small", SMALL | {"xattn_every": 2}, tparams),
              "small.ids": ids, "small.media": media, "small.mask": mask,
              "small.px": px, "small.kw": small_kw}
    ref = {"small": (jc, params, (ids, media, mask, px))}
    single = port.FlamingoModel(pc, params=tparams, device="cpu")
    pkw = dict(media_locations=media, attention_mask=mask, pixel_values=px, **small_kw)
    ref["port_layer"] = single.generate(ids, **pkw).numpy()
    ref["port_mega"] = single.generate(ids, megakernel=True, **pkw).numpy()
    ref["port_sample"] = single.generate(
        ids, do_sample=True, top_k=20, generator=torch.Generator().manual_seed(7),
        **pkw).numpy()
    mesh8 = create_mesh((8, 1))
    for key, mega in (("jax_layer", False), ("jax_mega", True)):
        dc = JaxDecodeConfig(eos_token_id=EOS, pad_token_id=0, max_length=MAX_LENGTH,
                             prefix_block=PREFIX_BLOCK, megakernel=mega)
        ref[key] = np.asarray(jax_generate(
            params, jc, jnp.asarray(ids), policy=jl.FAST, dc=dc,
            media_locations=jnp.asarray(media), attention_mask=jnp.asarray(mask),
            pixel_values=jnp.asarray(px), mesh=mesh8))

    tp_in = _tp_inputs()
    mesh24 = create_mesh((2, 4))
    for name, gen_kw in TP_KW.items():
        kw, jparams = _tp_model(name)
        pmodel = _port(kw, jparams)
        inputs.update(pack_model(name, kw, pmodel.params))
        inputs.update({f"{name}.{k}": v for k, v in tp_in.items()})
        inputs[name + ".kw"] = dict(eos_token_id=999, pad_token_id=0, **gen_kw)
        pkw = dict(media_locations=tp_in["media"], attention_mask=tp_in["mask"],
                   pixel_values=tp_in["px"], eos_token_id=999, pad_token_id=0, **gen_kw)
        if name == "gpt2_pallas":
            ref[name] = (pmodel, pmodel.generate(tp_in["ids"], **pkw).numpy())
            continue
        jc = JaxConfig(**kw)
        for beams in ((1,) if name.endswith("int8") else (1, 3)):
            dc = JaxDecodeConfig(eos_token_id=999, pad_token_id=0, num_beams=beams,
                                 **gen_kw)
            jkw = dict(media_locations=jnp.asarray(tp_in["media"]),
                       attention_mask=jnp.asarray(tp_in["mask"]),
                       pixel_values=jnp.asarray(tp_in["px"]), policy=jl.PARITY, dc=dc)
            tag = f"{name}.{'beams' if beams > 1 else 'greedy'}"
            ref[tag + ".single"] = np.asarray(jax_generate(
                jparams, jc, jnp.asarray(tp_in["ids"]), **jkw))
            if beams == 1:
                ref[tag + ".tp"] = np.asarray(jax_generate(
                    jparams, jc, jnp.asarray(tp_in["ids"]), mesh=mesh24,
                    tensor_parallel=True, **jkw))
    outs = run_ranks("serving", 4, inputs)
    return ref, outs


def _same_on_every_rank(outs, key):
    for r, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out[key], outs[0][key], err_msg=f"rank {r}")
    return outs[0][key]


@pytest.mark.parametrize("path", ["layer", "mega"])
def test_dp_greedy_matches_jax_mesh_and_one_process(runs, path):
    """Per layer (decode_attention and the fused lm_head_argmax, plain
    versions here) and the megakernel, each data rank on its 2 rows."""
    ref, outs = runs
    got = _same_on_every_rank(outs, "dp_" + path)
    np.testing.assert_array_equal(got, ref["port_" + path])
    jc, params, (ids, media, mask, px) = ref["small"]
    L = ids.shape[1]

    def logits(prefix):
        return _jax_logits(jc, params, prefix,
                           *_extend(media, mask, prefix.shape[1] - L), px)

    compared = _agree_up_to_near_ties(got, ref["jax_" + path], L, logits)
    assert compared >= 0.5 * got.shape[0] * (MAX_LENGTH - L), compared


def test_dp_sampling_matches_one_process(runs):
    ref, outs = runs
    got = _same_on_every_rank(outs, "dp_sample")
    np.testing.assert_array_equal(got, ref["port_sample"])
    assert not np.array_equal(got, ref["port_layer"])        # it sampled


@pytest.mark.parametrize("case", ["opt.greedy", "opt.beams", "opt_int8.greedy",
                                  "gpt2.greedy", "gpt2.beams", "gpt2_int8.greedy"])
def test_tp_matches_jax_tp_and_single_device(runs, case):
    ref, outs = runs
    name, search = case.split(".")
    got = _same_on_every_rank(outs, f"{name}.tp_{search}")
    np.testing.assert_array_equal(got, ref[case + ".single"])
    if case + ".tp" in ref:
        np.testing.assert_array_equal(got, ref[case + ".tp"])


def test_tp_use_pallas_bf16_matches_one_process_up_to_near_ties(runs):
    ref, outs = runs
    pmodel, want = ref["gpt2_pallas"]
    got = _same_on_every_rank(outs, "gpt2_pallas.tp_greedy")
    tp_in = _tp_inputs()
    L = tp_in["ids"].shape[1]

    def logits(prefix):
        media, mask = _extend(tp_in["media"], tp_in["mask"], prefix.shape[1] - L)
        out = pmodel.forward(prefix, media_locations=media, attention_mask=mask,
                             pixel_values=tp_in["px"])
        return out.logits[:, -1].float().numpy()

    compared = _agree_up_to_near_ties(got, want, L, logits, ulps=8)
    assert compared >= 0.5 * got.shape[0] * (want.shape[1] - L), compared


def test_shard_holds_the_slice_and_serves_the_same_tokens(runs):
    """``shard_``: the rank keeps its slice of the LM (about half at a
    model axis of 2) and generates the same tokens."""
    ref, outs = runs
    got = _same_on_every_rank(outs, "opt.sharded_greedy")
    np.testing.assert_array_equal(got, ref["opt.greedy.single"])
    kw, jparams = _tp_model("opt")
    whole = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                for x in jax.tree_util.tree_leaves(jparams["lm"]))
    for r, out in enumerate(outs):
        assert int(out["opt.shard_bytes"]) < 0.55 * whole, (out["opt.shard_bytes"], whole)
        # a whole model's first TP generate sharded it in place: one path
        assert tuple(out["opt.tp_shard"]) == (r % 2, 2), out["opt.tp_shard"]
    assert "tensor-parallel slice" in str(outs[0]["refuse_sharded"])


def test_refusals(runs):
    _, outs = runs
    for out in outs:
        assert "not divisible by the mesh data axis (4)" in str(out["refuse_batch"])
        assert "'model' axis of size > 1" in str(out["refuse_tp"])
