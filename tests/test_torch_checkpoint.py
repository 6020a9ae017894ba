"""Checkpoints, hub ids and freeze masks: the port against the JAX package.

Small models (2 trunk layers, a 1-layer ViT on 32-px images): GPT-2 with
xattn before every layer, a pre-norm OPT with xattn every other layer, and
opt-350m's post-norm layout with its in/out projections (export and
convert only). Weights are initialised by the JAX package, gates opened,
and carried over with ``from_jax_numpy``, or initialised by the port from a
seed.

* ``flatten_tree`` / ``unflatten_tree`` round trip (int8 leaves too) and
  give the JAX package's npz keys.
* a JAX ``save_pretrained(..., "both")`` loads in the port bit-equal, from
  the npz and from ``config.json`` + the HF-layout ``model.safetensors``
  alone (the bridged JAX vision tower passed as ``vision_params``: the
  port's seeded re-init cannot draw JAX's ``PRNGKey(0)`` tower), and the
  port's float32 forward logits then match JAX's within 1e-4 of their
  scale (``tests/test_torch_forward.py``'s tolerance); a port checkpoint
  loads in JAX bit-equal, both layouts; ``pytorch_model.bin`` loads too.
* the port's ``export_flamingo`` equals JAX's on the same params, and its
  ``convert_flamingo`` of that state equals JAX's convert.
* ``utils.safetensors_io`` against the ``safetensors`` package in both
  directions: F32, I8 and I64 through ``safetensors.numpy``, BF16 through
  ``safetensors.torch`` (``safetensors.numpy`` cannot load BF16).
* hub ids resolve from a cache staged under a ``tmp_path`` ``HF_HOME``;
  ``push_to_hub`` stages there (``huggingface_hub`` is made unimportable,
  so nothing reaches for the network).
* a bf16 save raises ``ValueError``; quantized HF export raises; int8
  ``w8`` leaves with float32 scales save and load bit-exact.
* ``trainable_mask``, ``num_parameters(only_trainable=...)`` and
  ``state_dict_trainable``'s keys equal JAX's, GPT-2 and OPT.

Parity tests keep off the JAX package's bf16 npz (its ``|V2`` leaves do not
load back in JAX either).
"""
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import modeling_flamingo as jmf
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.utils import hf_export as jexp
from flamingo_mini_tpu.utils import hf_weights as jhw
from flamingo_mini_tpu.utils.hub import stage_into_cache as jax_stage

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import modeling_flamingo as pmf
from flamingo_mini_tpu_torch.utils import hf_export as pexp
from flamingo_mini_tpu_torch.utils import hf_weights as phw
from flamingo_mini_tpu_torch.utils import safetensors_io
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
              num_attention_heads=4, image_size=32, patch_size=16)
BASE = dict(dim=128, dim_visual=64, xattn_dim_head=32, xattn_heads=4,
            resampler_depth=1, resampler_dim_head=16, resampler_heads=4,
            resampler_num_latents=8, vision_arch_overrides=VISION)
OPT_ARCH = dict(vocab_size=256, max_position_embeddings=64, hidden_size=128,
                ffn_dim=512, num_hidden_layers=2, num_attention_heads=4)
CONFIGS = {
    "gpt2": dict(BASE, lm="gpt2", xattn_every=1,
                 lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                                        n_layer=2, n_head=4)),
    "opt": dict(BASE, lm="facebook/opt-1.3b", xattn_every=2,
                lm_arch_overrides=dict(OPT_ARCH, word_embed_proj_dim=128)),
    "opt-350m": dict(BASE, lm="facebook/opt-350m", xattn_every=2,
                     lm_arch_overrides=dict(OPT_ARCH, word_embed_proj_dim=64)),
}


def _jax_params(family, seed=3):
    jc = JaxConfig(**CONFIGS[family])
    params = jflam.init_flamingo(jax.random.PRNGKey(seed), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    return jc, params


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(got, want):
    """Port tree (tensors) vs a JAX/numpy tree: same keys, equal bits."""
    g, w = pmf.flatten_tree(got), jmf.flatten_tree(_np_tree(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _batch(config, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (2, 7)).astype(np.int32)
    media = np.zeros_like(ids)
    media[:, 1] = 1
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    size = config.vision_arch.image_size
    pixels = rs.randn(2, 1, 3, size, size).astype(np.float32)
    return ids, media, mask, pixels


def _forward_close(pmodel, jmodel):
    ids, media, mask, pixels = _batch(jmodel.config)
    want = np.asarray(jmodel(jnp.asarray(ids), media_locations=jnp.asarray(media),
                             attention_mask=jnp.asarray(mask),
                             pixel_values=jnp.asarray(pixels)).logits)
    got = pmodel(ids, media_locations=media, attention_mask=mask,
                 pixel_values=pixels).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_flatten_round_trip_and_jax_keys():
    _, params = _jax_params("gpt2")
    tp = from_jax_numpy(_np_tree(params), device="cpu")
    flat = pmf.flatten_tree(tp)
    assert sorted(flat) == sorted(jmf.flatten_tree(_np_tree(params)))
    assert "lm.blocks.#1.ln_1.scale" in flat and "xattn.0.alpha_attn" in flat
    back = pmf.unflatten_tree(flat)
    _assert_trees_equal(back, params)
    assert isinstance(back["lm"]["blocks"], list) and sorted(back["xattn"]) == ["0", "1"]
    q = port.FlamingoModel(port.FlamingoConfig(**CONFIGS["gpt2"]), tp,
                           device="cpu").quantize_int8()
    qflat = pmf.flatten_tree(q.params)
    assert any(v.dtype == np.int8 for v in qflat.values())
    back = pmf.flatten_tree(pmf.unflatten_tree(qflat))
    for k, v in qflat.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_jax_checkpoint_loads_in_port(tmp_path, family):
    jc, params = _jax_params(family)
    jmodel = jmf.FlamingoModel(jc, params)
    jmodel.save_pretrained(str(tmp_path / "both"), save_format="both")
    assert os.path.isfile(tmp_path / "both" / "model.safetensors")
    pm = port.FlamingoModel.from_pretrained(str(tmp_path / "both"), device="cpu")
    assert pm.config == port.FlamingoConfig.from_pretrained(str(tmp_path / "both"))
    _assert_trees_equal(pm.params, params)
    _forward_close(pm, jmodel)
    # config.json + model.safetensors alone: the HF layout, vision given
    hf = tmp_path / "hf"
    hf.mkdir()
    for name in ("config.json", "model.safetensors"):
        shutil.copy(tmp_path / "both" / name, hf / name)
    vision = from_jax_numpy(_np_tree(params["vision"]), device="cpu")
    ph = port.FlamingoModel.from_pretrained(str(hf), vision_params=vision, device="cpu")
    _assert_trees_equal(ph.params, params)
    _forward_close(ph, jmodel)


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_port_checkpoint_loads_in_jax(tmp_path, family):
    pc = port.FlamingoConfig(**CONFIGS[family])
    pm = port.FlamingoModel(pc, device="cpu", seed=5)
    pm.save_pretrained(str(tmp_path / "both"), save_format="both")
    jm = jmf.FlamingoModel.from_pretrained(str(tmp_path / "both"))
    _assert_trees_equal(pm.params, jm.params)
    hf = tmp_path / "hf"
    pm.save_pretrained(str(hf), save_format="hf")
    assert sorted(os.listdir(hf)) == ["config.json", "model.safetensors"]
    jh = jmf.FlamingoModel.from_pretrained(
        str(hf), vision_params=jax.tree_util.tree_map(jnp.asarray, _np_tree(
            jm.params["vision"])))
    _assert_trees_equal(pm.params, jh.params)
    # and back into the port from the same HF-layout file
    ph = port.FlamingoModel.from_pretrained(str(hf), vision_params=pm.params["vision"],
                                            device="cpu")
    _assert_trees_equal(ph.params, jm.params)


def test_pytorch_model_bin_and_clip_checkpoint(tmp_path):
    jc, params = _jax_params("gpt2")
    state = jexp.export_flamingo(params, jc.xattn_every)
    d = tmp_path / "bin"
    d.mkdir()
    jc.save_pretrained(str(d))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
               str(d / "pytorch_model.bin"))
    clip = tmp_path / "clip"
    clip.mkdir()
    safetensors_io.save_file(jexp.export_clip_vit(params["vision"]),
                             str(clip / "model.safetensors"))
    pm = port.FlamingoModel.from_pretrained(str(d), clip_checkpoint=str(clip),
                                            device="cpu")
    _assert_trees_equal(pm.params, params)
    # no vision anywhere: a tower from the seed, the same for the same seed
    a = port.FlamingoModel.from_pretrained(str(d), seed=7, device="cpu")
    b = port.FlamingoModel.from_pretrained(str(d), seed=7, device="cpu")
    fa, fb = pmf.flatten_tree(a.params["vision"]), pmf.flatten_tree(b.params["vision"])
    fj = jmf.flatten_tree(_np_tree(params["vision"]))
    assert sorted(fa) == sorted(fj)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
        assert fa[k].shape == fj[k].shape
    empty = tmp_path / "empty"
    jc.save_pretrained(str(empty))
    with pytest.raises(FileNotFoundError, match="no weights"):
        port.FlamingoModel.from_pretrained(str(empty), device="cpu")
    with pytest.raises(FileNotFoundError, match="no such checkpoint"):
        port.FlamingoModel.from_pretrained(str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("include_vision", [False, True])
@pytest.mark.parametrize("family", ["gpt2", "opt", "opt-350m"])
def test_export_and_convert_match_jax(family, include_vision):
    jc, params = _jax_params(family)
    tp = from_jax_numpy(_np_tree(params), device="cpu")
    want = jexp.export_flamingo(params, jc.xattn_every, include_vision=include_vision)
    got = pexp.export_flamingo(tp, jc.xattn_every, include_vision=include_vision)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_layers = jc.lm_arch.n_layer if family == "gpt2" else jc.lm_arch.num_hidden_layers
    jconv = jhw.convert_flamingo(want, xattn_every=jc.xattn_every, n_lm_layers=n_layers)
    pconv = phw.convert_flamingo(got, xattn_every=jc.xattn_every, n_lm_layers=n_layers)
    _assert_trees_equal(pconv, jconv)
    assert ("vision" in pconv) == include_vision


def test_safetensors_io_against_the_package(tmp_path):
    import safetensors.numpy as sn
    import safetensors.torch as st
    rs = np.random.RandomState(0)
    arrays = {"f32": rs.randn(3, 5).astype(np.float32),
              "i8": rs.randint(-127, 128, (4, 7)).astype(np.int8),
              "i64": rs.randint(-2**40, 2**40, (6,)).astype(np.int64),
              "scalar": np.array(1.5, np.float32), "empty": np.zeros((0, 3), np.float32)}
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(arrays, ours)
    back = sn.load_file(ours)
    theirs = str(tmp_path / "theirs.safetensors")
    sn.save_file(arrays, theirs, metadata={"format": "pt"})     # skipped on read
    mine = safetensors_io.load_file(theirs)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
        assert mine[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(mine[k].numpy(), v)
    bf = {"bf16": torch.randn(5, 3).to(torch.bfloat16), "f32": torch.randn(4)}
    safetensors_io.save_file(bf, ours)
    for k, v in st.load_file(ours).items():
        assert v.dtype == bf[k].dtype and torch.equal(v, bf[k])
    st.save_file(bf, theirs)
    for k, v in safetensors_io.load_file(theirs).items():
        assert v.dtype == bf[k].dtype and torch.equal(v, bf[k])


def test_hub_ids_and_push_to_hub_staging(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    pc = port.FlamingoConfig(**CONFIGS["gpt2"])
    pm = port.FlamingoModel(pc, device="cpu", seed=1)
    snap = pm.push_to_hub("someone/tiny-flamingo", save_format="npz")
    assert snap.startswith(str(tmp_path / "hf_home")) and pm.last_push_uploaded is False
    loaded = port.FlamingoModel.from_pretrained("someone/tiny-flamingo", device="cpu")
    assert loaded.config == port.FlamingoConfig.from_pretrained("someone/tiny-flamingo")
    for k, v in pmf.flatten_tree(pm.params).items():
        np.testing.assert_array_equal(pmf.flatten_tree(loaded.params)[k], v)
    with pytest.raises(ImportError):
        pm.push_to_hub("someone/tiny-flamingo", save_format="npz", require_upload=True)
    # a JAX checkpoint staged into the same cache resolves by its id
    jc, params = _jax_params("opt")
    jax_stage("org/jax-flamingo", save=lambda d: jmf.FlamingoModel(jc, params)
              .save_pretrained(d, save_format="npz"))
    _assert_trees_equal(
        port.FlamingoModel.from_pretrained("org/jax-flamingo", device="cpu").params,
        params)
    with pytest.raises(FileNotFoundError):
        port.FlamingoConfig.from_pretrained("nobody/absent")


def test_bf16_and_quantized_saves_refused(tmp_path):
    pc = port.FlamingoConfig(**CONFIGS["gpt2"])
    with pytest.raises(ValueError, match="to_bf16"):
        port.FlamingoModel(pc, device="cpu").to_bf16().save_pretrained(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="to_bf16"):
        port.FlamingoModel(pc, device="cpu").to_bf16().save_pretrained(
            str(tmp_path / "b"), save_format="hf")
    q = port.FlamingoModel(pc, device="cpu").quantize_int8()
    for fmt in ("hf", "both"):
        with pytest.raises(ValueError, match="unquantized"):
            q.save_pretrained(str(tmp_path / "c"), save_format=fmt)
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "c")
    with pytest.raises(ValueError, match="save_format"):
        q.save_pretrained(str(tmp_path / "d"), save_format="pt")
    q.save_pretrained(str(tmp_path / "q"))
    back = port.FlamingoModel.from_pretrained(str(tmp_path / "q"), device="cpu")
    want, got = pmf.flatten_tree(q.params), pmf.flatten_tree(back.params)
    assert sorted(got) == sorted(want)
    assert want["lm.blocks.#0.c_attn.w8"].dtype == np.int8
    assert want["lm.blocks.#0.c_attn.scale"].dtype == np.float32
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # the same int8 checkpoint loads in JAX
    jm = jmf.FlamingoModel.from_pretrained(str(tmp_path / "q"))
    _assert_trees_equal(q.params, jm.params)


@pytest.mark.parametrize("freeze", [True, False])
@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_trainable_masks_match_jax(family, freeze):
    jc, params = _jax_params(family)
    jc.freeze_language_model = freeze
    pc = port.FlamingoConfig(**CONFIGS[family], freeze_language_model=freeze)
    jm = jmf.FlamingoModel(jc, params)
    pm = port.FlamingoModel(pc, from_jax_numpy(_np_tree(params), device="cpu"),
                            device="cpu")
    want = jmf.flatten_tree(_np_tree(jm.trainable_mask()))
    got = pmf.flatten_tree(pm.trainable_mask())
    assert got.keys() == want.keys()
    assert all(bool(got[k]) == bool(want[k]) for k in want)
    for only in (False, True):
        assert pm.num_parameters(only_trainable=only) == jm.num_parameters(only_trainable=only)
    assert list(pm.state_dict_trainable()) == list(jm.state_dict_trainable())
    frozen = pm.num_parameters() - pm.num_parameters(only_trainable=True)
    assert (frozen > pmf.param_utils.tree_size(pm.params["vision"])) == freeze


def test_registry_refuses_unsupported_lm():
    assert port.FlamingoModel.is_lm_supported("gpt2-medium")
    assert port.FlamingoModel.is_lm_supported("facebook/opt-1.3b")
    assert not port.FlamingoModel.is_lm_supported("llama")
    cfg = port.FlamingoConfig(**CONFIGS["gpt2"])
    cfg.lm = "llama-7b"
    with pytest.raises(ValueError, match="unsupported language model"):
        port.FlamingoModel(cfg, device="cpu")
