"""The port's ring attention against JAX's (tests/test_ring_attention.py's
cases): the sequence split over 4 gloo ranks (``torch_parallel_worker``, no
JAX) against JAX's ring over the conftest's 8 virtual devices.

* ``ring_attention`` on (3, 4, 64, 32) float32, without and with a padding
  mask (right padding in row 0, left in row 1): each rank's chunk of the
  output, and dq, dk, dv of the sum of squares over the rows every one of
  whose visible keys is not padding (the others are degenerate in both, 0
  here and in JAX's ring), against JAX's ring and ``jax.grad``: of JAX's
  ring with the mask, of tests/test_ring_attention.py's one-device causal
  reference without (which that file holds to the ring's; the ring's
  gradient takes 13 s to compile on the CPU): 2e-5 and 5e-5 (JAX's own
  tolerances).
* ``FlamingoModel.forward(context_mesh=...)`` through both trunks (GPT-2 with
  an image and a second one mid-sequence; pre-norm OPT), with the loss and
  with padding: the logits on every rank within 2e-5 of JAX's ring forward
  (at the real positions where padded), the loss within 1e-5.
* A sequence the ranks do not divide raises ``ValueError``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import FlamingoModel as JaxModel
from flamingo_mini_tpu.parallel import create_mesh
from flamingo_mini_tpu.parallel.ring_attention import ring_attention as jax_ring

from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

from test_ring_attention import _reference_causal
from torch_parallel_worker import pack_model, run_ranks

WORLD = 4
B, H, N, D = 3, 4, 64, 32
VIT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
           num_attention_heads=4, image_size=32, patch_size=8)
TRUNKS = {
    "gpt2": dict(lm="gpt2", lm_arch_overrides=dict(
        vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=4)),
    "opt": dict(lm="facebook/opt-125m", lm_arch_overrides=dict(
        vocab_size=256, max_position_embeddings=64, hidden_size=32, ffn_dim=64,
        num_hidden_layers=2, num_attention_heads=4)),
}


def _config(name):
    return dict(dim=32, dim_visual=32, xattn_every=1, xattn_dim_head=8, xattn_heads=4,
                resampler_depth=1, resampler_dim_head=8, resampler_heads=4,
                resampler_num_latents=4, vision_arch_overrides=VIT, **TRUNKS[name])


def _rows(mask):
    """The query rows at which some visible key is not padding and which are
    not padding themselves (JAX's test's well-defined rows)."""
    return ((np.cumsum(mask, axis=1) > 0) & mask.astype(bool)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = create_mesh((8, 1))
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(B, H, N, D).astype(np.float32) for _ in range(3))
    pad = np.ones((B, N), np.int32)
    pad[0, -9:] = 0                   # right padding
    pad[1, :11] = 0                   # left padding
    inputs = {"q": q, "k": k, "v": v, "pad_mask": pad,
              "rows_plain": np.ones((B, N), np.float32), "rows_padded": _rows(pad)}
    ref = {}
    for label, mask in (("plain", None), ("padded", pad)):
        rows = jnp.asarray(inputs["rows_" + label])

        def loss(q_, k_, v_):
            if mask is None:
                out = _reference_causal(q_, k_, v_, D ** -0.5)
            else:
                out = jax_ring(q_, k_, v_, mesh=mesh, attention_mask=jnp.asarray(mask))
            return jnp.sum(out ** 2 * rows[:, None, :, None])

        qkv = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out = jax_ring(*qkv, mesh=mesh,
                       attention_mask=None if mask is None else jnp.asarray(mask))
        grads = jax.grad(loss, argnums=(0, 1, 2))(*qkv)
        ref[label] = [np.asarray(out)] + [np.asarray(g) for g in grads]

    for name in TRUNKS:
        model = JaxModel(JaxConfig(**_config(name)), rng=jax.random.PRNGKey(0))
        rs = np.random.RandomState(1)
        b, n = 2, 32
        ids = rs.randint(0, 200, (b, n)).astype(np.int64)
        kw = {}
        if name == "gpt2":
            media = np.zeros((b, n), np.int32)
            media[:, 0] = 1
            media[1, 17] = 1          # a second image mid-sequence
            kw = dict(media_locations=media,
                      pixel_values=rs.randn(b, 2, 3, 32, 32).astype(np.float32))
        am = np.ones((b, n), np.int32)
        if name == "gpt2":
            am[0, -5:] = 0            # right padding
        else:
            am[1, :6] = 0             # left padding, HF OPT convention
        full = model.forward(ids, labels=ids, context_mesh=mesh, **kw)
        padded = model.forward(ids, attention_mask=am, context_mesh=mesh, **kw)
        ref[name] = (np.asarray(full.logits), float(full.loss), np.asarray(padded.logits),
                     am)
        params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, model.params),
                                device="cpu")
        inputs.update(pack_model(name, _config(name), params))
        inputs.update({f"{name}.ids": ids, f"{name}.pad": am,
                       **{f"{name}.{key}": val for key, val in kw.items()}})
    return ref, run_ranks("ring", WORLD, inputs)


@pytest.mark.parametrize("label", ["plain", "padded"])
def test_ring_forward_and_gradients_match_jax(runs, label):
    ref, outs = runs
    want_out, dq, dk, dv = ref[label]
    got = {name: np.concatenate([o[f"{label}.{name}"] for o in outs], axis=2)
           for name in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], want_out, atol=2e-5, rtol=2e-5)
    for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[name], want, atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_through_context_mesh_matches_jax(runs, name):
    ref, outs = runs
    logits, loss, padded, am = ref[name]
    real = am.astype(bool)
    for out in outs:
        np.testing.assert_allclose(out[name + ".logits"], logits, atol=2e-5, rtol=2e-5)
        assert abs(float(out[name + ".loss"]) - loss) <= 1e-5 * abs(loss)
        np.testing.assert_allclose(out[name + ".padded_logits"][real], padded[real],
                                   atol=2e-5, rtol=2e-5)


def test_undivided_sequence_is_refused(runs):
    _, outs = runs
    for out in outs:
        assert "not divisible by the 4 ranks" in str(out["refuse_length"])
