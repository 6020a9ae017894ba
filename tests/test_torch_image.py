"""The port's image preprocessing against the JAX package's.

* ``ops.image.preprocess_images`` (plain torch on the CPU here, the card's
  path on the card) is within 1e-4 of JAX's ``preprocess_images`` after
  normalization, one uint8 image at a time: a small image upsampled
  (100 x 150), 480 x 640, 375 x 500, a tall 1000 x 250, a 3 x 500 strip
  (resized to 224 x 37,333), a 224 x 224 image (no resize), grayscale, a
  PIL image, float32 input, and a batch of mixed shapes stacked. The
  port's per-axis weight matrices (``resize_weights``) are JAX's
  ``compute_weight_mat`` (transposed, the crop's rows only) to 1e-6.
* ``preprocess_images_pil`` is bit-equal to JAX's (both PIL).
* the processor's ``exact=True`` is that path; without Pillow it raises
  ``ImportError`` naming it.
"""
import sys

import numpy as np
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.ops import image as jimage

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.ops import image as pimage
from flamingo_mini_tpu_torch.tokenizer import build_toy_tokenizer

SHAPES = {"upsampled 100x150": (100, 150, 3), "480x640": (480, 640, 3),
          "375x500": (375, 500, 3), "tall 1000x250": (1000, 250, 3),
          "strip 3x500": (3, 500, 3), "224x224": (224, 224, 3),
          "grayscale 200x260": (200, 260)}
TOL = 1e-4


def _image(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_device_pipeline_matches_jax(name):
    im = _image(SHAPES[name])
    want = np.asarray(jimage.preprocess_images([im]))
    got = pimage.preprocess_images([im], device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 3, 224, 224)
    assert np.abs(got.numpy() - want).max() <= TOL, name


def test_pil_image_float_input_and_mixed_batch():
    from PIL import Image
    ims = [Image.fromarray(_image((120, 90, 4), 1), mode="RGBA"),
           _image((300, 200, 3), 2), _image((64, 64), 3),
           _image((240, 320, 3), 4).astype(np.float32)]
    want = np.asarray(jimage.preprocess_images(ims, size=64, crop=56))
    got = pimage.preprocess_images(ims, size=64, crop=56, device="cpu")
    assert tuple(got.shape) == (4, 3, 56, 56)
    assert np.abs(got.numpy() - want).max() <= TOL
    # a tensor input is taken as is
    t = pimage.preprocess_images([torch.from_numpy(_image((300, 200, 3), 2))],
                                 size=64, crop=56, device="cpu")
    assert torch.equal(t[0], got[1])


@pytest.mark.parametrize("sizes", [(480, 224, 0), (640, 299, 37), (150, 224, 0),
                                   (3, 224, 0), (500, 37333, 18554), (224, 224, 0),
                                   (1000, 896, 336)])
def test_resize_weights_are_jax_weights(sizes):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat
    in_size, out_size, start = sizes
    want = np.asarray(compute_weight_mat(in_size, out_size, out_size / in_size, 0.0,
                                         _fill_keys_cubic_kernel, True))
    got = pimage.resize_weights(in_size, out_size, start, 224)
    assert got.dtype == np.float32 and got.shape == (224, in_size)
    np.testing.assert_allclose(got, want[:, start:start + 224].T, rtol=0, atol=1e-6)


def test_resize_shape_rounds_as_python():
    for h, w in ((100, 150), (375, 500), (3, 500), (448, 336), (1000, 250)):
        nh, nw = pimage.resize_shape(h, w, 224)
        short = min(h, w)
        long = max(h, w)
        assert min(nh, nw) == 224
        assert max(nh, nw) == max(int(round(long * 224 / short)), 224)


@pytest.mark.parametrize("shape", [(100, 150, 3), (375, 500, 3), (1000, 250, 3),
                                   (200, 260)])
def test_pil_path_bit_equal_to_jax(shape):
    im = _image(shape, 5)
    want = jimage.preprocess_images_pil([im, im[::2]])
    got = pimage.preprocess_images_pil([im, im[::2]])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _processor():
    tok = build_toy_tokenizer(["a", "cat", "<", ">"])
    cfg = port.FlamingoConfig(lm="gpt2")
    return port.FlamingoProcessor(cfg, tokenizer=tok, device="cpu"), JaxConfig(lm="gpt2")


def test_processor_exact_is_the_pil_path():
    proc, _ = _processor()
    ims = [_image((300, 400, 3), 6), _image((224, 300), 7)]
    exact = proc.preprocess_images(ims, exact=True)
    assert exact.device.type == "cpu" and exact.dtype == torch.float32
    np.testing.assert_array_equal(exact.numpy(), jimage.preprocess_images_pil(ims))
    plain = proc.preprocess_images(ims)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jimage.preprocess_images(ims)),
                               rtol=0, atol=TOL)


def test_exact_without_pillow_raises(monkeypatch):
    proc, _ = _processor()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        proc.preprocess_images([_image((64, 64, 3))], exact=True)
    # the device path needs no PIL
    assert tuple(proc.preprocess_images(_image((64, 80, 3))).shape) == (1, 3, 224, 224)
