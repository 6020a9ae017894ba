"""The recompute backward of the port's attention kernels against autograd
through their plain versions and against the JAX kernels' ``custom_vjp``.

On the card ``fused_attention``, ``flash_attention`` and
``fused_media_xattn`` run through ``fused_attention.RecomputeBackward`` when
grad is enabled: the forward launches the kernel, the backward
differentiates the kernel's plain version recomputed. The CPU has no
kernel, so the ``Function`` is run here with the plain version passed in as
its forward (the streaming mode with the streaming plain version, whose
backward is the full-KV plain version's, as JAX's ``_bwd`` differentiates
``_reference_attention`` for both).

Checks, at narrow ViT-, resampler-, causal-left-padded- and media-shaped
cases (a ``text_time`` 0 row and a row past the media count among them):
dq, dk and dv equal autograd through the plain version bit for bit, for the
same upstream gradient, and agree with ``jax.vjp`` of the JAX kernels in
interpret mode within 1e-5 normwise (float32; only the summation order
differs). The masks get no gradient.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu.ops.pallas_attn import fused_attention as j_attn
from flamingo_mini_tpu.ops.pallas_xattn import fused_media_xattn as j_media

from flamingo_mini_tpu_torch.ops.fused_attention import (
    RecomputeBackward, flash_attention_plain, fused_attention, fused_attention_plain)
from flamingo_mini_tpu_torch.ops.media_xattn import (fused_media_xattn,
                                                     fused_media_xattn_plain)

# (b, h, n_q, n_kv, causal, pads): the ViT's self-attention, the resampler's
# latents over features + latents, GPT-2's causal forward with two rows
# left-padded; streaming over 300 keys in blocks of 128
ATTN_CASES = {
    "vit": (2, 2, 17, 17, False, None),
    "resampler": (2, 2, 4, 21, False, None),
    "causal left-padded": (3, 2, 12, 12, True, (0, 4, 11)),
}
STREAM_CASE = (2, 2, 40, 300, True, (0, 7))


def _inputs(seed, b, h, n_q, n_kv, d=16):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, d).astype(np.float32) for n in (n_q, n_kv, n_kv))
    g = rs.randn(b, h, n_q, d).astype(np.float32)
    return q, k, v, g


def _row_bias(b, n, pads):
    if pads is None:
        return None
    real = np.arange(n)[None, :] >= np.asarray(pads)[:, None]
    return np.where(real, 0.0, np.finfo(np.float32).min).astype(np.float32)


def _grads(fn, q, k, v, g):
    """(out, dq, dk, dv) of ``fn(q, k, v)`` for the upstream gradient g."""
    qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*qkv)
    grads = torch.autograd.grad(out, qkv, torch.tensor(g))
    return (out.detach(), *grads)


def _jax_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return (out, *vjp(jnp.asarray(g)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _held(label, port, jax_out):
    for name, got, want in zip(("out", "dq", "dk", "dv"), port, jax_out):
        err = _rel(got.numpy(), want)
        assert err <= 1e-5, (label, name, err)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_fused_attention_function_matches_plain_and_jax(case):
    b, h, n_q, n_kv, causal, pads = ATTN_CASES[case]
    q, k, v, g = _inputs(1, b, h, n_q, n_kv)
    rb = _row_bias(b, n_kv, pads)
    rb_t = None if rb is None else torch.tensor(rb)
    kw = dict(scale=0.25, causal=causal)

    def plain(q, k, v, bias, row_bias):
        return fused_attention_plain(q, k, v, bias=bias, row_bias=row_bias, **kw)

    def as_kernel(q, k, v, bias, row_bias):
        """The plain version written as the kernels write their output: a
        (b, h, n_q, d) view of a (b, n_q, h, d) buffer."""
        out = plain(q, k, v, bias, row_bias)
        return out.transpose(1, 2).contiguous().transpose(1, 2)

    want = _grads(lambda q, k, v: plain(q, k, v, None, rb_t), q, k, v, g)
    for forward in (plain, as_kernel):
        got = _grads(lambda q, k, v: RecomputeBackward.apply(forward, plain, q, k, v,
                                                             None, rb_t), q, k, v, g)
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)
    # the public wrapper on CPU tensors differentiates the plain version
    wrapped = _grads(lambda q, k, v: fused_attention(q, k, v, row_bias=rb_t, **kw),
                     q, k, v, g)
    for a, b_ in zip(wrapped, want):
        assert torch.equal(a, b_)
    jrb = None if rb is None else jnp.asarray(rb)
    _held(case, got, _jax_grads(
        lambda q, k, v: j_attn(q, k, v, row_bias=jrb, interpret=True, **kw), q, k, v, g))


def test_fused_attention_function_with_bias():
    """An additive (b, h, n_q, n_kv) bias: a constant, no gradient."""
    q, k, v, g = _inputs(2, 2, 2, 9, 13)
    bias = np.random.RandomState(3).randn(2, 2, 9, 13).astype(np.float32)
    bias[:, :, :, :3] = np.finfo(np.float32).min
    bias_t = torch.tensor(bias, requires_grad=True)

    def plain(q, k, v, bias, row_bias):
        return fused_attention_plain(q, k, v, scale=0.3, bias=bias, row_bias=row_bias)

    qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = RecomputeBackward.apply(plain, plain, *qkv, bias_t, None)
    got = torch.autograd.grad(out, qkv + [bias_t], torch.tensor(g), allow_unused=True)
    assert got[3] is None
    want = _grads(lambda q, k, v: plain(q, k, v, bias_t.detach(), None), q, k, v, g)
    for a, b_ in zip(got[:3], want[1:]):
        assert torch.equal(a, b_)
    _held("bias", (out.detach(), *got[:3]), _jax_grads(
        lambda q, k, v: j_attn(q, k, v, scale=0.3, bias=jnp.asarray(bias),
                               interpret=True), q, k, v, g))


def test_streaming_function_differentiates_the_full_kv_plain_version():
    """The streaming mode: forward the online-softmax plain version (the
    kernel's stand-in), backward through fused_attention_plain; against
    JAX's streaming kernel with its custom_vjp."""
    b, h, n_q, n_kv, causal, pads = STREAM_CASE
    q, k, v, g = _inputs(4, b, h, n_q, n_kv)
    rb = torch.tensor(_row_bias(b, n_kv, pads))

    def forward(q, k, v, row_bias):
        return flash_attention_plain(q, k, v, scale=0.25, row_bias=row_bias,
                                     causal=causal, block_q=128)

    def plain(q, k, v, row_bias):
        return fused_attention_plain(q, k, v, scale=0.25, row_bias=row_bias,
                                     causal=causal)

    got = _grads(lambda q, k, v: RecomputeBackward.apply(forward, plain, q, k, v, rb),
                 q, k, v, g)
    want = _grads(lambda q, k, v: plain(q, k, v, rb), q, k, v, g)
    assert torch.equal(got[0], forward(*(torch.tensor(a) for a in (q, k, v)), rb))
    for a, b_ in zip(got[1:], want[1:]):
        assert torch.equal(a, b_)
    _held("streaming", got, _jax_grads(
        lambda q, k, v: j_attn(q, k, v, scale=0.25, row_bias=jnp.asarray(rb.numpy()),
                               causal=causal, block_q=128, streaming=True,
                               interpret=True), q, k, v, g))


def test_media_xattn_function_matches_plain_and_jax():
    """Two images of 4 latents; rows with text_time 0 (zeroed), 1, 2 and 3
    (past the media count: the mean of V)."""
    b, h, n_q, n_visual, n_media = 2, 2, 10, 4, 2
    q, k, v, g = _inputs(5, b, h, n_q, n_visual * n_media)
    tt = np.array([[0, 0, 1, 1, 1, 2, 2, 2, 3, 3],
                   [1, 1, 1, 1, 2, 2, 2, 0, 0, 2]], np.int32)
    tt_t = torch.tensor(tt)
    kw = dict(scale=0.5, n_visual=n_visual)

    def plain(q, k, v, tt):
        return fused_media_xattn_plain(q, k, v, tt, **kw)

    got = _grads(lambda q, k, v: RecomputeBackward.apply(plain, plain, q, k, v, tt_t),
                 q, k, v, g)
    want = _grads(lambda q, k, v: plain(q, k, v, tt_t), q, k, v, g)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    wrapped = _grads(lambda q, k, v: fused_media_xattn(q, k, v, tt_t, **kw), q, k, v, g)
    for a, b_ in zip(wrapped, want):
        assert torch.equal(a, b_)
    # the zeroed rows take no gradient into q
    assert not bool(got[1][:, :, :2][0].any())
    _held("media", got, _jax_grads(
        lambda q, k, v: j_media(q, k, v, jnp.asarray(tt), interpret=True, **kw),
        q, k, v, g))


def test_function_skips_inputs_that_need_no_grad():
    """Only q requires grad: dk and dv are not computed (None)."""
    q, k, v, g = _inputs(6, 1, 2, 5, 7)
    qt = torch.tensor(q, requires_grad=True)
    kt, vt = torch.tensor(k), torch.tensor(v)

    def plain(q, k, v, bias, row_bias):
        return fused_attention_plain(q, k, v, scale=0.5, bias=bias, row_bias=row_bias)

    out = RecomputeBackward.apply(plain, plain, qt, kt, vt, None, None)
    (dq,) = torch.autograd.grad(out, [qt], torch.tensor(g))
    (want,) = torch.autograd.grad(plain(qt, kt, vt, None, None), [qt], torch.tensor(g))
    assert torch.equal(dq, want)
