"""The port's in-situ decode probes (``flamingo_mini_tpu_torch.tools.
probe_decode_kernel`` and ``.probe_lm_head``) against the TPU probes.

The TPU probes (``tools/probe_decode_kernel.py``, ``tools/probe_lm_head.py``)
are loaded by path, as copies: they read their shape from module globals at
call time, and the loop tests set smaller values on the copy (``SCALE`` set
again with D and H). Their Pallas kernels run in interpret mode, on inputs
made from a seed with numpy. Tolerances:

* One call of each stream kernel's plain version at the probe's shape (b=32,
  D=1024, T=192; ``block_t`` 16 and 32, ``block_b`` 32 and 8, and a
  ``kv_limit`` of 100 that neither divides): bit for bit. Each output is a
  float32 sum of 2 x 112-128 values cast once to bf16; the plain version
  sums in the CUDA kernel's order (groups of 8 rows, chunks in order), and
  the interpret-mode kernels' float32 sums measured equal to it in every
  case.
* The loops at NLAYER 2, T 32, B 4, D 128 (H 2, head dim 64), kv_limit 16,
  3 steps, against the TPU probe's ``run`` compiled with
  ``xla_allow_excess_precision`` off: the result ``sum(q.float())`` within
  2^-8 relative, one bf16 ulp at the result's scale. The stream loops carry
  rows that grow 3x per layer, and a float32 chunk sum in another order
  than XLA's moves single bf16 elements by an ulp (measured: 4.7e-4 for the
  T-major loop at ``block_t`` 32, 4.9e-5 packed, 1.5e-4 for the plain flat
  attention; 0 for the other loops).
* The head probe's two loops at B 4, D 128, V 1000, 6 steps, from hidden
  rows of 1e-5 so that each step's token (its low bit) moves the result:
  equal.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flamingo_mini_tpu_torch.ops.lm_head import pad_head_weights
from flamingo_mini_tpu_torch.tools import insitu
from flamingo_mini_tpu_torch.tools import probe_decode_kernel as port
from flamingo_mini_tpu_torch.tools import probe_lm_head as port_head

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(B=4, T=32, D=128, H=2, NLAYER=2, KV_LIMIT=16)
SMALL_SHAPE = port.Shape(b=4, t=32, d=128, h=2, n_layer=2, kv_limit=16)
STEPS = 3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_probe():
    return _load("tpu_probe_decode_kernel", "tools/probe_decode_kernel.py")


@pytest.fixture(scope="module")
def tpu_head():
    return _load("tpu_probe_lm_head", "tools/probe_lm_head.py")


@pytest.fixture(scope="module")
def caches():
    """q (32, 1024) and T-major K, V (192, 32, 1024), seeded, float32."""
    rs = np.random.RandomState(7)
    return {"q": rs.randn(32, 1024).astype(np.float32),
            "k": rs.randn(192, 32, 1024).astype(np.float32),
            "v": rs.randn(192, 32, 1024).astype(np.float32)}


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tt(a):
    return torch.tensor(a).to(torch.bfloat16)


def _packed_attn(mod, block_t):
    """The TPU probe's packed-cache kernel call, from its loop's closure."""
    fn = mod.make_tmajor_packed_loop(block_t).__wrapped__
    return fn.__closure__[fn.__code__.co_freevars.index("attn")].cell_contents


# (layout, block_t, block_b, kv_limit)
KERNEL_CASES = [("tmajor", 16, None, 128), ("tmajor", 32, None, 128),
                ("tmajor", 32, None, 100), ("bmajor", 16, 32, 128),
                ("bmajor", 32, 8, 128), ("bmajor", 16, 8, 100),
                ("packed", 16, None, 128), ("packed", 32, None, 128),
                ("packed", 16, None, 100)]


@pytest.mark.parametrize("layout,block_t,block_b,kv_limit", KERNEL_CASES)
def test_stream_kernel_plain_matches_tpu_kernel(tpu_probe, caches, monkeypatch,
                                                layout, block_t, block_b, kv_limit):
    monkeypatch.setattr(tpu_probe, "KV_LIMIT", kv_limit)
    q, k, v = caches["q"], caches["k"], caches["v"]
    shape = port.Shape(kv_limit=kv_limit)
    with pltpu.force_tpu_interpret_mode():
        if layout == "tmajor":
            want = tpu_probe.make_tmajor_stream(block_t)(_bf(q), _bf(k), _bf(v), None, None)
        elif layout == "bmajor":
            kb, vb = (np.ascontiguousarray(a.transpose(1, 0, 2)) for a in (k, v))
            want = tpu_probe.attn_stream_only(_bf(q), _bf(kb), _bf(vb), None, None,
                                              block_b, block_t)
        else:
            want = _packed_attn(tpu_probe, block_t)(_bf(q), _bf(np.concatenate([k, v], -1)))
    want = np.asarray(want.astype(jnp.float32))
    if layout == "tmajor":
        got = port.tmajor_stream(_tt(q), _tt(k), _tt(v), block_t=block_t, kv_limit=kv_limit)
    elif layout == "bmajor":
        kb, vb = (_tt(a).transpose(0, 1).contiguous() for a in (k, v))
        got = port.attn_stream_only(_tt(q), kb, vb, None, None, block_b, block_t,
                                    shape=shape)
    else:
        got = port.packed_stream(_tt(q), _tt(np.concatenate([k, v], -1)),
                                 block_t=block_t, kv_limit=kv_limit)
    assert got.dtype == torch.bfloat16 and got.shape == (32, 1024)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_stream_sum_reads_the_chunks_rows_only():
    """Rows past n block_t neither enter the sum nor are needed; rows in the
    last chunk past kv_limit do enter it (the TPU kernel reads whole chunks)."""
    T, b, d = 64, 2, 16
    k = torch.zeros((T, b, d), dtype=torch.bfloat16)
    k[:40] = 1.0
    k[40:] = 1000.0
    got = port.tmajor_stream(torch.zeros((b, d), dtype=torch.bfloat16), k, k,
                             block_t=8, kv_limit=33)
    assert torch.equal(got.float(), torch.full((b, d), 80.0))


def _jax_loop_sum(fn, q0, npad, reps):
    args = (_bf(q0), jnp.asarray(npad), jnp.int32(reps), jnp.float32(0.0))
    with pltpu.force_tpu_interpret_mode():
        compiled = fn.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return float(compiled(*args))


LOOPS = {
    "stream_tmajor_bt8": (lambda m: m.make_tmajor_loop(8),
                          lambda s: port.make_tmajor_loop(8, shape=s)),
    "stream_tmajor_bt32": (lambda m: m.make_tmajor_loop(32),
                           lambda s: port.make_tmajor_loop(32, shape=s)),
    "stream_tmajor_packed_bt8": (lambda m: m.make_tmajor_packed_loop(8),
                                 lambda s: port.make_tmajor_packed_loop(8, s)),
    "tmajor_kernel": (lambda m: m.make_tmajor_loop(None, real_kernel=True),
                      lambda s: port.make_tmajor_loop(None, True, s)),
    "head_layout": (lambda m: m.make_head_loop(), lambda s: port.make_head_loop(s)),
    "stream_bmajor_bt8": (lambda m: m.make_flat_loop(m.attn_stream_only, None, 8),
                          lambda s: port.make_flat_loop(port.attn_stream_only, None, 8, s)),
    "flat_plain_attention": (lambda m: m.make_flat_loop(m.attn_xla_flat),
                             lambda s: port.make_flat_loop(port.attn_eager_flat, shape=s)),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_loop_matches_tpu_probe(tpu_probe, monkeypatch, name):
    for key, val in SMALL.items():
        monkeypatch.setattr(tpu_probe, key, val)
    monkeypatch.setattr(tpu_probe, "SCALE", (SMALL["D"] // SMALL["H"]) ** -0.5)
    rs = np.random.RandomState(3)
    q0 = (rs.randn(SMALL["B"], SMALL["D"]) * 0.1).astype(np.float32)
    npad = rs.randint(0, 3, (SMALL["B"],)).astype(np.int32)
    jax_factory, port_factory = LOOPS[name]
    want = _jax_loop_sum(jax_factory(tpu_probe), q0, npad, STEPS)
    got = port_factory(SMALL_SHAPE)(_tt(q0), torch.tensor(npad), STEPS)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.isfinite(want)
    assert abs(float(got) - want) <= 2.0 ** -8 * abs(want), (float(got), want)


@pytest.mark.parametrize("variant", ["eager_int8", "kernel"])
def test_head_loop_matches_tpu_probe(tpu_head, monkeypatch, variant):
    b, d, v, steps = 4, 128, 1000, 6
    for key, val in dict(B=b, D=d, V=v).items():
        monkeypatch.setattr(tpu_head, key, val)
    rs = np.random.RandomState(11)
    x0 = (rs.randn(b, d) * 1e-5).astype(np.float32)
    w8 = rs.randint(-127, 128, (v, d)).astype(np.int8)
    scale = (np.abs(rs.randn(v)) * 0.01 + 1e-4).astype(np.float32)
    if variant == "eager_int8":
        run = tpu_head.make_loop(tpu_head.xla_head, padded=False)
        ops = (jnp.asarray(w8), jnp.asarray(scale))
        port_run = port_head.make_loop(port_head.eager_head, padded=False, n_valid=v)
        port_ops = (torch.tensor(w8), torch.tensor(scale))
    else:
        jp = tpu_head.pad_head_weights({"w8": jnp.asarray(w8),
                                        "scale": jnp.asarray(scale)}, 256)

        def head(w8p, sp, x):
            return tpu_head.lm_head_argmax(w8p, sp, x, n_valid=v, block_v=256)
        run = tpu_head.make_loop(head, padded=True)
        ops = (jp["w8"], jp["scale"])
        pp = pad_head_weights({"w8": torch.tensor(w8), "scale": torch.tensor(scale)},
                              port_head.PAD_ROWS)
        port_run = port_head.make_loop(port_head.kernel_head(v), padded=True, n_valid=v)
        port_ops = (pp["w8"], pp["scale"])
    args = (*ops, _bf(x0), jnp.int32(steps), jnp.float32(0.0))
    with pltpu.force_tpu_interpret_mode():
        want = float(run(*args))
    got = port_run(*port_ops, _tt(x0), steps)
    assert float(got) == want


def test_head_tokens_feed_back():
    """The loop's result depends on the tokens: a head that answers 1
    moves every element by 1e-6, one that answers 0 moves none."""
    x0 = torch.full((2, 8), 1e-5).to(torch.bfloat16)
    one = port_head.make_loop(lambda w, s, x: torch.ones(2, dtype=torch.int32), True)
    zero = port_head.make_loop(lambda w, s, x: torch.zeros(2, dtype=torch.int32), True)
    assert float(zero(None, None, x0, 3)) == float(x0.float().sum())
    assert float(one(None, None, x0, 3)) > float(x0.float().sum())


def test_stream_probes_refuse_bad_input():
    q = torch.zeros((4, 64), dtype=torch.bfloat16)
    tm = torch.zeros((32, 4, 64), dtype=torch.bfloat16)
    bm = torch.zeros((4, 32, 64), dtype=torch.bfloat16)
    small = port.Shape(b=4, t=32, d=64, kv_limit=16)
    with pytest.raises(ValueError, match="block_b"):     # 4 % 3: rows dropped
        port.attn_stream_only(q, bm, bm, None, None, 3, 8, shape=small)
    with pytest.raises(ValueError, match="past"):        # 2 x 24 rows > 32
        port.tmajor_stream(q, tm, tm, block_t=24, kv_limit=30)
    with pytest.raises(ValueError, match="past"):
        port.attn_stream_only(q, bm, bm, None, None, None, 24,
                              shape=port.Shape(b=4, t=32, d=64, kv_limit=30))
    with pytest.raises(ValueError, match="past"):
        port.packed_stream(q, torch.zeros((32, 4, 128), dtype=torch.bfloat16),
                           block_t=24, kv_limit=30)
    with pytest.raises(ValueError):                      # float32 cache
        port.tmajor_stream(q, tm.float(), tm, block_t=8, kv_limit=16)
    with pytest.raises(ValueError):                      # b-major cache as T-major
        port.tmajor_stream(q, bm, bm, block_t=8, kv_limit=16)
    with pytest.raises(ValueError):                      # packed cache D wide
        port.packed_stream(q, tm, block_t=8, kv_limit=16)


def test_insitu_times_on_the_card_only():
    run = port.make_tmajor_loop(8, shape=SMALL_SHAPE)
    q0 = torch.zeros((4, 128), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        insitu.per_step_ms(run, (q0, torch.zeros(4, dtype=torch.int32)), (1, 2))


def test_same_bits_is_nan_aware():
    a = torch.tensor([1.0, float("nan"), -0.0])
    assert insitu.same_bits(a, a.clone())
    assert not insitu.same_bits(a, torch.tensor([1.0, float("nan"), 0.0]))
    assert not insitu.same_bits(a, torch.tensor([1.0, 2.0, -0.0]))


@pytest.mark.parametrize("cli", [port, port_head])
def test_cli_needs_the_card(cli, capsys):
    """Without a CUDA device each CLI exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["--full"]) == 1
    assert capsys.readouterr().out == ""
