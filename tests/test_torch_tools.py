"""The port's checkpoint converter and ring memory tool against the JAX
package, and the parallel tests' launcher.

* ``tools/convert_checkpoint.py``: a seeded tiny HF-layout checkpoint (the
  JAX package's export of ``tests/test_torch_checkpoint.py``'s GPT-2 model,
  vocab files beside it) converted by the port's CLI in-process, with and
  without a local ``--clip-checkpoint``; the vocab files are copied, and
  the JAX package's ``FlamingoModel.from_pretrained(dst)`` gives the same
  float32 logits as the port's (1e-5);
* ``tools/ring_crossover.py``: the analytic fields equal the JAX tool's
  own expression (read from its source) at the same shapes, and one
  2-rank gloo run on the CPU at 256 tokens gives the full attention's
  output (normwise 1e-5);
* ``tests/torch_parallel_worker.py::wait_all``: one deadline for the whole
  world, not one per rank.
"""
import ast
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from flamingo_mini_tpu import modeling_flamingo as jmf
from flamingo_mini_tpu.utils import hf_export as jexp

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import modeling_flamingo as pmf
from flamingo_mini_tpu_torch.tools import convert_checkpoint, ring_crossover
from flamingo_mini_tpu_torch.utils import safetensors_io

from test_torch_checkpoint import _batch, _jax_params, _np_tree
from torch_parallel_worker import wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = {"vocab.json": '{"a": 0}', "merges.txt": "#version: 0.2\n", "tokenizer.json": "{}"}


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """(jax config, jax params, HF-layout dir with vocab files, CLIP dir)."""
    jc, params = _jax_params("gpt2")
    src = tmp_path_factory.mktemp("src")
    jc.save_pretrained(str(src))
    safetensors_io.save_file(jexp.export_flamingo(params, jc.xattn_every),
                             str(src / "model.safetensors"))
    for name, text in VOCAB.items():
        (src / name).write_text(text)
    clip = tmp_path_factory.mktemp("clip")
    safetensors_io.save_file(jexp.export_clip_vit(params["vision"]),
                             str(clip / "model.safetensors"))
    return jc, params, src, clip


@pytest.mark.parametrize("with_clip", [False, True])
def test_convert_checkpoint_cli(hf_checkpoint, tmp_path, capsys, with_clip):
    jc, params, src, clip = hf_checkpoint
    dst = tmp_path / "dst"
    argv = [str(src), str(dst), "--device", "cpu"]
    if with_clip:
        argv += ["--clip-checkpoint", str(clip)]
    model = convert_checkpoint.main(argv)
    out = capsys.readouterr().out
    n = model.num_parameters()
    assert f"({n:,} params, vision=" in out
    assert ("vision=from " + str(clip)) in out if with_clip else "vision=random-init" in out
    assert sorted(os.listdir(dst)) == sorted(["config.json", pmf.NPZ_NAME, *VOCAB])
    for name, text in VOCAB.items():
        assert (dst / name).read_text() == text

    jm = jmf.FlamingoModel.from_pretrained(str(dst))
    pm = port.FlamingoModel.from_pretrained(str(dst), device="cpu")
    flat_j = jmf.flatten_tree(_np_tree(jm.params))
    flat_src = jmf.flatten_tree(_np_tree(params))
    for k, v in pmf.flatten_tree(pm.params).items():
        np.testing.assert_array_equal(v, flat_j[k], err_msg=k)
        if with_clip or not k.startswith("vision."):
            np.testing.assert_array_equal(v, flat_src[k], err_msg=k)
    ids, media, mask, pixels = _batch(jm.config)
    want = np.asarray(jm(jnp.asarray(ids), media_locations=jnp.asarray(media),
                         attention_mask=jnp.asarray(mask),
                         pixel_values=jnp.asarray(pixels)).logits)
    got = pm(ids, media_locations=media, attention_mask=mask,
             pixel_values=pixels).logits.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _jax_analytic(n_seq, b=1, h=16, d=64):
    """The dict literal the JAX tool assigns to ``row["analytic"]``,
    evaluated at these shapes."""
    with open(os.path.join(REPO, "tools", "ring_crossover.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and ast.literal_eval(node.targets[0].slice) == "analytic"):
            expr = ast.Expression(node.value)
            return eval(compile(expr, "ring_crossover.py", "eval"),
                        {"b": b, "h": h, "d": d, "n_seq": n_seq})
    raise AssertionError("no analytic fields in the JAX tool")


def test_ring_analytic_fields_match_jax():
    for n_seq in ring_crossover.SEQ_LENS:
        assert ring_crossover.analytic(n_seq, 8) == _jax_analytic(n_seq)
    assert ring_crossover.analytic(256, 2) == {
        "score_matrix_bytes_single": 4 * 16 * 256 * 256,
        "score_chunk_bytes_ring": 4 * 16 * 128 * 128,
        "icI_bytes_per_ring_step": 2 * 4 * 16 * 128 * 64}


def test_ring_two_ranks_match_full_attention():
    rows = ring_crossover.run(2, [256], device="cpu", timeout=240)
    (row,) = rows
    assert row["seq_len"] == 256 and row["normwise_error_vs_full"] <= 1e-5
    assert row["single_device"]["args_bytes"] == 3 * 4 * 16 * 256 * 64
    assert row["ring_2rank"]["args_bytes_per_rank"] == 3 * 4 * 16 * 128 * 64
    assert row["analytic"] == ring_crossover.analytic(256, 2)
    # no card: no allocator statistics, and no shrink factor made of them
    assert row["single_device"]["temp_bytes"] is None and "temp_shrink_x" not in row


def test_wait_all_one_deadline_for_the_world():
    procs = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    t0 = time.monotonic()
    results = wait_all(procs, 2.0)
    assert time.monotonic() - t0 < 10.0
    assert all(p.poll() is not None for p in procs)
    assert results[0][1] == "timed out" and len(results) == 1
