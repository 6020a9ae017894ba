"""Data- and tensor-parallel training of the port against JAX's meshes.

tests/test_torch_train.py's tiny model (GPT-2 of 2 layers, D=32, xattn before
each, gates 0.5; vocab 513, padded to 514 over a model axis of 2) and its
batch of 8 collated by the JAX package, float32, clipping engaged. JAX's
``FlamingoTrainer`` runs at ``mesh_shape=(1, 1)``, ``(4, 1)`` and ``(2, 2)``
with ``tensor_parallel`` on the first 4 of the conftest's 8 virtual devices;
the port's on 4 gloo ranks (``torch_parallel_worker``, no JAX) at ``(4, 1)``
and ``(2, 2)``.

* Losses 1e-5 relative, the updated trainable leaves 1e-5 normwise (the
  float32 sums run in other orders; nothing else differs), against JAX's
  step on the same mesh and on one device.
* The TP rank's clipping norm (``sharded_global_norm``) equals the norm of
  the one-process gradient: sharded leaves summed over the model group,
  replicated ones counted once.
* Unequal token counts: a trainer whose loss counts only weighted tokens
  (``cross_entropy_loss``'s ``weights``; 13, 4, 15 and 1 tokens on the 4
  ranks) gives on every rank JAX's one-device gradient of the weighted mean
  (1e-5), where a mean of per-rank means would not.
* Dropout: DP and TP with dropout equal the port's one-process run with
  dropout (each rank draws the global mask and keeps its rows or heads;
  JAX's bits are not reproduced, so JAX is not compared).
* A TP checkpoint (written by the first rank, slices gathered, the vocab
  padding cut) read by 4 DP ranks and by one process: bit for bit; the TP
  trainer's captioning evaluation gives the one-process metrics of its
  weights.
* ``python -m flamingo_mini_tpu_torch.train --coordinator`` in two
  processes (RANK, WORLD_SIZE from the environment): one DP step, the loss
  the one-process CLI run logs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.parallel import create_mesh
from flamingo_mini_tpu.train import trainer as jax_trainer
from flamingo_mini_tpu.train.trainer import FlamingoTrainer as JaxTrainer
from flamingo_mini_tpu.train.trainer import TrainingArguments as JaxArgs
from flamingo_mini_tpu.utils import params as jparams

from flamingo_mini_tpu_torch.train import FlamingoTrainer, TrainingArguments
from flamingo_mini_tpu_torch.utils.params import leaves_with_path

from test_torch_train import (CLIP, DECAY, LR, TINY, WARMUP, WORDS, _args,
                              _flat, _jax_model, _port_model, _rel)
from torch_parallel_worker import free_port, pack_model, rank_env, run_ranks, wait_all

STEPS = 2
WEIGHT_ROWS = ((1, 12), (2, 4), (15, 15), (1, 0))   # each rank's 2 rows' tokens


def _batch():
    from flamingo_mini_tpu import FlamingoConfig as JaxConfig
    from flamingo_mini_tpu import FlamingoProcessor as JaxProcessor
    from flamingo_mini_tpu.tokenizer import build_toy_tokenizer
    from flamingo_mini_tpu.train.data import DataCollator as JaxCollator
    from flamingo_mini_tpu.train.data import SyntheticCaptionDataset as JaxDataset
    proc = JaxProcessor(JaxConfig(**TINY), tokenizer=build_toy_tokenizer(WORDS))
    ds = JaxDataset(size=8, image_hw=32)
    return JaxCollator(proc, length=16)([ds[i] for i in range(8)])


def _loss_weights(n):
    """(8, n) weights: rank r's two rows hold WEIGHT_ROWS[r] weighted tokens
    after the shift."""
    w = np.zeros((8, n), np.float32)
    for r, counts in enumerate(WEIGHT_ROWS):
        for i, c in enumerate(counts):
            w[2 * r + i, 1:1 + c] = 1.0
    return w


def _jax_run(batch, tmp, shape, tp=False):
    """JAX's trainer on the first prod(shape) devices -> (losses, trainable)."""
    jmodel = _jax_model()
    n = int(np.prod(shape))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "create_mesh",
                   lambda s: create_mesh(s, devices=jax.devices()[:n]))
        jt = JaxTrainer(jmodel, _args(JaxArgs, tmp, mesh_shape=shape,
                                      tensor_parallel=tp))
        losses = [jt.train_step_on(batch) for _ in range(STEPS)]
    leaves = jax.tree_util.tree_leaves(jax.device_get(jt.trainable))
    return np.array(losses), _flat(leaves)


def _jax_weighted(batch, weights):
    """JAX's one-device loss and trainable gradients of the weighted mean."""
    jmodel = _jax_model()
    mask = jmodel.trainable_mask()
    trainable, frozen = jparams.partition_params(jmodel.params, mask)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}

    def loss_fn(t):
        logits = jflam.forward(jparams.merge_params(t, frozen), jmodel.config,
                               jb["input_ids"], policy=jmodel.policy,
                               media_locations=jb["media_locations"],
                               attention_mask=jb["attention_mask"],
                               pixel_values=jb["pixel_values"]).logits
        return jflam.cross_entropy_loss(logits, jb["labels"],
                                        weights=jax.numpy.asarray(weights))

    loss, grads = jax.value_and_grad(loss_fn)(trainable)
    return float(loss), _flat(jax.tree_util.tree_leaves(grads))


def _port_trainer(tmp, **kw):
    pt = FlamingoTrainer(_port_model(_jax_model()), _args(TrainingArguments, tmp, **kw))
    return pt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    batch = _batch()
    tmp = tmp_path_factory.mktemp("parallel_training")
    ref = {"jax.single": _jax_run(batch, tmp / "j1", (1, 1)),
           "jax.dp": _jax_run(batch, tmp / "j2", (4, 1)),
           "jax.tp": _jax_run(batch, tmp / "j3", (2, 2), tp=True)}
    weights = _loss_weights(batch["labels"].shape[1])
    ref["jax.weighted"] = _jax_weighted(batch, weights)
    pt = _port_trainer(tmp / "p1")
    _, grads = pt.gradients(batch)
    ref["port.norm"] = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    for label, dropout in (("port.single", False), ("port.dropout", True)):
        pt = _port_trainer(tmp / label, enable_dropout=dropout)
        losses = np.array([pt.train_step_on(batch) for _ in range(STEPS)])
        ref[label] = (losses, {p: x.detach().numpy() for p, x in leaves_with_path(
            pt.model.params)}, pt.trainable_names)
    model = _port_model(_jax_model())
    inputs = {**pack_model("tiny", TINY, model.params),
              **{"batch." + k: np.asarray(v) for k, v in batch.items()},
              "loss_weights": weights, "out_dir": str(tmp / "ranks"),
              "words": WORDS,
              "hp": dict(learning_rate=LR, warmup_steps=WARMUP, weight_decay=DECAY,
                         grad_clip_norm=CLIP, steps=STEPS)}
    outs = run_ranks("training", 4, inputs)
    return ref, outs, tmp


def _trainable(out, label, names):
    return np.concatenate([np.asarray(out[f"{label}.params{n}"], np.float64).ravel()
                           for n in names])


@pytest.mark.parametrize("label", ["dp", "tp"])
def test_step_matches_jax_mesh_and_one_device(runs, label):
    ref, outs, _ = runs
    names = ref["port.single"][2]
    for out in outs:
        np.testing.assert_allclose(out[label + ".losses"], ref["jax." + label][0],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(out[label + ".losses"], ref["jax.single"][0],
                                   rtol=1e-5, atol=0)
        got = _trainable(out, label, names)
        assert _rel(got, ref["jax." + label][1]) <= 1e-5
        assert _rel(got, ref["jax.single"][1]) <= 1e-5
    assert ref["port.norm"] > CLIP                     # clipping engages


def test_tp_norm_counts_replicated_leaves_once(runs):
    ref, outs, _ = runs
    for out in outs:
        assert abs(float(out["tp.grad_norm"]) - ref["port.norm"]) <= 1e-5 * ref["port.norm"]


def test_unequal_token_counts_reduce_to_the_global_mean(runs):
    ref, outs, _ = runs
    loss, grads = ref["jax.weighted"]
    names = ref["port.single"][2]
    for out in outs:
        assert abs(float(out["weighted.loss"]) - loss) <= 1e-5 * abs(loss)
        got = np.concatenate([np.asarray(out["weighted.grad" + n], np.float64).ravel()
                              for n in names])
        assert _rel(got, grads) <= 1e-5
    # a mean of the ranks' means is another number
    counts = [sum(c) for c in WEIGHT_ROWS]
    assert len(set(counts)) == len(counts)


@pytest.mark.parametrize("label", ["dp_dropout", "tp_dropout"])
def test_dropout_matches_one_process(runs, label):
    ref, outs, _ = runs
    losses, params, names = ref["port.dropout"]
    want = np.concatenate([np.asarray(params[n], np.float64).ravel() for n in names])
    for out in outs:
        np.testing.assert_allclose(out[label + ".losses"], losses, rtol=1e-5, atol=0)
        assert _rel(_trainable(out, label, names), want) <= 1e-5
    assert not np.allclose(losses, ref["port.single"][0], rtol=1e-5)   # it dropped


def test_tp_checkpoint_reads_back_at_any_world_size(runs):
    ref, outs, tmp = runs
    for out in outs:
        assert float(out["tp.read_back"]) == 0.0
    pt = _port_trainer(tmp / "reader")
    pt.load_checkpoint(str(outs[0]["tp.ckpt"]))
    for name, leaf in zip(pt.trainable_names, pt.trainable_leaves):
        np.testing.assert_array_equal(leaf.detach().numpy(), outs[0]["tp.params" + name])
    assert pt.step == STEPS


def test_tp_evaluate_matches_one_process(runs):
    """Captioning evaluation as ``evaluate()`` runs it under TP (over the
    mesh's ``model`` axis alone): the metrics of the whole weights in one
    process."""
    _, outs, _ = runs
    for out in outs:
        tp = {k[len("tp.eval."):]: float(v) for k, v in out.items() if k.startswith("tp.eval.")}
        one = {k[len("tp.eval_one."):]: float(v) for k, v in out.items()
               if k.startswith("tp.eval_one.")}
        assert tp and tp == one, (tp, one)


def test_coordinator_command_line_two_processes(tmp_path):
    """Two processes of the CLI meet at ``--coordinator`` (gloo on the CPU)
    and take one DP step on the global batch of 2 x 2 rows: both log the
    one-process run's loss, and only the first writes ``final``."""
    from flamingo_mini_tpu_torch.train import __main__ as cli
    from test_torch_train_data import LM, VIT
    argv = ["--device", "cpu", "--lm", "gpt2", "--dim", "32", "--dim-visual", "32",
            "--lm-arch-overrides", json.dumps(LM), "--vision-arch-overrides",
            json.dumps(VIT), "--synthetic-size", "8", "--per-device-batch-size", "2",
            "--sequence-length", "16", "--max-steps", "1", "--warmup-steps", "1",
            "--learning-rate", "1e-3", "--eval-every-steps", "1000",
            "--log-every-steps", "1", "--vocab-path", str(tmp_path / "none")]
    one = cli.main(argv + ["--per-device-batch-size", "4", "--output-dir",
                           str(tmp_path / "one")])
    want = json.loads(open(tmp_path / "one" / "metrics.jsonl").read())["loss"]
    port_ = free_port()
    procs = []
    for rank in range(2):
        env = dict(rank_env(), RANK=str(rank), WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "flamingo_mini_tpu_torch.train", *argv,
             "--coordinator", f"127.0.0.1:{port_}", "--output-dir",
             str(tmp_path / "two")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=tmp_path))
    results = wait_all(procs, timeout=300)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{out[-4000:]}"
    logged = [line.split("step 1 loss=", 1)[1].split()[0] for _, out in results
              for line in out.splitlines() if "step 1 loss=" in line]
    assert len(logged) == 2 and logged[0] == logged[1], logged
    got = json.loads(open(tmp_path / "two" / "metrics.jsonl").read())["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert one.step == 1
    assert sorted(os.listdir(tmp_path / "two")) == ["checkpoint-1", "final", "metrics.jsonl"]
