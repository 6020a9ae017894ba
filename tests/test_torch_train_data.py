"""The port's training data pipeline, metrics, logging, evaluation and
command line, against the JAX package where it has a counterpart.

* ``SyntheticCaptionDataset``, ``DataCollator`` and ``batches``: the same
  samples, and batch for batch the same ids, media locations, masks and
  labels (exact; leading spaces and flips drawn in JAX's order) and pixels
  within 1e-4 (tests/test_torch_image.py's bound for the device pipeline).
* ``corpus_bleu``, ``rouge_l``, ``cider_d``, ``corpus_meteor``,
  ``meteor_score`` and ``porter_stem``: equal to JAX's on fixed captions.
* ``MetricsLogger``'s jsonl, the wandb fallback, and ``evaluate()`` with an
  ``eval_fn`` and over a small ``SyntheticEvalDataset`` (the captions of
  ``generate_captions`` scored by the fallback metrics), ``train()``'s
  logging, evaluation and checkpoint cadence.
* ``python -m flamingo_mini_tpu_torch.train`` in-process on the CPU (tiny
  overrides, 2 steps): ``final/`` loads with ``from_pretrained`` and holds
  the trained weights; ``--coordinator`` raises.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import FlamingoProcessor as JaxProcessor
from flamingo_mini_tpu.tokenizer import build_toy_tokenizer as jax_toy_tokenizer
from flamingo_mini_tpu.train import data as jdata
from flamingo_mini_tpu.train import eval as jeval
from flamingo_mini_tpu.train import meteor as jmeteor

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.tokenizer import build_toy_tokenizer
from flamingo_mini_tpu_torch.train import FlamingoTrainer, TrainingArguments
from flamingo_mini_tpu_torch.train import __main__ as cli
from flamingo_mini_tpu_torch.train import data as pdata
from flamingo_mini_tpu_torch.train import eval as peval
from flamingo_mini_tpu_torch.train import meteor as pmeteor
from flamingo_mini_tpu_torch.train.metrics import MetricsLogger
from flamingo_mini_tpu_torch.utils.params import leaves_with_path

LM = dict(vocab_size=512, n_positions=160, n_embd=32, n_layer=2, n_head=4)
VIT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
           num_attention_heads=4, image_size=32, patch_size=8)
TINY = dict(lm="gpt2", dim=32, dim_visual=32, xattn_every=1, xattn_dim_head=8,
            xattn_heads=4, resampler_depth=1, resampler_dim_head=8, resampler_heads=4,
            resampler_num_latents=4, lm_arch_overrides=LM, vision_arch_overrides=VIT)
WORDS = ["image", "a", "cat", "dog", "picture", "of", "red", "blue", "small", "big",
         "bird", "<", ">"]
CANDIDATES = ["a cat sat on the mat", "a dog running in the running park",
              "two birds", "", "the the the"]
REFERENCES = [["a cat is sitting on a mat", "the cat sat on the mat"],
              ["dogs run in a park", "a dog runs through the park quickly"],
              ["two small birds on a branch"], ["an empty caption"],
              ["the cat", "a picture of the thing"]]


def _processors():
    jp = JaxProcessor(JaxConfig(**TINY), tokenizer=jax_toy_tokenizer(WORDS))
    pp = port.FlamingoProcessor(port.FlamingoConfig(**TINY),
                                tokenizer=build_toy_tokenizer(WORDS), device="cpu")
    return jp, pp


@pytest.mark.parametrize("leading_space", [True, False])
def test_collated_batches_match_jax(leading_space):
    jp, pp = _processors()
    jds = jdata.SyntheticCaptionDataset(size=10, image_hw=40, seed=3)
    pds = pdata.SyntheticCaptionDataset(size=10, image_hw=40, seed=3)
    for i in range(10):
        assert np.array_equal(jds[i].image, pds[i].image)
        assert jds[i].caption == pds[i].caption
    kw = dict(length=24, random_leading_space=leading_space, seed=5)
    jcol, pcol = jdata.DataCollator(jp, **kw), pdata.DataCollator(pp, **kw)
    n = 0
    for epoch in range(2):
        for jb, pb in zip(jdata.batches(jds, jcol, 4, seed=epoch),
                          pdata.batches(pds, pcol, 4, seed=epoch)):
            n += 1
            assert set(pb) == set(jb)
            for key in ("input_ids", "media_locations", "attention_mask", "labels"):
                assert np.array_equal(pb[key].numpy(), np.asarray(jb[key])), key
            assert pb["input_ids"].dtype == torch.int64
            assert pb["attention_mask"].dtype == pb["media_locations"].dtype == torch.int32
            assert pb["pixel_values"].shape == (4, 1, 3, 32, 32)
            np.testing.assert_allclose(pb["pixel_values"].numpy(),
                                       np.asarray(jb["pixel_values"]), rtol=0, atol=1e-4)
    assert n == 4              # drop_last: two batches of 4 an epoch


def test_prefetch_on_the_cpu_moves_nothing():
    batch = {"input_ids": torch.ones((2, 3), dtype=torch.int64),
             "pixel_values": torch.zeros((2, 1, 3, 4, 4))}
    out = list(pdata.prefetch_to_device(iter([batch, batch]), "cpu",
                                        cast_pixels=lambda t: t.to(torch.bfloat16)))
    assert len(out) == 2
    assert out[0]["input_ids"] is batch["input_ids"]
    assert out[0]["pixel_values"].dtype == torch.bfloat16
    assert list(pdata.prefetch_to_device(iter([]), "cpu")) == []


def test_coco_datasets_need_torchvision(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_torchvision(name, *a, **k):
        if name.startswith("torchvision"):
            raise ImportError("no torchvision")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_torchvision)
    for cls in (pdata.CocoCaptionDataset, pdata.CocoCaptionEvalDataset):
        with pytest.raises(ImportError):
            cls("images", "annotations.json")


def test_caption_metrics_match_jax():
    assert pmeteor.porter_stem is not jmeteor.porter_stem
    for w in ("running", "caresses", "ponies", "relational", "hopeful", "sky", "a"):
        assert pmeteor.porter_stem(w) == jmeteor.porter_stem(w)
    assert peval.corpus_bleu(CANDIDATES, REFERENCES) == \
        jeval.corpus_bleu(CANDIDATES, REFERENCES)
    for name in ("rouge_l", "cider_d"):
        assert getattr(peval, name)(CANDIDATES, REFERENCES) == \
            getattr(jeval, name)(CANDIDATES, REFERENCES), name
    assert pmeteor.corpus_meteor(CANDIDATES, REFERENCES) == \
        jmeteor.corpus_meteor(CANDIDATES, REFERENCES)
    for c, r in zip(CANDIDATES, REFERENCES):
        assert pmeteor.meteor_score(c, r) == jmeteor.meteor_score(c, r)


def test_metrics_logger_jsonl(tmp_path, monkeypatch):
    log = MetricsLogger(report_to="jsonl", output_dir=str(tmp_path / "a"))
    log.log({"loss": 1.5, "epoch": 0}, step=3)
    log.log({"eval_CIDEr": 0.25}, step=4)
    log.finish()
    lines = [json.loads(s) for s in open(tmp_path / "a" / "metrics.jsonl")]
    assert [(d["step"], d.get("loss"), d.get("eval_CIDEr")) for d in lines] == \
        [(3, 1.5, None), (4, None, 0.25)]
    assert all("time" in d for d in lines)
    MetricsLogger(report_to="none", output_dir=str(tmp_path / "b")).log({"x": 1.0}, 1)
    assert not (tmp_path / "b").exists()
    # no wandb package: the jsonl sink
    monkeypatch.setitem(sys.modules, "wandb", None)
    fallback = MetricsLogger(report_to="wandb", output_dir=str(tmp_path / "c"))
    assert fallback.report_to == "jsonl"


@pytest.fixture(scope="module")
def tiny():
    model = port.FlamingoModel(port.FlamingoConfig(compute_dtype="bfloat16",
                                                   use_pallas=True, **TINY), device="cpu")
    _, proc = _processors()
    return model, proc


def test_evaluate_with_eval_fn_and_synthetic_eval_dataset(tiny, tmp_path):
    model, proc = tiny
    args = TrainingArguments(output_dir=str(tmp_path), report_to="none",
                             per_device_eval_batch_size=3)
    t = FlamingoTrainer(model, args, eval_fn=lambda tr: {"eval_steps": float(tr.step)})
    assert t.evaluate() == {"eval_steps": 0.0}
    with pytest.raises(ValueError):
        FlamingoTrainer(model, args).evaluate()
    eval_ds = pdata.SyntheticEvalDataset(pdata.SyntheticCaptionDataset(size=4, image_hw=32))
    t = FlamingoTrainer(model, args, eval_dataset=eval_ds, processor=proc)
    got = t.evaluate()
    assert set(got) == {"eval_Bleu_1", "eval_Bleu_2", "eval_Bleu_3", "eval_Bleu_4",
                        "eval_ROUGE_L", "eval_CIDEr", "eval_METEOR"}
    captions = model.generate_captions(proc, images=[eval_ds[i][0] for i in range(4)],
                                       prompt=args.eval_coco_captioning_prefix,
                                       max_length=150)
    refs = [eval_ds[i][1] for i in range(4)]
    assert got["eval_CIDEr"] == peval.cider_d(captions, refs)
    assert got["eval_METEOR"] == pmeteor.corpus_meteor(captions, refs)


def test_train_loop_logs_evaluates_and_saves(tiny, tmp_path):
    """train(): 5 steps over 20 samples at batch 4 (one epoch), logging every
    2, an eval_fn every 2, checkpoints every 2 and at the end, 2 kept."""
    model, proc = tiny
    col = pdata.DataCollator(proc, length=16)
    ds = pdata.SyntheticCaptionDataset(size=20, image_hw=32)
    args = TrainingArguments(output_dir=str(tmp_path), per_device_batch_size=4,
                             log_every_steps=2, eval_every_steps=2, save_every_steps=2,
                             learning_rate=1e-3, warmup_steps=1)
    t = FlamingoTrainer(model, args, train_dataset=ds, collator=col,
                        eval_fn=lambda tr: {"eval_step": float(tr.step)})
    losses = t.train()
    assert len(losses) == 5 and np.isfinite(losses).all() and t.step == 5
    lines = [json.loads(s) for s in open(tmp_path / "metrics.jsonl")]
    assert [d["step"] for d in lines if "loss" in d] == [2, 4]
    assert [d["eval_step"] for d in lines if "eval_step" in d] == [2.0, 4.0]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-4", "checkpoint-5",
                                             "metrics.jsonl"]
    assert open(tmp_path / "checkpoint-5" / "step.txt").read() == "5"


def test_command_line_trains_and_saves_final(tmp_path, monkeypatch):
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--lm", "gpt2", "--dim", "32", "--dim-visual", "32",
            "--lm-arch-overrides", json.dumps(LM), "--vision-arch-overrides",
            json.dumps(VIT), "--synthetic-size", "8", "--per-device-batch-size", "4",
            "--sequence-length", "16", "--max-steps", "2", "--warmup-steps", "1",
            "--learning-rate", "1e-3", "--eval-every-steps", "1000",
            "--log-every-steps", "1",
            "--vocab-path", str(tmp_path / "no vocabulary here"),
            "--output-dir", str(out)]
    trainer = cli.main(argv)
    assert trainer.step == 2
    assert sorted(os.listdir(out)) == ["checkpoint-2", "final", "metrics.jsonl"]
    assert [json.loads(s)["step"] for s in open(out / "metrics.jsonl")] == [1, 2]
    loaded = port.FlamingoModel.from_pretrained(str(out / "final"), device="cpu")
    want = dict(leaves_with_path(trainer.model.params))
    for path, leaf in leaves_with_path(loaded.params):
        assert torch.equal(leaf, want[path].detach()), path
    # a rendezvous with no rank and world size from the environment
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE and RANK"):
        cli.main(argv + ["--coordinator", "localhost:1234"])
