"""Training entry point, port of the JAX package's ``training/train.py``.

    python -m flamingo_mini_tpu_torch.train --synthetic-size 64 --max-steps 10

Arguments -> FlamingoConfig (by default the reference's published training
config: OPT-125m + CLIP ViT-L/14, dim 768, bf16) -> datasets (COCO through
torchvision, or ``--synthetic-size`` synthetic pairs) -> ``trainer.train``
-> ``save_pretrained(<output_dir>/final)``. Every ``TrainingArguments``
field is a flag (``--max-steps``, ``--learning-rate``, ...). The model runs
on ``--device`` (the card by default); batches are collated on the host and
copied ahead of each step. Without local vocabulary files a synthetic run
uses a toy tokenizer over the synthetic words.

Several processes: ``--coordinator host:port`` joins them
(``parallel.distributed_init``; each process's rank and the world size from
``RANK`` and ``WORLD_SIZE``, as torchrun sets them), ``--mesh-shape DxM``
lays them out (all on the data axis by default) and ``--tensor-parallel``
splits the weights over the model axis; ``torchrun --nproc-per-node N -m
flamingo_mini_tpu_torch.train ...`` needs no ``--coordinator``. The first
rank writes the checkpoints, the metrics and ``final``.
"""
import argparse
import dataclasses
import json
import logging
import os
from typing import List, Optional

from .. import FlamingoConfig, FlamingoModel, FlamingoProcessor
from ..parallel import distributed_init
from .data import (CocoCaptionDataset, CocoCaptionEvalDataset, DataCollator,
                   SyntheticCaptionDataset, SyntheticEvalDataset)
from .trainer import FlamingoTrainer, TrainingArguments


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m flamingo_mini_tpu_torch.train",
        description="Train Flamingo's resampler, xattn blocks and token "
                    "embedding over a frozen LM and vision tower.")
    for f in dataclasses.fields(TrainingArguments):
        name = "--" + f.name.replace("_", "-")
        tstr = str(f.type)
        if "bool" in tstr or isinstance(f.default, bool):
            p.add_argument(name, action="store_true", default=f.default)
        elif "int" in tstr:
            p.add_argument(name, type=int, default=f.default)
        elif "float" in tstr:
            p.add_argument(name, type=float, default=f.default)
        elif "tuple" in tstr:
            p.add_argument(name, type=lambda s: tuple(int(x) for x in s.split("x")),
                           default=f.default)
        else:
            p.add_argument(name, type=str, default=f.default)
    p.add_argument("--lm", default="facebook/opt-125m")
    p.add_argument("--clip-model-type", default="openai/clip-vit-large-patch14")
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--dim-visual", type=int, default=1024)
    p.add_argument("--resampler-act", default="sqrelu")
    p.add_argument("--xattn-act", default="sqrelu")
    p.add_argument("--use-pallas", action="store_true",
                   help="run the attention kernels (bf16)")
    p.add_argument("--coco-root", default=None)
    p.add_argument("--coco-ann-file", default=None)
    p.add_argument("--coco-val-root", default=None,
                   help="COCO val images dir (held-out eval)")
    p.add_argument("--coco-val-ann-file", default=None)
    p.add_argument("--synthetic-size", type=int, default=0,
                   help="use a synthetic dataset of this size instead of COCO")
    p.add_argument("--lm-arch-overrides", default=None,
                   help="JSON dict of LM arch overrides (tiny smoke runs)")
    p.add_argument("--vision-arch-overrides", default=None,
                   help="JSON dict of vision arch overrides")
    p.add_argument("--resume-from-checkpoint", default=None)
    p.add_argument("--coordinator", default=None,
                   help="the rendezvous (host:port) of a multi-process run; "
                        "RANK and WORLD_SIZE from the environment")
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--device", default="cuda", help="the model's device")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> FlamingoTrainer:
    ns = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    backend = "gloo" if ns.device == "cpu" else None
    if ns.coordinator:
        distributed_init(coordinator=ns.coordinator, backend=backend)
    else:
        distributed_init(backend=backend)        # torchrun's environment, if any

    arg_names = {f.name for f in dataclasses.fields(TrainingArguments)}
    args = TrainingArguments(**{k: v for k, v in vars(ns).items() if k in arg_names})
    config = FlamingoConfig(
        lm=ns.lm, clip_model_type=ns.clip_model_type, dim=ns.dim,
        dim_visual=ns.dim_visual, xattn_act=ns.xattn_act,
        resampler_act=ns.resampler_act, compute_dtype="bfloat16",
        use_pallas=ns.use_pallas,
        lm_arch_overrides=json.loads(ns.lm_arch_overrides)
        if ns.lm_arch_overrides else None,
        vision_arch_overrides=json.loads(ns.vision_arch_overrides)
        if ns.vision_arch_overrides else None)

    model = FlamingoModel(config, device=ns.device)
    # collation on the host: batches are copied to the model's device ahead
    # of each step (data.prefetch_to_device)
    try:
        processor = FlamingoProcessor(config, vocab_path=ns.vocab_path, device="cpu")
    except FileNotFoundError:
        if not ns.synthetic_size:
            raise
        # synthetic smoke runs work without local vocab files
        from ..tokenizer import build_toy_tokenizer
        processor = FlamingoProcessor(
            config, tokenizer=build_toy_tokenizer(
                ["image"] + SyntheticCaptionDataset().vocab), device="cpu")
    collator = DataCollator(processor, length=args.sequence_length)

    if ns.synthetic_size:
        train_ds = SyntheticCaptionDataset(size=ns.synthetic_size)
        # held-out synthetic eval set (another seed, other samples)
        eval_ds = SyntheticEvalDataset(
            SyntheticCaptionDataset(size=min(ns.synthetic_size, 64), seed=10_000))
    else:
        if not (ns.coco_root and ns.coco_ann_file):
            raise SystemExit("pass --coco-root/--coco-ann-file or --synthetic-size")
        train_ds = CocoCaptionDataset(ns.coco_root, ns.coco_ann_file)
        # the reference evaluates the COCO val split, never the training set
        eval_ds = None
        if ns.coco_val_root and ns.coco_val_ann_file:
            eval_ds = CocoCaptionEvalDataset(ns.coco_val_root, ns.coco_val_ann_file)

    trainer = FlamingoTrainer(model, args, train_dataset=train_ds,
                              eval_dataset=eval_ds, collator=collator,
                              processor=processor)
    trainer.train(resume_from_checkpoint=ns.resume_from_checkpoint)
    whole = trainer.whole_params()
    if trainer.is_writer:
        FlamingoModel(config, params=whole, device=ns.device).save_pretrained(
            os.path.join(args.output_dir, "final"))
    return trainer


if __name__ == "__main__":
    main()
