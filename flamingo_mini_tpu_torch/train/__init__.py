"""Training tier, port of ``flamingo_mini_tpu/train``: the trainer
(AdamW + constant-warmup over the trainable partition, optax's global-norm
clipping, rng-gated trunk dropout, remat, checkpoints and the captioning
eval hook), the data pipeline and the captioning metrics. One device;
``python -m flamingo_mini_tpu_torch.train`` is the command line.
"""
from .trainer import FlamingoTrainer, TrainingArguments
from .data import CaptionSample, DataCollator, SyntheticCaptionDataset

__all__ = ["FlamingoTrainer", "TrainingArguments", "CaptionSample",
           "DataCollator", "SyntheticCaptionDataset"]
