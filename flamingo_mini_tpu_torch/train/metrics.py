"""Metrics sinks, the port's copy of ``flamingo_mini_tpu/train/metrics.py``
(stdlib only; ``wandb`` imported where asked for). The reference trains
under HF Trainer with ``--report_to wandb`` (its training/train.sh:25);
this module is the equivalent reporting layer, zero-egress friendly.

Sinks (``TrainingArguments.report_to``):
* ``"jsonl"`` (default): one JSON object per event appended to
  ``<output_dir>/metrics.jsonl`` — machine-readable run history without any
  external service, plus the usual python logging.
* ``"wandb"``: logs through the ``wandb`` package when importable (offline
  mode works under zero egress via WANDB_MODE=offline); falls back to jsonl
  with a warning otherwise.
* ``"none"``: python logging only.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("flamingo_mini_tpu_torch.train")


class MetricsLogger:
    def __init__(self, report_to: str = "jsonl", output_dir: str = ".",
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        self.report_to = report_to
        self.output_dir = output_dir
        self.run_name = run_name
        self._jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if report_to == "wandb":
            try:
                import wandb
                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "flamingo_mini_tpu"),
                    name=run_name, config=config or {}, reinit=True)
            except Exception as e:  # not installed / no credentials
                logger.warning(
                    "wandb unavailable (%s); falling back to jsonl sink", e)
                self.report_to = "jsonl"

    def log(self, metrics: Dict[str, float], step: int) -> None:
        logger.info("step %d %s", step,
                    " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in metrics.items()))
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        elif self.report_to == "jsonl":
            os.makedirs(self.output_dir, exist_ok=True)
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps({"step": step, "time": time.time(),
                                    **metrics}) + "\n")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
