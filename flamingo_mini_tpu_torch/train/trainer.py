"""FlamingoTrainer, port of ``flamingo_mini_tpu/train/trainer.py``.

The JAX trainer's semantics on one device:

* AdamW with the constant-after-warmup schedule (lr 1e-4, warmup 5000: the
  reference's train.sh:8-10 defaults), HF-exact (lr 0 at step 0), and
  optax's ``clip_by_global_norm`` rule before it (``g / ||g|| * max_norm``
  only where ``||g|| >= max_norm``; no epsilon);
* only the trainable partition updates (``utils.params.trainable_mask``:
  the reference's freeze_lm / freeze_vm); the frozen leaves do not require
  grad, and the vision tower runs under ``torch.no_grad()``;
* bf16 compute (the policy) over float32 parameters and float32 Adam state;
* ``enable_dropout``: the trunk's dropout, its generator seeded from
  ``(seed, step)`` as the JAX step folds the step into its key, so a
  resumed run draws the masks an uninterrupted one draws;
* ``remat``: the loss under ``torch.utils.checkpoint`` (``jax.checkpoint``);
  the dropout generator is made inside the checkpointed function, so the
  recompute draws the forward's masks;
* checkpoints ``checkpoint-N/`` with ``step.txt``, the newest
  ``save_total_limit`` kept; the trainable leaves under their keystr names
  and the optimizer state as ``.safetensors`` (Orbax checkpoints of the JAX
  trainer are not read);
* the captioning eval hook (the reference overrides Trainer.evaluate).

Data and tensor parallelism (``mesh_shape``, ``tensor_parallel``) are not
ported: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from ..configuration_flamingo import FlamingoConfig
from ..models import flamingo as F
from ..ops.layers import Policy
from ..utils import params as param_utils
from ..utils.safetensors_io import load_file, save_file

logger = logging.getLogger("flamingo_mini_tpu_torch.train")


@dataclass
class TrainingArguments:
    """Run configuration: the JAX trainer's fields and defaults (the
    reference's FlamingoTrainingArguments and train.sh flag values)."""

    output_dir: str = os.path.join(tempfile.gettempdir(), "flamingo_run")
    learning_rate: float = 1e-4
    warmup_steps: int = 5000
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    per_device_batch_size: int = 8
    sequence_length: int = 64
    num_epochs: int = 1
    max_steps: Optional[int] = None
    save_every_steps: Optional[int] = None
    save_total_limit: int = 2
    eval_every_steps: Optional[int] = 1000
    log_every_steps: int = 50
    seed: int = 42
    enable_dropout: bool = False   # the frozen trunk's dropout (HF Trainer parity)
    remat: bool = False            # recompute the forward in the backward
    tensor_parallel: bool = False
    mesh_shape: Optional[tuple] = None
    grad_clip_norm: Optional[float] = 1.0
    eval_coco_captioning_prefix: str = "<image>A picture of"
    eval_coco_captioning_start: int = 0
    eval_coco_captioning_end: int = 1000
    per_device_eval_batch_size: int = 64
    report_to: str = "jsonl"       # "jsonl" | "wandb" | "none" (train.sh:25)
    run_name: Optional[str] = None


def constant_with_warmup(lr: float, warmup_steps: int) -> Callable[[int], float]:
    """HF's get_constant_schedule_with_warmup: ``lr * step / warmup_steps``
    below warmup (step 0 has lr 0), then ``lr``."""
    def schedule(step: int) -> float:
        return lr * (step / max(warmup_steps, 1) if step < warmup_steps else 1.0)
    return schedule


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: where the global norm is at
    least ``max_norm``, each gradient becomes ``(g / norm) * max_norm``.
    No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay=...)`` over a list
    of leaves, updated in place: moments in float32, bias correction from
    the update count (factors rounded to float32, as optax computes them),
    decoupled decay on the current parameter, then ``p - lr(count) * u``
    with ``count`` the updates made before this one."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** self.count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** self.count)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The state under the leaves' ``names``: ``mu<name>``, ``nu<name>``
        and ``count``."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for name, m, v in zip(names, self.mu, self.nu):
            out["mu" + name], out["nu" + name] = m, v
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor], names: Sequence[str]) -> None:
        self.count = int(state["count"])
        for name, m, v in zip(names, self.mu, self.nu):
            m.copy_(state["mu" + name])
            v.copy_(state["nu" + name])


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at ``step``: one function of (seed, step)
    (the JAX trainer's ``fold_in(PRNGKey(seed), step)``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


class FlamingoTrainer:
    def __init__(
        self,
        model,                                  # FlamingoModel
        args: TrainingArguments,
        train_dataset=None,
        eval_fn: Optional[Callable[["FlamingoTrainer"], Dict[str, float]]] = None,
        collator=None,
        eval_dataset=None,      # indexable of (image, List[str] references):
                                # the reference's COCO val split
        processor=None,         # for eval captioning; defaults to
                                # collator.processor
    ):
        if args.tensor_parallel or args.mesh_shape not in (None, (1, 1)):
            raise NotImplementedError(
                "data and tensor parallelism (mesh_shape, tensor_parallel) are "
                "not ported: ROADMAP queue 1 item 9; the trainer runs on one device")
        self.model = model
        self.args = args
        self.train_dataset = train_dataset
        self.eval_fn = eval_fn
        self.collator = collator
        self.eval_dataset = eval_dataset
        self.processor = processor if processor is not None else \
            getattr(collator, "processor", None)
        from .metrics import MetricsLogger
        self.metrics = MetricsLogger(
            report_to=args.report_to, output_dir=args.output_dir,
            run_name=args.run_name,
            config={f: getattr(args, f) for f in (
                "learning_rate", "warmup_steps", "per_device_batch_size",
                "sequence_length", "tensor_parallel")})
        self.config: FlamingoConfig = model.config
        self.policy: Policy = model.policy
        self.device = model.device

        self.mask = model.trainable_mask()
        param_utils.set_requires_grad(model.params, self.mask)
        named = param_utils.trainable_leaves(model.params, self.mask)
        self.trainable_names = [name for name, _ in named]
        self.trainable_leaves = [leaf for _, leaf in named]
        self.optimizer = AdamW(
            self.trainable_leaves, constant_with_warmup(args.learning_rate, args.warmup_steps),
            b1=args.beta1, b2=args.beta2, weight_decay=args.weight_decay)
        self.step = 0

    # ------------------------------------------------------------------
    @property
    def params(self):
        """The model's parameter tree: the trainer updates its leaves in place."""
        return self.model.params

    def loss(self, batch: Dict[str, torch.Tensor], step: int) -> torch.Tensor:
        """The training loss on a device batch (the JAX trainer's loss_fn):
        the forward with its shifted cross-entropy, with the trunk's dropout
        from a generator seeded for ``step`` when ``enable_dropout``."""
        gen = None
        if self.args.enable_dropout:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(dropout_seed(self.args.seed, step))
        return F.forward(
            self.model.params, self.config, batch["input_ids"], policy=self.policy,
            media_locations=batch["media_locations"],
            attention_mask=batch["attention_mask"],
            pixel_values=batch["pixel_values"], labels=batch["labels"],
            dropout_generator=gen).loss

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A host or device batch as the forward takes it on the model's
        device: int64 ids and labels, int32 masks, pixels in the policy's
        dtype."""
        dtypes = {"input_ids": torch.long, "labels": torch.long,
                  "media_locations": torch.int32, "attention_mask": torch.int32}
        out = {k: (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
                   ).to(self.device, dtypes.get(k)) for k, v in batch.items()}
        out["pixel_values"] = self.policy.cast(out["pixel_values"])
        return out

    def gradients(self, batch: Dict[str, torch.Tensor]):
        """(loss, gradients of the trainable leaves in pytree order) at the
        current step, before clipping; zeros for a leaf the loss does not
        reach."""
        batch = self.to_device(batch)
        if self.args.remat:
            loss = torch.utils.checkpoint.checkpoint(self.loss, batch, self.step,
                                                     use_reentrant=False)
        else:
            loss = self.loss(batch, self.step)
        grads = torch.autograd.grad(loss, self.trainable_leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step_on(self, batch) -> float:
        """One optimization step on a batch -> its loss."""
        loss, grads = self.gradients(batch)
        if self.args.grad_clip_norm:
            clip_by_global_norm(grads, self.args.grad_clip_norm)
        self.optimizer.update(grads)
        self.step += 1
        return float(loss)

    def evaluate(self) -> Dict[str, float]:
        """COCO-captioning evaluation on ``eval_dataset`` (the reference
        overrides Trainer.evaluate the same way); ``eval_fn`` takes
        precedence when given."""
        if self.eval_fn is not None:
            return self.eval_fn(self)
        if self.eval_dataset is None or self.processor is None:
            raise ValueError("evaluate() needs eval_dataset + processor "
                             "(or an eval_fn)")
        from .eval import evaluate_image_captioning
        args = self.args
        metrics = evaluate_image_captioning(
            self.eval_dataset, self.model, self.processor,
            prefix=args.eval_coco_captioning_prefix,
            start=args.eval_coco_captioning_start,
            end=args.eval_coco_captioning_end,
            batch_size=args.per_device_eval_batch_size)
        return {f"eval_{k}": v for k, v in metrics.items()}

    def train(self, resume_from_checkpoint: Optional[str] = None) -> List[float]:
        from .data import batches, prefetch_to_device
        if resume_from_checkpoint:
            self.load_checkpoint(resume_from_checkpoint)
        args = self.args
        sched = constant_with_warmup(args.learning_rate, args.warmup_steps)
        t0 = time.time()
        losses: List[float] = []
        can_eval = (self.eval_fn is not None
                    or (self.eval_dataset is not None and self.processor is not None))
        for epoch in range(args.num_epochs):
            epoch_batches = batches(self.train_dataset, self.collator,
                                    args.per_device_batch_size, seed=args.seed + epoch)
            for batch in prefetch_to_device(epoch_batches, self.device,
                                            cast_pixels=self.policy.cast):
                loss = self.train_step_on(batch)
                losses.append(loss)
                if self.step % args.log_every_steps == 0:
                    self.metrics.log({
                        "loss": float(np.mean(losses[-args.log_every_steps:])),
                        "learning_rate": float(sched(self.step - 1)),
                        "epoch": epoch,
                        "s_per_it": (time.time() - t0) / max(1, len(losses)),
                    }, step=self.step)
                if args.save_every_steps and self.step % args.save_every_steps == 0:
                    self.save_checkpoint()
                if (args.eval_every_steps and can_eval
                        and self.step % args.eval_every_steps == 0):
                    self.metrics.log(self.evaluate(), step=self.step)
                if args.max_steps and self.step >= args.max_steps:
                    self.save_checkpoint()
                    self.metrics.finish()
                    return losses
        self.save_checkpoint()
        self.metrics.finish()
        return losses

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """``checkpoint-<step>/`` under ``output_dir`` (or ``path``):
        ``trainable.safetensors`` (the trainable leaves by keystr name),
        ``opt_state.safetensors`` and ``step.txt``; then the oldest beyond
        ``save_total_limit`` are removed. -> the directory."""
        path = os.path.abspath(path or os.path.join(self.args.output_dir,
                                                    f"checkpoint-{self.step}"))
        os.makedirs(path, exist_ok=True)
        save_file(dict(zip(self.trainable_names, self.trainable_leaves)),
                  os.path.join(path, "trainable.safetensors"))
        save_file(self.optimizer.state_dict(self.trainable_names),
                  os.path.join(path, "opt_state.safetensors"))
        with open(os.path.join(path, "step.txt"), "w") as f:
            f.write(str(self.step))
        self._prune_checkpoints()
        logger.info("saved checkpoint %s", path)
        return path

    @torch.no_grad()
    def load_checkpoint(self, path: str) -> None:
        path = os.path.abspath(path)
        saved = load_file(os.path.join(path, "trainable.safetensors"))
        if set(saved) != set(self.trainable_names):
            raise ValueError(f"{path}: its trainable leaves are not this model's")
        for name, leaf in zip(self.trainable_names, self.trainable_leaves):
            leaf.copy_(saved[name])
        self.optimizer.load_state_dict(
            load_file(os.path.join(path, "opt_state.safetensors")), self.trainable_names)
        with open(os.path.join(path, "step.txt")) as f:
            self.step = int(f.read().strip())
        logger.info("resumed from %s at step %d", path, self.step)

    def _prune_checkpoints(self) -> None:
        """Keep the newest ``save_total_limit`` checkpoints (the reference's
        --save_total_limit 2; train.sh:20)."""
        out = self.args.output_dir
        if not os.path.isdir(out):
            return
        ckpts = sorted(
            (d for d in os.listdir(out) if re.fullmatch(r"checkpoint-\d+", d)),
            key=lambda d: int(d.split("-")[1]))
        for d in ckpts[:-self.args.save_total_limit]:
            shutil.rmtree(os.path.join(out, d), ignore_errors=True)
