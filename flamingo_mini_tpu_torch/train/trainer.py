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

Data and tensor parallelism over a ``("data", "model")`` mesh of one
process per rank (``mesh_shape``; the ranks of an initialised process
group all on ``data`` by default, as in JAX; ``parallel.distributed_init``
first):

* DP: the global batch is ``per_device_batch_size`` times the data axis;
  each data rank takes its rows. JAX's loss divides the summed token loss by
  the global count of label tokens, and a mean of per-rank means differs
  from that wherever ranks hold different counts: so each rank
  differentiates its summed loss, and the summed gradients, the loss and
  the count are all-reduced in float32 before the division. Clipping and
  AdamW run after that reduction, the same on every rank. Dropout: each
  rank draws the whole global tensor's mask and keeps its rows
  (``layers.drawn_rows``), so DP equals one device on the global batch.
* A ``mesh_shape`` that does not cover the ranks, and ``tensor_parallel``
  without a model axis of more than one rank, raise ``ValueError``.
* TP (``tensor_parallel``): every leaf, trainable and
  frozen, is the rank's slice by the Megatron rule
  (``parallel/sharding.py``, the vocab padded to the axis) and the Adam
  state follows its parameter. The global norm sums each sharded leaf's
  squares over the model group and counts each replicated leaf once.
* Checkpoints are written by the first rank, each sharded leaf (and its Adam
  state) gathered over its model group and the vocab padding cut off, so
  that a run of any mesh reads them; only that rank logs metrics.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from ..configuration_flamingo import FlamingoConfig
from ..models import flamingo as F
from ..ops.layers import Policy, drawn_rows
from ..parallel import comm
from ..parallel.mesh import axis_size, create_mesh
from ..parallel.sharding import (gather_leaf, gather_params, leaf_splits,
                                 shard_batch, shard_leaf)
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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """optax's ``clip_by_global_norm`` in place: where the global norm (of
    ``grads``, unless given) is at least ``max_norm``, each gradient becomes
    ``(g / norm) * max_norm``. No host sync."""
    if norm is None:
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


def sharded_global_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool],
                        group) -> torch.Tensor:
    """The global norm of a tensor-parallel rank's gradients: each sharded
    leaf's squares summed over the model ``group``, each replicated leaf's
    counted once."""
    def squares(gs):
        return torch.stack([g.float().square().sum() for g in gs]).sum() if gs \
            else torch.zeros((), device=grads[0].device)
    split = squares([g for g, s in zip(grads, sharded) if s])
    whole = squares([g for g, s in zip(grads, sharded) if not s])
    return torch.sqrt(comm.all_reduce(split, group) + whole)


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
        self.model = model
        self.args = args
        self.train_dataset = train_dataset
        self.eval_fn = eval_fn
        self.collator = collator
        self.eval_dataset = eval_dataset
        self.processor = processor if processor is not None else \
            getattr(collator, "processor", None)
        from .metrics import MetricsLogger
        # the first rank of a mesh writes the metrics and the checkpoints
        self.is_writer = comm.rank() == 0
        self.metrics = MetricsLogger(
            report_to=args.report_to if self.is_writer else "none",
            output_dir=args.output_dir,
            run_name=args.run_name,
            config={f: getattr(args, f) for f in (
                "learning_rate", "warmup_steps", "per_device_batch_size",
                "sequence_length", "tensor_parallel")})
        self.config: FlamingoConfig = model.config
        self.policy: Policy = model.policy
        self.device = model.device

        self.mesh = None
        self.data_group = self.model_group = None
        self.n_data, self.data_rank, self.n_model = 1, 0, 1
        world = comm.size()
        shape = tuple(args.mesh_shape or (world, 1))
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
        if args.tensor_parallel and shape[1] <= 1:
            raise ValueError("tensor_parallel=True needs a mesh with a 'model' "
                             f"axis of size > 1, got mesh_shape {shape}")
        if world > 1:
            self.mesh = create_mesh(shape)
            data_axis = self.mesh.mesh_dim_names[0]
            self.n_data = axis_size(self.mesh, data_axis)
            self.data_group = self.mesh.get_group(data_axis)
            self.data_rank = self.mesh.get_local_rank(data_axis)
            if args.tensor_parallel:
                self.n_model = axis_size(self.mesh, "model")
                self.model_group = self.mesh.get_group("model")
        self.mask = model.trainable_mask()
        embed_key = F.trunk(self.config).EMBED
        self.vocab_rows = int(model.params["lm"][embed_key].shape[0])
        self.embed_path = f"lm.{embed_key}"
        if self.model_group is not None:
            model.shard_(self.mesh)
            self.policy = replace(self.policy, tp=self.model_group)
            self.splits = model.tp_splits
        else:
            self.splits = leaf_splits(model.params, 1, False)
        param_utils.set_requires_grad(model.params, self.mask)
        named = param_utils.trainable_leaves(model.params, self.mask)
        self.trainable_names = [name for name, _ in named]
        self.trainable_leaves = [leaf for _, leaf in named]
        # the trainable leaves' dotted paths (``splits``: every leaf's spec
        # and packed projections by path); the padded vocab's rows
        self.trainable_paths = {
            name: ".".join(re.findall(r"\['?([^'\]]*)'?\]", name))
            for name in self.trainable_names}
        self.padded_rows = self.vocab_rows + (-self.vocab_rows) % self.n_model
        self.optimizer = AdamW(
            self.trainable_leaves, constant_with_warmup(args.learning_rate, args.warmup_steps),
            b1=args.beta1, b2=args.beta2, weight_decay=args.weight_decay)
        self.step = 0

    # ------------------------------------------------------------------
    @property
    def params(self):
        """The model's parameter tree: the trainer updates its leaves in place."""
        return self.model.params

    def loss(self, batch: Dict[str, torch.Tensor], step: int,
             reduction: str = "mean") -> torch.Tensor:
        """The training loss on a device batch (the JAX trainer's loss_fn):
        the forward with its shifted cross-entropy ("mean", or "sum" over
        the batch's tokens), with the trunk's dropout from a generator
        seeded for ``step`` when ``enable_dropout``."""
        gen = None
        if self.args.enable_dropout:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(dropout_seed(self.args.seed, step))
        loss = F.forward(
            self.model.params, self.config, batch["input_ids"], policy=self.policy,
            media_locations=batch["media_locations"],
            attention_mask=batch["attention_mask"],
            pixel_values=batch["pixel_values"], labels=batch["labels"],
            loss_reduction="none" if reduction == "sum" else reduction,
            dropout_generator=gen).loss
        return loss.sum() if reduction == "sum" else loss

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
        reach. On a mesh ``batch`` is the global batch: the rank takes its
        rows and the gradients are reduced over the data axis."""
        batch = self.to_device(batch)
        if self.mesh is not None:
            return self._mesh_gradients(batch)
        if self.args.remat:
            loss = torch.utils.checkpoint.checkpoint(self.loss, batch, self.step,
                                                     use_reentrant=False)
        else:
            loss = self.loss(batch, self.step)
        grads = torch.autograd.grad(loss, self.trainable_leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def _mesh_gradients(self, batch: Dict[str, torch.Tensor]):
        """``gradients`` on a mesh: the rank's rows, its summed token loss
        differentiated, then gradients, loss and token count all-reduced in
        float32 over the data axis and divided by the count."""
        b = batch["input_ids"].shape[0]
        if b % self.n_data:
            raise ValueError(
                f"global batch size {b} must be divisible by the mesh 'data' "
                f"axis ({self.n_data}); adjust per_device_batch_size")
        batch = shard_batch(batch, self.data_rank, self.n_data)
        count = self.token_count(batch)
        # the recompute of remat draws its masks inside the context too
        with drawn_rows(self.data_rank, self.n_data):
            if self.args.remat:
                loss = torch.utils.checkpoint.checkpoint(
                    self.loss, batch, self.step, "sum", use_reentrant=False)
            else:
                loss = self.loss(batch, self.step, "sum")
            grads = torch.autograd.grad(loss, self.trainable_leaves, allow_unused=True,
                                        materialize_grads=True)
        flat = torch.cat([g.float().reshape(-1) for g in grads]
                         + [loss.detach().float().reshape(1),
                            torch.full((1,), float(count), device=loss.device)])
        flat = comm.all_reduce(flat, self.data_group)
        total = flat[-1]
        out, at = [], 0
        for g in grads:
            out.append((flat[at:at + g.numel()] / total).view(g.shape).to(g.dtype))
            at += g.numel()
        return flat[-2] / total, out

    def token_count(self, batch: Dict[str, torch.Tensor]) -> float:
        """The label tokens ``loss(batch, step, "sum")`` sums over: every
        shifted position of every row (the reference's loss)."""
        labels = batch["labels"]
        return float(labels.shape[0] * (labels.shape[1] - 1))

    def train_step_on(self, batch) -> float:
        """One optimization step on a batch (the global batch on a mesh) ->
        its loss."""
        loss, grads = self.gradients(batch)
        if self.args.grad_clip_norm:
            norm = None
            if self.model_group is not None:
                norm = sharded_global_norm(
                    grads, [bool(self.splits[self.trainable_paths[n]][0])
                            for n in self.trainable_names], self.model_group)
            clip_by_global_norm(grads, self.args.grad_clip_norm, norm)
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
        # every rank captions every row; over its model axis under TP
        tp = {} if self.model_group is None else dict(
            mesh=self.mesh["model"], tensor_parallel=True)
        metrics = evaluate_image_captioning(
            self.eval_dataset, self.model, self.processor,
            prefix=args.eval_coco_captioning_prefix,
            start=args.eval_coco_captioning_start,
            end=args.eval_coco_captioning_end,
            batch_size=args.per_device_eval_batch_size, **tp)
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
                                    args.per_device_batch_size * self.n_data,
                                    seed=args.seed + epoch)
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
    def whole_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Trainable leaf ``name``'s (or its Adam moment's) whole tensor from
        this rank's slice: gathered over the model group, the vocab padding
        cut."""
        path = self.trainable_paths[name]
        x = gather_leaf(x, *self.splits[path], self.model_group)
        return x[:self.vocab_rows] if path == self.embed_path else x

    def rank_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``whole_leaf``: the vocab padded, the rank's slice."""
        path = self.trainable_paths[name]
        if path == self.embed_path and x.shape[0] < self.padded_rows:
            pad = torch.zeros((self.padded_rows - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        spec, parts = self.splits[path]
        return shard_leaf(x, spec, comm.rank(self.model_group), self.n_model, parts)

    def whole_params(self):
        """The model's whole parameter tree (the vocab padding cut): under
        TP gathered over the model group (every rank calls it), else the
        model's own."""
        if self.model_group is None:
            return self.model.params
        whole = gather_params(self.model.params, self.splits, self.model_group)
        lm = whole["lm"]
        key = self.embed_path.split(".")[1]
        lm[key] = lm[key][:self.vocab_rows]
        return whole

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """``checkpoint-<step>/`` under ``output_dir`` (or ``path``):
        ``trainable.safetensors`` (the trainable leaves by keystr name),
        ``opt_state.safetensors`` and ``step.txt``; then the oldest beyond
        ``save_total_limit`` are removed. -> the directory. On a mesh every
        rank calls it (the model group gathers its slices) and the first
        rank writes the whole leaves."""
        path = os.path.abspath(path or os.path.join(self.args.output_dir,
                                                    f"checkpoint-{self.step}"))
        leaves = {n: self.whole_leaf(n, x)
                  for n, x in zip(self.trainable_names, self.trainable_leaves)}
        state = self.optimizer.state_dict(self.trainable_names)
        state = {k: (v if k == "count" else self.whole_leaf(k[2:], v))
                 for k, v in state.items()}
        if not self.is_writer:
            return path
        os.makedirs(path, exist_ok=True)
        save_file(leaves, os.path.join(path, "trainable.safetensors"))
        save_file(state, os.path.join(path, "opt_state.safetensors"))
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
            leaf.copy_(self.rank_leaf(name, saved[name].to(leaf.device)))
        state = load_file(os.path.join(path, "opt_state.safetensors"))
        state = {k: (v if k == "count" else self.rank_leaf(k[2:], v))
                 for k, v in state.items()}
        self.optimizer.load_state_dict(state, self.trainable_names)
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
