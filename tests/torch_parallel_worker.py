"""Rank worker of the port's parallel tests, and the parent's launcher.

The parent test builds the seeded weights and inputs (and JAX's outputs) once
per module, writes the port's share to ``inputs.npz`` and calls ``run_ranks``:
it starts ``world`` processes of this file, each a gloo rank on the CPU with
one thread, on a free local port, each under a time limit. A rank runs one
job (``JOBS``) and writes its outputs to ``out<rank>.npz``; the parent reads
every rank's. A failed or timed-out rank fails the parent with its output.

This file imports no JAX and nothing of the JAX package: each rank asserts at
its end that ``jax`` is not among its modules.

    python tests/torch_parallel_worker.py JOB DIR RANK WORLD PORT
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env():
    """The environment of a rank: the repository importable, one thread,
    the parent's JAX settings dropped."""
    env = {k: v for k, v in os.environ.items() if k not in JAX_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def wait_all(procs, timeout: float):
    """Each process's (returncode, output); every process is killed once one
    fails or the time runs out. ``timeout`` is one deadline for the whole
    world, not a limit per process."""
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
            outs.append(out)
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_ranks(job: str, world: int, inputs: dict, timeout: float = 300.0):
    """Run ``job`` on ``world`` gloo ranks over ``inputs`` (numpy arrays and
    strings, dicts and lists stored as JSON) -> each rank's outputs (dicts
    of numpy arrays). Raises with a failed rank's output."""
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "inputs.npz"), **{
            k: (np.array(json.dumps(v)) if isinstance(v, (dict, list)) else v)
            for k, v in inputs.items()})
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, d, str(r), str(world),
             str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=rank_env(), cwd=d) for r in range(world)]
        results = wait_all(procs, timeout)
        for r, (rc, out) in enumerate(results):
            if rc != 0:
                raise AssertionError(f"rank {r} of {job} failed ({rc}):\n{out[-6000:]}")
        if len(results) < world:
            raise AssertionError(f"{job}: a rank did not finish")
        outs = []
        for r in range(world):
            with np.load(os.path.join(d, f"out{r}.npz")) as z:
                outs.append({k: z[k] for k in z.files})
        return outs


def pack_model(name: str, config: dict, params) -> dict:
    """A port model's config and weights as inputs: the tree flattened
    (``modeling_flamingo.flatten_tree``), bf16 leaves as their int16 bits
    under a ``@bf16`` key."""
    import torch
    from flamingo_mini_tpu_torch.modeling_flamingo import flatten_tree
    from flamingo_mini_tpu_torch.utils.params import tree_map
    bits = tree_map(lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                    params)
    kinds = dict(flatten_tree(tree_map(lambda t: np.array(t.dtype == torch.bfloat16),
                                       params)))
    out = {name + ".config": config}
    for key, val in flatten_tree(bits).items():
        out[f"{name}.params.{key}" + ("@bf16" if kinds[key] else "")] = val
    return out


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _model(inp, name, **config):
    """The port's model ``name`` from the inputs (``pack_model``)."""
    import torch
    import flamingo_mini_tpu_torch as port
    from flamingo_mini_tpu_torch.modeling_flamingo import unflatten_tree
    cfg = port.FlamingoConfig(**{**json.loads(str(inp[name + ".config"])), **config})
    prefix = name + ".params."
    flat, bf16 = {}, set()
    for k in inp:
        if k.startswith(prefix):
            key = k[len(prefix):]
            if key.endswith("@bf16"):
                key = key[:-5]
                bf16.add(key)
            flat[key] = inp[k]
    params = unflatten_tree(flat)

    def restore(path, tree):
        if isinstance(tree, dict):
            return {k: restore(f"{path}{k}.", v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [restore(f"{path}#{i}.", v) for i, v in enumerate(tree)]
        return tree.view(torch.bfloat16) if path[:-1] in bf16 else tree
    return port.FlamingoModel(cfg, params=restore("", params), device="cpu")


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def job_serving(inp, rank, world):
    """DP greedy (per layer with the fused head, the megakernel), DP
    sampling and the refusals on a (4, 1) mesh; TP greedy, beams, int8 and
    use_pallas on a (2, 2) mesh; ``shard_``'s bytes."""
    import torch
    from flamingo_mini_tpu_torch.parallel import create_mesh
    dp, tp = create_mesh((world, 1)), create_mesh((2, world // 2))
    out = {}
    t = lambda x: torch.as_tensor(x)
    m = _model(inp, "small")
    ids, media, mask, px = (t(inp["small." + k]) for k in ("ids", "media", "mask", "px"))
    kw = dict(media_locations=media, attention_mask=mask, pixel_values=px,
              **json.loads(str(inp["small.kw"])))
    out["dp_layer"] = m.generate(ids, mesh=dp, **kw)
    out["dp_mega"] = m.generate(ids, mesh=dp, megakernel=True, **kw)
    out["dp_sample"] = m.generate(ids, mesh=dp, do_sample=True, top_k=20,
                                  generator=torch.Generator().manual_seed(7), **kw)
    out["refuse_batch"] = _refusal(lambda: m.generate(
        ids[:6], mesh=dp, media_locations=media[:6], attention_mask=mask[:6],
        pixel_values=px[:6], max_length=12))
    out["refuse_tp"] = _refusal(lambda: m.generate(ids, mesh=dp, tensor_parallel=True, **kw))
    for name in ("opt", "opt_int8", "gpt2", "gpt2_int8", "gpt2_pallas"):
        m = _model(inp, name)
        ids, media, mask, px = (t(inp[name + "." + k]) for k in ("ids", "media", "mask", "px"))
        kw = dict(media_locations=media, attention_mask=mask, pixel_values=px,
                  **json.loads(str(inp[name + ".kw"])))
        out[name + ".tp_greedy"] = m.generate(ids, mesh=tp, tensor_parallel=True, **kw)
        if name in ("opt", "gpt2"):
            out[name + ".tp_beams"] = m.generate(ids, mesh=tp, tensor_parallel=True,
                                                 num_beams=3, **kw)
        if name == "opt":   # the first TP call kept only the rank's slice
            out["opt.tp_shard"] = np.array(m.tp_shard)
    # a model holding only its slice: the same tokens
    m = _model(inp, "opt").shard_(tp)
    out["opt.shard_bytes"] = np.array(sum(
        x.numel() * x.element_size() for _, x in _leaves(m.params["lm"])))
    ids, media, mask, px = (t(inp["opt." + k]) for k in ("ids", "media", "mask", "px"))
    out["opt.sharded_greedy"] = m.generate(
        ids, mesh=tp, tensor_parallel=True, media_locations=media, attention_mask=mask,
        pixel_values=px, **json.loads(str(inp["opt.kw"])))
    out["refuse_sharded"] = _refusal(lambda: m.generate(ids, max_length=12))
    return out


def _leaves(tree):
    from flamingo_mini_tpu_torch.utils.params import leaves_with_path
    return leaves_with_path(tree)


def _trainer(model, out_dir, cls=None, **kw):
    from flamingo_mini_tpu_torch.train import FlamingoTrainer, TrainingArguments
    args = dict(output_dir=out_dir, eval_every_steps=None, save_every_steps=None,
                report_to="none")
    return (cls or FlamingoTrainer)(model, TrainingArguments(**{**args, **kw}))


def _weighted_trainer(model, out_dir, **kw):
    """A trainer whose loss counts only the tokens of ``loss_weights``
    (``cross_entropy_loss``'s ``weights``): the ranks hold different numbers
    of them."""
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.train import FlamingoTrainer

    class Weighted(FlamingoTrainer):
        def loss(self, batch, step, reduction="mean"):
            logits = F.forward(self.model.params, self.config, batch["input_ids"],
                               policy=self.policy,
                               media_locations=batch["media_locations"],
                               attention_mask=batch["attention_mask"],
                               pixel_values=batch["pixel_values"]).logits
            tokens = F.cross_entropy_loss(logits, batch["labels"], "none").reshape(
                batch["labels"].shape[0], -1)
            w = batch["loss_weights"][:, 1:].to(tokens.dtype)
            return (tokens * w).sum() if reduction == "sum" else \
                (tokens * w).sum() / w.sum()

        def token_count(self, batch):
            return float(batch["loss_weights"][:, 1:].sum())

    return _trainer(model, out_dir, cls=Weighted, **kw)


def job_training(inp, rank, world):
    """The DP step on a (4, 1) mesh (also with dropout, and with weighted
    tokens), the TP step on (2, 2), a TP checkpoint read back by DP ranks."""
    import torch
    from flamingo_mini_tpu_torch.parallel import comm
    batch = {k[6:]: torch.as_tensor(inp[k]) for k in inp if k.startswith("batch.")}
    hp = json.loads(str(inp["hp"]))
    steps = hp.pop("steps")
    out_dir = str(inp["out_dir"])
    out = {}
    for label, shape, tp, extra in (("dp", (world, 1), False, {}),
                                    ("tp", (2, world // 2), True, {}),
                                    ("dp_dropout", (world, 1), False,
                                     dict(enable_dropout=True)),
                                    ("tp_dropout", (2, world // 2), True,
                                     dict(enable_dropout=True))):
        trainer = _trainer(_model(inp, "tiny"), os.path.join(out_dir, label),
                           mesh_shape=shape, tensor_parallel=tp, **hp, **extra)
        if label == "tp":
            loss, grads = trainer.gradients(batch)
            out["tp.grad_norm"] = _norm_of(trainer, grads)
        out[label + ".losses"] = np.array([trainer.train_step_on(batch)
                                           for _ in range(steps)])
        whole = trainer.whole_params()
        for path, leaf in _leaves(whole):
            out[f"{label}.params{path}"] = leaf.detach()
        if label == "tp":
            ckpt = trainer.save_checkpoint()
            comm.all_reduce(torch.zeros(1))        # the file is written
            reader = _trainer(_model(inp, "tiny"), os.path.join(out_dir, "read"),
                              mesh_shape=(world, 1), **hp)
            reader.load_checkpoint(ckpt)
            out["tp.read_back"] = np.array(max(
                float((a.detach() - whole_leaf).abs().max()) for (_, a), whole_leaf in zip(
                    _leaves(reader.model.params), (l for _, l in _leaves(whole)))))
            out["tp.ckpt"] = np.array(ckpt)
            out.update(_evaluations(trainer, json.loads(str(inp["words"]))))
    wbatch = dict(batch, loss_weights=torch.as_tensor(inp["loss_weights"]))
    trainer = _weighted_trainer(_model(inp, "tiny"), os.path.join(out_dir, "w"),
                                mesh_shape=(world, 1), **hp)
    loss, grads = trainer.gradients(wbatch)
    out["weighted.loss"] = loss
    for name, g in zip(trainer.trainable_names, grads):
        out["weighted.grad" + name] = g
    return out


def _evaluations(trainer, words):
    """``evaluate_image_captioning`` as a TP trainer's ``evaluate()`` runs it
    (every rank captions every image over its model axis alone), and of the
    whole trained weights in one process, over two synthetic images (24
    tokens: the tiny trunk has 64 positions)."""
    import flamingo_mini_tpu_torch as port
    from flamingo_mini_tpu_torch.tokenizer import build_toy_tokenizer
    from flamingo_mini_tpu_torch.train.data import (SyntheticCaptionDataset,
                                                    SyntheticEvalDataset)
    from flamingo_mini_tpu_torch.train.eval import evaluate_image_captioning
    proc = port.FlamingoProcessor(trainer.config, tokenizer=build_toy_tokenizer(words),
                                  device="cpu")
    data = SyntheticEvalDataset(SyntheticCaptionDataset(size=2, image_hw=32, seed=7))
    kw = dict(prefix=trainer.args.eval_coco_captioning_prefix, max_length=24)
    tp = evaluate_image_captioning(data, trainer.model, proc, mesh=trainer.mesh["model"],
                                   tensor_parallel=True, **kw)
    one = evaluate_image_captioning(
        data, port.FlamingoModel(trainer.config, params=trainer.whole_params(), device="cpu"),
        proc, **kw)
    return {"tp.eval." + k: np.array(v) for k, v in tp.items()} | {
        "tp.eval_one." + k: np.array(v) for k, v in one.items()}


def _norm_of(trainer, grads):
    """The TP rank's clipping norm (``sharded_global_norm``)."""
    from flamingo_mini_tpu_torch.train.trainer import sharded_global_norm
    return sharded_global_norm(
        grads, [bool(trainer.splits[trainer.trainable_paths[n]][0])
                for n in trainer.trainable_names], trainer.model_group)


def job_ring(inp, rank, world):
    """Ring attention's chunk outputs and dq/dk/dv (the loss over the rows
    every key of which is not padding), and both trunks through
    ``forward(context_mesh=...)``."""
    import torch
    from flamingo_mini_tpu_torch.parallel import create_mesh
    from flamingo_mini_tpu_torch.parallel.ring_attention import ring_attention
    out = {}
    q, k, v = (torch.as_tensor(inp[n]) for n in "qkv")
    n = q.shape[2]
    c = n // world
    chunk = slice(rank * c, (rank + 1) * c)
    for label, mask in (("plain", None), ("padded", torch.as_tensor(inp["pad_mask"]))):
        ql, kl, vl = (x[:, :, chunk].clone().requires_grad_() for x in (q, k, v))
        o = ring_attention(ql, kl, vl, attention_mask=None if mask is None else mask[:, chunk])
        rows = torch.as_tensor(inp["rows_" + label])[:, chunk]
        (o.square() * rows[:, None, :, None]).sum().backward()
        out[label + ".out"], out[label + ".dq"] = o.detach(), ql.grad
        out[label + ".dk"], out[label + ".dv"] = kl.grad, vl.grad
    mesh = create_mesh((world, 1))
    for name in ("gpt2", "opt"):
        m = _model(inp, name)
        ids = torch.as_tensor(inp[name + ".ids"])
        kw = {key: torch.as_tensor(inp[f"{name}.{key}"])
              for key in ("media_locations", "pixel_values") if f"{name}.{key}" in inp}
        got = m.forward(ids, labels=ids, context_mesh=mesh, **kw)
        out[name + ".logits"], out[name + ".loss"] = got.logits, got.loss
        got = m.forward(ids, attention_mask=torch.as_tensor(inp[name + ".pad"]),
                        context_mesh=mesh, **kw)
        out[name + ".padded_logits"] = got.logits
    out["refuse_length"] = _refusal(lambda: m.forward(ids[:, :-1], context_mesh=mesh))
    return out


JOBS = {"serving": job_serving, "training": job_training, "ring": job_ring}


def main(argv):
    job, d, rank, world, port = argv[1], argv[2], int(argv[3]), int(argv[4]), int(argv[5])
    import torch
    torch.set_num_threads(1)
    from flamingo_mini_tpu_torch.parallel import distributed_init
    distributed_init(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout=120)
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inp = {k: z[k] for k in z.files}
    out = JOBS[job](inp, rank, world)
    np.savez(os.path.join(d, f"out{rank}.npz"), **{
        k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in out.items()})
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules and not any(
        m.startswith("flamingo_mini_tpu.") or m == "flamingo_mini_tpu" for m in sys.modules)


if __name__ == "__main__":
    main(sys.argv)
