"""The port's trainer against the JAX package's ``FlamingoTrainer``.

A tiny model (GPT-2 of 2 layers, D=32, xattn before each; a 1-layer ViT on
32-px images; a 1-layer resampler of 4 latents), the JAX package's weights
carried over by ``from_jax_numpy``, the xattn gates opened to 0.5 (at init
``tanh(0) = 0`` zeroes every gradient through the media attention), and one
batch of 8 collated by the JAX package's ``DataCollator`` fed to both
trainers. JAX's trainer runs at ``mesh_shape=(1, 1)`` on the first of the
conftest's 8 virtual CPU devices.

Tolerances: float32 (PARITY) per-step losses 1e-5 relative, the trainable
parameters and the Adam moments 1e-5 normwise over all trainable leaves
(summation order and the optimizer's rounding differ, nothing else); bf16
with the attention kernels (their plain versions here, JAX's Pallas
kernels in interpret mode with their ``custom_vjp`` there) loss 2e-3
relative and gradients 2e-2 normwise over all trainable leaves, as bf16
rounds at points the two frameworks choose differently (measured 2e-5 and
4.8e-3). Frozen leaves, remat, dropout resumes and
checkpoint resumes are held bit for bit.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import FlamingoModel as JaxModel
from flamingo_mini_tpu import FlamingoProcessor as JaxProcessor
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.parallel import create_mesh
from flamingo_mini_tpu.tokenizer import build_toy_tokenizer
from flamingo_mini_tpu.train.data import DataCollator as JaxCollator
from flamingo_mini_tpu.train.data import SyntheticCaptionDataset as JaxDataset
from flamingo_mini_tpu.train import trainer as jax_trainer
from flamingo_mini_tpu.train.trainer import FlamingoTrainer as JaxTrainer
from flamingo_mini_tpu.train.trainer import TrainingArguments as JaxArgs
from flamingo_mini_tpu.utils import params as jparams

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.models import gpt2 as pgpt2
from flamingo_mini_tpu_torch.models import opt as popt
from flamingo_mini_tpu_torch.ops.layers import const, dropout
from flamingo_mini_tpu_torch.train import FlamingoTrainer, TrainingArguments
from flamingo_mini_tpu_torch.utils.params import leaves_with_path
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

TINY = dict(
    lm="gpt2", dim=32, dim_visual=32, xattn_every=1, xattn_dim_head=8,
    xattn_heads=4, resampler_depth=1, resampler_dim_head=8,
    resampler_heads=4, resampler_num_latents=4,
    lm_arch_overrides=dict(vocab_size=512, n_positions=64, n_embd=32, n_layer=2,
                           n_head=4),
    vision_arch_overrides=dict(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=8))
WORDS = ["image", "a", "cat", "dog", "picture", "of", "red", "blue", "small", "big",
         "bird", "<", ">"]
STEPS, LR, WARMUP, DECAY, CLIP = 4, 1e-2, 2, 0.01, 0.5


def _jax_model(compute_dtype="float32", use_pallas=False):
    jc = JaxConfig(compute_dtype=compute_dtype, use_pallas=use_pallas, **TINY)
    model = JaxModel(jc, rng=jax.random.PRNGKey(0))
    for blk in model.params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    return model


def _port_model(jmodel):
    pc = port.FlamingoConfig(compute_dtype=jmodel.config.compute_dtype,
                             use_pallas=jmodel.config.use_pallas, **TINY)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params)
    return port.FlamingoModel(pc, params=from_jax_numpy(tree, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def batch():
    jc = JaxConfig(**TINY)
    proc = JaxProcessor(jc, tokenizer=build_toy_tokenizer(WORDS))
    ds = JaxDataset(size=8, image_hw=32)
    return JaxCollator(proc, length=16)([ds[i] for i in range(8)])


def _args(cls, out, **kw):
    base = dict(output_dir=str(out), learning_rate=LR, warmup_steps=WARMUP,
                weight_decay=DECAY, grad_clip_norm=CLIP, eval_every_steps=None,
                save_every_steps=None, report_to="none")
    return cls(**{**base, **kw})


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in leaves])


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _adam_state(opt_state):
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
                if is_adam(s))


def _snapshot(model):
    return {path: leaf.detach().clone() for path, leaf in leaves_with_path(model.params)}


@pytest.fixture(scope="module")
def float32_runs(batch, tmp_path_factory):
    """Both trainers, 4 float32 steps on the batch: (jax trainer, jax
    losses, port trainer, port losses, port params before, after step 0)."""
    jmodel = _jax_model()
    pmodel = _port_model(jmodel)
    before = _snapshot(pmodel)
    # the conftest's 8 virtual CPU devices: JAX's mesh of (1, 1) takes the first
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "create_mesh",
                   lambda shape: create_mesh(shape, devices=jax.devices()[:1]))
        jt = JaxTrainer(jmodel, _args(JaxArgs, tmp_path_factory.mktemp("jax"),
                                      mesh_shape=(1, 1)))
    pt = FlamingoTrainer(pmodel, _args(TrainingArguments, tmp_path_factory.mktemp("port")))
    _, grads = pt.gradients(batch)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    assert norm > CLIP, norm            # clipping engages
    j_losses = [jt.train_step_on(batch) for _ in range(STEPS)]
    p_losses = [pt.train_step_on(batch)]
    after0 = _snapshot(pmodel)
    p_losses += [pt.train_step_on(batch) for _ in range(STEPS - 1)]
    return jt, j_losses, pt, p_losses, before, after0


def test_float32_losses_parameters_and_adam_state_match_jax(float32_runs):
    jt, j_losses, pt, p_losses, _, _ = float32_runs
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5, atol=0)
    assert p_losses[-1] < p_losses[0]
    # the same leaves in the same (pytree) order
    j_paths = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(jt.trainable)[0]]
    assert pt.trainable_names == j_paths
    assert _rel(_flat(l.detach() for l in pt.trainable_leaves),
                _flat(jax.tree_util.tree_leaves(jt.trainable))) <= 1e-5
    adam = _adam_state(jt.opt_state)
    assert int(adam.count) == pt.optimizer.count == STEPS
    for ours, theirs in ((pt.optimizer.mu, adam.mu), (pt.optimizer.nu, adam.nu)):
        assert _rel(_flat(ours), _flat(jax.tree_util.tree_leaves(theirs))) <= 1e-5


def test_float32_step_zero_frozen_leaves_and_embedding(float32_runs):
    """Step 0 runs at lr 0 and leaves every parameter as it was; after the
    steps the frozen leaves are bit for bit as they were and ``wte`` (the
    trainable embedding) has moved."""
    _, _, pt, _, before, after0 = float32_runs
    for path, leaf in after0.items():
        assert torch.equal(leaf, before[path]), path
    mask = dict(leaves_with_path(pt.mask))
    now = _snapshot(pt.model)
    for path, leaf in now.items():
        if not mask[path]:
            assert torch.equal(leaf, before[path]), path
    assert all(leaf.requires_grad == mask[path]
               for path, leaf in leaves_with_path(pt.model.params))
    key = "['lm']['wte']"
    assert mask[key] and not torch.equal(now[key], before[key])


def test_bf16_pallas_loss_and_gradients_match_jax(batch, tmp_path):
    """bf16 compute over float32 parameters, the attention kernels on (the
    port's plain versions; JAX's interpret-mode kernels and custom_vjp)."""
    jmodel = _jax_model("bfloat16", use_pallas=True)
    pmodel = _port_model(jmodel)
    pt = FlamingoTrainer(pmodel, _args(TrainingArguments, tmp_path))
    loss, grads = pt.gradients(batch)

    mask = jmodel.trainable_mask()
    trainable, frozen = jparams.partition_params(jmodel.params, mask)
    policy = jmodel.policy
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        out = jflam.forward(jparams.merge_params(trainable, frozen), jmodel.config,
                            jb["input_ids"], policy=policy,
                            media_locations=jb["media_locations"],
                            attention_mask=jb["attention_mask"],
                            pixel_values=policy.cast(jb["pixel_values"]),
                            labels=jb["labels"])
        return out.loss

    j_loss, j_grads = jax.value_and_grad(loss_fn)(trainable)
    assert abs(float(loss) - float(j_loss)) <= 2e-3 * abs(float(j_loss))
    err = _rel(_flat(grads), _flat(jax.tree_util.tree_leaves(j_grads)))
    assert err <= 2e-2, err
    # the gates open: the media attention's projections get gradients
    g = dict(zip(pt.trainable_names, grads))
    assert float(g["['xattn']['0']['attn']['to_kv']['w']"].norm()) > 0


def test_vision_tower_takes_no_gradient(batch):
    """Every vision leaf made to require grad: the port's gradient for each
    is None (the tower runs under no_grad), JAX's is zero (stop_gradient),
    and the resampler's gradients agree with JAX's."""
    jmodel = _jax_model()
    pmodel = _port_model(jmodel)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        return jflam.forward(params, jmodel.config, jb["input_ids"], policy=jmodel.policy,
                             media_locations=jb["media_locations"],
                             attention_mask=jb["attention_mask"],
                             pixel_values=jb["pixel_values"], labels=jb["labels"]).loss

    j_grads = jax.grad(jloss)(jmodel.params)
    for leaf in jax.tree_util.tree_leaves(j_grads["vision"]):
        assert not np.asarray(leaf).any()

    vision = [leaf.requires_grad_() for _, leaf in leaves_with_path(pmodel.params["vision"])]
    resampler = [leaf.requires_grad_() for _, leaf in
                 leaves_with_path(pmodel.params["resampler"])]
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    loss = pflam.forward(pmodel.params, pmodel.config, tb["input_ids"].long(),
                         policy=pmodel.policy, media_locations=tb["media_locations"],
                         attention_mask=tb["attention_mask"],
                         pixel_values=tb["pixel_values"], labels=tb["labels"].long()).loss
    grads = torch.autograd.grad(loss, vision + resampler, allow_unused=True)
    for g in grads[:len(vision)]:
        assert g is None or not bool(g.any())
    err = _rel(_flat(grads[len(vision):]),
               _flat(jax.tree_util.tree_leaves(j_grads["resampler"])))
    assert err <= 1e-5, err


def test_remat_gives_the_same_loss_and_gradients(batch, tmp_path):
    """torch.utils.checkpoint of the loss: the same loss and gradients bit
    for bit, with and without dropout (the generator is re-seeded inside
    the checkpointed function, so the recompute draws the same masks)."""
    jmodel = _jax_model("bfloat16", use_pallas=True)
    for drop in (False, True):
        out = {}
        for remat in (False, True):
            pt = FlamingoTrainer(_port_model(jmodel), _args(
                TrainingArguments, tmp_path, remat=remat, enable_dropout=drop))
            out[remat] = pt.gradients(batch)
        assert torch.equal(out[False][0], out[True][0])
        for a, b in zip(out[False][1], out[True][1]):
            assert torch.equal(a, b)


def test_dropout_primitive():
    """Identity without a generator or at rate 0; with one, reproducible,
    the kept share within 5 sigma of 1 - rate, kept values x / keep (keep
    rounded to x's dtype), the rest 0."""
    x = torch.randn(200_000).to(torch.bfloat16)
    assert dropout(x, 0.1, None) is x
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.1, torch.Generator().manual_seed(4)))
    kept = a != 0
    n, share = x.numel(), float(kept.float().mean())
    assert abs(share - 0.9) <= 5 * (0.9 * 0.1 / n) ** 0.5, share
    assert torch.equal(a[kept], (x[kept] / const(0.9, torch.bfloat16)).to(torch.bfloat16))


def test_dropout_resume_draws_the_same_masks(batch, tmp_path):
    """With dropout, 4 uninterrupted steps equal 2 steps, a checkpoint, a
    fresh trainer that loads it and 2 more steps, bit for bit; two runs of
    one seed are equal and a step's loss differs from the dropout-free one.
    The checkpoint directories are pruned to ``save_total_limit``."""
    jmodel = _jax_model("bfloat16", use_pallas=True)

    def trainer(out, **kw):
        return FlamingoTrainer(_port_model(jmodel), _args(
            TrainingArguments, out, enable_dropout=True, save_total_limit=2, **kw))

    full = trainer(tmp_path / "full")
    full_losses = [full.train_step_on(batch) for _ in range(4)]
    again = trainer(tmp_path / "again")
    assert [again.train_step_on(batch) for _ in range(4)] == full_losses
    off = FlamingoTrainer(_port_model(jmodel), _args(TrainingArguments, tmp_path / "off"))
    assert off.train_step_on(batch) != full_losses[0]

    first = trainer(tmp_path / "resume")
    losses = []
    for _ in range(2):
        losses.append(first.train_step_on(batch))
        first.save_checkpoint()
    first.train_step_on(batch)
    first.save_checkpoint()
    assert sorted(os.listdir(tmp_path / "resume")) == ["checkpoint-2", "checkpoint-3"]
    second = trainer(tmp_path / "resume")
    second.load_checkpoint(str(tmp_path / "resume" / "checkpoint-2"))
    assert second.step == 2 and second.optimizer.count == 2
    losses += [second.train_step_on(batch) for _ in range(2)]
    assert losses == full_losses
    for a, b in zip(second.trainable_leaves, full.trainable_leaves):
        assert torch.equal(a, b)
    for a, b in zip(second.optimizer.mu + second.optimizer.nu,
                    full.optimizer.mu + full.optimizer.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lm", ["gpt2", "opt"])
def test_dropout_forces_the_plain_trunk_attention(lm, monkeypatch):
    """Under the pallas policy the trunk's uncached attention calls
    fused_attention once a layer; with a dropout generator it calls it
    never (JAX's rule, gpt2.py:225 and opt.py:273)."""
    module = pgpt2 if lm == "gpt2" else popt
    calls = []
    real = module.fused_attention
    monkeypatch.setattr(module, "fused_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dict(TINY, use_pallas=True, compute_dtype="bfloat16")
    if lm == "opt":
        cfg.update(lm="facebook/opt-125m", lm_arch_overrides=dict(
            vocab_size=512, max_position_embeddings=64, hidden_size=32, ffn_dim=64,
            num_hidden_layers=2, num_attention_heads=4, word_embed_proj_dim=32))
    model = port.FlamingoModel(port.FlamingoConfig(**cfg), device="cpu")
    ids = torch.randint(0, 500, (2, 10))
    mask = torch.ones((2, 10), dtype=torch.int32)
    mask[1, :3] = 0
    kw = dict(policy=model.policy, attention_mask=mask, labels=ids)
    pflam.forward(model.params, model.config, ids, **kw)
    assert len(calls) == 2
    pflam.forward(model.params, model.config, ids, **kw,
                  dropout_generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2


@pytest.mark.parametrize("kw", [dict(mesh_shape=(2, 1)), dict(mesh_shape=(4, 2)),
                                dict(tensor_parallel=True)])
def test_parallel_options_are_refused(kw, tmp_path):
    """In one process: a mesh the ranks do not cover, and TP without a model
    axis (tests/test_torch_parallel_training.py runs the meshes on ranks)."""
    jmodel = _jax_model()
    with pytest.raises(ValueError, match="does not cover 1 ranks|'model' axis"):
        FlamingoTrainer(_port_model(jmodel), _args(TrainingArguments, tmp_path, **kw))
    FlamingoTrainer(_port_model(jmodel), _args(TrainingArguments, tmp_path,
                                               mesh_shape=(1, 1)))
