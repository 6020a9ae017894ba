"""The port's examples (``flamingo_mini_tpu_torch/examples/``) and its
training launcher (``flamingo_mini_tpu_torch/train/train.sh``).

* ``export_to_torch`` and ``model_stats`` run on the CPU (``--device
  cpu``): the export reloads with identical greedy tokens and stages
  ``push_to_hub`` with the environment restored after it; ``model_stats``'
  total and trainable counts equal the JAX model's for its config (shapes
  from ``jax.eval_shape``, the mask from the JAX package's rule);
* the other four import and parse their arguments, and every example runs
  on the card by default: with none present it raises;
* ``train.sh``'s arguments, as it passes them, are accepted by the port's
  CLI parser, in the synthetic and the multi-process case;
* the per-layer decode calls the decode attention kernels' wrappers at
  every head width, and off the CPU they refuse a width their kernels do
  not take (opt-2.7b's 80) rather than run their plain versions.
"""
import importlib
import json
import os
import stat
import subprocess
import sys

import jax
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.utils import params as jparams

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.examples import export_to_torch, model_stats
from flamingo_mini_tpu_torch.models import gpt2
from flamingo_mini_tpu_torch.train.__main__ import parse_args as train_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("image_captioning", "batch_serving", "few_shot_prompt",
            "video_captioning", "model_stats", "export_to_torch")


def test_export_to_torch_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("HF_HOME", "/nonexistent/hf_home")
    hub = sys.modules.get("huggingface_hub")
    tokens = export_to_torch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "exported: ['config.json', 'flamingo_tpu.npz', 'model.safetensors']" in out
    assert f"self round-trip OK; greedy tokens identical: {tokens}" in out
    assert "from_pretrained('demo/flamingo-tpu-export') OK: FlamingoModel" in out
    assert len(tokens) == 8
    assert os.environ["HF_HOME"] == "/nonexistent/hf_home"
    assert sys.modules.get("huggingface_hub") is hub


def test_model_stats_counts_match_jax(capsys):
    total, trainable = model_stats.main(["--device", "cpu"])
    jc = JaxConfig(lm="gpt2", clip_model_type="openai/clip-vit-base-patch32",
                   dim=768, dim_visual=768)
    shapes = jax.eval_shape(lambda key: jflam.init_flamingo(key, jc), jax.random.PRNGKey(0))
    mask = jparams.trainable_mask(shapes, freeze_lm=jc.freeze_language_model,
                                  lm_embed_key="wte")
    want_trainable = sum(int(x.size) for x, m in zip(jax.tree_util.tree_leaves(shapes),
                                                     jax.tree_util.tree_leaves(mask)) if m)
    assert total == jparams.tree_size(shapes)
    assert trainable == want_trainable
    out = capsys.readouterr().out
    assert f"total params:     {total:>12,}" in out
    assert "per subsystem:" in out and "trainable leaves:" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_parse_and_default_to_the_card(name, monkeypatch):
    module = importlib.import_module(f"flamingo_mini_tpu_torch.examples.{name}")
    assert callable(module.main) and "python -m flamingo_mini_tpu_torch.examples." \
        f"{name}" in module.__doc__
    from flamingo_mini_tpu_torch.examples import parse_args
    assert parse_args(module.__doc__, []).device == "cuda"
    assert parse_args(module.__doc__, ["--device", "cpu"]).device == "cpu"
    monkeypatch.delenv("FLAMINGO_CKPT", raising=False)
    monkeypatch.delenv("FLAMINGO_IMAGE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    with pytest.raises(RuntimeError):
        module.main([])


@pytest.mark.parametrize("coordinator", [None, "10.0.0.1:1234"])
def test_train_sh_arguments_parse(tmp_path, coordinator):
    """Run train.sh with a stand-in ``python`` first on PATH that records
    its arguments, then parse them as the port's CLI does."""
    fake = tmp_path / "python"
    fake.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"json.dump(sys.argv[1:], open({str(tmp_path / 'argv.json')!r}, 'w'))\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env = {k: v for k, v in os.environ.items() if k not in ("COCO_ROOT", "COORDINATOR")}
    env["PATH"] = f"{tmp_path}{os.pathsep}{env['PATH']}"
    if coordinator:
        env["COORDINATOR"] = coordinator
    res = subprocess.run(["bash", os.path.join(REPO, "flamingo_mini_tpu_torch", "train",
                                               "train.sh"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "synthetic smoke run" in res.stdout
    argv = json.loads((tmp_path / "argv.json").read_text())
    assert argv[:2] == ["-m", "flamingo_mini_tpu_torch.train"]
    ns = train_args(argv[2:])
    assert (ns.learning_rate, ns.warmup_steps, ns.per_device_batch_size) == (1e-4, 5000, 8)
    assert (ns.eval_every_steps, ns.save_total_limit, ns.log_every_steps) == (1000, 2, 50)
    assert (ns.lm, ns.clip_model_type, ns.dim, ns.dim_visual) == (
        "facebook/opt-125m", "openai/clip-vit-large-patch14", 768, 1024)
    assert (ns.resampler_act, ns.xattn_act) == ("sqrelu", "sqrelu")
    assert (ns.synthetic_size, ns.max_steps, ns.device) == (512, 50, "cpu")
    assert ns.coordinator == coordinator


@pytest.mark.parametrize("head_dim", [16, 64, 80, 128, 96])
def test_every_head_width_takes_the_decode_attention_kernels(head_dim, monkeypatch):
    """The per-layer decode calls the kernel wrappers at every head width:
    on the CPU they run their plain versions; a tensor anywhere else goes
    to the kernel, which takes widths 16, 32, 64, 80 and 128 (the export
    example's and the fidelity tool's tiny models are 16 wide, opt-2.7b's
    80, opt-6.7b's 128) and refuses any other, such as 96, rather than
    running plain."""
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    calls = []
    for name in ("decode_attention", "decode_attention_beam"):
        kernel = getattr(gpt2, name)
        monkeypatch.setattr(gpt2, name, lambda *a, _k=kernel, **kw: calls.append(1) or _k(*a, **kw))
    dim = 2 * head_dim
    config = port.FlamingoConfig(
        lm="gpt2", dim=dim, dim_visual=32, xattn_every=2, xattn_dim_head=16, xattn_heads=2,
        resampler_depth=1, resampler_dim_head=16, resampler_heads=2, resampler_num_latents=4,
        lm_arch_overrides=dict(vocab_size=64, n_positions=32, n_embd=dim, n_layer=2, n_head=2),
        vision_arch_overrides=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=2, image_size=32, patch_size=16))
    model = port.FlamingoModel(config, device="cpu", seed=0)
    ids = [[1, 2, 3]]
    greedy = model.generate(ids, max_length=8, eos_token_id=999, pad_token_id=0)
    beams = model.generate(ids, max_length=8, eos_token_id=999, pad_token_id=0, num_beams=2)
    assert greedy.shape == beams.shape == (1, 8)
    assert len(calls) == 16, len(calls)       # 2 layers x 4 decode steps, greedy and beams

    def no_plain(*a, **kw):
        raise AssertionError("a tensor off the CPU ran the plain version")
    monkeypatch.setattr(da, "decode_attention_plain", no_plain)
    monkeypatch.setattr(da, "decode_attention_beam_plain", no_plain)
    n_head, D = 32, 32 * head_dim             # opt-2.7b: 32 heads of 80, opt-6.7b of 128
    q, k, v = (torch.empty((2, 1, D), device="meta") for _ in range(3))
    cache = {"kf": torch.empty((16, 2, D), device="meta"),
             "vf": torch.empty((16, 2, D), device="meta")}
    npad = torch.empty(2, dtype=torch.int32, device="meta")
    why = "unsupported device meta" if head_dim in da.HEAD_DIMS else "head dims"
    for anc in (None, torch.empty((1, 2, 16), dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match=why):
            gpt2.cached_attention(q, k, v, cache, 3, n_head=n_head, scale=0.125,
                                  kv_limit=None, npad=npad, beam_anc=anc)
