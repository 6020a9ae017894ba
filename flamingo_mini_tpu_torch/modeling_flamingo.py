"""FlamingoModel: the public entry point, port of
``flamingo_mini_tpu/modeling_flamingo.py::FlamingoModel``.

Construction from a ``FlamingoConfig`` (random weights from a seed) or a
checkpoint (``from_pretrained``: a local directory or a hub id from the
local HF cache, holding ``config.json`` and the port's and the JAX
package's ``flamingo_tpu.npz`` or a reference-layout ``model.safetensors``
/ ``pytorch_model.bin``, whose missing vision tower comes from
``vision_params``, ``clip_checkpoint`` or a seed); ``save_pretrained`` in
both layouts and ``push_to_hub``, which stages into the local cache;
greedy, sampled, beam and beam-sample decoding with HF's logits processors
over a GPT-2 or OPT trunk, per layer or through the whole-step megakernel
(weight-only or w8a8), constrained beams and contrastive search per layer;
``generate_captions`` (images and a prompt in, caption strings out, through
a ``FlamingoProcessor``); ``score_sequences``; the uncached forward with
its loss; and the freeze masks. Over a ``DeviceMesh`` of one process per
rank (``parallel.create_mesh``): data- and tensor-parallel ``generate``
(``mesh``, ``tensor_parallel``; ``shard_`` keeps only the rank's slice of
the weights) and the forward with the sequence split over the ranks
(``context_mesh``). The policy follows ``compute_dtype`` and
``use_pallas`` (bf16 with ``use_pallas``: the attention kernels). Holds
(config, params, policy, device); params are a nested dict of tensors in
the JAX package's layout. The model runs on the card unless the caller
asks for another device.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .configuration_flamingo import FlamingoConfig
from .flamingo_processor import FlamingoProcessor
from .generation import DecodeConfig, generate_impl, generate_on_mesh
from .models import flamingo as F
from .models.clip_vit import init_clip_vit
from .ops.layers import Policy, policy_for
from .parallel import comm
from .parallel.mesh import axis_size
from .parallel.sharding import (check_tensor_parallel, leaf_splits,
                                pad_vocab_params, shard_params)
from .ops.quant import (cast_params_bf16, quantize_gpt2_lm, quantize_opt_lm,
                        quantize_xattn_blocks)
from .scoring import score_sequences as _score_sequences
from .utils import params as param_utils
from .utils.hf_weights import convert_clip_vit, convert_flamingo, state_dict_to_numpy

logger = logging.getLogger(__name__)
Params = Dict[str, Any]
NPZ_NAME = "flamingo_tpu.npz"


# ---------------------------------------------------------------------------
# parameter tree <-> flat dict (npz persistence)
# ---------------------------------------------------------------------------


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """Flatten to {dotted.path: numpy array}. List indices are marked ``#i``
    so digit-keyed dicts (the xattn layer map) survive the round trip; the
    JAX package's npz keys."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}#{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """The inverse of ``flatten_tree``: nested dicts and lists of CPU
    tensors."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        val = np.asarray(val)
        if val.dtype.kind == "V":
            raise ValueError(
                f"{key} holds raw {val.dtype.itemsize}-byte values (a bf16 "
                "leaf numpy could not type): re-save the checkpoint before "
                "its bf16 cast")
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(val, order="C"))

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            return [listify(node[f"#{i}"]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _load_torch_state_dict(path: str) -> Optional[Dict[str, np.ndarray]]:
    """An HF checkpoint's flat state dict as numpy (``model.safetensors``
    preferred, read by ``utils.safetensors_io``; ``pytorch_model.bin`` by
    ``torch.load(weights_only=True)``), or None where the directory holds
    neither."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            f = os.path.join(path, name)
            if os.path.isfile(f):
                path = f
                break
        else:
            return None
    if path.endswith(".safetensors"):
        from .utils.safetensors_io import load_file
        return state_dict_to_numpy(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_to_numpy(sd)


class FlamingoModel:
    """Stateful wrapper over the functional core."""

    def __init__(self, config: FlamingoConfig, params: Optional[Params] = None,
                 *, device="cuda", seed: int = 0):
        """``params`` on another device are moved to ``device``."""
        if not self.is_lm_supported(config.lm):
            raise ValueError(f"unsupported language model {config.lm!r}")
        self.config = config
        self.device = torch.device(device)
        self.policy: Policy = policy_for(config.compute_dtype, config.use_pallas)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = F.init_flamingo(gen, config)
        self.params = param_utils.tree_map(lambda t: t.to(self.device), params)
        # (rank, size) on the model axis and the whole tree's splits, once
        # ``shard_`` sliced the weights
        self.tp_shard, self.tp_splits = None, None

    # -- registry --------------------------------------------------------
    _LANGUAGE_MODEL_PREFIXES = ("gpt2", "facebook/opt")

    @classmethod
    def is_lm_supported(cls, lm_id: str) -> bool:
        return any(lm_id.startswith(p) for p in cls._LANGUAGE_MODEL_PREFIXES)

    # -- persistence -----------------------------------------------------
    def save_pretrained(self, path: str, *, save_format: str = "npz") -> None:
        """Write ``config.json`` and the weights to the directory ``path``.

        ``save_format``: ``"npz"`` (``flamingo_tpu.npz``, the flat tree
        under the JAX package's keys), ``"hf"`` (``model.safetensors`` in
        the reference's ``flamingo.*`` layout, vision excluded; quantized
        params raise ``ValueError``) or ``"both"``. A tree with bf16 leaves
        raises ``ValueError``: numpy has no bf16, so save before
        ``to_bf16()``."""
        if save_format not in ("npz", "hf", "both"):
            raise ValueError(f"unknown save_format {save_format!r}")
        if any(t.dtype == torch.bfloat16
               for _, t in param_utils.leaves_with_path(self.params)):
            raise ValueError("the params are bf16, which numpy (and so the npz) "
                             "cannot hold: save before to_bf16()")
        # both layouts built before anything is written: a refusal leaves no
        # partial checkpoint
        flat = flatten_tree(self.params) if save_format != "hf" else None
        state = None
        if save_format != "npz":
            from .utils.hf_export import export_flamingo
            state = export_flamingo(self.params, self.config.xattn_every)
        os.makedirs(path, exist_ok=True)
        self.config.save_pretrained(path)
        if flat is not None:
            np.savez(os.path.join(path, NPZ_NAME), **flat)
        if state is not None:
            from .utils.hf_export import save_hf_checkpoint
            save_hf_checkpoint(state, path)

    def push_to_hub(self, repo_id: str, *, save_format: str = "both",
                    require_upload: bool = False) -> str:
        """Stage the checkpoint into the local HF cache layout
        (``$HF_HOME/hub/models--org--name/snapshots``), so
        ``from_pretrained(repo_id)`` resolves it; then, where
        ``huggingface_hub`` imports and the hub answers, create the repo and
        upload the snapshot. Returns the staged snapshot directory;
        ``last_push_uploaded`` says whether the upload happened. A failed
        upload is logged as a warning, or raised with ``require_upload``."""
        from .utils.hub import stage_into_cache
        snap = stage_into_cache(repo_id, save=lambda d: self.save_pretrained(
            d, save_format=save_format))
        self.last_push_uploaded = False
        try:
            from huggingface_hub import HfApi
            api = HfApi()
            api.create_repo(repo_id, repo_type="model", exist_ok=True)
            api.upload_folder(folder_path=snap, repo_id=repo_id, repo_type="model")
            self.last_push_uploaded = True
        except Exception as e:  # offline, no token, or no package
            if require_upload:
                raise
            logger.warning("hub upload failed (%s); checkpoint staged locally at "
                           "%s: pass require_upload=True to make this an error",
                           e, snap)
        return snap

    @classmethod
    def from_pretrained(cls, path: str, *, config: Optional[FlamingoConfig] = None,
                        vision_params: Optional[Params] = None,
                        clip_checkpoint: Optional[str] = None, seed: int = 0,
                        device="cuda") -> "FlamingoModel":
        """Load from a local directory holding ``config.json`` and weights
        (``flamingo_tpu.npz``, else ``model.safetensors`` /
        ``pytorch_model.bin`` in the reference's layout), or from a hub id
        resolved against the local HF cache (nothing is fetched). A
        checkpoint without the vision tower (the reference's convention)
        takes ``vision_params``, else the CLIP checkpoint
        ``clip_checkpoint``, else a tower initialised from ``seed``. The
        tensors land on ``device``."""
        from .utils.hub import resolve_checkpoint_dir
        path = resolve_checkpoint_dir(path)
        if config is None:
            config = FlamingoConfig.from_pretrained(path)

        npz = os.path.join(path, NPZ_NAME)
        params: Optional[Params] = None
        if os.path.isfile(npz):
            with np.load(npz) as data:
                params = unflatten_tree({k: data[k] for k in data.files})
        else:
            sd = _load_torch_state_dict(path)
            if sd is not None:
                params = convert_flamingo(sd, xattn_every=config.xattn_every,
                                          n_lm_layers=F.n_lm_layers(config))
        if params is None:
            raise FileNotFoundError(
                f"no weights found under {path!r} ({NPZ_NAME}, "
                "pytorch_model.bin or model.safetensors)")

        if "vision" not in params:
            if vision_params is not None:
                params["vision"] = vision_params
            elif clip_checkpoint is not None:
                csd = _load_torch_state_dict(resolve_checkpoint_dir(clip_checkpoint))
                if csd is None:
                    raise FileNotFoundError(
                        f"no CLIP weights under {clip_checkpoint!r}")
                params["vision"] = convert_clip_vit(csd)
            else:
                gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
                params["vision"] = init_clip_vit(gen, config.vision_arch)
        return cls(config, params, device=device)

    # -- freeze machinery ------------------------------------------------
    def trainable_mask(self) -> Params:
        lm_embed_key = "wte" if F.lm_family(self.config) == "gpt2" else "embed_tokens"
        return param_utils.trainable_mask(
            self.params, freeze_lm=self.config.freeze_language_model,
            lm_embed_key=lm_embed_key)

    def parameters_trainable(self):
        """The trainable subtree (None holes where frozen)."""
        trainable, _ = param_utils.partition_params(self.params, self.trainable_mask())
        return trainable

    def state_dict_trainable(self) -> Dict[str, torch.Tensor]:
        return param_utils.state_dict_trainable(self.params, self.trainable_mask())

    def num_parameters(self, only_trainable: bool = False) -> int:
        return param_utils.tree_size(self.parameters_trainable() if only_trainable
                                     else self.params)

    def to_bf16(self) -> "FlamingoModel":
        """Store float weights as bf16 (int8 scales stay float32). In place."""
        self.params = cast_params_bf16(self.params)
        return self

    def quantize_int8(self) -> "FlamingoModel":
        """Weight-only int8 trunk (GPT-2 or OPT) and xattn blocks. In place."""
        quantize = (quantize_gpt2_lm if F.lm_family(self.config) == "gpt2"
                    else quantize_opt_lm)
        self.params["lm"] = quantize(self.params["lm"])
        self.params["xattn"] = quantize_xattn_blocks(self.params["xattn"])
        return self

    def shard_(self, mesh) -> "FlamingoModel":
        """Keep only this rank's tensor-parallel slice of the weights on
        ``mesh``'s ``model`` axis (the vocab padded to it first), in place,
        so that the rank holds its share of the memory;
        ``generate(mesh=..., tensor_parallel=True)`` and a tensor-parallel
        trainer run on it (the first such call shards a whole model), and
        the other paths refuse it. ``tp_splits``: every leaf's (spec, packed
        projections) in the whole padded tree, for gathering it back. A
        ``model`` axis of one rank, or widths it does not divide
        (``check_tensor_parallel``), raise ``ValueError``; so does a model
        already sharded over another axis."""
        n = axis_size(mesh, "model")
        if n <= 1:
            sizes = {name: axis_size(mesh, name) for name in mesh.mesh_dim_names}
            raise ValueError("tensor_parallel=True needs a mesh with a 'model' "
                             f"axis of size > 1, got axes {sizes}")
        r = comm.rank(mesh.get_group("model"))
        if self.tp_shard is not None:
            if self.tp_shard != (r, n):
                raise ValueError(f"this model holds rank {self.tp_shard[0]} of "
                                 f"{self.tp_shard[1]}'s tensor-parallel slice, not "
                                 f"rank {r} of {n}'s")
            return self
        check_tensor_parallel(self.config, n)
        padded = pad_vocab_params(self.params, n)
        self.tp_splits = leaf_splits(padded, n)
        self.params = shard_params(padded, r, n)
        self.tp_shard = (r, n)
        return self

    def _whole(self, what: str) -> None:
        if self.tp_shard is not None:
            raise ValueError(f"{what} needs the whole weights: this model holds "
                             f"rank {self.tp_shard[0]} of {self.tp_shard[1]}'s "
                             "tensor-parallel slice")

    def __call__(self, input_ids, **kw) -> F.FlamingoOutput:
        return self.forward(input_ids, **kw)

    def forward(self, input_ids, *, media_locations=None, attention_mask=None,
                pixel_values=None, visual_features=None, labels=None,
                loss_reduction: str = "mean",
                context_mesh=None) -> F.FlamingoOutput:
        """The uncached forward -> ``FlamingoOutput(logits, loss, xattn_kv)``;
        ``loss`` is the shifted cross-entropy when ``labels`` are given.
        ``context_mesh``: context parallelism over the mesh's first (data)
        axis, every rank with the same inputs: the sequence split in chunks
        over its ranks, every LM self-attention through ring attention, and
        every rank gets the whole output back (``models.flamingo.forward``'s
        ``ring``). The sequence length must divide by the axis' size."""
        self._whole("forward")
        ring = None
        if context_mesh is not None and context_mesh.size() > 1:
            ring = context_mesh.get_group(context_mesh.mesh_dim_names[0])
        dev = self.device

        def put(x, dtype=None):
            return None if x is None else torch.as_tensor(x, device=dev, dtype=dtype)
        return F.forward(
            self.params, self.config, put(input_ids, torch.long),
            policy=self.policy, media_locations=put(media_locations, torch.int32),
            attention_mask=put(attention_mask, torch.int32),
            pixel_values=put(pixel_values), visual_features=put(visual_features),
            labels=put(labels, torch.long), loss_reduction=loss_reduction,
            ring=ring)

    def encode_resample_visuals(self, pixel_values) -> torch.Tensor:
        """Pixels -> resampled visual features (b, N, q, d_visual)."""
        return F.encode_resample_visuals(
            self.params, self.config, torch.as_tensor(pixel_values, device=self.device),
            policy=self.policy)

    @torch.inference_mode()
    def generate(self, input_ids, *, media_locations=None, attention_mask=None,
                 pixel_values=None, visual_features=None,
                 max_length: int = 150, max_new_tokens: Optional[int] = None,
                 num_beams: int = 1, do_sample: bool = False, top_k: int = 0,
                 top_p: float = 1.0, temperature: float = 1.0,
                 min_p: float = 0.0, typical_p: float = 1.0,
                 epsilon_cutoff: float = 0.0, eta_cutoff: float = 0.0,
                 penalty_alpha: float = 0.0, repetition_penalty: float = 1.0,
                 length_penalty: float = 1.0, early_stopping: bool = True,
                 min_length: int = 0, min_new_tokens: int = 0,
                 no_repeat_ngram_size: int = 0, bad_words_ids=None,
                 force_words_ids=None, num_return_sequences: int = 1,
                 num_beam_groups: int = 1, diversity_penalty: float = 0.0,
                 forced_bos_token_id: Optional[int] = None,
                 forced_eos_token_id: Optional[int] = None,
                 suppress_tokens=None, begin_suppress_tokens=None,
                 sequence_bias=None, exponential_decay_length_penalty=None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 int8_kv_cache: bool = False, prefix_block: int = 0,
                 beam_reorder: str = "lazy", flat_kv_cache: bool = True,
                 megakernel: bool = False, w8a8: bool = False,
                 fused_head: bool = True, return_scores: bool = False,
                 output_scores: bool = False, mesh=None,
                 tensor_parallel: bool = False, **unsupported):
        """Token ids (b, max_length): prompt, generated tokens, pads after
        EOS. Greedy; sampling with ``do_sample`` (HF's warpers: temperature,
        ``top_k``, ``top_p``, ``min_p``, ``typical_p``, ``epsilon_cutoff``,
        ``eta_cutoff``; the noise from ``generator``, a ``torch.Generator``
        on the model's device, seeded 0 when None, as JAX's ``rng``
        defaults to ``PRNGKey(0)``); or beam search with ``num_beams > 1``
        (HF semantics, ``beam_search.py``), diverse with ``num_beam_groups >
        1``, beam-sample with ``do_sample`` (the warpers after the chain,
        the candidates drawn without replacement, the noise from
        ``generator``, seeded 0 when None); constrained beams with
        ``force_words_ids`` (HF's nested lists: a list of ids is a phrase,
        a list of lists a disjunctive set; ``constrained_beam.py``); or
        contrastive search with ``penalty_alpha > 0`` over ``top_k > 1``
        candidates (``contrastive.py``; ``return_scores`` raises
        ``ValueError``). Every path runs HF's logits processors: ``sequence_bias``,
        ``repetition_penalty``, ``no_repeat_ngram_size``, ``bad_words_ids``
        (a lone-EOS word dropped), ``min_length``, ``min_new_tokens``,
        ``forced_bos_token_id``, ``forced_eos_token_id``,
        ``exponential_decay_length_penalty``, ``suppress_tokens``,
        ``begin_suppress_tokens``.

        ``num_return_sequences=n``: sampling returns n samples per prompt,
        beams the top n hypotheses, either as (b * n, max_length); greedy
        raises ``ValueError``. ``return_scores``: also the scores (b,)
        (greedy and sampling: the sum of the chosen tokens' log-probs under
        the processed, and when sampling warped, step distribution, post-EOS
        pads excluded; beams: HF's ``sequences_scores``). ``output_scores``
        (greedy and sampling): also those log-probs per step, (b,
        max_length) float32 at absolute positions, 0 at prompt slots and
        post-EOS pads; ``(tokens, scores, step_scores)`` with both.

        ``megakernel`` runs each decode step's trunk as one
        ``decode_step_megakernel`` launch (int8 weights, bf16 policy, GPT-2
        or pre-norm OPT trunk; opt-350m's post-norm trunk with its in/out
        projections raises ``ValueError``), any batch; ``w8a8`` (with
        ``megakernel`` only, else ``ValueError``) runs its w8a8 tier, every
        linear on int8 activations; diverse beams run per layer and refuse
        ``w8a8``. ``fused_head`` lets plain greedy (no processor, no scores)
        take ``lm_head_argmax`` (over the flat bf16 cache only, as in JAX).
        Before vision and prefill, a megakernel call the card cannot hold
        raises ``ValueError``. The KV-cache variants run per layer in plain
        torch, as JAX runs them in plain XLA: ``flat_kv_cache=False`` (the
        head-major cache), ``int8_kv_cache`` (the head-major cache in int8
        and the xattn K/V in int8; the megakernel refuses it with
        ``ValueError``) and ``beam_reorder="gather"`` (beams reorder the
        head-major cache's live prefix; with ``megakernel`` it raises
        ``ValueError``). ``pixel_values`` of one prompt may be 4-D, ``(N c
        h w)``. Constrained and contrastive search run per layer over the
        head-major cache, as in JAX: with ``megakernel`` they raise
        ``ValueError``.

        ``mesh`` (a ``DeviceMesh``, ``parallel.create_mesh``; one process per
        rank, each passing the whole batch and getting the whole result):
        data-parallel serving over its first axis, and with
        ``tensor_parallel`` the weights split over its ``model`` axis (the
        first such call keeps only the rank's slice, ``shard_``;
        ``generation.generate_on_mesh``, JAX's dispatch: greedy and sampling
        keep the megakernel and the fused head per data rank; beams,
        constrained and contrastive search and tensor parallelism run
        without them). Any other JAX option raises ``NotImplementedError``."""
        if unsupported:
            raise NotImplementedError(
                f"generate options not ported yet: {sorted(unsupported)}")
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        b, L = ids.shape
        mask = (torch.ones((b, L), dtype=torch.int32, device=dev)
                if attention_mask is None
                else torch.as_tensor(attention_mask, device=dev).to(torch.int32))
        media = (torch.zeros((b, L), dtype=torch.int32, device=dev)
                 if media_locations is None
                 else torch.as_tensor(media_locations, device=dev).to(torch.int32))
        if pixel_values is not None:
            pixel_values = torch.as_tensor(pixel_values, device=dev)
        elif visual_features is not None:
            visual_features = torch.as_tensor(visual_features, device=dev)
        else:
            visual_features = torch.zeros(
                (b, 1, self.config.resampler_num_latents, self.config.dim_visual),
                dtype=self.policy.dtype, device=dev)
        arch = self.config.lm_arch
        eos = arch.eos_token_id if eos_token_id is None else eos_token_id
        if bad_words_ids is not None:
            # HF drops a bad word equal to [eos]: EOS stays reachable
            bad_words_ids = tuple(tuple(int(t) for t in w) for w in bad_words_ids
                                  if not (len(w) == 1 and int(w[0]) == eos))
        ints = lambda xs: None if xs is None else tuple(int(t) for t in xs)
        if sequence_bias is not None:
            # HF takes a dict {ids: bias} or a list [[ids, bias], ...]
            sequence_bias = tuple(
                (tuple(int(t) for t in w), float(v))
                for w, v in (sequence_bias.items() if isinstance(sequence_bias, dict)
                             else sequence_bias))
        if exponential_decay_length_penalty is not None:
            start, factor = exponential_decay_length_penalty
            exponential_decay_length_penalty = (int(start), float(factor))
        if force_words_ids is not None:
            # HF's nested lists: a phrase becomes one alternative, a
            # disjunctive set keeps its alternatives
            force_words_ids = tuple(
                tuple(tuple(int(t) for t in alt) for alt in w)
                if w and isinstance(w[0], (list, tuple))
                else (tuple(int(t) for t in w),)
                for w in force_words_ids)
        dc = DecodeConfig(
            max_length=max_length, max_new_tokens=max_new_tokens,
            eos_token_id=eos, pad_token_id=eos if pad_token_id is None else pad_token_id,
            do_sample=do_sample, top_k=top_k, top_p=top_p, temperature=temperature,
            min_p=min_p, typical_p=typical_p, epsilon_cutoff=epsilon_cutoff,
            eta_cutoff=eta_cutoff, penalty_alpha=penalty_alpha,
            sequence_bias=sequence_bias,
            exponential_decay_length_penalty=exponential_decay_length_penalty,
            repetition_penalty=repetition_penalty, min_length=min_length,
            min_new_tokens=min_new_tokens, no_repeat_ngram_size=no_repeat_ngram_size,
            bad_words_ids=bad_words_ids,
            force_words_ids=force_words_ids,
            forced_bos_token_id=forced_bos_token_id,
            forced_eos_token_id=forced_eos_token_id,
            suppress_tokens=ints(suppress_tokens),
            begin_suppress_tokens=ints(begin_suppress_tokens),
            int8_kv_cache=int8_kv_cache, prefix_block=prefix_block,
            flat_kv_cache=flat_kv_cache, fused_head=fused_head,
            megakernel=megakernel, w8a8=w8a8, num_beams=num_beams,
            length_penalty=length_penalty, early_stopping=early_stopping,
            num_return_sequences=num_return_sequences,
            num_beam_groups=num_beam_groups, diversity_penalty=diversity_penalty,
            beam_reorder=beam_reorder, return_scores=return_scores,
            output_scores=output_scores)
        if mesh is not None:
            if tensor_parallel and mesh.size() > 1:
                self.shard_(mesh)
            else:
                self._whole("generate without tensor_parallel")
            return generate_on_mesh(
                self.params, self.config, dc, self.policy, ids, media, mask,
                visual_features=visual_features, pixel_values=pixel_values,
                generator=generator, mesh=mesh, tensor_parallel=tensor_parallel)
        self._whole("generate without a mesh")
        return generate_impl(self.params, self.config, dc, self.policy, ids,
                             media, mask, visual_features=visual_features,
                             pixel_values=pixel_values, generator=generator)

    def generate_captions(self, processor: FlamingoProcessor, pixel_values=None,
                          images=None, prompt: str = "<image>",
                          max_length: int = 150, num_beams: int = 1,
                          **kw) -> List[str]:
        """Caption a batch of images: ``images`` (PIL images or HWC arrays,
        through ``processor.preprocess_images``) or ``pixel_values`` (b c h
        w) / (b N c h w); the prompt is encoded once and repeated per row;
        ``generate`` with ``max_length``, ``num_beams`` and ``**kw``
        (``megakernel``, ``prefix_block``, ...); the rows decoded without
        special tokens and with the tags removed."""
        if images is not None:
            if pixel_values is not None:
                raise ValueError("pass either images or pixel_values, not both")
            pixel_values = processor.preprocess_images(images)
        if pixel_values is None:
            raise ValueError("need images or pixel_values")
        pixel_values = torch.as_tensor(pixel_values, device=self.device)
        if pixel_values.ndim == 4:
            pixel_values = pixel_values[:, None]          # (b, N=1, c, h, w)
        batch = pixel_values.shape[0]
        ids, media, mask = processor.encode_text(prompt)
        out = self.generate(
            ids[:1].repeat(batch, 1), media_locations=media[:1].repeat(batch, 1),
            attention_mask=mask[:1].repeat(batch, 1), pixel_values=pixel_values,
            max_length=max_length, num_beams=num_beams, **kw)
        texts = processor.tokenizer.batch_decode(out.cpu(), skip_special_tokens=True)
        return processor.remove_tags(texts)

    def score_sequences(self, input_ids, media_locations, attention_mask,
                        pixel_values=None, visual_features=None,
                        k: int = 100000) -> torch.Tensor:
        """Log-prob scores (b,) of candidate sequences sharing a prefix and
        one visual input (``scoring.score_sequences``)."""
        dev = self.device

        def put(x, dtype=None):
            return None if x is None else torch.as_tensor(x, device=dev, dtype=dtype)
        return _score_sequences(
            self.params, self.config, put(input_ids, torch.long),
            put(media_locations, torch.int32), put(attention_mask, torch.int32),
            policy=self.policy, pixel_values=put(pixel_values),
            visual_features=put(visual_features), k=k)

