"""Batched generation: greedy and sampling here, beams in ``beam_search.py``,
constrained beams in ``constrained_beam.py``, contrastive search in
``contrastive.py``.

Port of ``flamingo_mini_tpu/generation.py`` (``_prefill``, the logits
chain, ``_select_token``, ``_generate_impl`` and ``generate``'s row
expansion and dispatch); ``generate_impl`` hands ``force_words_ids`` to
``constrained_beam.constrained_beam_generate``, then ``num_beams > 1``
(beam-sample too) to ``beam_search.beam_generate``, then ``penalty_alpha >
0`` to ``contrastive.contrastive_generate``, in the JAX package's order:

* prefill runs the (left-padded) prompt through the model once, filling the
  cache; the xattn K/V are computed once and stay constant (int8 under
  ``int8_kv_cache``). The cache is the flat T-major one, or the head-major
  one (``flat_kv_cache=False``; always under ``int8_kv_cache``, in int8),
  whose steps attend in plain ops as in the JAX package; the megakernel
  reads the flat cache whatever ``flat_kv_cache`` says, and refuses the int8
  cache;
* each decode step runs embed -> trunk -> final LayerNorm -> head. The
  trunk (GPT-2 or OPT) runs either per layer (the default: gated xattn
  where the layer has it, then the decoder block with
  ``decode_attention``) or, with ``megakernel``, as one
  ``decode_step_megakernel`` launch over the stacked cache (int8 weights
  packed once per call; GPT-2 and pre-norm OPT), weight-only or, with
  ``w8a8``, with int8 activations too;
* every pick, the prefill's included, runs HF's logits-processor chain
  (``process_logits``) on the float32 logits, then greedy ``argmax`` or, with
  ``do_sample``, the warpers (``apply_logit_filters``) and the Gumbel-max
  draw that ``jax.random.categorical`` is (``_select_token``; the noise from
  a ``torch.Generator``, ``gumbel_noise``). On the plain-greedy bf16 int8
  path over a bf16 flat cache (identity chain, no scores) the head is
  ``lm_head_argmax``, which returns the token without writing the logits;
  otherwise the full ``lm_head``;
* with ``prefix_block > 0`` the steps run in segments that attend only the
  live cache prefix ``[0, seg_end)``; every segment, and the whole loop,
  stops once every row has emitted EOS.

Generated tokens see ``text_time`` = the prompt's media count. Prompts must
be unpadded or left-padded. Pixels of one prompt may come 4-D, ``(N c h w)``;
they are viewed as ``(1, N, c, h, w)`` before any row is repeated. The loop
is a Python loop; it checks the all-EOS exit once per step.

``generate_on_mesh`` is JAX's ``generate(mesh=..., tensor_parallel=...)``
dispatch over a ``DeviceMesh`` of one process per rank: each data rank runs
``generate_impl`` on its rows (whose decode is independent of the other
rows') and the rows are gathered; with ``tensor_parallel`` each model rank
computes its heads over its slice of the weights.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch

from .configuration_flamingo import FlamingoConfig
from .models import flamingo, gpt2
from .ops import lm_head, megadecode
from .ops.layers import Policy, drawn_rows, layer_norm, rand
from .ops.lm_head import lm_head_argmax, pad_head_weights
from .ops.quant import quantize_kv_pair
from .parallel import comm
from .parallel.mesh import axis_size

Params = Dict[str, Any]
HEAD_BLOCK_V = 2048
NEG = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class DecodeConfig:
    """The JAX package's DecodeConfig, with its defaults and checks. The
    megakernel refuses what it does not run (the int8 KV cache, the gather
    reorder of beams, constrained and contrastive search) with
    ``ValueError`` here, before vision and prefill."""

    max_length: int = 150
    max_new_tokens: Optional[int] = None
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    # sampling warpers, in HF's chain order (apply_logit_filters)
    do_sample: bool = False
    top_k: int = 0                    # 0 = off
    top_p: float = 1.0                # 1.0 = off
    temperature: float = 1.0
    min_p: float = 0.0                # 0.0 = off
    typical_p: float = 1.0            # 1.0 = off
    epsilon_cutoff: float = 0.0       # 0.0 = off
    eta_cutoff: float = 0.0           # 0.0 = off
    # contrastive search (penalty_alpha > 0 over top_k > 1 candidates)
    penalty_alpha: float = 0.0
    # HF logits processors (process_logits): ((token ids...), bias) pairs
    sequence_bias: Optional[tuple] = None
    # (start_index, decay_factor)
    exponential_decay_length_penalty: Optional[tuple] = None
    repetition_penalty: float = 1.0
    min_length: int = 0
    min_new_tokens: int = 0
    no_repeat_ngram_size: int = 0
    bad_words_ids: Optional[tuple] = None      # tuple of token-id tuples
    # constrained beams: a tuple of constraints, each a tuple of alternative
    # phrases (tuples of ids); FlamingoModel.generate normalises HF's lists
    force_words_ids: Optional[tuple] = None
    forced_bos_token_id: Optional[int] = None
    forced_eos_token_id: Optional[int] = None
    suppress_tokens: Optional[tuple] = None        # banned at every step
    begin_suppress_tokens: Optional[tuple] = None  # banned at the first step
    # the head-major cache in int8 with per-position bf16 scales, and the
    # xattn K/V in int8; overrides flat_kv_cache; the megakernel refuses it
    int8_kv_cache: bool = False
    prefix_block: int = 0
    # False: the head-major (b, h, max_len, d_head) cache, plain attention
    flat_kv_cache: bool = True
    fused_head: bool = True
    # whole-step megakernel: int8 weights, bf16 policy, GPT-2 or pre-norm
    # OPT trunk
    megakernel: bool = False
    # w8a8 tier (needs the megakernel): every trunk and xattn linear of the
    # step quantizes its activations per row (symmetric absmax int8) and
    # sums int8 x int8 products; attention stays bf16. Another numerics
    # tier than weight-only, not an approximation of it.
    w8a8: bool = False
    # beam search (HF semantics, beam_search.py)
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = True
    # sampling: each prompt repeated n times; beams: top n hypotheses
    num_return_sequences: int = 1
    num_beam_groups: int = 1          # diverse beams: per layer only
    diversity_penalty: float = 0.0
    # "lazy": cache rows never move, an ancestry table is permuted instead;
    # "gather": the head-major cache's live prefix is permuted every step
    # (per layer only: the megakernel's beam mode reads the ancestry)
    beam_reorder: str = "lazy"
    # greedy / sampling: the sum of the chosen tokens' log-probs under the
    # step distribution (post-processor, post-warper), post-EOS pads
    # excluded; beams: HF sequences_scores
    return_scores: bool = False
    # greedy / sampling: those log-probs per step, (b, max_length) float32
    # at absolute positions, 0 at prompt slots and post-EOS pads
    output_scores: bool = False

    def __post_init__(self):
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.max_length < 2:
            raise ValueError(f"max_length must be >= 2, got {self.max_length}")
        if self.output_scores and (self.num_beams > 1 or self.penalty_alpha > 0.0
                                   or self.force_words_ids is not None):
            raise ValueError("output_scores (per-step arrays) is greedy/sample "
                             "only; beam variants return sequences_scores "
                             "(return_scores=True)")
        if self.num_beam_groups > 1:
            if self.num_beams % self.num_beam_groups:
                raise ValueError(f"num_beams ({self.num_beams}) must be "
                                 f"divisible by num_beam_groups "
                                 f"({self.num_beam_groups})")
            if self.do_sample:
                raise ValueError("diverse beam search is deterministic; "
                                 "do_sample=True is not supported")
        if self.diversity_penalty != 0.0 and self.num_beam_groups <= 1:
            raise ValueError("diversity_penalty requires num_beam_groups > 1")
        if self.exponential_decay_length_penalty is not None:
            factor = self.exponential_decay_length_penalty[1]
            if not factor > 0.0:
                raise ValueError("exponential_decay_length_penalty decay "
                                 f"factor must be > 0, got {factor}")
        if self.w8a8 and not self.megakernel:
            raise ValueError("w8a8 (int8 activation quantization) is a "
                             "megakernel tier: set megakernel=True")
        if self.w8a8 and self.num_beam_groups > 1:
            raise ValueError("w8a8 runs on the megakernel, and diverse beams "
                             "(num_beam_groups > 1) run per layer")
        if self.megakernel and self.int8_kv_cache:
            raise ValueError("the megakernel reads a bf16 KV cache: "
                             "int8_kv_cache must be off")
        if self.megakernel and self.beam_reorder == "gather" \
                and self.num_beams > 1 and self.num_beam_groups == 1:
            raise ValueError("the megakernel's beam mode reorders lazily: "
                             "beam_reorder='gather' runs per layer "
                             "(megakernel=False)")
        if self.beam_reorder not in ("gather", "lazy"):
            raise ValueError(f"beam_reorder must be 'gather' or 'lazy', "
                             f"got {self.beam_reorder!r}")
        if self.num_beams == 1 and self.num_return_sequences > 1 \
                and not self.do_sample:
            raise ValueError("num_return_sequences > 1 requires do_sample=True "
                             "or num_beams >= num_return_sequences")
        if self.force_words_ids is not None:
            # HF: constrained search is beams without sampling or groups
            if self.num_beams <= 1:
                raise ValueError("force_words_ids (constrained beam search) "
                                 "requires num_beams > 1")
            if self.do_sample:
                raise ValueError("force_words_ids is incompatible with "
                                 "do_sample=True")
            if self.num_beam_groups > 1:
                raise ValueError("force_words_ids is incompatible with "
                                 "num_beam_groups > 1")
        if self.penalty_alpha > 0.0:
            if self.top_k <= 1:
                raise ValueError("contrastive search (penalty_alpha > 0) needs "
                                 "top_k > 1 candidate tokens")
            if self.do_sample or self.num_beams > 1:
                raise ValueError("contrastive search is a deterministic "
                                 "single-beam strategy; do_sample and "
                                 "num_beams are incompatible")
        if self.megakernel and (self.force_words_ids is not None
                                or self.penalty_alpha > 0.0):
            raise ValueError("constrained and contrastive search run per layer "
                             "over the head-major cache: set megakernel=False")


def uses_flat_cache(dc: DecodeConfig) -> bool:
    """Whether greedy and sampling decode over the flat cache: with
    ``flat_kv_cache`` or the megakernel, never over the int8 cache."""
    return (dc.flat_kv_cache or dc.megakernel) and not dc.int8_kv_cache


def _prefill(params: Params, config: FlamingoConfig, dc: DecodeConfig,
             policy: Policy, input_ids, media_locations, attention_mask,
             visual_features, flat: Optional[bool] = None,
             with_hidden: bool = False):
    """Run the prompt, filling the cache -> (next_logits, xattn_kv, state):
    the flat cache (state "kc", "vc": the stacks; "cache": per-layer views)
    or with ``flat=False`` the head-major one (int8 under
    ``dc.int8_kv_cache``, which also quantizes the xattn K/V; "kc" and "vc"
    None). ``flat`` None: ``uses_flat_cache(dc)``. With ``with_hidden`` the
    state gains "prompt_hidden" (b, L, D): the trunk's output, the states
    the head reads (contrastive search's penalty space)."""
    flat = uses_flat_cache(dc) if flat is None else flat
    b, L = input_ids.shape
    dev = input_ids.device
    mask_buf = torch.zeros((b, dc.max_length), dtype=torch.int32, device=dev)
    mask_buf[:, :L] = attention_mask
    tokens = torch.full((b, dc.max_length), dc.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :L] = input_ids

    text_time = torch.cumsum(media_locations.to(torch.int32), dim=-1)
    xattn_kv = flamingo.compute_xattn_kv(params, config, visual_features,
                                         policy=policy)
    if dc.int8_kv_cache:
        # decode reads the xattn K/V every step; int8 halves that stream
        xattn_kv = {idx: quantize_kv_pair(kv) for idx, kv in xattn_kv.items()}
    hook = flamingo.make_layer_hook(params, config, xattn_kv, text_time,
                                    policy=policy)
    kc, vc, cache = flamingo.trunk(config).init_cache(
        config.lm_arch, b, dc.max_length, policy.dtype, dev,
        int8=dc.int8_kv_cache, flat=flat, shards=policy.tp_size)
    # position ids from the attention mask (pads do not advance positions)
    pos = torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1,
                      min=0)
    logits, cache, hidden = flamingo.apply_lm(
        params, config, input_ids, policy=policy, layer_hook=hook,
        attention_mask=mask_buf, position_ids=pos, cache=cache, cache_index=0)
    state = {
        "tokens": tokens,
        "mask": mask_buf,
        "cache": cache,
        "kc": kc,
        "vc": vc,
        "media_count": text_time[:, -1:],
        "pos_next": attention_mask.to(torch.int32).sum(-1, keepdim=True),
    }
    if with_hidden:
        state["prompt_hidden"] = hidden
    return logits[:, -1], xattn_kv, state


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jax.nn.log_softmax`` over the last axis, in its order of
    operations."""
    x = x.float()
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _entropy(logp: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """-sum(p log p) over the last axis, terms with p == 0 taken as 0."""
    return -torch.where(p > 0, logp * p, 0.0).sum(dim=-1, keepdim=True)


def _unsort(sorted_mask: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """A mask over sorted positions -> the same mask over the original ones."""
    return torch.empty_like(sorted_mask).scatter_(1, order, sorted_mask)


def apply_logit_filters(logits: torch.Tensor, *, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0,
                        min_p: float = 0.0, typical_p: float = 1.0,
                        epsilon_cutoff: float = 0.0,
                        eta_cutoff: float = 0.0) -> torch.Tensor:
    """HF's sampling warpers over (b, V) logits, in HF's order: Temperature
    -> TopK -> TopP -> MinP -> Typical -> Epsilon -> Eta, each keeping at
    least one token. Removed entries become float32's ``finfo.min``. Sorts
    are stable, as ``jnp.argsort``'s, so tied logits cut as in JAX."""
    logits = logits.float()
    V = logits.shape[-1]
    if temperature != 1.0:
        logits = logits / temperature
    if top_k > 0:
        # the k-th largest value: every logit tied with it stays
        kth = torch.topk(logits, min(top_k, V), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG)
    if top_p < 1.0:
        # ascending: drop the tokens whose cumulative mass is <= 1 - top_p
        sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
        cum = torch.cumsum(_softmax(sorted_logits), dim=-1)
        remove = cum <= (1.0 - top_p)
        remove[:, -1] = False
        logits = logits.masked_fill(_unsort(remove, order), NEG)
    if min_p > 0.0:
        probs = _softmax(logits)
        remove = probs < min_p * probs.amax(dim=-1, keepdim=True)
        remove[torch.arange(logits.shape[0]), logits.argmax(dim=-1)] = False
        logits = logits.masked_fill(remove, NEG)
    if typical_p < 1.0:
        # the smallest set of tokens, closest to the entropy first, whose
        # mass reaches typical_p
        logp = _log_softmax(logits)
        shifted = torch.abs((-logp) - _entropy(logp, torch.exp(logp)))
        sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
        cum = torch.cumsum(_softmax(logits.gather(1, order)), dim=-1)
        last = torch.clamp((cum < typical_p).sum(dim=-1), max=V - 1)
        remove = sorted_shifted > sorted_shifted.gather(1, last[:, None])
        remove[:, 0] = False
        logits = logits.masked_fill(_unsort(remove, order), NEG)
    if epsilon_cutoff > 0.0:
        remove = (_softmax(logits) < epsilon_cutoff) & \
            (logits < logits.amax(dim=-1, keepdim=True))
        logits = logits.masked_fill(remove, NEG)
    if eta_cutoff > 0.0:
        # entropy-adaptive: eta = min(epsilon, sqrt(epsilon) * exp(-H))
        probs = _softmax(logits)
        eps = torch.tensor(eta_cutoff, dtype=torch.float32, device=logits.device)
        eta = torch.minimum(eps, torch.sqrt(eps) * torch.exp(
            -_entropy(_log_softmax(logits), probs)))
        remove = (probs < eta) & (logits < logits.amax(dim=-1, keepdim=True))
        logits = logits.masked_fill(remove, NEG)
    return logits


def _scatter_any(shape, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A (b, V) bool mask: [r, index[r, j]] is set where src[r, j] holds.
    Indices outside [0, V) are dropped, as JAX's scatter drops them."""
    V = shape[-1]
    src = src & (index >= 0) & (index < V)
    hits = torch.zeros(shape, dtype=torch.int32, device=index.device)
    hits.scatter_add_(1, index.clamp(0, V - 1), src.to(torch.int32))
    return hits > 0


def _window(tokens: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """The n tokens before position ``idx``, their start clamped into the
    buffer as ``lax.dynamic_slice`` clamps it (the callers' ``idx >= n``
    tests then discard the clamped windows)."""
    start = min(max(idx - n, 0), tokens.shape[1] - n)
    return tokens[:, start:start + n]


def _repetition_penalty(logits, tokens, mask, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: every token present in the
    (real) sequence has positive logits divided by ``penalty`` and negative
    ones multiplied by it."""
    seen = _scatter_any(logits.shape, tokens, mask.bool())
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _ban_eos_while_short(logits, dc: DecodeConfig, idx: int, prompt_len: int):
    """HF Min(NewTokens)LengthLogitsProcessor: EOS is banned while the
    sequence so far (length ``idx``, pads included) is shorter than
    ``min_length``, or fewer than ``min_new_tokens`` have been generated."""
    too_short = idx < dc.min_length or idx - prompt_len < dc.min_new_tokens
    if not too_short or not 0 <= dc.eos_token_id < logits.shape[-1]:
        return logits
    return logits.index_fill(1, torch.tensor([dc.eos_token_id],
                                             device=logits.device), NEG)


def _no_repeat_ngram(logits, tokens, idx: int, n: int):
    """HF NoRepeatNGramLogitsProcessor: ban every token that would complete
    an n-gram already in the row. Works on the raw token buffer (prompt pads
    included), as HF sees ``input_ids``; slots from ``idx`` on are out."""
    b, max_len = tokens.shape
    if n == 1:
        valid = (torch.arange(max_len, device=tokens.device) < idx)[None, :]
        return logits.masked_fill(
            _scatter_any(logits.shape, tokens, valid.expand(b, -1)), NEG)
    m = max_len - n + 1
    suffix = _window(tokens, idx, n - 1)                       # (b, n-1)
    windows = tokens.unfold(1, n - 1, 1)[:, :m]                # (b, m, n-1)
    match = (windows == suffix[:, None, :]).all(dim=-1)
    match = match & (torch.arange(m, device=tokens.device) <= idx - n)[None, :]
    return logits.masked_fill(
        _scatter_any(logits.shape, tokens[:, n - 1:n - 1 + m], match), NEG)


def _ends_with(tokens, idx: int, prefix) -> torch.Tensor:
    """(b,) bool: the sequence so far (length ``idx``) ends with ``prefix``
    and is at least one token longer (HF skips a word longer than the
    current length)."""
    n = len(prefix) + 1
    want = torch.tensor(prefix, dtype=tokens.dtype, device=tokens.device)
    return (_window(tokens, idx, n - 1) == want).all(dim=-1) & (idx >= n)


def _sequence_bias(logits, tokens, idx: int, seq_bias):
    """HF SequenceBiasLogitsProcessor over ``((token ids...), bias)`` pairs:
    a one-token sequence biases its token always, a longer one its last
    token where the sequence so far ends with the rest."""
    b, V = logits.shape
    bias = torch.zeros((b, V), dtype=torch.float32, device=logits.device)
    for w, bv in seq_bias:
        if len(w) == 0 or int(w[-1]) >= V:
            continue
        add = torch.tensor(bv, dtype=torch.float32, device=logits.device)
        if len(w) > 1:
            add = torch.where(_ends_with(tokens, idx, w[:-1]), add, 0.0)
        bias[:, int(w[-1])] += add
    return logits + bias


def _ban_bad_words(logits, tokens, idx: int, words):
    """HF NoBadWordsLogitsProcessor: a word bans its last token wherever
    the sequence so far ends with the rest; one-token words always."""
    b, V = logits.shape
    banned = torch.zeros((b, V), dtype=torch.bool, device=logits.device)
    for w in words:
        if len(w) == 0 or int(w[-1]) >= V:
            continue
        hit = True if len(w) == 1 else _ends_with(tokens, idx, w[:-1])
        banned[:, int(w[-1])] |= hit
    return logits.masked_fill(banned, NEG)


def _force_token(logits, token_id: int, when: bool):
    """HF Forced{BOS,EOS}TokenLogitsProcessor: when the condition holds,
    every logit is banned but the forced token's, which becomes 0."""
    if not when:
        return logits
    forced = torch.full_like(logits, NEG)
    if 0 <= token_id < logits.shape[-1]:
        forced[:, token_id] = 0.0
    return forced


def _suppress(logits, ids, when: bool = True):
    """HF SuppressTokens(AtBegin)LogitsProcessor: the listed ids banned."""
    V = logits.shape[-1]
    ids = [int(i) for i in ids if -V <= int(i) < V]
    if not when or not ids:
        return logits
    return logits.index_fill(1, torch.tensor(ids, device=logits.device) % V, NEG)


def process_logits(logits: torch.Tensor, dc: DecodeConfig, tokens: torch.Tensor,
                   mask: torch.Tensor, idx: int, prompt_len: int) -> torch.Tensor:
    """HF's logits-processor chain in HF's order (sequence bias ->
    repetition penalty -> no-repeat-ngram -> bad words -> min length ->
    forced BOS -> forced EOS -> exponential decay -> suppress -> begin
    suppress) over (b, V) next-token logits, in float32. ``tokens`` and
    ``mask`` are the (b, max_length) buffers; ``idx`` is the length of the
    sequence so far, the position being filled."""
    logits = logits.float()
    if dc.sequence_bias:
        logits = _sequence_bias(logits, tokens, idx, dc.sequence_bias)
    if dc.repetition_penalty != 1.0:
        logits = _repetition_penalty(logits, tokens, mask, dc.repetition_penalty)
    if dc.no_repeat_ngram_size > 0:
        logits = _no_repeat_ngram(logits, tokens, idx, dc.no_repeat_ngram_size)
    if dc.bad_words_ids:
        logits = _ban_bad_words(logits, tokens, idx, dc.bad_words_ids)
    if dc.min_length > 0 or dc.min_new_tokens > 0:
        logits = _ban_eos_while_short(logits, dc, idx, prompt_len)
    if dc.forced_bos_token_id is not None:
        # the token at sequence length 1: a one-token prompt only
        logits = _force_token(logits, dc.forced_bos_token_id, idx == 1)
    if dc.forced_eos_token_id is not None:
        logits = _force_token(logits, dc.forced_eos_token_id,
                              idx == _stop(dc, prompt_len) - 1)
    if dc.exponential_decay_length_penalty is not None:
        # past the start, EOS gains |logit| * (factor^(idx - start) - 1)
        start, factor = dc.exponential_decay_length_penalty
        reg_start = start + prompt_len
        eos = dc.eos_token_id
        if idx > reg_start and 0 <= eos < logits.shape[-1]:
            f32 = dict(dtype=torch.float32, device=logits.device)
            steps_past = torch.tensor(float(idx - reg_start), **f32)
            grow = torch.exp(torch.log(torch.tensor(factor, **f32)) * steps_past)
            logits = logits.clone()
            logits[:, eos] += torch.abs(logits[:, eos]) * (grow - 1.0)
    if dc.suppress_tokens:
        logits = _suppress(logits, dc.suppress_tokens)
    if dc.begin_suppress_tokens:
        begin = prompt_len if (prompt_len > 1 or dc.forced_bos_token_id is None) \
            else prompt_len + 1
        logits = _suppress(logits, dc.begin_suppress_tokens, idx == begin)
    return logits


def _logits_chain_is_identity(dc: DecodeConfig) -> bool:
    """True when ``process_logits`` changes nothing at any step (every
    processor at its HF default): the plain-greedy fast path."""
    return (not dc.sequence_bias and dc.repetition_penalty == 1.0
            and dc.no_repeat_ngram_size == 0 and not dc.bad_words_ids
            and dc.min_length == 0 and dc.min_new_tokens == 0
            and dc.forced_bos_token_id is None
            and dc.forced_eos_token_id is None
            and dc.exponential_decay_length_penalty is None
            and not dc.suppress_tokens and not dc.begin_suppress_tokens)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` in float32, U uniform on
    [tiny, 1) from ``generator``, as ``jax.random.gumbel`` draws it (a data
    rank's rows of the whole batch's draw: ``layers.rand``). Looked up at
    call time, so that a test can feed other noise through."""
    u = rand(shape, generator, device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def warp(logits: torch.Tensor, dc: DecodeConfig) -> torch.Tensor:
    """``apply_logit_filters`` with the warpers ``dc`` asks for."""
    return apply_logit_filters(
        logits, temperature=dc.temperature, top_k=dc.top_k, top_p=dc.top_p,
        min_p=dc.min_p, typical_p=dc.typical_p,
        epsilon_cutoff=dc.epsilon_cutoff, eta_cutoff=dc.eta_cutoff)


def _select_token(logits: torch.Tensor, dc: DecodeConfig,
                  noise: Optional[torch.Tensor]):
    """Greedy or sampled token over (b, V) logits -> (tokens (b,) int64,
    log-probs (b,) float32 or None).

    Greedy is the first maximum. Sampling runs the warpers, then takes
    ``argmax(filtered + noise)``: with Gumbel noise, the draw
    ``jax.random.categorical`` makes. With ``return_scores`` or
    ``output_scores`` also the chosen token's log-prob under the step
    distribution (the warped one when sampling)."""
    logits = logits.float()
    if dc.do_sample:
        logits = warp(logits, dc)
        tok = torch.argmax(noise + logits, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    if not (dc.return_scores or dc.output_scores):
        return tok, None
    return tok, _log_softmax(logits).gather(1, tok[:, None])[:, 0]


def _stop(dc: DecodeConfig, prompt_len: int) -> int:
    """The position generation stops at: ``max_length``, or fewer with
    ``max_new_tokens``."""
    return dc.max_length if dc.max_new_tokens is None else \
        min(dc.max_length, prompt_len + dc.max_new_tokens)


def check_mega_fits(config: FlamingoConfig, dc: DecodeConfig, rows: int,
                    visual_features: Optional[torch.Tensor],
                    pixel_values: Optional[torch.Tensor], device) -> None:
    """With ``dc.megakernel`` on a CUDA device, refuse a step the card
    cannot hold (``megadecode.check_fits``: ``rows`` rows, the flat cache's
    slots, the media's latents) before vision and prefill run."""
    if not dc.megakernel:
        return
    if pixel_values is not None:
        n_media = pixel_values.shape[0 if pixel_values.ndim == 4 else 1]
    else:
        n_media = visual_features.shape[1]
    megadecode.check_fits(config, rows, gpt2.cache_len(dc.max_length),
                          n_media * config.resampler_num_latents,
                          act_quant=dc.w8a8, device=device)


def _mega_prepare(params: Params, config: FlamingoConfig, policy: Policy,
                  dc: DecodeConfig, xattn_kv, mask: torch.Tensor,
                  media_count: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The megakernel's per-generate inputs: packed weights and xattn K/V,
    each row's first real slot and its media count, the w8a8 switch."""
    if policy.dtype != torch.bfloat16:
        raise ValueError("the megakernel runs the bf16 compute policy")
    xk, xv = megadecode.pack_xattn_kv_flat(xattn_kv, flamingo.n_lm_layers(config))
    return dict(packed=megadecode.pack_decode_weights(params, config), xk=xk,
                xv=xv, npad=mask.argmax(dim=-1).to(torch.int32),
                text_time=media_count[:, 0].to(torch.int32).contiguous(),
                act_quant=dc.w8a8)


def _mega_hidden(params: Params, config: FlamingoConfig, policy: Policy,
                 mega: Dict[str, torch.Tensor], kc, vc, tok: torch.Tensor,
                 pos: torch.Tensor, cur: int, kv_limit: Optional[int],
                 beam_anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One megakernel decode step: embed ``tok`` (b,) at positions ``pos``
    (b,), run every layer (K/V written at slot ``cur`` of kc/vc) ->
    final-LN hidden (b, D)."""
    lm, trunk = params["lm"], flamingo.trunk(config)
    x = trunk.embed(lm, tok, pos, policy.dtype)
    hidden = megadecode.decode_step_megakernel(
        mega["packed"], mega["xk"], mega["xv"], kc, vc, x, mega["npad"],
        mega["text_time"], cur, config=config, kv_limit=kv_limit,
        beam_anc=beam_anc, act_quant=mega["act_quant"])
    return layer_norm(hidden, lm[trunk.FINAL_LN], config.lm_arch.layer_norm_epsilon)


def generate_impl(params: Params, config: FlamingoConfig, dc: DecodeConfig,
                  policy: Policy, input_ids: torch.Tensor,
                  media_locations: torch.Tensor, attention_mask: torch.Tensor,
                  visual_features: Optional[torch.Tensor] = None,
                  pixel_values: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """Greedy or sampled decode -> tokens (b, max_length) int64: prompt,
    generated tokens, pad after EOS; ``(tokens, scores (b,))`` with
    ``dc.return_scores``, ``(tokens, step_scores (b, max_length))`` with
    ``dc.output_scores``, ``(tokens, scores, step_scores)`` with both.
    Sampling with ``dc.num_return_sequences = n`` repeats each row n times
    (rows ``i*n .. i*n+n-1`` sample prompt i). The noise comes from
    ``generator``; None seeds one with 0 on the inputs' device. On the
    batch as given, with their returns: ``dc.force_words_ids``,
    ``constrained_beam.constrained_beam_generate``; ``dc.num_beams > 1``,
    ``beam_search.beam_generate`` (beam-sample with ``dc.do_sample``, its
    noise from ``generator``); ``dc.penalty_alpha > 0``,
    ``contrastive.contrastive_generate``, which refuses
    ``dc.return_scores``."""
    if pixel_values is not None and pixel_values.ndim == 4:
        # one prompt's media (N c h w): one row of N before any repeat
        pixel_values = pixel_values[None]
    if dc.megakernel and not megadecode.supports_arch(config.lm_arch):
        raise ValueError("the megakernel takes GPT-2 and pre-norm OPT trunks "
                         f"without project_in/out, width a multiple of "
                         f"{megadecode.K_CHUNK}; got {config.lm!r}")
    # the searches import _prefill from here
    if dc.force_words_ids is not None:
        from .constrained_beam import constrained_beam_generate
        return constrained_beam_generate(params, config, dc, policy, input_ids,
                                         media_locations, attention_mask,
                                         visual_features=visual_features,
                                         pixel_values=pixel_values)
    if dc.num_beams > 1:
        from .beam_search import beam_generate
        return beam_generate(params, config, dc, policy, input_ids,
                             media_locations, attention_mask,
                             visual_features=visual_features,
                             pixel_values=pixel_values, generator=generator)
    if dc.penalty_alpha > 0.0:
        if dc.return_scores:
            raise ValueError("return_scores is not supported with contrastive "
                             "search: its penalised scores are not sequence "
                             "log-probs")
        from .contrastive import contrastive_generate
        return contrastive_generate(params, config, dc, policy, input_ids,
                                    media_locations, attention_mask,
                                    visual_features=visual_features,
                                    pixel_values=pixel_values)
    if dc.num_return_sequences > 1:
        rep = lambda x: None if x is None else \
            x.repeat_interleave(dc.num_return_sequences, dim=0)
        input_ids, media_locations, attention_mask = (
            rep(input_ids), rep(media_locations), rep(attention_mask))
        visual_features, pixel_values = rep(visual_features), rep(pixel_values)
    b, L = input_ids.shape
    dev = input_ids.device
    check_mega_fits(config, dc, b, visual_features, pixel_values, dev)
    # fused int8 head + argmax: plain greedy (identity chain, no scores)
    # under the bf16 policy with an int8 tied embedding, over a bf16 flat
    # cache as in the JAX package (the kernel takes a bf16 hidden row of any
    # width; what the card cannot hold is refused here, before vision and
    # prefill). Otherwise the chain and the draw need the full logits.
    head = None
    wq = params["lm"].get(flamingo.trunk(config).EMBED + "_q")
    if (dc.fused_head and uses_flat_cache(dc) and policy.dtype == torch.bfloat16
            and wq is not None
            and not dc.do_sample and not dc.return_scores
            and not dc.output_scores and _logits_chain_is_identity(dc)):
        lm_head.check_fits(int(wq["w8"].shape[1]), b, dev)
        head_nvalid = min(int(wq["w8"].shape[0]), config.lm_arch.vocab_size + 1)
        head = pad_head_weights(wq, HEAD_BLOCK_V)
    if dc.do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if pixel_values is not None:
        visual_features = flamingo.encode_resample_visuals(
            params, config, policy.cast(pixel_values), policy=policy)
    next_logits, xattn_kv, st = _prefill(
        params, config, dc, policy, input_ids, media_locations,
        attention_mask, visual_features)
    decode_hook = flamingo.make_layer_hook(params, config, xattn_kv,
                                           st["media_count"], policy=policy)
    if dc.megakernel:
        mega = _mega_prepare(params, config, policy, dc, xattn_kv, st["mask"],
                             st["media_count"])

    def pick(logits: torch.Tensor, idx: int):
        """The chain and the pick for position ``idx`` -> (token, log-prob)."""
        logits = process_logits(logits, dc, st["tokens"], st["mask"], idx, L)
        noise = gumbel_noise(logits.shape, generator, dev) if dc.do_sample else None
        return _select_token(logits, dc, noise)

    tok, lp = pick(next_logits, L)
    finished = tok == dc.eos_token_id
    scores = lp if dc.return_scores else None
    step_scores = None
    if dc.output_scores:
        step_scores = torch.zeros((b, dc.max_length), dtype=torch.float32,
                                  device=dev)
        step_scores[:, L] = lp
    # the first generated token is written as-is; finished rows emit pad
    # from the next step on
    st["tokens"][:, L] = tok
    st["mask"][:, L] = 1

    M = _stop(dc, L)
    if dc.prefix_block > 0:
        seg_ends = sorted(set(list(range(L + dc.prefix_block, M - 1,
                                         dc.prefix_block)) + [M - 1]))
    else:
        seg_ends = [M - 1]

    cur = L
    for seg_end in seg_ends:
        kv_limit = min(seg_end, dc.max_length) if dc.prefix_block > 0 else None
        while cur < seg_end and not bool(finished.all()):
            if dc.megakernel:
                hid = _mega_hidden(params, config, policy, mega, st["kc"],
                                   st["vc"], tok, st["pos_next"][:, 0], cur,
                                   kv_limit)[:, None]
                logits = None if head is not None else flamingo.lm_head(
                    params, config, hid)
            else:
                logits, _, hid = flamingo.apply_lm(
                    params, config, tok[:, None], policy=policy,
                    layer_hook=decode_hook, attention_mask=st["mask"],
                    position_ids=st["pos_next"], cache=st["cache"],
                    cache_index=cur, kv_limit=kv_limit,
                    skip_head=head is not None)
            st["pos_next"] = st["pos_next"] + 1
            # this step fills position cur + 1, the sequence's length so far
            if head is not None:
                nxt = lm_head_argmax(head["w8"], head["scale"],
                                     hid[:, -1].contiguous(),
                                     n_valid=head_nvalid).long()
            else:
                nxt, lp = pick(logits[:, -1], cur + 1)
                # finished rows emit pads and score nothing
                lp = lp if lp is None else lp.masked_fill(finished, 0.0)
                if dc.return_scores:
                    scores = scores + lp
                if dc.output_scores:
                    step_scores[:, cur + 1] = lp
            st["tokens"][:, cur + 1] = nxt.masked_fill(finished, dc.pad_token_id)
            st["mask"][:, cur + 1] = 1
            finished = finished | (nxt == dc.eos_token_id)
            tok = nxt
            cur += 1
    out = (st["tokens"],) + tuple(
        s for s in (scores, step_scores) if s is not None)
    return out[0] if len(out) == 1 else out


def generate_on_mesh(params: Params, config: FlamingoConfig, dc: DecodeConfig,
                     policy: Policy, input_ids: torch.Tensor,
                     media_locations: torch.Tensor, attention_mask: torch.Tensor,
                     visual_features: Optional[torch.Tensor] = None,
                     pixel_values: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, *, mesh,
                     tensor_parallel: bool = False):
    """``generate_impl`` over ``mesh`` (a ``DeviceMesh`` whose first axis is
    the data axis, unless it is a ``model`` axis alone), JAX's mesh dispatch
    (``generation.py:876-921``). Every rank passes the whole batch and gets
    the whole result back.

    * A one-rank mesh is no mesh.
    * Sampled ``num_return_sequences`` repeat the rows first, as in JAX.
    * Greedy and sampling over the flat cache or the megakernel, where the
      data axis divides the batch, run the whole one-device program on the
      rank's rows: the megakernel, ``decode_attention`` and the fused head.
      Beams, constrained and contrastive search, and tensor parallelism, run
      with ``flat_kv_cache``, ``megakernel`` and ``w8a8`` cleared.
    * A batch the data axis does not divide raises ``ValueError``.
    * ``tensor_parallel``: ``params`` are the rank's slice on the mesh's
      ``model`` axis, the vocab padded to it (``FlamingoModel.shard_``).
    * Sampling: each data rank draws the whole batch's noise from
      ``generator`` and keeps its rows (``layers.drawn_rows``), so the result
      is the one-device run's. JAX folds the data index into each shard's
      key (``generation.py:962-967``) instead; a ``torch.Generator`` cannot
      reproduce that draw, so its samples are not matched bit for bit.

    Then the rows are gathered over the data axis."""
    if mesh.size() == 1:
        return generate_impl(params, config, dc, policy, input_ids,
                             media_locations, attention_mask, visual_features,
                             pixel_values, generator)
    if pixel_values is not None and pixel_values.ndim == 4:
        pixel_values = pixel_values[None]
    nrs = dc.num_return_sequences
    if nrs > 1 and dc.num_beams == 1 and dc.do_sample:
        rep = lambda x: None if x is None else x.repeat_interleave(nrs, dim=0)
        input_ids, media_locations, attention_mask = (
            rep(input_ids), rep(media_locations), rep(attention_mask))
        visual_features, pixel_values = rep(visual_features), rep(pixel_values)
        dc = replace(dc, num_return_sequences=1)
    data_axis = mesh.mesh_dim_names[0]
    if data_axis == "model":     # a model axis alone: every rank all rows
        data_axis = None
    n_data = 1 if data_axis is None else axis_size(mesh, data_axis)
    b = input_ids.shape[0]
    if dc.flat_kv_cache or dc.megakernel:
        per_rank = (not tensor_parallel and dc.num_beams == 1
                    and dc.force_words_ids is None and dc.penalty_alpha == 0.0
                    and b % n_data == 0)
        if not per_rank:
            dc = replace(dc, flat_kv_cache=False, megakernel=False, w8a8=False)
    if b % n_data != 0:
        raise ValueError(f"batch {b} not divisible by the mesh data axis ({n_data})")
    if tensor_parallel:
        policy = replace(policy, tp=mesh.get_group("model"))
    rank = 0 if data_axis is None else mesh.get_local_rank(data_axis)
    n = b // n_data
    rows = lambda x: None if x is None else x[rank * n:(rank + 1) * n]
    with drawn_rows(rank, n_data):
        out = generate_impl(params, config, dc, policy, rows(input_ids),
                            rows(media_locations), rows(attention_mask),
                            rows(visual_features), rows(pixel_values), generator)
    if data_axis is None:
        return out
    data_group = mesh.get_group(data_axis)
    if isinstance(out, tuple):
        return tuple(comm.all_gather(x, data_group) for x in out)
    return comm.all_gather(out, data_group)
