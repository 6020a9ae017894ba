"""Beam search with the lazy ancestry reorder or the gather reorder.

Port of ``flamingo_mini_tpu/beam_search.py`` (``_beam_impl``,
``_group_beam_impl``, ``beam_generate``), which follows HF transformers'
vectorised ``_beam_search`` and its group (diverse) variant:

* prefill runs once per batch row; the cache, the xattn K/V, the tokens,
  the mask, ``pos_next`` and the media count are then tiled k times, so
  batch row r becomes the beam family of rows ``r*k .. r*k + k - 1``;
* each step runs the logits-processor chain (``generation.process_logits``)
  on the ``log_softmax`` of the full head, as HF's beam mode does (after the
  ``log_softmax``, unlike greedy and sampling), adds the result to the
  running beam scores and takes the top 2k of the flattened (k x V)
  candidates. Beam-sample (``do_sample``) runs HF's warpers after the chain
  (their values, not renormalised, are what the running scores add up),
  draws the 2k candidates without replacement as the top 2k of the scores
  plus Gumbel noise ``-log(-log(U))``, U uniform on [1e-20, 1) drawn once a
  step (``uniform_noise``), and keeps the candidates' scores without the
  noise. A candidate that is EOS or reaches the length limit leaves
  the running refill; those ranked < k enter the finished pool with the score
  ``sum_logprobs / gen_len ** length_penalty`` (EOS kept in the sequence).
  The pool keeps the best k by a merged top-k, blocked once it is full
  (``early_stopping``) or once the one-way early-stop heuristic trips. The
  loop halts when no row can improve, every pool is full (early stopping),
  or every candidate hit a stopping criterion;
* the reorder (``beam_reorder``) is lazy by default: cache rows never
  move. A (b, k, max_length) int32 ancestry table says which row of its
  family holds each logical beam's K/V at each position; each step permutes
  the table, and the decode attention reads through it. The forward at
  ``cur`` writes the K/V of position ``cur - 1`` into each beam's own row.
  ``"gather"`` instead permutes the cache's rows over the live prefix
  ``[0, lim)`` after every step (the whole cache without ``prefix_block``).

The cache: the flat T-major one for lazy beams (``flat_kv_cache``, or the
megakernel); the head-major one for the gather reorder, under
``int8_kv_cache`` (int8) and with ``flat_kv_cache=False``, whose steps run
plain attention (lazy beams ``ops.attention.attend_beam_lazy``), as in the
JAX package (``flat_beam``).

Two decode bodies, both ending in the full ``lm_head`` (beams consume the
whole distribution): per layer, each step's 24 layers run
``decode_attention_beam`` over the flat cache; with ``megakernel`` (lazy,
flat, bf16 K/V only), each step is embed -> one
``decode_step_megakernel`` launch in its beam mode -> final LayerNorm
(GPT-2 or pre-norm OPT), weight-only or w8a8 (``dc.w8a8``). Group beams
run per layer only, as in the JAX package, and refuse w8a8; each group's
rows run the chain after their Hamming penalty. The loop is a Python loop
with one host check of the halting condition per step. Every top-k is a
stable sort, so ties go to the lower index, as ``lax.top_k``'s do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .configuration_flamingo import FlamingoConfig
from .generation import (DecodeConfig, _log_softmax, _mega_hidden,
                         _mega_prepare, _prefill, _stop, check_mega_fits,
                         process_logits, warp)
from .models import flamingo
from .ops.layers import Policy, rand
from .ops.topk import top_k as _top_k

Params = Dict[str, Any]
NEG = -1.0e9


def select_candidates(flat: torch.Tensor, n: int,
                      noise: Optional[torch.Tensor] = None):
    """A step's ``n`` best (scores, flat indices) of each row of the
    flattened (beams x V) scores; with ``noise`` (beam-sample), the ``n``
    best keys ``flat + noise``, each with its score in ``flat``. Looked up
    at call time, so that a caller can watch the candidates by replacing
    it."""
    if noise is None:
        return _top_k(flat, n)
    _, idx = _top_k(flat + noise, n)
    return flat.gather(1, idx), idx


def uniform_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Beam-sample's float32 U, uniform on [1e-20, 1) from ``generator``, as
    ``jax.random.uniform(key, shape, minval=1e-20)`` draws it (a data
    rank's rows of the whole batch's draw: ``layers.rand``). Looked up at
    call time, so that a test can feed other noise through."""
    u = rand(shape, generator, device)
    return u.clamp_min(1e-20)


def _tile_beams(x: torch.Tensor, k: int) -> torch.Tensor:
    """(b, ...) -> (b*k, ...) repeating each row."""
    return x.repeat_interleave(k, dim=0)


def _tile_leaves(node, k: int):
    """``_tile_beams`` over every tensor of a (k, v) pair or a dict."""
    if isinstance(node, dict):
        return {name: _tile_beams(x, k) for name, x in node.items()}
    return tuple(_tile_beams(x, k) for x in node)


def _gather_beams(x: torch.Tensor, parent: torch.Tensor, b: int,
                  k: int) -> torch.Tensor:
    """Reorder the (b*k, ...) leading axis by per-row parent indices (b, k)."""
    xr = x.reshape((b, k) + tuple(x.shape[1:]))
    idx = parent.reshape((b, k) + (1,) * (x.dim() - 1)).expand_as(xr)
    return torch.gather(xr, 1, idx).reshape(x.shape)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, n, max_len) -> its rows ``idx`` (b, m) along axis 1."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _pow(n: int, p: float) -> torch.Tensor:
    """float32 ``n ** p`` (the generated length under the length penalty)."""
    return torch.tensor(float(n), dtype=torch.float32) ** p


class _Decoder:
    """Prefill once per row, tile the state over the beams, and run one
    decode step's forward -> float32 log-probs (b*k, V), before the
    logits chain. ``reorder`` permutes the head-major cache's rows (the
    gather reorder). ``head_major``: the head-major cache, read lazily
    whatever ``beam_reorder`` says (constrained beams, as in JAX)."""

    def __init__(self, params: Params, config: FlamingoConfig,
                 dc: DecodeConfig, policy: Policy, input_ids, media_locations,
                 attention_mask, visual_features, pixel_values, *,
                 megakernel: bool, head_major: bool = False):
        if megakernel:
            check_mega_fits(config, dc, input_ids.shape[0] * dc.num_beams,
                            visual_features, pixel_values, input_ids.device)
        if pixel_values is not None:
            visual_features = flamingo.encode_resample_visuals(
                params, config, policy.cast(pixel_values), policy=policy)
        self.params, self.config, self.policy = params, config, policy
        k = dc.num_beams
        self.L = input_ids.shape[1]
        # JAX's flat_beam: the flat cache for lazy bf16/float32 beams (the
        # megakernel reads it whatever flat_kv_cache says)
        self.lazy = head_major or dc.beam_reorder == "lazy"
        flat = (dc.flat_kv_cache or megakernel) and self.lazy \
            and not dc.int8_kv_cache and not head_major
        next_logits, xattn_kv, st = _prefill(
            params, config, dc, policy, input_ids, media_locations,
            attention_mask, visual_features, flat=flat)
        self.logp0 = _log_softmax(next_logits)
        self.vocab = self.logp0.shape[-1]
        if flat:
            # T-major caches (n_layer, T, b, D): beams tile the row axis
            self.kc = st["kc"].repeat_interleave(k, dim=2)
            self.vc = st["vc"].repeat_interleave(k, dim=2)
            self.cache = [{"kf": self.kc[i], "vf": self.vc[i]}
                          for i in range(self.kc.shape[0])]
        else:
            # head-major (b, h, max_len, d): beams tile the batch axis
            self.kc = self.vc = None
            self.cache = [_tile_leaves(layer, k) for layer in st["cache"]]
        del st["cache"], st["kc"], st["vc"]
        xattn_kv = {key: _tile_leaves(kv, k) for key, kv in xattn_kv.items()}
        self.tokens = _tile_beams(st["tokens"], k)
        self.mask = _tile_beams(st["mask"], k)
        self.pos_next = _tile_beams(st["pos_next"], k)
        media_count = _tile_beams(st["media_count"], k)
        self.megakernel = megakernel
        if megakernel:
            self.mega = _mega_prepare(params, config, policy, dc, xattn_kv,
                                      self.mask, media_count)
        else:
            self.hook = flamingo.make_layer_hook(params, config, xattn_kv,
                                                 media_count, policy=policy)

    def logp(self, cur: int, lim: Optional[int], anc: torch.Tensor) -> torch.Tensor:
        """Feed the token at ``cur - 1`` (written into each beam's own cache
        row at ``cur - 1``) -> log-probs for position ``cur``; the gather
        reorder reads no ancestry."""
        prev = self.tokens[:, cur - 1:cur]
        pos = self.pos_next + (cur - 1 - self.L)
        if not self.megakernel:
            logits, _, _ = flamingo.apply_lm(
                self.params, self.config, prev, policy=self.policy,
                layer_hook=self.hook, attention_mask=self.mask,
                position_ids=pos, cache=self.cache, cache_index=cur - 1,
                kv_limit=lim, beam_anc=anc if self.lazy else None)
            return _log_softmax(logits[:, -1])
        h = _mega_hidden(self.params, self.config, self.policy, self.mega,
                         self.kc, self.vc, prev[:, 0], pos[:, 0], cur - 1, lim,
                         beam_anc=anc)
        logits = flamingo.lm_head(self.params, self.config, h[:, None])
        return _log_softmax(logits[:, -1])

    def reorder(self, parent: torch.Tensor, lim: Optional[int]) -> None:
        """The gather reorder: every head-major cache leaf's rows take their
        parents' (b, k) over the slots [0, lim) (all without ``lim``); the
        slots past it are the families' unwritten zeros."""
        if self.lazy:
            return
        b, k = parent.shape
        for layer in self.cache:
            for x in layer.values():
                live = x if lim is None else x[:, :, :lim]
                live.copy_(_gather_beams(live, parent, b, k))


def _limits(dc: DecodeConfig, L: int):
    """(M, segment ends): hypotheses stop at M; with ``prefix_block`` the
    steps run in segments that attend only the live prefix [0, seg_end)."""
    M = _stop(dc, L)
    pb = dc.prefix_block
    seg_ends = ([M] if pb <= 0 else
                sorted(set(list(range(L + 1 + pb, M, pb)) + [M])))
    return M, seg_ends


def _initial_ancestry(b: int, k: int, max_len: int, dev) -> torch.Tensor:
    """Every logical beam owns its own row at every position."""
    own = torch.arange(k, dtype=torch.int32, device=dev)
    return own[None, :, None].expand(b, k, max_len).contiguous()


def beam_impl(params: Params, config: FlamingoConfig, dc: DecodeConfig,
              policy: Policy, input_ids, media_locations, attention_mask,
              visual_features=None, pixel_values=None,
              generator: Optional[torch.Generator] = None):
    """Beam search -> (fin_seq (b, k, max_length) int64, fin_scores (b, k)
    float32): each row's finished pool, sorted by score (slot 0 best). Per
    layer, or through the megakernel with ``dc.megakernel``. Beam-sample
    (``dc.do_sample``) draws its noise from ``generator``; None seeds one
    with 0 on the inputs' device."""
    b, L = input_ids.shape
    k, k2, max_len = dc.num_beams, 2 * dc.num_beams, dc.max_length
    M, seg_ends = _limits(dc, L)
    dec = _Decoder(params, config, dc, policy, input_ids, media_locations,
                   attention_mask, visual_features, pixel_values,
                   megakernel=dc.megakernel)
    V, dev = dec.vocab, input_ids.device
    f32 = torch.float32
    lp_pow, early = dc.length_penalty, bool(dc.early_stopping)
    if dc.do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def processed(logp: torch.Tensor, tokens, mask, cur: int) -> torch.Tensor:
        """The chain on the log-probs; beam-sample's warpers after it."""
        logp = process_logits(logp, dc, tokens, mask, cur, L)
        return warp(logp, dc) if dc.do_sample else logp

    run_scores = torch.full((b, k), NEG, dtype=f32, device=dev)
    run_scores[:, 0] = 0.0
    fin_seq = torch.full((b, k, max_len), dc.pad_token_id, dtype=torch.long,
                         device=dev)
    fin_scores = torch.full((b, k), NEG, dtype=f32, device=dev)
    fin_flags = torch.zeros((b, k), dtype=torch.bool, device=dev)
    heur_unsat = torch.ones((b,), dtype=torch.bool, device=dev)
    top_mask = torch.arange(k2, device=dev) < k              # rank < k
    anc = _initial_ancestry(b, k, max_len, dev)
    own_row = torch.arange(k, dtype=torch.int32, device=dev)

    def step_update(logp: torch.Tensor, cur: int, lim: Optional[int]) -> torch.Tensor:
        """Fill position ``cur`` from per-beam log-probs (b, k, V) -> hits;
        the gather reorder moves the cache's slots [0, lim)."""
        nonlocal run_scores, fin_seq, fin_scores, fin_flags, heur_unsat, anc
        flat = (run_scores[:, :, None] + logp).reshape(b, k * V)
        if dc.do_sample:
            # HF beam-sample: 2k draws without replacement from the flat
            # scores (Gumbel-top-k); the candidates keep their scores
            g = -torch.log(-torch.log(uniform_noise(flat.shape, generator, dev)))
            top_lp, top_idx = select_candidates(flat, k2, g)
        else:
            top_lp, top_idx = select_candidates(flat, k2)       # (b, 2k)
        parent, tok = top_idx // V, top_idx % V
        hits = (tok == dc.eos_token_id) | (cur + 1 >= M)
        cand_seq = _rows(dec.tokens.reshape(b, k, max_len), parent)
        cand_seq[:, :, cur] = tok

        # running refill: the best k candidates that did not finish
        new_run_scores, run_idx = _top_k(top_lp + hits.to(f32) * NEG, k)
        run_parent = parent.gather(1, run_idx)
        run_tok = tok.gather(1, run_idx)
        dec.tokens = _gather_beams(dec.tokens, run_parent, b, k)
        dec.tokens[:, cur] = run_tok.reshape(-1)
        dec.mask[:, cur] = 1
        # lazy: only the ancestry moves; position cur's K/V lands in each
        # beam's own row at the next forward
        anc = _rows(anc, run_parent)
        anc[:, :, cur] = own_row
        dec.reorder(run_parent, lim)

        # finished pool (HF _update_finished_beams)
        just_finished = hits & top_mask
        denom = _pow(cur + 1 - L, lp_pow)
        pen_lp = top_lp / denom
        pool_full = fin_flags.all(dim=-1, keepdim=True) & early
        pen_lp = pen_lp + pool_full.to(f32) * NEG
        pen_lp = pen_lp + (~heur_unsat[:, None]).to(f32) * NEG
        pen_lp = pen_lp + (~just_finished).to(f32) * NEG
        best_sc, best_idx = _top_k(torch.cat([fin_scores, pen_lp], dim=1), k)
        fin_seq = _rows(torch.cat([fin_seq, cand_seq], dim=1), best_idx)
        fin_flags = torch.cat([fin_flags, just_finished], dim=1).gather(1, best_idx)
        fin_scores = best_sc

        # one-way early-stop heuristic (HF _check_early_stop_heuristic)
        best_possible = new_run_scores[:, :1] / denom
        worst_fin = torch.where(fin_flags, fin_scores.amin(dim=1, keepdim=True),
                                torch.full_like(fin_scores, NEG))
        heur_unsat = heur_unsat & (best_possible > worst_fin).any(dim=-1)
        run_scores = new_run_scores
        return hits

    # the prefill's rows are the families' (tiled) rows
    logp0 = processed(dec.logp0, dec.tokens[::k], dec.mask[::k], L)
    hits = step_update(logp0[:, None, :].expand(b, k, V), L,
                       seg_ends[0] if dc.prefix_block > 0 else None)
    cur = L + 1
    for seg_end in seg_ends:
        lim = min(seg_end, max_len) if dc.prefix_block > 0 else None
        while cur < seg_end:
            alive = heur_unsat.any() & ~(fin_flags.all() & early) & ~hits.all()
            if not bool(alive):
                break
            logp = processed(dec.logp(cur, lim, anc), dec.tokens, dec.mask, cur)
            hits = step_update(logp.reshape(b, k, V), cur, lim)
            cur += 1
    return fin_seq, fin_scores


def group_beam_impl(params: Params, config: FlamingoConfig, dc: DecodeConfig,
                    policy: Policy, input_ids, media_locations, attention_mask,
                    visual_features=None, pixel_values=None):
    """Diverse (group) beam search, per layer -> (fin_seq (b, k, max_length),
    fin_scores (b, k)) sorted like ``beam_impl``'s.

    Per step the G groups of kg = k / G beams run in turn: group g's
    log-probs lose ``diversity_penalty`` times the count of each token the
    groups before it chose this step, the logits chain runs on the group's
    rows, then a 2kg-candidate beam update runs
    with the group's own pool of kg. A group freezes once done (pool full
    under early stopping, or HF's is_done test); frozen groups emit pads,
    which still count for later groups. At the end the groups that are not
    done absorb their running beams, and each row returns all pools merged
    and sorted."""
    b, L = input_ids.shape
    k, G = dc.num_beams, dc.num_beam_groups
    kg, max_len = k // G, dc.max_length
    M, seg_ends = _limits(dc, L)
    dec = _Decoder(params, config, dc, policy, input_ids, media_locations,
                   attention_mask, visual_features, pixel_values,
                   megakernel=False)
    V, dev = dec.vocab, input_ids.device
    f32 = torch.float32
    lp_pow, early, dp = dc.length_penalty, bool(dc.early_stopping), dc.diversity_penalty

    # slot 0 of every group starts live (HF: beam_scores[:, ::group_size] = 0)
    run_scores = torch.full((b, G, kg), NEG, dtype=f32, device=dev)
    run_scores[:, :, 0] = 0.0
    fin_seq = torch.full((b, G, kg, max_len), dc.pad_token_id,
                         dtype=torch.long, device=dev)
    fin_scores = torch.full((b, G, kg), NEG, dtype=f32, device=dev)
    fin_flags = torch.zeros((b, G, kg), dtype=torch.bool, device=dev)
    done = torch.zeros((b, G), dtype=torch.bool, device=dev)
    rank2 = torch.arange(2 * kg, device=dev) < kg
    anc = _initial_ancestry(b, k, max_len, dev)
    own_row = torch.arange(k, dtype=torch.int32, device=dev)

    def step(logp: torch.Tensor, cur: int, lim: Optional[int]) -> None:
        """Fill position ``cur`` from (b, k, V) log-probs, group by group;
        the gather reorder moves the cache's slots [0, lim)."""
        nonlocal run_scores, fin_seq, fin_scores, fin_flags, done, anc
        rows4 = dec.tokens.reshape(b, G, kg, max_len)
        mask4 = dec.mask.reshape(b, G, kg, max_len)
        counts = torch.zeros((b, V), dtype=f32, device=dev)
        denom = _pow(cur + 1 - L, lp_pow)
        parents, toks, rs, fseqs, fscs, ffls, dones = [], [], [], [], [], [], []
        for g in range(G):
            done_g = done[:, g, None]
            s = logp[:, g * kg:(g + 1) * kg, :] - dp * counts[:, None, :]
            s = process_logits(s.reshape(b * kg, V), dc,
                               rows4[:, g].reshape(b * kg, max_len),
                               mask4[:, g].reshape(b * kg, max_len), cur, L
                               ).reshape(b, kg, V)
            flat = (run_scores[:, g, :, None] + s).reshape(b, kg * V)
            top_lp, top_idx = select_candidates(flat, 2 * kg)     # (b, 2kg)
            parent, tok = top_idx // V, top_idx % V
            eos_cand = tok == dc.eos_token_id

            # running refill: the best kg non-EOS candidates; frozen groups
            # emit pads from beam 0 with score 0
            new_rs, run_idx = _top_k(top_lp + eos_cand.to(f32) * NEG, kg)
            run_parent = torch.where(done_g, 0, parent.gather(1, run_idx))
            run_tok = torch.where(done_g, dc.pad_token_id, tok.gather(1, run_idx))
            new_rs = torch.where(done_g, 0.0, new_rs)

            # finished pool: EOS candidates ranked < kg, unless the group is done
            just_fin = eos_cand & rank2 & ~done_g
            pen_lp = top_lp / denom + (~just_fin).to(f32) * NEG
            cand_seq = _rows(rows4[:, g], parent)
            cand_seq[:, :, cur] = tok
            best_sc, best_idx = _top_k(torch.cat([fin_scores[:, g], pen_lp], dim=1), kg)
            fseq = _rows(torch.cat([fin_seq[:, g], cand_seq], dim=1), best_idx)
            ffl = torch.cat([fin_flags[:, g], just_fin], dim=1).gather(1, best_idx)

            # HF BeamHypotheses.is_done(next_scores.max(), cur_len)
            pool_full = ffl.all(dim=-1)
            if early:
                done_new = done_g[:, 0] | pool_full
            else:
                highest = top_lp[:, 0] / denom
                done_new = done_g[:, 0] | (pool_full & (best_sc.amin(dim=-1) >= highest))

            # this group's tokens (pads when frozen) count for later groups
            counts.scatter_add_(1, run_tok, torch.ones_like(run_tok, dtype=f32))
            parents.append(g * kg + run_parent)
            toks.append(run_tok)
            rs.append(new_rs)
            fseqs.append(fseq)
            fscs.append(best_sc)
            ffls.append(ffl)
            dones.append(done_new)

        parent_global = torch.cat(parents, dim=1)                 # (b, k)
        dec.tokens = _gather_beams(dec.tokens, parent_global, b, k)
        dec.tokens[:, cur] = torch.cat(toks, dim=1).reshape(-1)
        dec.mask[:, cur] = 1
        anc = _rows(anc, parent_global)
        anc[:, :, cur] = own_row
        dec.reorder(parent_global, lim)
        run_scores = torch.stack(rs, dim=1)
        fin_seq = torch.stack(fseqs, dim=1)
        fin_scores = torch.stack(fscs, dim=1)
        fin_flags = torch.stack(ffls, dim=1)
        done = torch.stack(dones, dim=1)

    step(dec.logp0[:, None, :].expand(b, k, V), L,
         seg_ends[0] if dc.prefix_block > 0 else None)
    cur = L + 1
    for seg_end in seg_ends:
        lim = min(seg_end, max_len) if dc.prefix_block > 0 else None
        while cur < seg_end and cur < M and not bool(done.all()):
            step(dec.logp(cur, lim, anc).reshape(b, k, V), cur, lim)
            cur += 1

    # finalize (BeamSearchScorer.finalize): groups not done absorb their kg
    # running beams, penalised by the final generated length
    run_pen = run_scores / _pow(cur - L, lp_pow) + done[:, :, None].to(f32) * NEG
    rows4 = dec.tokens.reshape(b, G, kg, max_len)
    merged_seq = torch.cat([fin_seq, rows4], dim=2)               # (b, G, 2kg, .)
    best_sc, best_idx = _top_k(torch.cat([fin_scores, run_pen], dim=2), kg)
    fin_seq = torch.gather(merged_seq, 2,
                           best_idx[..., None].expand(-1, -1, -1, max_len))
    # every row: all groups' pools merged, sorted (HF finalize)
    best_sc, best_idx = _top_k(best_sc.reshape(b, G * kg), k)
    return _rows(fin_seq.reshape(b, G * kg, max_len), best_idx), best_sc


def beam_generate(params: Params, config: FlamingoConfig, dc: DecodeConfig,
                  policy: Policy, input_ids, media_locations, attention_mask,
                  visual_features=None, pixel_values=None,
                  generator: Optional[torch.Generator] = None):
    """Beam-search decode -> token ids (b, max_length): prompt, the best
    hypothesis (EOS kept in the sequence), pads; HF's decoded layout. With
    ``dc.num_return_sequences = n`` the top n hypotheses of each row,
    interleaved, (b*n, max_length). With ``dc.return_scores`` also HF's
    ``sequences_scores`` (the length-penalised pool scores), (b,) or (b*n,).
    ``dc.num_beam_groups > 1`` runs diverse beams (per layer);
    ``dc.do_sample`` beam-sample, its noise from ``generator``."""
    nrs = dc.num_return_sequences
    if nrs > dc.num_beams:
        raise ValueError(f"num_return_sequences ({nrs}) must be <= num_beams "
                         f"({dc.num_beams}) for beam search")
    args = (params, config, dc, policy, input_ids, media_locations,
            attention_mask, visual_features, pixel_values)
    fin_seq, scores = (group_beam_impl(*args) if dc.num_beam_groups > 1
                       else beam_impl(*args, generator=generator))
    b, _k, max_len = fin_seq.shape
    seqs = fin_seq[:, :nrs].reshape(b * nrs, max_len)
    if dc.return_scores:
        return seqs, scores[:, :nrs].reshape(b * nrs)
    return seqs


def beam_generate_with_scores(params: Params, config: FlamingoConfig,
                              dc: DecodeConfig, policy: Policy, input_ids,
                              media_locations, attention_mask,
                              visual_features=None, pixel_values=None,
                              generator: Optional[torch.Generator] = None):
    """Like ``beam_generate`` with one sequence per row, and always also
    the length-penalised sequence scores (HF's ``sequences_scores``)."""
    fin_seq, fin_scores = beam_impl(params, config, dc, policy, input_ids,
                                    media_locations, attention_mask,
                                    visual_features, pixel_values, generator)
    return fin_seq[:, 0], fin_scores[:, 0]
