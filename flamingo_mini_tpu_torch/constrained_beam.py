"""Constrained beam search (HF ``force_words_ids``), port of
``flamingo_mini_tpu/constrained_beam.py``, which follows transformers'
``ConstrainedBeamSearchScorer`` and its ``_constrained_beam_search`` loop.

Each step, over the flattened (k x V) scores (the chain on the
``log_softmax``, plus the running beam scores):

* the top 2k candidates; an EOS candidate ranked < k enters the finished
  pool only if its parent beam has completed every constraint, and the k
  best non-EOS candidates are the "topk" candidates;
* advance candidates: for every beam whose constraints are incomplete, one
  per token that advances them (the next trie edge of the constraint in
  progress, or the first token of each pending one), scored from the same
  matrix. Duplicates (same parent sequence and token) are dropped;
* every candidate falls in a bank (its completed constraints times the
  longest phrase, plus its depth in the one in progress); the new k beams
  are taken round-robin across banks from the highest, best first within a
  bank, by HF's key ``banks * 100 + scores`` and a stable sort of the ranks
  within each bank (bit for bit, the quirk of scores below -100 included);
* at the end, running beams enter the pool only if complete; if fewer than
  ``num_return_sequences`` hypotheses were collected, the best incomplete
  beams fill the rest (HF's ``finalize`` fallback).

The constraints are static numpy tables (``ConstraintTables``: one merged
trie per constraint, its edges flattened into arrays); a beam's state is
three int32s (completed bitmask, constraint in progress, trie node). The
cache is the head-major one, tiled over the beams and read through the
lazy ancestry (``ops.attention.attend_beam_lazy``), per layer in plain
torch, as JAX runs it in plain XLA; the megakernel refuses this search.

Deviation from HF, kept from the JAX package: after a constraint in
progress is broken, HF moves it to the end of its pending scan; here the
pending constraints are scanned in their original order. The two differ
only when two incomplete constraints can both advance on the same token
after a reset, and then only in which advances first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .beam_search import (NEG, _Decoder, _gather_beams, _initial_ancestry,
                          _limits, _pow, _rows)
from .configuration_flamingo import FlamingoConfig
from .generation import DecodeConfig, process_logits
from .ops.layers import Policy
from .ops.topk import top_k as _top_k

Params = Dict[str, Any]
Spec = Tuple[Tuple[Tuple[int, ...], ...], ...]


def normalize_force_words(force_words_ids) -> Spec:
    """HF's ``force_words_ids`` (``List[List[int]]`` phrasal constraints,
    ``List[List[List[int]]]`` disjunctive ones, mixed) -> a hashable tuple
    of constraints, each a tuple of alternative phrases."""
    out = []
    for w in force_words_ids:
        if len(w) == 0:
            raise ValueError("force_words_ids entries must be non-empty")
        if isinstance(w[0], (list, tuple)):
            alts = tuple(tuple(int(t) for t in alt) for alt in w)
        else:
            alts = (tuple(int(t) for t in w),)
        for alt in alts:
            if len(alt) == 0 or any(t < 0 for t in alt):
                raise ValueError(f"force_words_ids phrases must be non-empty "
                                 f"positive token ids, got {w}")
        # HF DisjunctiveTrie(no_subsets=True): an alternative that is a
        # prefix of another makes completion ambiguous
        for a in alts:
            for c in alts:
                if a is not c and len(a) <= len(c) and c[:len(a)] == a:
                    raise ValueError(f"force_words_ids disjunctive set {w} has "
                                     "an alternative that is a subset of another")
        out.append(alts)
    return tuple(out)


class ConstraintTables:
    """Merged-trie automaton tables of a constraint spec.

    Nodes are numbered globally, each constraint's root first. Edge arrays
    ``edge_node``, ``edge_tok``, ``edge_next``, ``edge_cidx`` (its
    constraint), ``edge_leaf`` (1 where ``edge_next`` is a leaf),
    ``edge_is_root``, in (constraint, node, insertion) order, the order HF's
    pending scan and trie walk follow. ``node_bank[n]``: HF ``get_bank``'s
    share for standing at node n, ``max_seqlen - seqlen(constraint) +
    depth(n)``. ``full_mask``: every constraint completed."""

    def __init__(self, spec: Spec):
        self.spec = spec
        n_c = len(spec)
        if n_c > 31:
            raise ValueError("at most 31 constraints (an int32 bitmask)")
        seqlens = [max(len(a) for a in alts) for alts in spec]
        self.max_seqlen = max(seqlens)
        edges: List[Tuple[int, int, int, int, int]] = []
        node_bank, roots = [], []
        next_node = 0
        for cidx, alts in enumerate(spec):
            root = next_node
            roots.append(root)
            next_node += 1
            node_bank.append(self.max_seqlen - seqlens[cidx])
            children: Dict[int, Dict[int, int]] = {root: {}}
            for alt in alts:
                cur = root
                for depth, tok in enumerate(alt):
                    if tok in children.setdefault(cur, {}):
                        cur = children[cur][tok]
                    else:
                        children[cur][tok] = next_node
                        node_bank.append(self.max_seqlen - seqlens[cidx] + depth + 1)
                        cur = next_node
                        next_node += 1
            leaves = {n for n in range(root, next_node) if not children.get(n)}
            for node in range(root, next_node):
                for tok, nxt in children.get(node, {}).items():
                    edges.append((node, tok, nxt, cidx, int(nxt in leaves)))
        self.n_constraints = n_c
        self.n_nodes = next_node
        self.full_mask = (1 << n_c) - 1
        self.roots = np.asarray(roots, np.int32)
        e = np.asarray(edges, np.int32).reshape(-1, 5)
        self.edge_node, self.edge_tok, self.edge_next, self.edge_cidx, \
            self.edge_leaf = (e[:, i] for i in range(5))
        self.edge_is_root = np.isin(self.edge_node, self.roots)
        self.node_bank = np.asarray(node_bank, np.int32)
        self.n_edges = len(edges)
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The tables as tensors on ``device`` (made once per device)."""
        device = torch.device(device)
        if device not in self._on:
            arrays = dict(node=self.edge_node, tok=self.edge_tok,
                          next=self.edge_next, cidx=self.edge_cidx,
                          leaf=self.edge_leaf, is_root=self.edge_is_root,
                          bit=np.left_shift(1, self.edge_cidx).astype(np.int32),
                          bank=self.node_bank)
            self._on[device] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                for k, v in arrays.items()}
        return self._on[device]


def _state_add_token(tab: ConstraintTables, mask, cidx, node, tok):
    """HF's ``ConstraintListState.add(tok)`` over (...,) state tensors ->
    (mask', cidx', node'). A constraint in progress steps or completes on a
    matching trie edge, or resets (the breaking token is not tried on other
    constraints); with none in progress, the first pending constraint whose
    root takes ``tok`` steps (original order: module docstring)."""
    t = tab.on(mask.device)
    full = mask == tab.full_mask
    tokx = tok[..., None]
    m_prog = (t["node"] == node[..., None]) & (t["tok"] == tokx)
    pending_ok = ((mask[..., None] >> t["cidx"]) & 1) == 0
    m_pend = t["is_root"] & (t["tok"] == tokx) & pending_ok
    inprog = cidx >= 0
    # argmax: the first matching edge (0 where none matches)
    e_sel = torch.where(inprog, m_prog.to(torch.int32).argmax(dim=-1),
                        m_pend.to(torch.int32).argmax(dim=-1))
    stepped = torch.where(inprog, m_prog.any(dim=-1), m_pend.any(dim=-1))
    leaf = t["leaf"][e_sel] == 1
    minus1 = torch.full_like(cidx, -1)
    mask_n = torch.where(~full & stepped & leaf, mask | t["bit"][e_sel], mask)
    moved = stepped & ~leaf
    cidx_n = torch.where(full, cidx, torch.where(
        moved, t["cidx"][e_sel], torch.where(inprog | stepped, minus1, cidx)))
    node_n = torch.where(full, node, torch.where(
        moved, t["next"][e_sel], torch.where(inprog | stepped, minus1, node)))
    return mask_n, cidx_n, node_n


def _popcount(x: torch.Tensor) -> torch.Tensor:
    c = torch.zeros_like(x)
    for i in range(31):
        c = c + ((x >> i) & 1)
    return c


def _state_bank(tab: ConstraintTables, mask, cidx, node) -> torch.Tensor:
    """HF's ``ConstraintListState.get_bank``."""
    add = torch.where(cidx >= 0, tab.on(mask.device)["bank"][node.clamp(min=0)], 0)
    return _popcount(mask) * tab.max_seqlen + add


def constrained_beam_impl(params: Params, config: FlamingoConfig,
                          dc: DecodeConfig, policy: Policy, spec: Spec,
                          input_ids, media_locations, attention_mask,
                          visual_features=None, pixel_values=None):
    """Constrained beam search -> (fin_seq (b, k, max_length) int64,
    fin_scores (b, k) float32, complete (b, k) bool: the hypothesis holds
    every constraint; False only for the finalize fallback's picks), each
    row's pool sorted by score."""
    tab = ConstraintTables(spec)
    E = tab.n_edges
    b, L = input_ids.shape
    k, k2, max_len = dc.num_beams, 2 * dc.num_beams, dc.max_length
    C = k + k * E                              # candidate slots a row
    M, seg_ends = _limits(dc, L)
    dec = _Decoder(params, config, dc, policy, input_ids, media_locations,
                   attention_mask, visual_features, pixel_values,
                   megakernel=False, head_major=True)
    V, dev = dec.vocab, input_ids.device
    f32, i32 = torch.float32, torch.int32
    lp_pow, early = dc.length_penalty, bool(dc.early_stopping)
    t = tab.on(dev)
    edge_tok = t["tok"].long()

    run_scores = torch.full((b, k), NEG, dtype=f32, device=dev)
    run_scores[:, 0] = 0.0
    fin_seq = torch.full((b, k, max_len), dc.pad_token_id, dtype=torch.long,
                         device=dev)
    fin_scores = torch.full((b, k), NEG, dtype=f32, device=dev)
    fin_flags = torch.zeros((b, k), dtype=torch.bool, device=dev)
    heur_unsat = torch.ones((b,), dtype=torch.bool, device=dev)
    top_mask = torch.arange(k2, device=dev) < k
    # each beam's constraint state: the prompt advances nothing (HF starts
    # fresh states at decoding)
    c_mask = torch.zeros((b, k), dtype=i32, device=dev)
    c_cidx = torch.full((b, k), -1, dtype=i32, device=dev)
    c_node = torch.full((b, k), -1, dtype=i32, device=dev)
    anc = _initial_ancestry(b, k, max_len, dev)
    own_row = torch.arange(k, dtype=i32, device=dev)
    beam_of = torch.arange(k, device=dev)[None, :, None].expand(b, k, E).reshape(b, k * E)
    # (E, E) [e, f]: edge f is dropped where a later edge e of its beam with
    # the same token is valid (JAX's tril(k=-1) einsum)
    pos_e = torch.arange(E, device=dev)
    later_same = (edge_tok[:, None] == edge_tok[None, :]) & (pos_e[None, :] < pos_e[:, None])
    pos_k = torch.arange(k, device=dev)
    earlier_beam = pos_k[None, :] < pos_k[:, None]           # [i, j]: j < i
    pos_c = torch.arange(C, device=dev)
    before = pos_c[None, :] < pos_c[:, None]                 # [i, j]: j < i

    def step_update(logp: torch.Tensor, cur: int) -> torch.Tensor:
        """Fill position ``cur`` from per-beam log-probs (b, k, V): the
        top 2k and the advance candidates, refilled round-robin by bank
        (HF ``process`` + ``step_sentence_constraint``) -> hits."""
        nonlocal run_scores, fin_seq, fin_scores, fin_flags, heur_unsat, anc
        nonlocal c_mask, c_cidx, c_node
        flat = (run_scores[:, :, None] + logp).reshape(b, k * V)
        top_lp, top_idx = _top_k(flat, k2)                  # (b, 2k)
        parent, tok = top_idx // V, top_idx % V
        hits = tok == dc.eos_token_id
        rows = dec.tokens.reshape(b, k, max_len)

        # finished pool: EOS candidates ranked < k whose parent completed
        # every constraint (HF checks the sequence without the EOS)
        cand_seq = _rows(rows, parent)
        cand_seq[:, :, cur] = tok
        just_finished = hits & top_mask & (c_mask.gather(1, parent) == tab.full_mask)
        denom = _pow(cur + 1 - L, lp_pow)
        pen_lp = top_lp / denom
        pool_full = fin_flags.all(dim=-1, keepdim=True) & early
        pen_lp = pen_lp + pool_full.to(f32) * NEG
        pen_lp = pen_lp + (~heur_unsat[:, None]).to(f32) * NEG
        pen_lp = pen_lp + (~just_finished).to(f32) * NEG
        best_sc, best_idx = _top_k(torch.cat([fin_scores, pen_lp], dim=1), k)
        fin_seq_n = _rows(torch.cat([fin_seq, cand_seq], dim=1), best_idx)
        fin_flags_n = torch.cat([fin_flags, just_finished], dim=1).gather(1, best_idx)

        # the k best non-EOS candidates ("topk") and their advanced states
        topk_sc, run_idx = _top_k(top_lp + hits.to(f32) * NEG, k)
        topk_parent, topk_tok = parent.gather(1, run_idx), tok.gather(1, run_idx)
        topk_valid = topk_sc > NEG / 2
        tm, tc, tn = _state_add_token(
            tab, c_mask.gather(1, topk_parent), c_cidx.gather(1, topk_parent),
            c_node.gather(1, topk_parent), topk_tok.to(i32))

        # advance candidates (beam i, edge e): the edge continues beam i's
        # node in progress, or roots a pending constraint when none is
        inprog = c_cidx >= 0
        e_ok_prog = t["node"] == c_node[:, :, None]
        pending_ok = ((c_mask[:, :, None] >> t["cidx"]) & 1) == 0
        adv_valid = torch.where(inprog[:, :, None], e_ok_prog,
                                t["is_root"] & pending_ok)
        adv_valid = adv_valid & (c_mask != tab.full_mask)[:, :, None]
        # duplicates: the same token within a beam ...
        adv_valid = adv_valid & ~(adv_valid[:, :, :, None] & later_same).any(dim=2)
        # ... the same sequence on an earlier beam with that edge valid ...
        row_eq = (rows[:, :, None, :] == rows[:, None, :, :]).all(dim=-1)
        adv_valid = adv_valid & ~((row_eq & earlier_beam)[:, :, :, None]
                                  & adv_valid[:, None, :, :]).any(dim=2)
        # ... and a topk candidate with the same parent sequence and token
        topk_rows = _rows(rows, topk_parent)
        topk_row_eq = (rows[:, :, None, :] == topk_rows[:, None, :, :]).all(dim=-1)
        tok_eq = edge_tok[None, None, :, None] == topk_tok[:, None, None, :]
        adv_valid = adv_valid & ~(topk_row_eq[:, :, None, :] & tok_eq
                                  & topk_valid[:, None, None, :]).any(dim=-1)
        adv_sc = flat.reshape(b, k, V).gather(2, edge_tok.expand(b, k, E))
        adv_sc = torch.where(adv_valid, adv_sc, NEG)
        am, ac, an = _state_add_token(
            tab, c_mask[:, :, None].expand(b, k, E), c_cidx[:, :, None].expand(b, k, E),
            c_node[:, :, None].expand(b, k, E), t["tok"].expand(b, k, E))

        # every candidate (C = k + k*E slots), refilled round-robin by bank
        cand_sc = torch.cat([topk_sc, adv_sc.reshape(b, k * E)], dim=1)
        cand_tok = torch.cat([topk_tok, edge_tok.expand(b, k, E).reshape(b, k * E)], dim=1)
        cand_parent = torch.cat([topk_parent, beam_of], dim=1)
        cand_m = torch.cat([tm, am.reshape(b, k * E)], dim=1)
        cand_c = torch.cat([tc, ac.reshape(b, k * E)], dim=1)
        cand_n = torch.cat([tn, an.reshape(b, k * E)], dim=1)
        cand_valid = torch.cat([topk_valid, adv_valid.reshape(b, k * E)], dim=1)
        banks = _state_bank(tab, cand_m, cand_c, cand_n)        # (b, C)
        # HF: zipped = banks * 100 + scores sorted descending, then a stable
        # sort by rank within the bank
        zipped = torch.where(cand_valid, banks.to(f32) * 100.0 + cand_sc, NEG)
        order = torch.sort(-zipped, dim=1, stable=True).indices
        sorted_banks = torch.where(cand_valid, banks, -1).gather(1, order)
        increments = ((sorted_banks[:, :, None] == sorted_banks[:, None, :])
                      & before).sum(dim=2)
        increments = torch.where(cand_valid.gather(1, order), increments,
                                 C + pos_c[None, :])
        rearr = torch.sort(increments, dim=1, stable=True).indices
        pick = order.gather(1, rearr)[:, :k]                    # (b, k)

        new_run_scores = cand_sc.gather(1, pick)
        run_parent = cand_parent.gather(1, pick)
        c_mask, c_cidx, c_node = (x.gather(1, pick) for x in (cand_m, cand_c, cand_n))
        dec.tokens = _gather_beams(dec.tokens, run_parent, b, k)
        dec.tokens[:, cur] = cand_tok.gather(1, pick).reshape(-1)
        dec.mask[:, cur] = 1
        anc = _rows(anc, run_parent)
        anc[:, :, cur] = own_row

        # one-way early-stop heuristic (as beam_search.beam_impl's)
        best_possible = new_run_scores[:, :1] / denom
        worst_fin = torch.where(fin_flags_n, best_sc.amin(dim=1, keepdim=True),
                                torch.full_like(best_sc, NEG))
        heur_unsat = heur_unsat & (best_possible > worst_fin).any(dim=-1)
        run_scores, fin_seq, fin_scores, fin_flags = (new_run_scores, fin_seq_n,
                                                      best_sc, fin_flags_n)
        return hits

    logp0 = process_logits(dec.logp0, dc, dec.tokens[::k], dec.mask[::k], L, L)
    hits = step_update(logp0[:, None, :].expand(b, k, V), L)
    cur = L + 1
    for seg_end in seg_ends:
        lim = min(seg_end, max_len) if dc.prefix_block > 0 else None
        while cur < seg_end:
            alive = heur_unsat.any() & ~(fin_flags.all() & early) & ~hits.all()
            if not bool(alive):
                break
            logp = process_logits(dec.logp(cur, lim, anc), dc, dec.tokens,
                                  dec.mask, cur, L)
            hits = step_update(logp.reshape(b, k, V), cur)
            cur += 1

    # finalize: running beams enter the pool where complete; a pool short
    # of num_return_sequences takes the best incomplete beams, ranked after
    # every genuine hypothesis by an offset (HF's finalize fallback)
    run_pen = run_scores / _pow(cur - L, lp_pow)
    run_complete = c_mask == tab.full_mask
    merged_seq = torch.cat([fin_seq, dec.tokens.reshape(b, k, max_len)], dim=1)
    merged_fl = torch.cat([fin_flags, run_complete], dim=1)
    neg = torch.full((b, k), NEG, dtype=f32, device=dev)
    main_sc = torch.cat([fin_scores, torch.where(run_complete, run_pen, neg)], dim=1)
    n_valid = (main_sc > NEG / 2).to(i32).sum(dim=1, keepdim=True)
    fb_sc = torch.where(run_complete, neg, run_pen - 1.0e7)
    fb_sc = torch.where(n_valid >= max(dc.num_return_sequences, 1), NEG,
                        torch.cat([neg, fb_sc], dim=1))
    best_sc, best_idx = _top_k(torch.maximum(main_sc, fb_sc), k)
    # the true (unoffset) scores of fallback picks
    best_true = torch.cat([fin_scores, run_pen], dim=1).gather(1, best_idx)
    best_sc = torch.where(best_sc <= NEG / 2, best_sc, best_true)
    return _rows(merged_seq, best_idx), best_sc, merged_fl.gather(1, best_idx)


def constrained_beam_generate(params: Params, config: FlamingoConfig,
                              dc: DecodeConfig, policy: Policy, input_ids,
                              media_locations, attention_mask,
                              visual_features=None, pixel_values=None):
    """HF ``generate(force_words_ids=...)``: token ids laid out as
    ``beam_search.beam_generate``'s (the best hypothesis a row, or the top
    ``num_return_sequences`` interleaved); with ``dc.return_scores`` also
    the length-penalised sequence scores."""
    nrs = dc.num_return_sequences
    if nrs > dc.num_beams:
        raise ValueError(f"num_return_sequences ({nrs}) must be <= num_beams "
                         f"({dc.num_beams}) for beam search")
    fin_seq, scores, _complete = constrained_beam_impl(
        params, config, dc, policy, normalize_force_words(dc.force_words_ids),
        input_ids, media_locations, attention_mask, visual_features, pixel_values)
    b, _k, max_len = fin_seq.shape
    seqs = fin_seq[:, :nrs].reshape(b * nrs, max_len)
    if dc.return_scores:
        return seqs, scores[:, :nrs].reshape(b * nrs)
    return seqs
