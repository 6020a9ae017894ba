#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``flamingo_mini_tpu_torch`` through both of its decode paths, greedy
(with and without HF's logits processors and scores), top-k sampling,
beam search and beam-sample, constrained beams and contrastive search, the
megakernel's w8a8 tier, the ``use_pallas``
configuration's generate, the uncached forward with its loss, and training
(``flamingo_mini_tpu_torch.train``), for
flamingo-mini (GPT-2-medium) and for OPT-1.3B, opt-350m and OPT-125m trunks and
OPT-2.7B and OPT-6.7B (heads 80 and 128 wide) at full width and depth, the
stream probe and the in-situ decode and head probes, and checks them:

1. device and build: prints the card's name and power limit (nvidia-smi)
   and builds the hand-written kernels from ``flamingo_mini_tpu_torch/csrc``
   (one nvcc per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: ``decode_attention`` at b=32, D=1024, H=16, T=192
   (left-padded rows, several ``cur`` and ``kv_limit``, bf16 and float32;
   then its edges: kv_limit 1, 63, 64, 65, 127, 128, 129 and 192 under the
   layout ``plan()`` picks, and layouts of 2, 3 and 8 splits at 129, each
   with the live prefix ending on both sides of every split boundary, a
   row whose [npad, cur] is empty and one whose first split is masked,
   printing the worst error and where it lies),
   ``lm_head_argmax`` at B=32, D=1024, V=50258 (padded to 51200), with
   exact ties planted across tiles, across one warpgroup's rounds and
   across two blocks' shares of its persistent grid, and again with
   n_valid on a tile's edge, the same checks at D=1040 (a K tail) and
   D=8192 (hidden rows staged in K-slices), and ``decode_step_megakernel`` at
   D=1024, H=16, XI=512, 64 latents, T=192: b in {1, 3, 32}, a left-padded
   row, a row with text_time 0, several ``cur``/``kv_limit``, xattn every
   layer and every other layer, 1 and 2 layers (2 bf16 ulps at the
   output's scale, hidden row and every layer's written K/V row) and 24
   layers (normwise relative error <= 1e-2: roundings compound over
   layers). The beam kernels: ``decode_attention_beam`` at 96 rows (32
   families of 3), D=1024, H=16, T=128, a random valid ancestry table of 68
   slots, left-padded families, several ``cur``/``kv_limit`` (one where some
   rows attend nothing, one past the table), bf16 and float32, and the
   same edges as ``decode_attention``'s at 96 and 160 rows (families of 3
   and 5; split layouts at kv_limit 68); both at the same edges at the
   test-scale models' head widths 16 and 32 (8 rows, or 4 families of 3, 4
   heads), and at width 96, which they do not take, each must raise; the
   megakernel's beam mode at 1 and 2 layers and 3, 24, 96 and 160 rows
   (families of 3, 3, 3, 5) at 2 bf16 ulps, and at 24 layers and 96 rows
   under the normwise rule, with its grid at 96 and 160 rows. The
   megakernel's OPT mode at OPT-1.3B width (D=2048, 32 heads, ffn 8192,
   XI=512, xattn before every other layer, a 128-slot cache): 1 and 2
   layers, b in {1, 3, 8, 32}, at 2 bf16 ulps, printing where the largest
   error lies, and the same cases with GELU in place of ReLU (printed, not
   held to a limit); 24 layers at b=8 under the normwise rule; its grid at
   b=8 and 32. The weight-only megakernel also at BASELINE's other
   widths: flamingo-tiny's D=768 (12 heads) over 64 and 256 media latents
   and D=1024 over 256 (four images, text_time 0-4), 1-2 layers, b in {1,
   3, 8, 32}, at 2 bf16 ulps, printing where the largest error lies; 12
   layers at b=32 and 24 layers at b=8 over 256 latents under the normwise
   rule, each timed. ``decode_attention`` and
   ``lm_head_argmax`` also at OPT-1.3B's shapes (b=8, D=2048, 32 heads,
   T=128; V=50273 padded to 51200). Each kernel is
   timed beside its plain version and its bound, ``decode_attention`` also
   beside ``scaled_dot_product_attention`` and ``decode_attention_beam``
   beside one SDPA call over each family's 3 x T keys under the ancestry as
   a boolean mask. The attention kernels of ``use_pallas``:
   ``fused_attention`` at the ViT (32, 16, 257, 64), resampler (32, 8, 64
   queries, 321 keys), ViT-B/32 (32, 12, 50, 64), 8-frame resampler (8, 8,
   64 queries, 464 keys) and causal GPT-2 and OPT-1.3B forward (8, 16 or 32,
   64, 64) shapes, the last two with two rows left-padded by 8 (fully
   masked pad queries); its
   streaming kernel ``flash_attention`` at (2, 16, 4000, 64) (keys padded to
   4096), causal and not, a left-padded row; ``fused_media_xattn`` (bf16 on
   its Hopper kernel, float32 on the mma.sync tile) at the prefill (32, 8,
   4 tokens, 64 keys), forward (8, 8, 64, 64), two-image (8, 8, 64, 128)
   and four-image (8, 8, 64, 256; BASELINE config 4's prefill) shapes, at 5 and 17 tokens over two images and at 40 tokens over 13
   and 20 images (832 and 1,280 keys: the bf16 kernel streams), under each
   ``MEDIA_MIXES`` mix (text_time 0, each image and past the media count;
   a 16-row slice spanning two media; a slice all 0; every row past the
   media count; the timed mix), one launch a call, rows with text_time 0
   exactly 0, rows past the media count the mean of V, two calls
   bit-equal, printing the worst error and where it lies; float32
   within 1e-5 of the output's scale, bf16 within 2 bf16 ulps; each timed
   beside its plain version, SDPA (for the media kernel under the media
   mask as a boolean mask, without the zeroing; at each media shape, two
   images with text_time 1 then 2, and also with L2 clean) and its bound,
   and beside its wrapper's host time per call (``host_us``). The bf16
   calls of the first two run the Hopper tile (``csrc/attention_sm90.cuh``), also held
   at its edges: n_kv in {1, 63, 64, 65, 127, 128, 129, 257} by n_q in
   {1, 65, 129, 257}, each plain (strided and contiguous inputs), causal
   with a left-padded row and with a bias; back-to-back calls of five
   shapes on one stream before one synchronize; streaming at 3000 keys,
   causal with a left-padded row. Phase 1 prints the kernels' registers and
   spills (``-Xptxas -v``) and requires wgmma (``HGMMA`` bf16, ``IGMMA``
   int8) and ``UTMALDG`` in the SASS (``cuobjdump -sass``, where the
   toolkit has it) of the attention tile, both megakernel modes (``IGMMA``
   in the w8a8 mode), the w8a8 linear alone and the head. The
   megakernel's w8a8 mode (``act_quant``, the same Hopper kernel): its
   linear alone (``lin_w8a8``, the kernel's machinery with a one-linear
   schedule) bitwise against the plain version
   at ``W8A8_LINEAR``'s shapes, b in {1, 3, 8, 32}, a zero row and .5
   rounding boundaries planted; the whole step at 1-2 layers (greedy b in
   {1, 3, 32}, beams at 96 and 160 rows, OPT-1.3B width b in {3, 8}) and
   at 24 layers (greedy b=32, beams 96 rows, OPT-1.3B b=8) under the
   normwise rule below, printing where the largest error lies, each 24
   layer case timed beside its plain version and bound (OPT-1.3B also
   beside the weight-only mode on the same inputs), its grid printed,
   and the 1-2 layer cases also bit for bit; then at the weight-only
   mode's edge rows (2 layers, D=1024), back to back and on two streams,
   each bit for bit the plain version, and twice bit-equal. The refusal:
   on a D=8192 trunk (wider than the kernel's LayerNorm holds in
   registers) a w8a8 greedy call, w8a8 beams and a weight-only greedy
   call each raise ``ValueError`` before vision and prefill, launching
   nothing; at D=4096 both modes pass the check at 27 to 2,048 rows
   (``D4096_ROWS``). The
   weight-only mode's Hopper kernel (``csrc/decode_megakernel_sm90.cuh``)
   at its edges: its grid barrier alone (every block's stamps read back
   after each of 2,000 barriers), the step at 2 layers, D=1024, xattn
   every 1 and 2 layers, rows b in {1, 3, 8, 9, 31, 32, 33, 64, 65, 256, 257}, (cur,
   kv_limit) in {(0, 1) with left-padded rows, (35, 36), (131, 132)}, and
   at D=2048 (OPT mode) b in {9, 33}, each within 2 bf16 ulps, printing
   the largest error and where; two launches on the same inputs bit-equal
   (greedy b=32, beams 96 rows, OPT-1.3B b=8); four shapes launched back to
   back on one stream before one synchronize, each against its plain
   version. The decode stream probes'
   kernels (``attn_stream_only``, ``tmajor_stream``, ``packed_stream``)
   at the probe's shape (b=32, D=1024, T=192, random caches from a seed):
   ``block_t`` 16 and 32, ``block_b`` 32 and 8, kv_limit 128 and 100 (a
   multiple of neither), bit for bit against their plain versions (which
   sum in the kernels' order); each timed at kv_limit 128 beside its plain
   version, its bound (16.78 MB at 3.35 TB/s) and, as a rate reference,
   ``torch.sum(dim=0)`` over 16.78 MB. Then the kernels taken at head
   widths 80 and 128 (``phase2_wide_heads``) at OPT-2.7B's and OPT-6.7B's
   shapes (b=8, 32 heads, T=128): ``decode_attention`` and
   ``decode_attention_beam`` (24 rows in families of 3) at their edges in
   both dtypes, ``fused_attention`` at the trunk's prefill and forward and
   the Hopper tile's edges, ``flash_attention`` at 4,000 keys, and the
   megakernel's OPT mode at 1 and 2 layers, greedy and beams, weight-only
   at 2 bf16 ulps and w8a8 bit for bit;
3. greedy captioning end to end through ``FlamingoModel.generate`` at the
   full width of flamingo-mini (GPT-2-medium with gated xattn before every
   layer, CLIP ViT-L/14) at 12 of its 24 layers (``MINI_LAYERS``, the first
   12 of the seeded 24-layer model: the depth cut that keeps the script
   inside its time limit; the forward, scoring and the constrained-search
   check run all 24), random weights from a fixed seed, int8 trunk and
   xattn, bf16, batch 32, one image + 4-token prompt, 128 new tokens,
   ``prefix_block=32``, EOS unreachable; first per layer (``megakernel``
   off), then with the whole-step megakernel. Each path's launch counts are
   set to 0 before it and read after it. Each path is compared with the
   same program run through the plain versions, and the megakernel path
   with the per-layer path, up to each row's first near-tie (the reference
   run's top-2 logit gap <= 8 bf16 ulps there). Then the logits chain on
   the megakernel, greedy at b=32 with ``no_repeat_ngram_size=3`` and
   ``repetition_penalty=1.2`` (127 ``decode_step_megakernel``, 0
   ``lm_head_argmax``: the full head and the chain run; tokens against the
   plain-version run under the near-tie rule, on the processed logits; no
   row repeats a 3-gram), and with ``return_scores`` and ``output_scores``
   (the same counts; the per-step scores summed within 1e-3 relative of the
   sequence scores; tokens against the plain fused-head greedy run under
   its near-tie rule). Then beam search on both
   paths: ``num_beams=3``, 64 new tokens, ``length_penalty=1.0``,
   ``early_stopping``, the lazy reorder; launch counts (per layer: 12 x 63
   ``decode_attention_beam``, every other kernel 0; megakernel: 63
   ``decode_step_megakernel``, every other 0), output (32, 68) with the
   prompts intact. Beam near-tie rule: rows agree up to the first step where
   the two runs' chosen candidates differ (the top 3 as a set; at the last
   step also the best), where the reference run's gap between its 3rd and
   4th candidate scores (at the last step: 1st and 2nd) is <= 8 bf16 ulps
   of the score. Then the KV-cache variants per layer, in plain torch as in
   the JAX package (no kernel launches): greedy over the head-major bf16
   cache (``flat_kv_cache=False``) against the flat cache's per-layer run
   under the near-tie rule; over the int8 cache (``int8_kv_cache``), its
   prefill logits within JAX's envelope (0.05 x absmax + 0.05) of the bf16
   head-major cache's and its tokens' agreement printed (another numerics
   tier); beams with ``beam_reorder="gather"`` and lazily over the
   head-major cache, each against the flat cache's lazy beams under the
   beam near-tie rule. Then ``use_pallas`` (the same weights): the megakernel
   generate with the ViT, the resampler and the xattn prefill on the
   attention kernels, launch counts exactly ``fused_attention`` 30,
   ``fused_media_xattn`` 12, ``decode_step_megakernel`` 127,
   ``lm_head_argmax`` 127 and every other 0, tokens compared with the
   plain-version run and with the use_pallas=False run (near-ties as above,
   the prefill's pick included). Last the uncached forward with its loss
   (bf16 weights, not quantized; batch 8 x 64, one image per row at its
   first real token, rows 0 and 1 left-padded by 8): ``fused_attention`` 54
   and ``fused_media_xattn`` 24 launches and nothing else; logits (all
   rows, and the left-padded rows) and loss within max(1e-2, 1.25 x the
   plain version's CPU-vs-card spread) of the plain-version run; the same
   forward under ``torch.inference_mode()`` within 1e-3 of it, normwise. The w8a8
   tier on the same weights: greedy b=32 (127 ``decode_step_megakernel``,
   127 ``lm_head_argmax``, every other 0; tokens against the plain-version
   w8a8 run under the near-tie rule), an odd batch of 3 on the kernel (its
   tokens against the same rows at b=32), beams 3 x 64 on the megakernel
   (63 ``decode_step_megakernel`` and nothing else, against the plain
   version); each run's agreement with its weight-only run printed, not
   held (another numerics tier).
   OPT-1.3B at 12 of its 24 layers (``CUT_LAYERS``; BASELINE config 3's
   widths: ViT-L/14, xattn every other
   layer, int8 trunk and xattn, bf16, batch 8, one image + 8-token prompt
   with rows 0 and 1 left-padded by 2, 64 new tokens, ``prefix_block=32``,
   EOS unreachable; ``trunk_cells``), greedy per layer (12 x 63
   ``decode_attention``, 63 ``lm_head_argmax``) and on the megakernel (63
   ``decode_step_megakernel``, 63 ``lm_head_argmax``), each against its
   plain-version run and the two paths against each other (near-ties as
   above), every launch at the trunk's head width; config 3 as written, ``do_sample=True, top_k=50`` on the
   megakernel with a seeded ``torch.Generator`` (63
   ``decode_step_megakernel``, 0 ``lm_head_argmax``, every other 0;
   every token in its own run's top 50; tokens against the plain-version
   run under the same seed up to each row's first near-tie: the
   reference's top two of the warped logits plus the Gumbel noise within 8
   bf16 ulps, or a pick within 8 bf16 ulps of the top-50 cut of the run
   that dropped it (random OPT-1.3B logits are flat, about 4 at the top,
   and bf16 ties at the 50th are common); up to that point every token in
   the reference run's top 50; two runs with one seed bit-equal, two seeds
   different); w8a8 on the
   megakernel (63 + 63, against its plain-version
   run; agreement with the weight-only run printed); beams per layer and on
   the megakernel (3 beams, 32 new tokens: 12 x 31 ``decode_attention_beam``
   or 31 ``decode_step_megakernel`` and nothing else, output (8, 40), each
   against its plain-version run, and the two paths against each other);
   the use_pallas forward (42 ``fused_attention``, each at its tower's head
   width, 6 ``fused_media_xattn``, the forward rule). opt-350m at 12 of its 24
   layers (post-norm with
   project_in/out): per layer, 16 new tokens, batch 8, against the
   plain-version run; ``megakernel=True`` must raise ``ValueError``.
   OPT-2.7B and OPT-6.7B at full width and all 32 layers (``WIDE``, the
   configuration's presets; heads 80 and 128 wide) through the same
   ``trunk_cells`` on the same traffic, the megakernel paths held to the
   plain program over their first ``WIDE_PLAIN_NEW`` tokens and the
   forward's logits within ``WIDE_FWD_LIMIT`` of the plain program on the
   card (no CPU run), each model freed before the next;
   BASELINE configs 1, 4 and 5 (``BASELINE_CELLS``, bench_extended.py's
   programs, random weights, int8 weight-only in bf16, ``prefix_block=32``):
   flamingo-tiny greedy at b=32 over one image and a 4-token prompt, 64 new
   tokens; flamingo-mini (12 layers) at b=8 over four images at 16-token steps of a
   64-token prompt, 32 new tokens (256 media latents a row); flamingo-tiny
   with ``resampler_num_time_embeds=8`` at b=8 over one 8-frame clip, 32 new
   tokens. Each per layer and on the megakernel, with use_pallas off and
   on: launch counts exact (``decode_attention`` 12 a step or
   ``decode_step_megakernel`` 1, ``lm_head_argmax`` 1; under use_pallas
   also ``fused_attention`` once per ViT and resampler layer and
   ``fused_media_xattn`` once per xattn layer), tokens against
   plain-version runs, the megakernel against per layer and use_pallas
   against use_pallas=False, under the near-tie rule. Then the rest of
   search on the same flamingo-mini (12 layers; the constrained beams'
   check on all 24): beam-sample (3 beams, temperature
   0.7, top-k 50, 64 new tokens, a seeded CUDA generator) per layer (12 x
   63 ``decode_attention_beam``, every other 0) and on the megakernel (63
   ``decode_step_megakernel``, every other 0), each against its
   plain-version run under the same seed and the two paths against each
   other (``compare_sampled_beams``: every kept candidate in its step's
   warped support; rows equal up to the first decision that parts them, a
   near-tie of either run within 8 bf16 ulps of the value on the noisy
   keys or the scores, or a candidate at its run's top-k cut), one seed
   bit-equal twice and another seed different; constrained beams (3 beams,
   32 new tokens, a 3-token phrase and a set of two 2-token alternatives)
   and contrastive search (``penalty_alpha`` 0.6 over 4 candidates, 32 new
   tokens) per layer over the head-major cache, no launch of the port's
   kernels (plain attention and the full head, as in JAX): every
   hypothesis flagged complete holds the phrase and one alternative after
   the prompt (the complete rows counted), contrastive twice bit-equal and
   at ``penalty_alpha`` 0 against greedy over the head-major cache under
   the near-tie rule. Then SMALL's float32 shape (tests/test_torch_beam.py's
   small model, TF32 off) on the card against the CPU, same weights and
   noise: ``torch.sort(stable=True)`` over rows full of ties, beam-sample
   per layer at top-k 1 (ties at finfo.min) and at temperature 0.7, top-k
   20 (``compare_sampled_beams``), constrained and contrastive search
   identical. Then the public entry point (``entry_point_cells``): a
   seeded synthetic GPT-2-sized vocabulary (``synthetic_vocab``: the 256
   byte symbols, 50,000 merges, ``<|endoftext|>`` at 50,256, loaded by
   ``BPETokenizer.gpt2`` so ``<EOC>`` is 50,257) behind a
   ``FlamingoProcessor`` on the card; captions of 32 seeded uint8 images
   of mixed sizes (two grayscale) through
   ``FlamingoModel.generate_captions`` at flamingo-mini width, prompt
   ``"<image>A picture of"``, 128 new tokens, EOS unreachable, on the
   megakernel, per layer and with use_pallas on the megakernel, launches
   exact, the tokens bit-equal to ``generate`` on the processor's own
   ids, media and pixels, the card's pixels within 1e-4 of the same
   function on the CPU, each caption its row's decode with the tags
   removed; BASELINE config 1 via ``from_pretrained`` (flamingo-tiny
   seeded in float32, saved in both layouts, loaded from the npz and from
   ``config.json`` + ``model.safetensors`` with ``vision_params``, each
   bit-equal to the saved params, and through the checkpoint converter
   (``tools/convert_checkpoint.py`` on the HF layout with its CLIP tower as
   a local checkpoint: vocab files copied, the result bit-equal to the
   saved params); then int8 and bf16, captions from uint8 images per layer
   and on the megakernel, launches exact, tokens bit-equal to the
   in-memory model's, the converted model's too); ``score_sequences`` at
   flamingo-mini width (32 candidates, a 16-token prefix after
   ``<image>``, 8-token suffixes, tied first suffix tokens, k=8) with
   use_pallas off and on: no decode kernel, with use_pallas 30
   ``fused_attention`` and 2 x 24 ``fused_media_xattn``; the same top-k
   set but at near-ties of the candidate logits (8 bf16 ulps, printed),
   kept scores within 1.25 x the plain version's CPU-vs-card spread
   normwise, every other row at float32 min. Then the ported scripts
   (``scripts_cells``, on the same flamingo-mini): the fidelity tool's
   measurement (``tools/int8_fidelity.py``) at all 24 layers, one batch of
   32 captions x 16 tokens, bf16 and int8 per layer and w8a8 on the
   megakernel (2 x 24 x 15 ``decode_attention``, 30 ``lm_head_argmax``, 15
   ``decode_step_megakernel``, every other 0), its pair report printed;
   the six examples in-process on the card, each ending with its usual
   line (batch_serving in int8; export_to_torch's tiny model runs the
   decode attention kernel at head width 16); ``utils/profiling.py`` on
   phase 3's warm flamingo-mini at 12 layers: a trace of one megakernel generate whose CUDA
   kernel events name the megakernel's and the head's symbols, a
   ``PhaseTimer`` over encode, prefill and decode, and ``debug_nans`` (on:
   a clean generate passes, a NaN planted in the pixels raises
   ``FloatingPointError``; off: it returns). Then training
   (``training_cells``): first the recompute backward per op at the
   training step's shapes (``TRAIN_OPS``: the resampler, both trunks
   right- and left-padded, the media xattn), dq, dk and dv through the
   wrappers bit for bit those of autograd through the plain versions;
   then flamingo-mini and the reference's recipe, OPT-125m + ViT-L/14 at
   dim 768 (``TRAIN_CELLS``), each with ``FlamingoTrainer`` in bf16 over
   float32 parameters and float32 AdamW state, use_pallas, gates 0.5, one
   batch of 8 x 64 tokens that ``DataCollator`` collates from
   ``SyntheticCaptionDataset`` over the synthetic vocabulary: the loss and
   the trainable gradients against use_pallas off within max(1e-2, 1.25 x
   that program's CPU-vs-card spread), normwise; 12 steps (launches of the
   first exact: 54 ``fused_attention`` and 24 ``fused_media_xattn`` for
   flamingo-mini, 42 and 12 for OPT-125m; the backward launches none), the
   loss finite and lower at the end, the frozen leaves bit for bit and no
   gradient reaching the vision tower; flamingo-mini with dropout (30
   ``fused_attention``: the trunk's attention runs plain; one seed's loss
   twice bit-equal), with remat (108 and 48 launches: the forward and its
   recompute; loss bit-equal, gradients within 1.25 x the spread of the
   same step run twice, peak memory beside the run without) and one
   ``evaluate()`` over 8 synthetic images; OPT-125m's checkpoint saved and
   loaded into a fresh trainer, whose next step's loss equals the
   uninterrupted run's and its parameters within 1.25 x the spread of
   that resumed step run twice. Then the parallel tier (``parallel_cells``,
   ``flamingo_mini_tpu_torch.parallel``): which collectives gloo takes on
   CUDA tensors between two processes on the card (each op in a process
   pair of its own; every op it does not take must be one that
   ``parallel/comm.py`` stages through host memory), then two ranks started by ``spawn`` over gloo (NCCL
   refuses two ranks on one card), sharing the kernels the parent built,
   on flamingo-mini at its first 12 layers: DP greedy b=32 (16 rows a
   rank) on the megakernel and per layer with the fused head and DP top-k
   50 sampling (31 ``decode_step_megakernel`` + 31 ``lm_head_argmax``,
   12 x 31 ``decode_attention`` + 31, 31 a rank), TP=2 greedy and 3 beams
   per layer over the head-major cache with use_pallas (30
   ``fused_attention`` and 12 ``fused_media_xattn`` a rank on its heads),
   each against the rank's own one-rank run (tokens up to near-ties); TP's
   weight bytes and peak memory a rank against one rank's; the megakernel's
   generate alone on the card and beside the other rank's; 2 DP steps and
   1 TP step of training at 8 x 64 (42 + 12 a rank), DP also against the
   one-rank run of its two halves summed (1e-6); the ring forward with its
   loss and gradients over 1 x 1,024 tokens (30 + 12 a rank); the bf16
   training and ring errors against one rank within max(1e-2, 1.25 x the
   plain programs' CPU-vs-card spread), measured in the run (the CPU part
   while the ranks run); TP's training step and the ring again in float32
   compute against one rank in float32 (loss 1e-5, logits and gradients
   1e-4, normwise); the ring memory tool (``tools/ring_crossover.py``) at
   2,048 tokens on the same two ranks (full attention on rank 0 first,
   then the ring, each rank's temporary and argument bytes; the gathered
   output within 1e-4 normwise of the full attention's); a rank that fails
   or outlasts its time limit fails the run. Then, in the parent, each attention kernel at the inputs rank 0
   gave it (TP's ViT, resampler and media prefill on its heads, the DP
   trunk at its 4 rows, the ring's media xattn at its 512 tokens) held to
   its plain version (2 bf16 ulps) and timed, and the three decode kernels
   checked and timed at a DP rank's 16 rows;
4. timing on the card: ms per decode step (two lengths) and captions/s of
   the seven flamingo-mini generate paths (w8a8 greedy and beams included),
   the head-major and int8 KV caches per layer (32 new tokens), the two
   paths of each of BASELINE configs 1, 4 and 5, the four search paths
   (beam-sample per layer and on the megakernel, constrained and
   contrastive per layer) and beam-sample's step work alone (the warpers
   over 96 rows; the noise and the top 6 of 32 x 150,774 keys), and the
   four OPT-1.3B paths (top-k 50 sampling and w8a8 included) and the
   megakernel path of OPT-2.7B and OPT-6.7B, with their 32-layer step
   alone beside its plain version and bound, peak memory;
   the entry point's captions/s (preprocessing and decode included) beside
   ``generate`` alone, the preprocessing of 32 images and ``batch_decode``
   alone, config 1 via ``from_pretrained``'s captions/s, and scored
   sequences/s; each training configuration's step (median ms of 10
   steps between CUDA events, their spread, samples/s, tokens/s, peak
   memory) and its split (encode + resample, the forward with its loss,
   forward + backward, clip + AdamW, each its own timed call), and each
   op's kernel forward beside its forward with the recompute backward and
   the plain forward and backward; the sampled OPT-1.3B step's full head (``lm_head`` at 8 rows,
   and its float32 weight copy alone) and chain with the draw, each alone
   on the card, as shares of that path's step; the beam
   step's full head (``lm_head`` at 96 rows) and candidate selection,
   encode + resample at batch 32 with and without the attention kernels,
   and both forwards' ms and tokens/s. Last the stream probe at 512 MB:
   ``stream_sum`` against its plain version (float32, 1e-5 relative, a
   uniform [0, 1) buffer), then its own protocol (marginal time per call
   over chains of 4 and 36, median of 5): GB/s of the kernel and of
   ``torch.sum(dim=0)``. Last the in-situ probes
   (``tools/probe_decode_kernel.py``, ``tools/probe_lm_head.py``), each
   loop captured as one CUDA graph per trip count: every graphed loop, 2
   steps, bit for bit (NaN-aware) against the same loop run eagerly on
   the card; then, with every launch count at 0, the decode probe's
   variants (``tmajor_kernel``, ``stream_tmajor_bt32``,
   ``stream_tmajor_packed_bt16``, ``head_layout_attend``,
   ``stream_bmajor_bt32``, and ``glue_only``, its loop without the
   probed call: per-layer us and GB/s, graphs of 8 and 40 steps) and the
   head probe's (``eager_int8`` and the fused kernel: us per step, graphs
   of 64 and 576 steps), launch counts exact (1,176 each
   of ``decode_attention`` and the three stream kernels, 641
   ``lm_head_argmax``: one eager step and each captured launch; replays
   relaunch without Python).

Any failure raises and exits nonzero. Without a CUDA device it exits 1 and
prints no result. ``[time]`` lines give the seconds since the start at each
phase. The line before the last lists the kernels as JSON (each of the
eleven, with the megakernel's OPT, beam and w8a8 modes and the shapes of
BASELINE's configurations where they have them); the last line is
``{"ok": true, "device": ...}``.
"""
import collections
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, PROMPT_LEN, NEW_TOKENS, PREFIX_BLOCK = 32, 4, 128, 32
MAX_LENGTH = PROMPT_LEN + NEW_TOKENS
# beam search: 3 beams, 64 new tokens; the flat cache rounds 68 up to 128
BEAMS, BEAM_NEW_TOKENS = 3, 64
BEAM_MAX_LENGTH = PROMPT_LEN + BEAM_NEW_TOKENS
BEAM_T = 128
# (cur, kv_limit) pairs the beam loop reaches: segments end at 37 and 68
BEAM_PAIRS = ((4, 37), (35, 37), (50, 68), (66, 68))
ATTN_B, ATTN_D, ATTN_H, ATTN_T = 32, 1024, 16, 192
# the decode attention kernels' edges: live prefixes around 64-slot
# multiples and the cache's end (each with cur at its last slot), and
# (heads, splits) layouts that the decode paths' shapes do not pick
ATTN_EDGE_LIMITS = (1, 63, 64, 65, 127, 128, 129, 192)
ATTN_SPLIT_PLANS = ((1, 2), (2, 3), (4, 8))
HEAD_B, HEAD_D, HEAD_V = 32, 1024, 50258
# the megakernel at flamingo-mini width: GPT-2-medium, xattn 8 heads of 64
MEGA_D, MEGA_H, MEGA_XI, MEGA_XH, MEGA_NV, MEGA_T = 1024, 16, 512, 8, 64, 192
# the attention kernels of the use_pallas path, (b, h, n_q, n_kv): the ViT's
# 24 self-attentions and the resampler's 6 per generate (one image per row),
# the uncached GPT-2 forward's 24 at batch 8 x 64 tokens, OPT-1.3B's 24
# (causal, two rows left-padded); flamingo-tiny's ViT-B/32 over 32 images
# (BASELINE config 1) and the resampler over 8-frame clips (config 5: 8 x
# 50 frame tokens and the 64 latents); the OPT-125m recipe's training trunk
HEAD_DIM = 64
ATT_SHAPES = {"vit": (32, 16, 257, 257), "resampler": (32, 8, 64, 321),
              "gpt2 forward": (8, 16, 64, 64), "opt forward": (8, 32, 64, 64),
              "vit-b/32": (32, 12, 50, 50), "video resampler": (8, 8, 64, 464),
              "opt-125m forward": (8, 12, 64, 64)}
GPT2_PAD = 8
FLASH_SHAPE = (2, 16, 4000)
# media xattn (b, n_token, n_media), 8 heads: the generate prefill (4-token
# prompts, one image), the forward (64 tokens, one image), two images, and
# BASELINE config 4's prefill (64-token prompts over four images)
MEDIA_SHAPES = {"prefill": (32, 4, 1), "forward": (8, 64, 1),
                "two images": (8, 64, 2), "four images": (8, 64, 4)}
# the media kernel's edges: prompts of 5 and 17 tokens (a slice and one row
# more) over two images; 40 tokens over 13 and 20 images (832 and 1,280
# keys: past the bf16 kernel's 16 slots, and at 20 past one 64-tile window)
MEDIA_EDGE_SHAPES = {"n_q 5": (8, 5, 2), "n_q 17": (8, 17, 2),
                     "13 images": (2, 40, 13), "20 images": (2, 40, 20)}
# text_time mixes it is held under (media_mix): media_text_time's (0, each
# image, past the media count), a 16-row slice spanning two media, a slice
# all 0, every row past the media count (and one at -1), and the timed one
MEDIA_MIXES = ("random", "span", "zero slice", "past", "timed")
# flamingo-mini: GPT-2-medium with xattn before every layer, CLIP ViT-L/14
MINI = dict(lm="gpt2-medium", clip_model_type="openai/clip-vit-large-patch14",
            dim=1024, dim_visual=1024, compute_dtype="bfloat16")
# the uncached forward: batch 8 x 64 tokens (bench_train.py's shape)
FWD_B, FWD_N = 8, 64
# OPT-1.3B captioning, BASELINE config 3 (bench_extended.py:214-216,
# :233-235), run as written (top-k 50 sampling) and greedy: ViT-L/14, xattn
# every other layer, batch 8, one image + 8-token prompt with rows 0 and 1
# left-padded by 2, 64 new tokens (the flat cache rounds 72 up to 128);
# beams: 3, 32 new tokens
OPT13 = dict(lm="facebook/opt-1.3b", clip_model_type="openai/clip-vit-large-patch14",
             dim=2048, dim_visual=1024, xattn_every=2, compute_dtype="bfloat16")
OPT_B, OPT_PROMPT, OPT_PAD, OPT_NEW, OPT_BEAM_NEW = 8, 8, 2, 64, 32
OPT_TOP_K = 50                    # BASELINE config 3 samples top-k 50
OPT_MAX = OPT_PROMPT + OPT_NEW
OPT_D, OPT_H, OPT_T, OPT_V = 2048, 32, 128, 50273
# (cur, kv_limit) pairs the OPT loop reaches: segments end at 40 and 71
OPT_PAIRS = ((8, 40), (39, 40), (40, 71), (70, 71))
# OPT-2.7B and OPT-6.7B captioning: the presets of configuration_flamingo.py
# (heads 80 and 128 wide, 32 layers) at BASELINE config 3's traffic (OPT13's
# batch, prompts, left padding, 64 new tokens, 3 beams of 32), full width
# and depth, greedy per layer, on the megakernel (weight-only and w8a8),
# 3 beams per layer and on the megakernel, and the use_pallas forward
WIDE = {"OPT-2.7B": dict(lm="facebook/opt-2.7b", dim=2560),
        "OPT-6.7B": dict(lm="facebook/opt-6.7b", dim=4096)}
WIDE_COMMON = dict(clip_model_type="openai/clip-vit-large-patch14", dim_visual=1024,
                   xattn_every=2, compute_dtype="bfloat16")
WIDE_HEADS = {"OPT-2.7B": (2560, 32, 80), "OPT-6.7B": (4096, 32, 128)}
# the megakernel paths' plain-version runs, which the cells are held to:
# their first 8 tokens (the plain megakernel takes 0.35-0.65 s a step here)
WIDE_PLAIN_NEW = 8
# the use_pallas forward's logits against the plain program on the card,
# normwise: the plain program on the CPU and on the card part by 0.018 at
# both trunks' 32 layers (PERF.md section 2), as far as the kernels do
WIDE_FWD_LIMIT = 0.03
# the trunk's attention in the use_pallas forward (b, h, n) and the
# streaming kernel's check (b, h, keys); the edges of the Hopper tile at
# the new widths (n_kv by n_q, b=2, 3 heads)
WIDE_FWD = (8, 32, 64)
WIDE_FLASH = (1, 32, 4000)
WIDE_N_KV = (1, 63, 64, 65, 127, 129, 257)
WIDE_N_Q = (1, 65)
# BASELINE's other configurations (bench_extended.py:208-241), int8
# weight-only in bf16, prefix_block 32, EOS unreachable: (config, batch,
# prompt tokens, new tokens, images a row, frames a clip). 1: flamingo-tiny
# (GPT-2 small + ViT-B/32, D=768, 12 heads, xattn every layer) greedy; 4:
# flamingo-mini over four images at 16-token steps (few-shot); 5:
# flamingo-tiny with 8-frame clips (resampler_num_time_embeds=8)
TINY = dict(lm="gpt2", clip_model_type="openai/clip-vit-base-patch32", dim=768,
            dim_visual=768, compute_dtype="bfloat16")
BASELINE_CELLS = {"config 1": (TINY, 32, 4, 64, 1, 1),
                  "config 4": (MINI, 8, 64, 32, 4, 1),
                  "config 5": (dict(TINY, resampler_num_time_embeds=8), 8, 4, 32, 1, 8)}
# the megakernel at flamingo-tiny width (GPT-2 small: D=768, 12 heads), and
# at BASELINE config 4's 4 x 64 media latents a row
TINY_D, TINY_H, MEDIA4_NV = 768, 12, 4 * 64
# the KV-cache variants at flamingo-mini width, per layer: greedy over the
# head-major bf16 cache and the int8 cache (timed over this many new tokens),
# and beams with the gather reorder and lazily over the head-major cache
KV_TIMED_NEW = 32
# the rest of search at flamingo-mini width (batch 32, one image + 4-token
# prompt): beam-sample (3 beams, temperature 0.7, top-k 50, 64 new tokens,
# a seeded CUDA generator), constrained beams (3 beams, 32 new tokens, a
# 3-token phrase and a set of two 2-token alternatives) and contrastive
# search (penalty_alpha 0.6 over 4 candidates, 32 new tokens)
SAMPLE_TEMPERATURE, SAMPLE_TOP_K, SAMPLE_SEED = 0.7, 50, 17
SEARCH_NEW = 32
FORCE_WORDS = [[464, 3290, 318], [[257, 3797], [262, 5044]]]
CONTRAST_ALPHA, CONTRAST_TOP_K = 0.6, 4
# the public entry point: a seeded synthetic vocabulary of GPT-2's size
# (256 byte symbols + 50,000 merges + <|endoftext|>), BASELINE's eval prompt
# (BASELINE.md), 32 uint8 images of these sizes, two of them grayscale
# (2-D), for captions at flamingo-mini width (128 new tokens) and BASELINE
# config 1 via from_pretrained (64 new tokens); scoring: 32 candidates, a
# 16-token prefix after the image tag, 8-token suffixes, top 8 kept
VOCAB_MERGES, CAPTION_PROMPT = 50000, "<image>A picture of"
PROMPT_WORDS = ("image", "Ġpicture", "Ġof")     # byte symbols: "Ġ" is a space
IMAGE_SHAPES = ((480, 640, 3), (640, 480, 3), (375, 500, 3), (224, 224, 3),
                (100, 150, 3), (1000, 250, 3), (300, 400), (224, 224))
SCORE_N, SCORE_PREFIX, SCORE_SUFFIX, SCORE_K = 32, 16, 8, 8
# the card against the CPU at tests/test_torch_beam.py's small float32
# shape (GPT-2 D=256, 4 heads, 2 layers, vocab 256, a 1-layer ViT on 32-px
# images), batch 4, 5-token prompts, 9 new tokens
SMALL = dict(lm="gpt2", dim=256, dim_visual=64, xattn_every=1, xattn_dim_head=64,
             xattn_heads=4, resampler_depth=1, resampler_dim_head=16,
             resampler_heads=4, resampler_num_latents=8,
             lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=256,
                                    n_layer=2, n_head=4),
             vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                        num_hidden_layers=1, num_attention_heads=4,
                                        image_size=32, patch_size=16))
SMALL_B, SMALL_L, SMALL_MAX = 4, 5, 14
# opt-350m: post-norm with project_in/out, per layer only, 16 new tokens
OPT350 = dict(lm="facebook/opt-350m", clip_model_type="openai/clip-vit-large-patch14",
              dim=1024, dim_visual=1024, compute_dtype="bfloat16")
OPT350_NEW = 16
# depth cuts that keep the script inside its time limit beside the training
# and parallel cells: the OPT cells (OPT-1.3B and opt-350m) at 12 of their
# trunks' 24 layers; flamingo-mini's decode paths (phase 3 and 4), BASELINE
# config 4, the search section and the entry point at its first 12
# (``first_layers``), the parallel cells at 12 of their own; the
# constrained-search check, the forward, training and scoring at all 24
CUT_LAYERS = MINI_LAYERS = 12
# the w8a8 linear alone, bitwise: (K, N, slice width or None for the
# column form) at the step's shapes: c_attn and fc at D=1024 and 2048,
# to_out's K = XI = 512 in both forms, mlp_proj over D-wide slices of Dff
W8A8_LINEAR = ((1024, 3072, None), (2048, 8192, None), (512, 1024, None),
               (512, 1024, 1024), (4096, 1024, 1024), (8192, 2048, 2048))
# the weight-only megakernel's edge rows: each side of the wgmma N steps
# (8, 32), of its wide mode (64) and of its 256-row passes (256)
EDGE_ROWS = (1, 3, 8, 9, 31, 32, 33, 64, 65, 256, 257)
# training (flamingo_mini_tpu_torch.train): flamingo-mini (bench_train.py:235-244)
# and the reference's own recipe, OPT-125m + ViT-L/14 at dim 768
# (bench_train.py:238-247, training/train.py:81-90), bf16 over float32
# parameters, use_pallas, gates 0.5; one batch of 8 x 64 tokens collated by
# DataCollator from SyntheticCaptionDataset over the synthetic vocabulary;
# lr 1e-3 after a 1-step warm-up (step 0 at lr 0); 2 warm-up steps, then
# the timed ones; the extra checks of each cell; evaluate() over 8 images
OPT125 = dict(lm="facebook/opt-125m", clip_model_type="openai/clip-vit-large-patch14",
              dim=768, dim_visual=1024, compute_dtype="bfloat16")
TRAIN_CELLS = {"flamingo-mini": (MINI, 10, ("dropout", "remat", "eval")),
               "OPT-125m recipe": (OPT125, 10, ("checkpoint",))}
TRAIN_B, TRAIN_N, TRAIN_WARM, TRAIN_LR, TRAIN_EVAL_IMAGES = 8, 64, 2, 1e-3, 8
# the recompute backward per op at the training step's shapes (b, h, n_q,
# n_kv, padding): the resampler, the trunks (causal; rows 0 and 1 padded on
# the right by 8 and 3, as the right-padded batches are, and on the left),
# and the media xattn over one image of 64 latents
TRAIN_OPS = {"resampler": (8, 8, 64, 321, None),
             "gpt2-medium trunk": (8, 16, 64, 64, "right"),
             "opt-125m trunk": (8, 12, 64, 64, "right"),
             "gpt2-medium trunk, left-padded": (8, 16, 64, 64, "left"),
             "media": (8, 8, 64, 64, None)}
# the parallel tier on the one card (flamingo_mini_tpu_torch.parallel): two
# ranks over gloo (NCCL refuses two ranks on one GPU), flamingo-mini at its
# first MINI_LAYERS layers; DP greedy b=32 (16 rows a rank), 32 new tokens;
# TP=2 greedy 8 rows, 32 new tokens, 3 beams 16 new tokens; training at
# TRAIN_B x TRAIN_N; the ring forward over one row of 1,024 tokens; the
# ranks' time limit
PAR_RANKS, PAR_B, PAR_NEW = 2, 32, 32
PAR_TP_B, PAR_TP_NEW, PAR_BEAM_NEW = 8, 32, 16
PAR_RING_B, PAR_RING_N = 1, 1024
PAR_TIMEOUT = 400
# TP and the ring against one rank in float32 compute, where only the order
# of float32 sums lies between them: relative error limits, normwise
PAR_F32_LIMITS = {"loss": 1e-5, "logits": 1e-4, "gradients": 1e-4}
# gloo's probe names -> comm.py's ops that move data that way
GLOO_PROBE_COMM = {"all_reduce": ("all_reduce",), "broadcast": ("broadcast",),
                   "all_gather": ("all_gather",), "send/recv": ("ring_shift",)}
# the stream probe: a 512 MB buffer, its TPU protocol's middle chunk_rows
STREAM_MB, STREAM_CHUNK = 512, 1024
# the decode stream probes (tools/probe_decode_kernel.py's three kernels):
# (layout, block_t, block_b, kv_limit, b, T, D); first at the probe's shape,
# b=32, D=1024, T=192 (kv_limit 100 is a multiple of neither block_t), then
# in each layout at the kernel's edges: b of 1 and 3, D of 5 vectors and
# OPT-1.3B's 2048, block_t 1, 3 and 24 (groups of 1, 1 and 8 rows), a long
# cache walked in windows (T = 1,024, kv_limit 1,024 and 1,000), and chunks
# longer than a block holds (block_t 256: a chunk's sum carried across
# windows)
PROBE_SHAPE = (32, 192, 1024)
PROBE_EDGES = ((32, None, 128, 1, 192, 1024), (16, None, 100, 3, 192, 1024),
               (32, None, 128, 32, 192, 40), (32, None, 128, 8, 192, 2048),
               (1, None, 100) + PROBE_SHAPE, (3, None, 100) + PROBE_SHAPE,
               (24, None, 100) + PROBE_SHAPE, (32, None, 1024, 32, 1024, 1024),
               (32, None, 1000, 32, 1024, 1024), (256, None, 300, 4, 512, 1024))
PROBE_CASES = tuple(c + PROBE_SHAPE for c in (
    ("tmajor", 16, None, 128), ("tmajor", 32, None, 128),
    ("tmajor", 32, None, 100), ("bmajor", 16, 32, 128),
    ("bmajor", 32, 32, 128), ("bmajor", 32, 8, 128), ("bmajor", 16, 8, 100),
    ("packed", 16, None, 128), ("packed", 32, None, 128),
    ("packed", 16, None, 100))) + tuple(
        (layout,) + e for layout in ("tmajor", "bmajor", "packed") for e in PROBE_EDGES)
# the block_t each layout is timed at: its in-situ variant's
PROBE_TIMED = {"tmajor": 32, "bmajor": 32, "packed": 16}
# NVIDIA H100 SXM data sheet: device memory rate, dense bf16 tensor cores,
# dense int8 tensor cores, float32 outside the tensor cores
HBM_BYTES_PER_S, BF16_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 1979e12
F32_OPS_PER_S = 67e12
# the card's spin before each timed call: about a millisecond at 1.7-2 GHz
LEAD_CYCLES = 2_000_000


T0 = time.perf_counter()


# the scripts section: the fidelity tool's measurement at flamingo-mini
# width, one batch of 32 captions x 16 tokens; the trace, timer and NaN
# checks on greedy generates of this many rows and new tokens; the ring
# tool's sequence (run inside the parallel ranks)
FID_B, FID_NEW = 32, 16
PROF_B, PROF_NEW = 4, 16
RING_TOOL_SEQ = 2048
# each example's usual line
EXAMPLE_LINES = {"image_captioning": "caption:", "batch_serving": "batch 2 (run):",
                 "few_shot_prompt": "continuation:", "video_captioning": "video caption:",
                 "model_stats": "trainable params:",
                 "export_to_torch": "from_pretrained('demo/flamingo-tpu-export') OK"}


def stamp(label: str) -> None:
    """Print the seconds since the script started, at ``label``."""
    print(f"[time] {label}: {time.perf_counter() - T0:.1f} s", flush=True)


def bf16_ulps(ref: torch.Tensor, n: int) -> float:
    """n bf16 ulps at the scale of the largest |value| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)


def bound(n_bytes: float, n_ops: float, n_int8_ops: float = 0.0,
          n_f32_ops: float = 0.0):
    """(least ms the card could take, what bounds it): ``n_ops`` at the
    bf16 rate, ``n_int8_ops`` at the int8 rate, ``n_f32_ops`` at the
    float32 rate outside the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / BF16_OPS_PER_S + n_int8_ops / INT8_OPS_PER_S \
        + n_f32_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sm90_sass(lib: str) -> None:
    """Print the Hopper kernels' instructions of note in the built library
    (the attention tile, the megakernel's two modes and its w8a8 linear
    alone, the head) and require TMA loads (UTMALDG) in each and its wgmma:
    int8 (IGMMA) in the megakernel's w8a8 mode and its linear, bf16 (HGMMA)
    in the others; a toolkit without cuobjdump skips the check, saying
    so."""
    from flamingo_mini_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"[phase 1] SASS not checked: no {tool}")
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if any(k in name for k in SM90_KERNELS):
                found[name] = set()
            else:
                name = None
        elif name is not None:
            found[name].update(op for op in ("HGMMA", "IGMMA", "UTMALDG", "SYNCS")
                               if op in line)
    for k in SM90_KERNELS:
        assert any(k in n for n in found), \
            f"{k} is missing from the library's SASS: {sorted(found)}"
    assert any(W8A8_SASS in n for n in found), \
        f"the megakernel's w8a8 mode is missing from the library's SASS: {sorted(found)}"
    for name, ops in found.items():
        print(f"[phase 1] SASS {name}: {' '.join(sorted(ops))}")
        mma = "IGMMA" if W8A8_SASS in name or "w8a8_linear_kernel" in name else "HGMMA"
        assert {mma, "UTMALDG"} <= ops, f"{name}: no {mma} or no TMA in its SASS"


# the Hopper kernels the SASS check looks for (names as cuobjdump prints them)
SM90_KERNELS = ("attention_sm90_kernel", "decode_megakernel_sm90", "w8a8_linear_kernel",
                "lm_head_kernel")
# the megakernel's w8a8 instantiation, decode_megakernel_sm90<true>, mangled
W8A8_SASS = "decode_megakernel_sm90ILb1E"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, iters: int, flush: torch.Tensor, clean: bool = False) -> float:
    """Median device time of one call, by CUDA events around each call.
    ``flush``: a buffer larger than L2, rewritten before each call so that
    the call finds its inputs in device memory, as the decode loop does.
    ``clean``: read the buffer instead, so that L2 holds clean lines, as in
    the decode loop, where the last layer's reads filled it, and the call
    pays no write-back of dirty ones. A spin of about a millisecond on the
    card (``LEAD_CYCLES``) precedes each call, so that the host enqueues the
    call while the card is busy and the events time the card alone, not the
    wrapper's host steps (``host_us`` times those)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_us(fn, n: int = 100) -> float:
    """Host µs per call of a wrapper: the host clock over ``n`` enqueues,
    then one synchronize (not timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def attention_edge_cases(rows: int, kb: int, kv_limit: int, cur: int, T: int, p):
    """(cur, npad) cases around one (kv_limit, cur) under the plan ``p`` of
    ``ops/decode_attention``: the live prefix ending on each side of every
    split boundary; left padding 0-3 by family, then one family with an
    empty [npad, cur] (uniform over its entries) and another whose npad
    lies past the first split (that split masked)."""
    t_lim = min(kv_limit, T)
    curs = {cur} | {c for s in range(1, p.splits)
                    for c in (s * p.positions - 1, s * p.positions)}
    for c in sorted(curs):
        base = np.repeat(np.arange(rows // kb) % 4, kb)
        yield c, base
        masked = base.copy()
        masked[:kb] = c + 1
        if p.splits > 1 and p.positions + 1 <= min(c, t_lim - 1):
            masked[kb:2 * kb] = p.positions + 1
        yield c, masked


def attention_edges(dev, rows: int, kb: int, D: int, T: int, seed: int,
                    head_dim: int = HEAD_DIM) -> dict:
    """``decode_attention`` (kb 1) or ``decode_attention_beam`` against its
    plain version at its edges, float32 and bf16, heads ``head_dim`` wide:
    every ATTN_EDGE_LIMITS live prefix under ``plan()``'s layout through
    the wrapper (one launch a call), then each ATTN_SPLIT_PLANS layout at
    kv_limit 129 (beams: 68) through the launch itself, each with
    ``attention_edge_cases``. -> {dtype: (worst error, its tolerance,
    where: (kv_limit, cur, row, head, plan))}."""
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    H = D // head_dim
    rs = np.random.RandomState(seed)
    q32, k32, v32 = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                     for s in ((rows, D), (T, rows, D), (T, rows, D)))
    anc = random_ancestry(dev, rows // kb, kb, seed) if kb > 1 else None
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        runs = [(kv, None) for kv in ATTN_EDGE_LIMITS]
        runs += [(129 if kb == 1 else 68, hs) for hs in ATTN_SPLIT_PLANS]
        for kv_limit, hs in runs:
            t_lim = min(kv_limit, T)
            p = da.plan(rows, H, t_lim, q.element_size(), kb=kb, beam=kb > 1,
                        head_dim=head_dim)
            if hs is not None:
                p = da.make_plan(rows, H, t_lim, q.element_size(), kb=kb, beam=kb > 1,
                                 heads=hs[0], splits=hs[1], head_dim=head_dim)
            kw = dict(n_head=H, scale=0.125, kv_limit=kv_limit)
            for cur, npad in attention_edge_cases(rows, kb, kv_limit, t_lim - 1, T, p):
                npad = torch.tensor(npad, dtype=torch.int32, device=dev)
                if hs is not None:
                    got = da._launch(q, k, v, npad, anc, cur, n_head=H, scale=0.125, kb=kb,
                                     t_lim=t_lim, p=p)
                elif kb == 1:
                    got = da.decode_attention(q, k, v, npad, cur, **kw)
                else:
                    got = da.decode_attention_beam(q, k, v, anc, npad, cur, kb=kb, **kw)
                if kb == 1:
                    want = da.decode_attention_plain(q, k, v, npad, cur, **kw)
                else:
                    want = da.decode_attention_beam_plain(q, k, v, anc, npad, cur, kb=kb,
                                                          **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                tol = 1e-5 if dtype == torch.float32 else bf16_ulps(want.float(), 2)
                row, col = np.unravel_index(int(diff.argmax()), diff.shape)
                where = (kv_limit, cur, int(row), int(col) // head_dim, tuple(p[:4]))
                assert bool(torch.isfinite(got).all()), (dtype, where)
                assert err <= tol, f"decode_attention{'_beam' if kb > 1 else ''} " \
                    f"{dtype} at {where}: max err {err} > {tol}"
                if err > worst.get(str(dtype), (-1.0,))[0]:
                    worst[str(dtype)] = (err, tol, where)
    return worst


def narrow_attention(dev, kb: int = 1) -> float:
    """The decode attention kernel (``kb`` 1) or its beam kernel at the
    narrow head widths of the test-scale models (16: the export example's
    and the fidelity tool's smoke model; 32), at their edges
    (``attention_edges``: 8 greedy rows or 4 families of ``kb``, 4 heads).
    Then a width the kernels do not take (32 heads of 96) must raise on the
    card, never run plain. -> the worst error."""
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    rows, T = (8, 192) if kb == 1 else (4 * kb, BEAM_T)
    name = "decode_attention" if kb == 1 else "decode_attention_beam"
    worst = 0.0
    for head_dim in (16, 32):
        edges = attention_edges(dev, rows, kb, 4 * head_dim, T, seed=head_dim,
                                head_dim=head_dim)
        print_edges(f"{name} edges at head width {head_dim} ({rows} rows, 4 heads, T={T})",
                    edges)
        worst = max([worst] + [err for err, _tol, _where in edges.values()])
    q = torch.zeros((kb, 3072), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((16, kb, 3072), dtype=torch.bfloat16, device=dev)
    npad = torch.zeros(kb, dtype=torch.int32, device=dev)
    try:
        if kb == 1:
            da.decode_attention(q, kv, kv, npad, 3, n_head=32, scale=0.1)
        else:
            anc = torch.zeros((1, kb, 16), dtype=torch.int32, device=dev)
            da.decode_attention_beam(q, kv, kv, anc, npad, 3, n_head=32, scale=0.1, kb=kb)
        raise AssertionError(f"{name} ran at head width 96")
    except ValueError as e:
        print(f"[phase 2] {name} at head width 96 (not taken) on the card raises: {e}")
    return worst


def print_edges(label: str, worst: dict) -> None:
    for dtype, (err, tol, (kv_limit, cur, row, head, p)) in worst.items():
        print(f"[phase 2] {label} {dtype}: worst error {err} (tolerance {tol}) at "
              f"kv_limit {kv_limit}, cur {cur}, row {row}, head {head}, plan (heads, "
              f"splits, positions, warps) {p}")


def phase2_decode_attention(dev, flush, b=ATTN_B, D=ATTN_D, H=ATTN_H, T=ATTN_T,
                            curs=(4, 70, 131), limits=(36, 68, 132)):
    """decode_attention vs plain at (b, D, H heads, a T-slot cache) for each
    cur and kv_limit, and at its edges (heads D / H wide); timed at the last
    of each, beside SDPA and the bound."""
    from flamingo_mini_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    rs = np.random.RandomState(0)
    shape = (T, b, D)
    q32 = torch.tensor(rs.randn(b, D) * 0.3, dtype=torch.float32, device=dev)
    k32 = torch.tensor(rs.randn(*shape) * 0.3, dtype=torch.float32, device=dev)
    v32 = torch.tensor(rs.randn(*shape) * 0.3, dtype=torch.float32, device=dev)
    npad = torch.tensor(np.arange(b) % 4, dtype=torch.int32, device=dev)
    scale = 1.0 / 8.0
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        for cur in curs:
            for kv_limit in limits:
                got = decode_attention(q, k, v, npad, cur, n_head=H,
                                       scale=scale, kv_limit=kv_limit)
                want = decode_attention_plain(q, k, v, npad, cur, n_head=H,
                                              scale=scale, kv_limit=kv_limit)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = 1e-5 if dtype == torch.float32 else bf16_ulps(want.float(), 2)
                assert bool(torch.isfinite(got).all()), (dtype, cur, kv_limit)
                assert err <= tol, f"decode_attention {dtype} cur={cur} " \
                    f"kv_limit={kv_limit}: max err {err} > {tol}"
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    print(f"[phase 2] decode_attention vs plain at b={b}, D={D}, {H} heads, T={T}: "
          f"max abs err {worst} (tolerance: f32 1e-5, bf16 2 ulp of the output scale)")
    edges = attention_edges(dev, b, 1, D, T, seed=b, head_dim=D // H)
    print_edges(f"decode_attention edges at b={b}, D={D}, {H} heads, T={T} (kv_limit "
                f"{ATTN_EDGE_LIMITS}, split layouts {ATTN_SPLIT_PLANS} at 129)", edges)
    for dtype, (err, _tol, _where) in edges.items():
        worst[dtype] = max(worst.get(dtype, 0.0), err)
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    t_lim, cur = limits[-1], curs[-1]
    kw = dict(n_head=H, scale=scale, kv_limit=t_lim)
    ms = time_ms(lambda: decode_attention(q, k, v, npad, cur, **kw), 50, flush)
    plain_ms = time_ms(lambda: decode_attention_plain(q, k, v, npad, cur, **kw),
                       50, flush)
    # the same function as one library call, on the same cache (views)
    dh = D // H
    q4 = q.view(b, H, 1, dh)
    k4, v4 = (c[:t_lim].view(t_lim, b, H, dh).permute(1, 2, 0, 3) for c in (k, v))
    pos = torch.arange(t_lim, device=dev)
    mask = ((pos[None, :] >= npad[:, None]) & (pos[None, :] <= cur))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q4, k4, v4, attn_mask=mask, scale=scale).reshape(b, D)
    lib_err = float((lib_out.float() - decode_attention(q, k, v, npad, cur, **kw)
                     .float()).abs().max())
    library_ms = time_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=scale),
                         50, flush)
    print(f"[phase 2] scaled_dot_product_attention at decode_attention's shape: "
          f"max abs diff to the kernel {lib_err}; the wrapper's host "
          f"{host_us(lambda: decode_attention(q, k, v, npad, cur, **kw)):.1f} us a call")
    n_bytes = 2 * 2 * t_lim * b * D + 2 * 2 * b * D + 4 * b
    n_ops = 4 * b * (cur + 1) * D
    return dict(max_abs_err=max(worst.values()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **dict(zip(("bound_ms", "bound_by"),
                                                  bound(n_bytes, n_ops))))


def head_inputs(dev, B: int, D: int, V: int, seed: int):
    """The head's inputs on the card -> (head (pad_head_weights), x (B, D)
    bf16, {hidden row: the planted tie's (first, second) vocab row}). Random
    int8 rows, scales 1e-4 + |N(0, 0.01)|, hidden rows N(0, 0.1); the first
    three hidden rows (as many as B has) each zero but for 8 columns of 1 /
    127 (their own), which meet exactly two vocab rows at 127 with scale 1:
    an exact tie at the top (logit 8) between vocab rows 7 and 40000 (other
    tiles, other blocks' shares), 63 and 256 (tiles 0 and 4: one block's,
    one warpgroup's, two rounds), and the last row of the first block's
    share and the first of the second's (lm_head.schedule's deal)."""
    from flamingo_mini_tpu_torch.ops import lm_head as lh
    gen = torch.Generator(device=dev).manual_seed(seed)
    w8 = torch.randint(-127, 128, (V, D), generator=gen, device=dev).to(torch.int8)
    scale = torch.randn(V, generator=gen, device=dev).abs() * 0.01 + 1e-4
    x = torch.randn((B, D), generator=gen, device=dev) * 0.1
    n_tiles = -(-V // 2048) * 2048 // lh.TILE
    edge = n_tiles // min(n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    ties = {0: (7, 40000), 1: (63, 256), 2: (edge * lh.TILE - 1, edge * lh.TILE)}
    ties = {i: t for i, t in ties.items() if i < B}
    for pair in ties.values():
        w8[list(pair), :24] = 0
    for i, pair in ties.items():
        x[i] = 0.0
        x[i, 8 * i:8 * i + 8] = 1.0 / 127
        w8[list(pair), 8 * i:8 * i + 8] = 127
        scale[list(pair)] = 1.0
    head = lh.pad_head_weights({"w8": w8, "scale": scale}, 2048)
    return head, x.to(torch.bfloat16), ties


def head_picks(head, xt, n_valid: int):
    """(kernel picks, plain picks, the plain logits' gap between them, one
    bf16 ulp of the plain pick's logit), each (B,)."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax, lm_head_argmax_plain
    got = lm_head_argmax(head["w8"], head["scale"], xt, n_valid=n_valid)
    want = lm_head_argmax_plain(head["w8"], head["scale"], xt, n_valid=n_valid)
    torch.cuda.synchronize()
    logits = torch.matmul(xt.float(), head["w8"][:, :xt.shape[1]].float().t()) * head["scale"]
    logits = logits.to(torch.bfloat16).float()[:, :n_valid]
    rows = torch.arange(xt.shape[0], device=xt.device)
    gap = (logits[rows, want.long()] - logits[rows, got.long()]).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(logits[rows, want.long()].abs())) - 7)
    return got, want, gap, ulp


def lh_shape(D: int, B: int) -> str:
    """How the head kernel takes B rows of width D: its chunks, the tail
    of the last, and its K-slices."""
    from flamingo_mini_tpu_torch.ops import lm_head as lh
    n = len(lh.slices(D, min(B, lh.MAX_N)))
    return (f"{lh.n_chunks(D)} chunks, the last {D - (lh.n_chunks(D) - 1) * lh.TILE} wide, "
            f"{'staged whole' if n == 1 else f'staged in {n} K-slices'}")


def phase2_lm_head(dev, flush, B=HEAD_B, D=HEAD_D, V=HEAD_V, widths=()):
    """lm_head_argmax vs plain at (B rows, width D, V vocab rows padded to
    a multiple of 2048), exact ties planted across tiles, across one
    warpgroup's rounds and across two blocks' shares (``head_inputs``);
    again with n_valid at a tile's edge below V, a masked vocab row
    planted above the tie; timed beside the bound. ``widths``: the same
    checks (ties, picks within 1 bf16 ulp) at B rows of each of these
    widths too."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax, lm_head_argmax_plain
    head, xt, ties = head_inputs(dev, B, D, V, seed=1)
    Vp = head["w8"].shape[0]
    assert Vp == -(-V // 2048) * 2048
    got, want, gap, ulp = head_picks(head, xt, V)
    for i, (first, _second) in ties.items():
        assert int(got[i]) == first, f"planted tie {ties[i]} resolved to {int(got[i])}"
    mismatch = int((got != want).sum())
    assert bool((gap <= ulp).all()), "lm_head_argmax picks differ by more " \
        f"than 1 bf16 ulp: {gap.max().item()}"
    # n_valid at a tile's edge: vocab row n_valid (masked) planted above
    # row 0's tie
    edge = V // 64 * 64
    head["w8"][edge, :8] = 127
    head["scale"][0, edge] = 2.0
    got_e, want_e, gap_e, ulp_e = head_picks(head, xt, edge)
    assert int(got_e[0]) == ties[0][0] and bool((gap_e <= ulp_e).all()), \
        (int(got_e[0]), gap_e.max().item())
    mismatch_e = int((got_e != want_e).sum())
    # NaN rows (a NaN in the hidden row makes every logit NaN): torch.argmax
    # picks the first NaN, so the kernel must too
    if B > 5:
        xn = xt.clone()
        xn[4] = float("nan")
        xn[5, D - 1] = float("nan")
        got_n, want_n = (f(head["w8"], head["scale"], xn, n_valid=edge)
                         for f in (lm_head_argmax, lm_head_argmax_plain))
        assert torch.equal(got_n, want_n) and int(got_n[4]) == int(got_n[5]) == 0, \
            (got_n[3:6].tolist(), want_n[3:6].tolist())
    print(f"[phase 2] lm_head_argmax vs plain at B={B}, D={D}, V={V} (padded to "
          f"{Vp}): {mismatch}/{B} tokens differ, all within 1 bf16 ulp; planted ties "
          f"{ties} -> the first of each; n_valid={edge} (a tile's edge, a masked row "
          f"planted above): {mismatch_e}/{B} differ, within 1 ulp"
          f"{'; NaN rows pick their first row, as plain' if B > 5 else ''}")
    gaps = [gap.max(), gap_e.max()]
    for width in widths:
        w_head, w_xt, w_ties = head_inputs(dev, B, width, V, seed=width)
        w_got, w_want, w_gap, w_ulp = head_picks(w_head, w_xt, V)
        for i, (first, _second) in w_ties.items():
            assert int(w_got[i]) == first, (width, w_ties[i], int(w_got[i]))
        assert bool((w_gap <= w_ulp).all()), (width, w_gap.max().item())
        gaps.append(w_gap.max())
        print(f"[phase 2] lm_head_argmax vs plain at B={B}, D={width} (the weight "
              f"{tuple(w_head['w8'].shape)}; {lh_shape(width, B)}): "
              f"{int((w_got != w_want).sum())}/{B} tokens differ, all within 1 bf16 ulp; "
              f"planted ties {w_ties} -> the first of each")
        del w_head
    ms = time_ms(lambda: lm_head_argmax(head["w8"], head["scale"], xt,
                                        n_valid=V), 50, flush)
    plain_ms = time_ms(lambda: lm_head_argmax_plain(
        head["w8"], head["scale"], xt, n_valid=V), 50, flush)
    wrapper_us = host_us(lambda: lm_head_argmax(head["w8"], head["scale"], xt, n_valid=V))
    print(f"[phase 2] lm_head_argmax at B={B}, D={D}: {ms} ms, plain {plain_ms} ms, "
          f"wrapper {wrapper_us} us of host time per call")
    n_bytes = Vp * D + 4 * Vp + 2 * B * D + 4 * B
    return dict(max_abs_err=float(max(gaps)), ms=ms, plain_ms=plain_ms,
                library_ms=None, **dict(zip(("bound_ms", "bound_by"), bound(
                    n_bytes, 2 * B * Vp * D))))


def random_trunk(dev, *, n_layer: int, xattn_every: int, seed: int, D=MEGA_D,
                 H=MEGA_H, XI=MEGA_XI, XH=MEGA_XH, n_visual=MEGA_NV,
                 family="gpt2", activation="relu"):
    """(config, packed weights) for the megakernel: a random int8 trunk
    (GPT-2, or pre-norm OPT with ffn 4 D and ``activation``) and gated
    xattn blocks with random biases and LayerNorm params and open gates,
    from a seed (the activation does not change the weights)."""
    from flamingo_mini_tpu_torch import FlamingoConfig
    from flamingo_mini_tpu_torch.models import gpt2, opt
    from flamingo_mini_tpu_torch.models.xattn import init_gated_xattn_block
    from flamingo_mini_tpu_torch.ops import megadecode, quant
    common = dict(dim=D, xattn_every=xattn_every, xattn_heads=XH,
                  xattn_dim_head=XI // XH, resampler_num_latents=n_visual,
                  compute_dtype="bfloat16")
    if family == "gpt2":
        cfg = FlamingoConfig(lm="gpt2", lm_arch_overrides=dict(
            vocab_size=512, n_positions=256, n_embd=D, n_layer=n_layer, n_head=H),
            **common)
    else:
        cfg = FlamingoConfig(lm="facebook/opt-1.3b", lm_arch_overrides=dict(
            vocab_size=512, max_position_embeddings=256, hidden_size=D,
            ffn_dim=4 * D, num_hidden_layers=n_layer, num_attention_heads=H,
            word_embed_proj_dim=D, activation=activation), **common)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if family == "gpt2":
        lm = gpt2.init_gpt2(gen, cfg.lm_arch)
        blocks, lns = lm["blocks"], ("ln_1", "ln_2")
        lins = ("c_attn", "c_proj", "mlp_fc", "mlp_proj")
    else:
        lm = opt.init_opt(gen, cfg.lm_arch)
        blocks, lns = lm["layers"], ("attn_ln", "final_ln")
        lins = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
    xattn = {str(i): init_gated_xattn_block(gen, dim=D, dim_visual=64,
                                            dim_head=XI // XH, heads=XH,
                                            ff_mult=4)
             for i in range(0, n_layer, xattn_every)}

    def randn_like(t, std, mean=0.0):
        return mean + std * torch.randn(t.shape, generator=gen, device=dev)

    norms = [blk[k] for blk in blocks for k in lns]
    norms += [x[k]["norm"] for x in xattn.values() for k in ("attn", "ffw")]
    for ln in norms:
        ln["scale"], ln["bias"] = randn_like(ln["scale"], 0.1, 1.0), randn_like(ln["bias"], 0.02)
    for blk in blocks:
        for k in lins:
            blk[k]["b"] = randn_like(blk[k]["b"], 0.02)
    for x in xattn.values():
        x["alpha_attn"].fill_(0.5)
        x["alpha_ffw"].fill_(0.3)
    quantize = quant.quantize_gpt2_lm if family == "gpt2" else quant.quantize_opt_lm
    params = quant.cast_params_bf16({"lm": quantize(lm),
                                     "xattn": quant.quantize_xattn_blocks(xattn)})
    return cfg, megadecode.pack_decode_weights(params, cfg)


def mega_inputs(dev, cfg, b: int, seed: int, *, T=MEGA_T, NMNV=MEGA_NV):
    """Random (xk, xv, kc, vc, x_emb, npad, text_time) for one step: rows
    left-padded by r % 4 slots (row 0 of a single row by 2), row 1 without
    an image (text_time 0)."""
    from flamingo_mini_tpu_torch.ops import megadecode
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, _Dff, L, _H = megadecode.trunk_dims(cfg.lm_arch)
    XH, xdh = cfg.xattn_heads, cfg.xattn_dim_head

    def rnd(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    kv = {str(i): (rnd(b, XH, NMNV, xdh), rnd(b, XH, NMNV, xdh))
          for i in range(0, L, cfg.xattn_every)}
    xk, xv = megadecode.pack_xattn_kv_flat(kv, L)
    npad = torch.tensor([2] if b == 1 else np.arange(b) % 4, dtype=torch.int32,
                        device=dev)
    tt = torch.ones(b, dtype=torch.int32, device=dev)
    if b > 1:
        tt[1] = 0
    return xk, xv, rnd(L, T, b, D), rnd(L, T, b, D), rnd(b, D), npad, tt


def random_ancestry(dev, families: int, kb: int, seed: int,
                    anc_len: int = BEAM_MAX_LENGTH) -> torch.Tensor:
    """A random valid lazy-beam ancestry table (families, kb, anc_len)
    int32: every entry names a row of its family."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, kb, (families, kb, anc_len), generator=gen,
                         device=dev, dtype=torch.int32)


def family_npad(dev, families: int, kb: int) -> torch.Tensor:
    """Families left-padded by f % 4 slots, every beam as its family."""
    return torch.tensor(np.repeat(np.arange(families) % 4, kb), dtype=torch.int32,
                        device=dev)


def mega_errors(cfg, packed, inputs, cur, kv_limit, beam_anc=None, act_quant=False):
    """Kernel and plain version on the same inputs -> {name: (got, want)}
    for the hidden row and every layer's K and V rows at ``cur``."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain)
    xk, xv, kc, vc, x, npad, tt = inputs
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    call = dict(config=cfg, kv_limit=kv_limit, beam_anc=beam_anc, act_quant=act_quant)
    got = decode_step_megakernel(packed, xk, xv, kc1, vc1, x, npad, tt, cur, **call)
    want = decode_step_megakernel_plain(packed, xk, xv, kc2, vc2, x, npad, tt,
                                        cur, **call)
    torch.cuda.synchronize()
    return {"hidden": (got.float(), want.float()),
            "k rows": (kc1[:, cur].float(), kc2[:, cur].float()),
            "v rows": (vc1[:, cur].float(), vc2[:, cur].float())}


def held_to_ulps(label, errs, worst, limit=2):
    """Every (got, want) of ``mega_errors`` within ``limit`` bf16 ulps at
    want's scale; ``worst`` = [ulps, abs error, where] so far, updated:
    ``where`` names the case, the tensor and index of the largest error
    ((layer, row, column) for the K/V rows), both values, and how many
    elements of that tensor differ by 1 ulp or more."""
    for name, (got, want) in errs.items():
        assert bool(torch.isfinite(got).all()), (label, name)
        diff = (got - want).abs()
        err, ulp = float(diff.max()), bf16_ulps(want, 1)
        if err / ulp > worst[0]:
            idx = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
            worst[2] = (f"{label} {name}{list(idx)}: kernel {float(got[idx])}, plain "
                        f"{float(want[idx])}, ulp {ulp}; {int((diff >= ulp).sum())} of "
                        f"{diff.numel()} elements at 1 ulp or more")
        worst[0], worst[1] = max(worst[0], err / ulp), max(worst[1], err)
        assert err / ulp <= limit, f"{label} {name}: {err / ulp} ulp"


def held_normwise(label, cfg, packed, inputs, cur, kv_limit, beam_anc=None,
                  act_quant=False, worst=None, bitwise=False):
    """A deep trunk (or any w8a8 step): the kernel against the plain version
    on the card, normwise. The roundings compound over layers, and in the
    w8a8 mode one bf16 element rounded the other way can move its row's
    quantization scale; the plain version on the CPU (float32 sums in
    another order) measures how far that alone moves the result, and the
    kernel may differ from the plain version on the card by 1e-2 or by 1.25
    times that spread, whichever is larger. ``worst`` (a dict, updated:
    the largest abs error and where it lies, the largest share of the
    tolerance used): print one summary instead of a line per case.
    ``bitwise``: also hold every tensor bit for bit equal to the plain
    version on the card (the w8a8 mode is exact by design)."""
    from flamingo_mini_tpu_torch.ops.megadecode import decode_step_megakernel_plain
    host = {k: (t.cpu() if isinstance(t, torch.Tensor) else t) for k, t in packed.items()}
    xk, xv, kc, vc, x, npad, tt = (t.cpu() for t in inputs)
    cpu_hidden = decode_step_megakernel_plain(
        host, xk, xv, kc, vc, x, npad, tt, cur, config=cfg, kv_limit=kv_limit,
        beam_anc=None if beam_anc is None else beam_anc.cpu(), act_quant=act_quant)
    cpu = {"hidden": cpu_hidden.float(), "k rows": kc[:, cur].float(),
           "v rows": vc[:, cur].float()}
    rel, spread = {}, {}
    for name, (got, want) in mega_errors(cfg, packed, inputs, cur, kv_limit,
                                         beam_anc, act_quant).items():
        rel[name] = float((got - want).norm() / want.norm())
        spread[name] = float((cpu[name] - want.cpu()).norm() / want.norm())
        assert bool(torch.isfinite(got).all()), name
        assert rel[name] <= max(1e-2, 1.25 * spread[name]), (label, name, rel, spread)
        assert not bitwise or torch.equal(got, want), (label, name, "not bit-equal", rel)
        if worst is not None:
            diff = (got - want).abs()
            err = float(diff.max())
            if err > worst.get("err", -1.0):
                idx = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
                worst["err"], worst["where"] = err, (
                    f"{label} {name}{list(idx)}: kernel {float(got[idx])}, plain "
                    f"{float(want[idx])}; normwise {rel[name]}, CPU spread {spread[name]}")
            worst["share"] = max(worst.get("share", 0.0),
                                 rel[name] / max(1e-2, 1.25 * spread[name]))
            worst["rel"] = max(worst.get("rel", 0.0), rel[name])
    if worst is None:
        print(f"[phase 2] {label}: normwise relative error {rel}; the plain version "
              f"on the CPU vs on the card {spread} (tolerance: the larger of 1e-2 "
              "and 1.25 x that spread)")


def mega_bound(packed, cfg, inputs, kv_slots: int, n_pos: int, extra_bytes=0,
               act_quant=False):
    """(bound ms, what bounds it) of one megakernel call: every weight,
    scale, bias and LN param once; the xattn K/V of each row's image; per
    layer ``kv_slots`` cached K/V rows read and the new ones written; the
    hidden rows in and out; two multiply-adds per weight per row (w8a8: at
    the int8 rate) and four per (row, position, dim) of self-attention over
    ``n_pos`` pairs."""
    from flamingo_mini_tpu_torch.ops.megadecode import trunk_dims
    xk, xv, kc, vc, x, npad, tt = inputs
    D, _Dff, L, _H = trunk_dims(cfg.lm_arch)
    b, XI = x.shape[0], xk.shape[3]
    weights = sum(t.numel() * t.element_size() for t in packed.values()
                  if isinstance(t, torch.Tensor))
    x_kv = len(packed["xlayers"]) * 2 * int((tt > 0).sum()) * cfg.resampler_num_latents * XI * 2
    n_bytes = (weights + x_kv + L * 2 * kv_slots * D * 2 + L * 2 * b * D * 2
               + 2 * 2 * b * D + extra_bytes)
    n_mac = sum(t.numel() for k, t in packed.items() if k.startswith("w_"))
    lin_ops, att_ops = 2 * b * n_mac, L * 4 * n_pos * D
    n_ops = lin_ops + att_ops
    bound_ms, bound_by = (bound(n_bytes, att_ops, lin_ops) if act_quant
                          else bound(n_bytes, n_ops))
    return bound_ms, bound_by, n_bytes, n_ops


def print_grids(label, packed, cfg, inputs_by_rows, cur, kv_limit, act_quant=False):
    """The cooperative grid the megakernel launches for each {rows:
    (inputs, beam_anc)}."""
    from flamingo_mini_tpu_torch.ops.megadecode import kernel_args, kernel_grid
    for rows, (inputs, anc) in inputs_by_rows.items():
        args, _, _ = kernel_args(packed, *inputs, cur, config=cfg, kv_limit=kv_limit,
                                 beam_anc=anc, act_quant=act_quant)
        blocks, smem = kernel_grid(args)
        print(f"[phase 2] {label} grid at {rows} rows: {blocks} blocks, {smem} bytes "
              "of shared memory each")


def phase2_megakernel(dev, flush):
    pairs = ((4, 36), (35, 36), (70, 100), (131, 132))
    worst, case = [0.0, 0.0, None], 0
    for n_layer, every in ((1, 1), (2, 1), (2, 2)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                   seed=10 * n_layer + every)
        for b in (1, 3, 32):
            inputs = mega_inputs(dev, cfg, b, seed=case)
            for cur, kv_limit in (pairs[case % 4], pairs[(case + 1) % 4]):
                held_to_ulps(f"megakernel layers={n_layer} every={every} b={b} "
                             f"cur={cur} kv_limit={kv_limit}",
                             mega_errors(cfg, packed, inputs, cur, kv_limit), worst)
            case += 1
    print(f"[phase 2] decode_step_megakernel vs plain, 1-2 layers, b in "
          f"{{1, 3, 32}}, xattn every 1 and 2, {2 * case} (cur, kv_limit) "
          f"cases: max error {worst[0]} bf16 ulp at the output's scale "
          f"(tolerance 2), max abs error {worst[1]}; largest at {worst[2]}")

    # 24 layers at the slice's shape, then the timing
    return dict(mega_timed(dev, flush, BATCH), max_abs_err=worst[1])


def mega_timed(dev, flush, b: int, plain_iters: int = 50):
    """decode_step_megakernel on the slice's 24-layer trunk at ``b`` rows:
    held to its plain version normwise (``held_normwise``), then timed
    beside it (the median of ``plain_iters`` calls of the plain version),
    with its bound -> a kernel row (``max_abs_err`` that check's)."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain)
    cfg, packed = random_trunk(dev, n_layer=24, xattn_every=1, seed=24)
    inputs = mega_inputs(dev, cfg, b, seed=99)
    worst = {}
    label = f"decode_step_megakernel vs plain, 24 layers, b={b}"
    held_normwise(label, cfg, packed, inputs, 131, 132, worst=worst)
    print(f"[phase 2] {label}: normwise relative error {worst['rel']} (share of the "
          f"tolerance {worst['share']}: the larger of 1e-2 and 1.25 x the plain "
          f"version's CPU-vs-card spread); max abs err {worst['err']}")
    xk, xv, kc, vc, x, npad, tt = inputs
    npad.zero_()
    call = dict(config=cfg, kv_limit=132)
    print_grids("decode_step_megakernel", packed, cfg, {b: (inputs, None)}, 131, 132)
    ms = time_ms(lambda: decode_step_megakernel(packed, xk, xv, kc, vc, x, npad,
                                                tt, 131, **call), 50, flush)
    plain_ms = time_ms(lambda: decode_step_megakernel_plain(
        packed, xk, xv, kc, vc, x, npad, tt, 131, **call), plain_iters, flush)
    n_pos = int((132 - npad).sum())
    bound_ms, bound_by, n_bytes, n_ops = mega_bound(packed, cfg, inputs, n_pos, n_pos)
    print(f"[phase 2] decode_step_megakernel bound at b={b}, 24 layers, "
          f"kv_limit 132: {n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} GFLOP -> "
          f"{bound_ms:.4f} ms ({bound_by}); {ms} ms, plain {plain_ms} ms")
    return dict(max_abs_err=worst["err"], ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def ancestor_reads(anc, npad, cur: int, kb: int):
    """(distinct family (row, slot) pairs that the rows' valid positions
    [npad, cur] read, number of valid (row, position) pairs)."""
    families = anc.shape[0]
    t = torch.arange(cur + 1, device=anc.device)
    a = anc[:, :, :cur + 1]
    valid = t >= npad.view(families, kb)[:, :, None]                # (f, i, t)
    touched = torch.stack([((a == j) & valid).any(dim=1) for j in range(kb)])
    return int(touched.sum()), int(valid.sum())


def phase2_decode_attention_beam(dev, flush):
    from flamingo_mini_tpu_torch.ops.decode_attention import (
        decode_attention_beam, decode_attention_beam_plain)
    b, kb = BATCH, BEAMS
    B = b * kb
    rs = np.random.RandomState(2)
    shape = (BEAM_T, B, ATTN_D)
    q32 = torch.tensor(rs.randn(B, ATTN_D) * 0.3, dtype=torch.float32, device=dev)
    k32 = torch.tensor(rs.randn(*shape) * 0.3, dtype=torch.float32, device=dev)
    v32 = torch.tensor(rs.randn(*shape) * 0.3, dtype=torch.float32, device=dev)
    npad = family_npad(dev, b, kb)
    anc = random_ancestry(dev, b, kb, seed=3)     # 68 slots: shorter than the cache
    scale = 1.0 / 8.0
    # cur 2: the families padded by 3 attend nothing (uniform over the
    # family); cur 127: past the table's 68 slots (ancestor 0)
    cases = BEAM_PAIRS + ((2, 37), (127, 128))
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        for cur, kv_limit in cases:
            kw = dict(n_head=ATTN_H, scale=scale, kb=kb, kv_limit=kv_limit)
            got = decode_attention_beam(q, k, v, anc, npad, cur, **kw)
            want = decode_attention_beam_plain(q, k, v, anc, npad, cur, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = 1e-5 if dtype == torch.float32 else bf16_ulps(want.float(), 2)
            assert bool(torch.isfinite(got).all()), (dtype, cur, kv_limit)
            assert err <= tol, f"decode_attention_beam {dtype} cur={cur} " \
                f"kv_limit={kv_limit}: max err {err} > {tol}"
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    print(f"[phase 2] decode_attention_beam vs plain, {B} rows in families of "
          f"{kb}, {len(cases)} (cur, kv_limit) cases: max abs err {worst} "
          "(tolerance: f32 1e-5, bf16 2 ulp of the output scale)")
    for rows, fam in ((B, kb), (160, 5)):
        edges = attention_edges(dev, rows, fam, ATTN_D, BEAM_T, seed=rows)
        print_edges(f"decode_attention_beam edges at {rows} rows in families of {fam} "
                    f"(kv_limit {ATTN_EDGE_LIMITS}, split layouts {ATTN_SPLIT_PLANS} "
                    f"at 68)", edges)
        for dtype, (err, _tol, _where) in edges.items():
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    # the beam loop's last step
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    return dict(max_abs_err=max(worst.values()),
                **time_beam_attention(dev, flush, q, k, v, anc, npad, 66, 68, ATTN_H, kb,
                                      scale))


def time_beam_attention(dev, flush, q, k, v, anc, npad, cur, t_lim, H, kb, scale):
    """decode_attention_beam at (cur, kv_limit t_lim) on bf16 inputs: its
    time, the plain version's, one SDPA call's over each family's kb x
    t_lim keys (the ancestry as a boolean mask) and the bound of the
    distinct ancestor slots it needs -> those, as a kernel row's fields."""
    from flamingo_mini_tpu_torch.ops.decode_attention import (
        decode_attention_beam, decode_attention_beam_plain)
    B, D = q.shape
    b, dh = B // kb, D // H
    kw = dict(n_head=H, scale=scale, kb=kb, kv_limit=t_lim)
    ms = time_ms(lambda: decode_attention_beam(q, k, v, anc, npad, cur, **kw), 50, flush)
    plain_ms = time_ms(lambda: decode_attention_beam_plain(q, k, v, anc, npad, cur, **kw),
                       20, flush)
    # yardstick: one SDPA call over each family's kb x t_lim keys, the
    # ancestry as a boolean mask (all built outside the timed region)
    qf = q.view(b, kb, H, dh).permute(0, 2, 1, 3).contiguous()
    kf, vf = (c[:t_lim].view(t_lim, b, kb, H, dh).permute(1, 3, 2, 0, 4)
              .reshape(b, H, kb * t_lim, dh).contiguous() for c in (k, v))
    t = torch.arange(t_lim, device=dev)
    ok = (t >= npad.view(b, kb)[:, :, None]) & (t <= cur)            # (b, i, t)
    own = anc[:, :, :t_lim, None] == torch.arange(kb, device=dev)    # (b, i, t, j)
    mask = (own & ok[..., None]).permute(0, 1, 3, 2).reshape(b, 1, kb, kb * t_lim)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qf, kf, vf, attn_mask=mask, scale=scale)
    lib_err = float((lib_out.permute(0, 2, 1, 3).reshape(B, D).float()
                     - decode_attention_beam(q, k, v, anc, npad, cur, **kw).float())
                    .abs().max())
    library_ms = time_ms(lambda: sdpa(qf, kf, vf, attn_mask=mask, scale=scale), 50, flush)
    print(f"[phase 2] scaled_dot_product_attention over each family's {kb} x "
          f"{t_lim} keys, ancestry mask: max abs diff to the kernel {lib_err}; the "
          f"wrapper's host "
          f"{host_us(lambda: decode_attention_beam(q, k, v, anc, npad, cur, **kw)):.1f} "
          "us a call")
    slots, n_pos = ancestor_reads(anc, npad, cur, kb)
    n_bytes = 2 * 2 * slots * D + 2 * 2 * B * D + 4 * B + 4 * n_pos
    bound_ms, bound_by = bound(n_bytes, 4 * n_pos * D)
    print(f"[phase 2] decode_attention_beam at {B} rows, D={D}, heads of {dh}, cur {cur}: "
          f"{ms} ms, plain {plain_ms} ms, SDPA {library_ms} ms; bound: {slots} distinct "
          f"ancestor slots of {B * (cur + 1)}, {n_bytes / 1e6:.3f} MB -> {bound_ms:.5f} ms "
          f"({bound_by}) (median per call, L2 flushed)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def beam_trunk_inputs(dev, cfg, rows: int, kb: int, seed: int):
    """mega_inputs at the beam cache length with family padding, and a
    random ancestry table."""
    inputs = list(mega_inputs(dev, cfg, rows, seed, T=BEAM_T))
    inputs[5] = family_npad(dev, rows // kb, kb)
    return tuple(inputs), random_ancestry(dev, rows // kb, kb, seed)


def phase2_megakernel_beam(dev, flush):
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain, max_rows)
    worst, n_cases = [0.0, 0.0, None], 0
    for n_layer, every in ((1, 1), (2, 1), (2, 2)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                   seed=100 + 10 * n_layer + every)
        grids = {}
        for rows, kb in ((3, 3), (24, 3), (96, 3), (160, 5)):
            inputs, anc = beam_trunk_inputs(dev, cfg, rows, kb, seed=rows + n_layer)
            grids[rows] = (inputs, anc)
            for i in (n_cases % 4, (n_cases + 1) % 4):
                cur, kv_limit = BEAM_PAIRS[i]
                held_to_ulps(f"megakernel beam layers={n_layer} every={every} "
                             f"rows={rows} kb={kb} cur={cur} kv_limit={kv_limit}",
                             mega_errors(cfg, packed, inputs, cur, kv_limit,
                                         beam_anc=anc), worst)
            n_cases += 1
    print(f"[phase 2] decode_step_megakernel beam mode vs plain, 1-2 layers, "
          f"rows (kb) in 3 (3), 24 (3), 96 (3), 160 (5), xattn every 1 and 2, "
          f"{2 * n_cases} (cur, kv_limit) cases: max error {worst[0]} bf16 ulp "
          f"at the output's scale (tolerance 2), max abs error {worst[1]}; "
          f"largest at {worst[2]}")
    print_grids("decode_step_megakernel beam mode", packed, cfg,
                {r: grids[r] for r in (96, 160)}, 66, 68)

    # 24 layers at the slice's 96 rows: the normwise criterion of the
    # greedy mode (phase 2 above)
    cfg, packed = random_trunk(dev, n_layer=24, xattn_every=1, seed=24)
    print(f"[phase 2] decode_step_megakernel row limit at flamingo-mini width: "
          f"{max_rows(packed, cfg)} rows")
    rows = BATCH * BEAMS
    inputs, anc = beam_trunk_inputs(dev, cfg, rows, BEAMS, seed=97)
    held_normwise(f"decode_step_megakernel beam mode vs plain, 24 layers, {rows} rows",
                  cfg, packed, inputs, 66, 68, beam_anc=anc)
    xk, xv, kc, vc, x, npad, tt = inputs
    call = dict(config=cfg, kv_limit=68, beam_anc=anc)
    ms = time_ms(lambda: decode_step_megakernel(packed, xk, xv, kc, vc, x, npad,
                                                tt, 66, **call), 30, flush)
    plain_ms = time_ms(lambda: decode_step_megakernel_plain(
        packed, xk, xv, kc, vc, x, npad, tt, 66, **call), 10, flush)
    # each distinct ancestor slot's K/V once per layer, the ancestry read
    slots, n_pos = ancestor_reads(anc, npad, 66, BEAMS)
    bound_ms, bound_by, n_bytes, n_ops = mega_bound(packed, cfg, inputs, slots, n_pos,
                                                    extra_bytes=4 * n_pos)
    print(f"[phase 2] decode_step_megakernel beam mode bound at {rows} rows, 24 "
          f"layers, cur 66, kv_limit 68: {n_bytes / 1e9:.4f} GB, "
          f"{n_ops / 1e9:.3f} GFLOP -> {bound_ms:.4f} ms ({bound_by})")
    # scaling past the slice: 160 rows (32 x 5 beams), the same step
    inputs160, anc160 = beam_trunk_inputs(dev, cfg, 160, 5, seed=96)
    ms160 = time_ms(lambda: decode_step_megakernel(
        packed, *inputs160, 66, config=cfg, kv_limit=68, beam_anc=anc160), 30, flush)
    print(f"[phase 2] decode_step_megakernel beam mode, 24 layers, kv_limit 68: "
          f"{ms} ms at {rows} rows, {ms160} ms at 160 rows (median per call, "
          "L2 flushed)")
    return dict(max_abs_err=worst[1], ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, ms160=ms160)


def phase2_megakernel_opt(dev, flush):
    """The OPT mode at OPT-1.3B width: D=2048, 32 heads, ffn 8192, xattn
    XI=512 (Dffx 8192) before every other layer, 64 latents, a 128-slot
    cache."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain, max_rows)
    dims = dict(family="opt", D=OPT_D, H=OPT_H, xattn_every=2)

    def shallow(activation, limit):
        worst, case = [0.0, 0.0, None], 0
        for n_layer in (1, 2):
            cfg, packed = random_trunk(dev, n_layer=n_layer, seed=200 + n_layer,
                                       activation=activation, **dims)
            for b in (1, 3, 8, 32):
                inputs = mega_inputs(dev, cfg, b, seed=300 + case, T=OPT_T)
                for cur, kv_limit in (OPT_PAIRS[case % 4], OPT_PAIRS[(case + 1) % 4]):
                    held_to_ulps(f"layers={n_layer} b={b} cur={cur} kv_limit={kv_limit}",
                                 mega_errors(cfg, packed, inputs, cur, kv_limit),
                                 worst, limit)
                case += 1
        return worst, case

    worst, case = shallow("relu", 2)
    print(f"[phase 2] decode_step_megakernel OPT mode vs plain, 1-2 layers "
          f"(xattn on the first), b in {{1, 3, 8, 32}}, {2 * case} (cur, kv_limit) "
          f"cases: max error {worst[0]} bf16 ulp at the output's scale "
          f"(tolerance 2), max abs error {worst[1]}; largest at {worst[2]}")
    # the same weights and inputs with GELU in place of ReLU: whether ReLU
    # is what brings the error to its largest (not checked against a limit)
    gelu, _ = shallow("gelu_new", float("inf"))
    print(f"[phase 2] the same cases with GELU (tanh) in place of ReLU: max "
          f"error {gelu[0]} bf16 ulp; largest at {gelu[2]}")

    cfg, packed = random_trunk(dev, n_layer=24, seed=224, **dims)
    print(f"[phase 2] decode_step_megakernel row limit at OPT-1.3B width: "
          f"{max_rows(packed, cfg)} rows")
    inputs = mega_inputs(dev, cfg, OPT_B, seed=98, T=OPT_T)
    held_normwise(f"decode_step_megakernel OPT mode vs plain, 24 layers, b={OPT_B}",
                  cfg, packed, inputs, 70, 71)
    print_grids("decode_step_megakernel OPT mode", packed, cfg,
                {OPT_B: (inputs, None),
                 32: (mega_inputs(dev, cfg, 32, seed=97, T=OPT_T), None)}, 70, 71)
    torch.cuda.empty_cache()
    # the greedy loop's last step: rows 0 and 1 left-padded, every row an image
    xk, xv, kc, vc, x, npad, tt = inputs
    npad.copy_(torch.tensor([OPT_PAD] * 2 + [0] * (OPT_B - 2), dtype=torch.int32))
    tt.fill_(1)
    call = dict(config=cfg, kv_limit=71)
    ms = time_ms(lambda: decode_step_megakernel(packed, xk, xv, kc, vc, x, npad,
                                                tt, 70, **call), 50, flush)
    plain_ms = time_ms(lambda: decode_step_megakernel_plain(
        packed, xk, xv, kc, vc, x, npad, tt, 70, **call), 10, flush)
    n_pos = int((71 - npad).sum())
    bound_ms, bound_by, n_bytes, n_ops = mega_bound(packed, cfg, inputs, n_pos, n_pos)
    print(f"[phase 2] decode_step_megakernel OPT mode at b={OPT_B}, 24 layers, "
          f"kv_limit 71: {ms} ms, plain {plain_ms} ms; bound {n_bytes / 1e9:.4f} GB, "
          f"{n_ops / 1e9:.3f} GFLOP -> {bound_ms:.4f} ms ({bound_by}) (median per "
          "call, L2 flushed)")
    return dict(max_abs_err=worst[1], ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase2_megakernel_edges(dev):
    """The weight-only mode's Hopper kernel (``decode_megakernel_sm90.cuh``)
    at its edges: its grid barrier alone, rows on both sides of the wgmma
    N steps, of its wide mode and of its 256-row passes, a cache of one slot with left-padded
    rows, D=2048, determinism, and shapes launched back to back (module
    docstring) -> the largest abs error."""
    from flamingo_mini_tpu_torch.ops.megadecode import grid_sync_test
    bad = grid_sync_test(dev, 2000)
    assert bad == 0, f"grid barrier: {bad} stamps read wrong"
    print("[phase 2] the weight-only kernel's grid barrier alone: 2000 barriers, "
          "every block's stamps read back after each, 0 wrong")
    worst, n = [0.0, 0.0, None], 0
    for every in (1, 2):
        cfg, packed = random_trunk(dev, n_layer=2, xattn_every=every, seed=900 + every)
        for b in EDGE_ROWS:
            n += edge_rows_case(dev, cfg, packed, b, worst, f"every={every} ")
    opt = random_trunk(dev, n_layer=2, seed=930, family="opt", D=OPT_D, H=OPT_H,
                       xattn_every=2)
    for b in (9, 33):
        n += edge_rows_case(dev, *opt, b, worst, "OPT-1.3B width ")
    print(f"[phase 2] weight-only kernel at its edges, 2 layers: D=1024 (xattn every 1 "
          f"and 2) b in {EDGE_ROWS} x (cur, kv_limit) in (0, 1) (left-padded rows "
          f"attend nothing), (35, 36), (131, 132); D=2048 b in (9, 33) (cur, kv_limit "
          f"(0, 1), (70, 71)); {n} cases: max error {worst[0]} bf16 ulp at the output's "
          f"scale (tolerance 2), max abs error {worst[1]}; largest at {worst[2]}")
    back_to_back(dev, worst)
    return worst[1]


def media_inputs(dev, cfg, b: int, seed: int, NMNV: int):
    """``mega_inputs`` over ``NMNV`` media latents a row: with more than one
    image, rows take text_time from the media count (row 0) down through 0
    in turn."""
    inputs = mega_inputs(dev, cfg, b, seed, NMNV=NMNV)
    if NMNV > cfg.resampler_num_latents:
        n_media = NMNV // cfg.resampler_num_latents
        inputs[6].copy_((torch.arange(b, device=dev) + n_media) % (n_media + 1))
    return inputs


def phase2_megakernel_widths(dev, flush):
    """The weight-only megakernel at BASELINE's other widths: flamingo-tiny
    (D=768, 12 heads; configs 1 and 5) over one image's 64 latents and four
    images' 256, and flamingo-mini (D=1024) over 256 (config 4). 1-2
    layers, b in {1, 3, 8, 32}, within 2 bf16 ulps (printing the worst case
    and where it fell); then 12 layers at b=32 (config 1) and 24 layers at
    b=8 over 256 latents (config 4) under the normwise rule, each timed
    beside its plain version and bound -> {"tiny": row, "media4": row}."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain)
    tiny = dict(D=TINY_D, H=TINY_H)
    pairs = ((3, 36), (35, 36), (66, 68), (95, 96))
    worst, case = [0.0, 0.0, None], 0
    for width, n_layer, every, nmnv in (
            (tiny, 1, 1, MEGA_NV), (tiny, 2, 1, MEGA_NV), (tiny, 2, 2, MEGA_NV),
            (tiny, 2, 1, MEDIA4_NV), ({}, 1, 1, MEDIA4_NV), ({}, 2, 2, MEDIA4_NV)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                   seed=1600 + case, **width)
        for b in (1, 3, 8, 32):
            inputs = media_inputs(dev, cfg, b, 1700 + case, nmnv)
            for cur, kv_limit in (pairs[case % 4], pairs[(case + 1) % 4]):
                held_to_ulps(f"D={cfg.dim} layers={n_layer} every={every} NMNV={nmnv} "
                             f"b={b} cur={cur} kv_limit={kv_limit}",
                             mega_errors(cfg, packed, inputs, cur, kv_limit), worst)
            case += 1
    print(f"[phase 2] decode_step_megakernel vs plain at D={TINY_D} ({TINY_H} heads; "
          f"64 and {MEDIA4_NV} media latents) and D={MEGA_D} ({MEDIA4_NV} latents, "
          f"text_time 0-4), 1-2 layers, b in {{1, 3, 8, 32}}, {2 * case} (cur, kv_limit) "
          f"cases: max error {worst[0]} bf16 ulp at the output's scale (tolerance 2), "
          f"max abs error {worst[1]}; largest at {worst[2]}")
    out = {}
    for key, width, n_layer, b, nmnv, cur in (("tiny", tiny, 12, 32, MEGA_NV, 67),
                                              ("media4", {}, 24, 8, MEDIA4_NV, 95)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=1, seed=1650 + b,
                                   **width)
        inputs = media_inputs(dev, cfg, b, 1660 + b, nmnv)
        label = f"decode_step_megakernel D={cfg.dim}, {n_layer} layers, b={b}, NMNV={nmnv}"
        held_normwise(f"{label} vs plain", cfg, packed, inputs, cur, cur + 1)
        xk, xv, kc, vc, x, npad, tt = inputs
        npad.zero_()
        call = dict(config=cfg, kv_limit=cur + 1)
        print_grids(label, packed, cfg, {b: (inputs, None)}, cur, cur + 1)
        ms = time_ms(lambda: decode_step_megakernel(packed, xk, xv, kc, vc, x, npad,
                                                    tt, cur, **call), 50, flush)
        plain_ms = time_ms(lambda: decode_step_megakernel_plain(
            packed, xk, xv, kc, vc, x, npad, tt, cur, **call), 20, flush)
        n_pos = b * (cur + 1)
        bound_ms, bound_by, n_bytes, n_ops = mega_bound(packed, cfg, inputs, n_pos, n_pos)
        print(f"[phase 2] {label}, kv_limit {cur + 1}: {ms} ms, plain {plain_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {n_bytes / 1e9:.4f} GB, "
              f"{n_ops / 1e9:.3f} GFLOP) (median per call, L2 flushed)")
        out[key] = dict(max_abs_err=worst[1], ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by)
    return out


def edge_rows_case(dev, cfg, packed, b: int, worst, label: str = "",
                   act_quant: bool = False) -> int:
    """The kernel (weight-only, or the w8a8 mode) against its plain version
    at ``b`` rows over a cache of one slot (rows left-padded by r % 4
    attend nothing), and at the last steps of two live prefixes; 2 bf16
    ulps, and in the w8a8 mode (exact by design) bit for bit -> cases
    run."""
    T = MEGA_T if cfg.dim == MEGA_D else OPT_T
    inputs = mega_inputs(dev, cfg, b, seed=910 + b, T=T)
    pairs = ((0, 1), (35, 36), (131, 132)) if T == MEGA_T else ((0, 1), (70, 71))
    for cur, kv_limit in pairs:
        errs = mega_errors(cfg, packed, inputs, cur, kv_limit, act_quant=act_quant)
        held_to_ulps(f"{label}b={b} cur={cur} kv_limit={kv_limit}", errs, worst)
        for name, (got, want) in errs.items():
            assert not act_quant or torch.equal(got, want), \
                f"{label}b={b} cur={cur} {name}: not bit-equal to the plain version"
    return len(pairs)


def back_to_back(dev, worst, act_quant: bool = False):
    """The kernel (weight-only, or the w8a8 mode): greedy b=32 and b=3
    (flamingo-mini width), beams at 96 rows and OPT-1.3B width at b=8, 2
    layers, launched back to back on one stream before one synchronize,
    each within 2 bf16 ulps of its plain version (the w8a8 mode bit for
    bit); each launched again on the same inputs, bit-equal."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain)
    cfg1, packed1 = random_trunk(dev, n_layer=2, xattn_every=1, seed=901)
    opt = random_trunk(dev, n_layer=2, seed=930, family="opt", D=OPT_D, H=OPT_H,
                       xattn_every=2)
    beam_in, anc = beam_trunk_inputs(dev, cfg1, 96, 3, seed=950)
    cases = (("greedy b=32", cfg1, packed1, mega_inputs(dev, cfg1, 32, seed=951), 131, 132,
              None),
             ("greedy b=3", cfg1, packed1, mega_inputs(dev, cfg1, 3, seed=952), 35, 36, None),
             ("beams 96 rows", cfg1, packed1, beam_in, 66, 68, anc),
             ("OPT-1.3B b=8", *opt, mega_inputs(dev, opt[0], 8, seed=953, T=OPT_T), 70, 71,
              None))
    outs = []
    for label, cfg, packed, inputs, cur, kv_limit, beam_anc in cases:
        xk, xv, kc, vc, x, npad, tt = inputs
        kc1, vc1 = kc.clone(), vc.clone()
        outs.append((decode_step_megakernel(packed, xk, xv, kc1, vc1, x, npad, tt, cur,
                                            config=cfg, kv_limit=kv_limit,
                                            beam_anc=beam_anc, act_quant=act_quant),
                     kc1, vc1))
    torch.cuda.synchronize()
    for (label, cfg, packed, inputs, cur, kv_limit, beam_anc), (got, kc1, vc1) in zip(
            cases, outs):
        xk, xv, kc, vc, x, npad, tt = inputs
        kc2, vc2 = kc.clone(), vc.clone()
        want = decode_step_megakernel_plain(packed, xk, xv, kc2, vc2, x, npad, tt, cur,
                                            config=cfg, kv_limit=kv_limit,
                                            beam_anc=beam_anc, act_quant=act_quant)
        errs = {"hidden": (got.float(), want.float()),
                "k rows": (kc1[:, cur].float(), kc2[:, cur].float()),
                "v rows": (vc1[:, cur].float(), vc2[:, cur].float())}
        held_to_ulps(f"back to back {label}", errs, worst)
        for name, (g, w) in errs.items():
            assert not act_quant or torch.equal(g, w), \
                f"back to back {label} {name}: not bit-equal to the plain version"
        again = decode_step_megakernel(packed, xk, xv, kc.clone(), vc.clone(), x, npad, tt,
                                       cur, config=cfg, kv_limit=kv_limit, beam_anc=beam_anc,
                                       act_quant=act_quant)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), again.view(torch.int16)), \
            f"{label}: two launches on the same inputs differ"
    print(f"[phase 2] {'w8a8' if act_quant else 'weight-only'} mode: "
          f"{', '.join(c[0] for c in cases)} launched back to back before one "
          f"synchronize, each {'bit for bit' if act_quant else 'within 2 bf16 ulps of'} "
          "its plain version; each launched again on the same inputs: bit-equal")


def two_streams(dev, act_quant: bool = False):
    """Launches taking turns on two streams (greedy b=32, beams at 160
    rows, 2 layers) give the bits of the same launches on the current
    stream; the weight-only kernel's launches count on barrier words of
    each stream's own (the w8a8 kernel's grid barrier is the cooperative
    launch's)."""
    from flamingo_mini_tpu_torch.ops import megadecode as md
    cfg, packed = random_trunk(dev, n_layer=2, xattn_every=1, seed=960)
    beam_in, anc = beam_trunk_inputs(dev, cfg, 160, 5, seed=961)
    cases = ((mega_inputs(dev, cfg, 32, seed=962), 131, 132, None),
             (beam_in, 66, 68, anc))

    def launch(inputs, cur, kv_limit, beam_anc):
        xk, xv, kc, vc, x, npad, tt = inputs
        return md.decode_step_megakernel(packed, xk, xv, kc.clone(), vc.clone(), x, npad, tt,
                                         cur, config=cfg, kv_limit=kv_limit,
                                         beam_anc=beam_anc, act_quant=act_quant)
    want = [launch(*case) for case in cases]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    got = []
    for turn in range(4):
        stream = streams[turn % 2]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            got.append(launch(*cases[turn // 2 % 2]))
        torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize()
    for turn, out in enumerate(got):
        assert torch.equal(out.view(torch.int16), want[turn // 2 % 2].view(torch.int16)), turn
    keys = {(want[0].device, s.cuda_stream) for s in streams}
    assert act_quant or keys <= set(md._SYNC), \
        ("each stream has its own barrier words", keys, set(md._SYNC))


def phase2_megakernel_w8a8_edges(dev):
    """The w8a8 mode at the weight-only mode's edges: 2 layers, D=1024
    (xattn every 1 and 2) at ``EDGE_ROWS`` x (cur, kv_limit) in (0, 1)
    (left-padded rows attend nothing), (35, 36), (131, 132), bit for bit
    the plain version (and within 2 bf16 ulps); back to back and twice on
    the same inputs; taking turns on two streams -> the largest abs
    error."""
    worst, n = [0.0, 0.0, None], 0
    for every in (1, 2):
        cfg, packed = random_trunk(dev, n_layer=2, xattn_every=every, seed=900 + every)
        for b in EDGE_ROWS:
            n += edge_rows_case(dev, cfg, packed, b, worst, f"w8a8 every={every} ",
                                act_quant=True)
    print(f"[phase 2] w8a8 mode at its edges, 2 layers, D=1024 (xattn every 1 and 2), b in "
          f"{EDGE_ROWS} x (cur, kv_limit) in (0, 1), (35, 36), (131, 132): {n} cases, "
          f"each bit for bit the plain version; max error {worst[0]} bf16 ulp, max abs "
          f"error {worst[1]}")
    back_to_back(dev, worst, act_quant=True)
    two_streams(dev, act_quant=True)
    print("[phase 2] w8a8 mode: launches taking turns on two streams give the bits of "
          "one stream's")
    return worst[1]


def w8a8_linear_case(dev, b: int, K: int, N: int, width, seed: int):
    """The megakernel's w8a8 linear (``lin_w8a8``: its own device
    functions) and its plain version on the card, on the same inputs ->
    (kernel, plain), (b, N) bf16. Rows of N(0, 0.25); with b >= 3 row 0 is
    all zeros (amax 0); the last row holds, in each k-slice, 127 (scale
    exactly 1) and values on a .5 rounding boundary."""
    from flamingo_mini_tpu_torch.ops.megadecode import _lin_w8a8, lin_w8a8
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 * torch.randn((b, K), generator=gen, device=dev)
    if b >= 3:
        x[0] = 0.0
    plant = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], device=dev)
    for k0 in range(0, K, K if width is None else width):
        x[-1, k0:k0 + len(plant)] = plant
    x = x.to(torch.bfloat16)
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev).to(torch.int8)
    s = 0.01 + 0.01 * torch.rand(N, generator=gen, device=dev)
    bias = (0.1 * torch.randn(N, generator=gen, device=dev)).to(torch.bfloat16)
    return lin_w8a8(x, w, s, bias, width=width), _lin_w8a8(x, w, s, bias, width=width)


def phase2_w8a8_linear(dev):
    """The w8a8 linear alone, bitwise against its plain version on the card
    (the int8 sums are exact on both sides, each slice's sum is cast to
    float32 once, every later step is one float32 op in the same order)."""
    n = 0
    for K, N, width in W8A8_LINEAR:
        for b in (1, 3, 8, 32):
            got, want = w8a8_linear_case(dev, b, K, N, width, seed=n)
            torch.cuda.synchronize()
            parted = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            assert parted == 0, f"w8a8 linear K={K} N={N} width={width} b={b}: " \
                f"{parted} elements part"
            n += 1
    print(f"[phase 2] the megakernel's w8a8 linear alone vs plain, (K, N, slice) in "
          f"{W8A8_LINEAR} (None: column form), b in {{1, 3, 8, 32}}, a zero row and "
          f".5 rounding boundaries planted: {n} cases, bitwise equal")
    return n


def phase2_megakernel_w8a8(dev, flush):
    """The act_quant mode against its plain version: greedy (flamingo-mini
    width), beam (96 and 160 rows) and OPT-1.3B width at 1-2 layers, then
    at 24 layers each, timed -> {mode: kernel row}."""
    from flamingo_mini_tpu_torch.ops.megadecode import (
        decode_step_megakernel, decode_step_megakernel_plain)
    worst, n = {}, 0
    for n_layer, every in ((1, 1), (2, 2)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                   seed=400 + 10 * n_layer + every)
        for b in (1, 3, 32):
            cur, kv_limit = ((4, 36), (70, 100), (131, 132))[n % 3]
            held_normwise(f"greedy layers={n_layer} every={every} b={b} cur={cur}",
                          cfg, packed, mega_inputs(dev, cfg, b, seed=500 + n), cur,
                          kv_limit, act_quant=True, worst=worst, bitwise=True)
            n += 1
        for rows, kb in ((96, 3), (160, 5)):
            inputs, anc = beam_trunk_inputs(dev, cfg, rows, kb, seed=600 + n)
            cur, kv_limit = BEAM_PAIRS[n % 4]
            held_normwise(f"beam layers={n_layer} rows={rows} kb={kb} cur={cur}", cfg,
                          packed, inputs, cur, kv_limit, beam_anc=anc, act_quant=True,
                          worst=worst, bitwise=True)
            n += 1
    for n_layer in (1, 2):
        cfg, packed = random_trunk(dev, n_layer=n_layer, seed=700 + n_layer,
                                   family="opt", D=OPT_D, H=OPT_H, xattn_every=2)
        for b in (3, 8):
            cur, kv_limit = OPT_PAIRS[n % 4]
            held_normwise(f"OPT layers={n_layer} b={b} cur={cur}", cfg, packed,
                          mega_inputs(dev, cfg, b, seed=800 + n, T=OPT_T), cur, kv_limit,
                          act_quant=True, worst=worst, bitwise=True)
            n += 1
    print(f"[phase 2] decode_step_megakernel act_quant (w8a8) vs plain, 1-2 layers: "
          f"greedy b in {{1, 3, 32}}, beam 96 (kb 3) and 160 (kb 5) rows, OPT-1.3B "
          f"width b in {{3, 8}}, {n} cases, each bit for bit the plain version; "
          f"normwise relative error at most "
          f"{worst['rel']}, {worst['share']:.3f} of each case's tolerance at most "
          f"(the larger of 1e-2 and 1.25 x the plain version's CPU-vs-card spread); "
          f"max abs error {worst['err']}, at {worst['where']}")
    shallow_err = worst["err"]

    rows = {}
    # 24 layers: greedy b=32 and beams at 96 rows on flamingo-mini's trunk
    cfg, packed = random_trunk(dev, n_layer=24, xattn_every=1, seed=24)
    inputs = mega_inputs(dev, cfg, BATCH, seed=99)
    held_normwise("decode_step_megakernel act_quant vs plain, 24 layers, b=32", cfg,
                  packed, inputs, 131, 132, act_quant=True)
    b_inputs, anc = beam_trunk_inputs(dev, cfg, BATCH * BEAMS, BEAMS, seed=97)
    held_normwise(f"decode_step_megakernel act_quant beam mode vs plain, 24 layers, "
                  f"{BATCH * BEAMS} rows", cfg, packed, b_inputs, 66, 68, beam_anc=anc,
                  act_quant=True)
    print_grids("decode_step_megakernel act_quant", packed, cfg,
                {BATCH: (inputs, None), BATCH * BEAMS: (b_inputs, anc)}, 66, 68,
                act_quant=True)
    inputs[5].zero_()
    for mode, inp, cur, lim, beam_anc in (("greedy", inputs, 131, 132, None),
                                          ("beam", b_inputs, 66, 68, anc)):
        call = dict(config=cfg, kv_limit=lim, act_quant=True, beam_anc=beam_anc)
        ms = time_ms(lambda: decode_step_megakernel(packed, *inp, cur, **call), 30, flush)
        plain_ms = time_ms(lambda: decode_step_megakernel_plain(packed, *inp, cur, **call),
                           5, flush)
        if beam_anc is not None:
            slots, n_pos = ancestor_reads(anc, inp[5], cur, BEAMS)
            bound_ms, bound_by, n_bytes, _ = mega_bound(
                packed, cfg, inp, slots, n_pos, extra_bytes=4 * n_pos, act_quant=True)
        else:
            n_pos = int((lim - inp[5]).sum())
            bound_ms, bound_by, n_bytes, _ = mega_bound(packed, cfg, inp, n_pos, n_pos,
                                                        act_quant=True)
        print(f"[phase 2] decode_step_megakernel act_quant {mode} mode, 24 layers, "
              f"{inp[4].shape[0]} rows, kv_limit {lim}: {ms} ms, plain {plain_ms} ms; "
              f"bound {n_bytes / 1e9:.4f} GB -> {bound_ms:.4f} ms ({bound_by}) "
              "(median per call, L2 flushed)")
        rows[mode] = dict(max_abs_err=shallow_err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    del packed, inputs, b_inputs
    torch.cuda.empty_cache()
    # 24 layers at OPT-1.3B width, b=8, the greedy loop's last step
    cfg, packed = random_trunk(dev, n_layer=24, seed=224, family="opt", D=OPT_D,
                               H=OPT_H, xattn_every=2)
    inputs = mega_inputs(dev, cfg, OPT_B, seed=98, T=OPT_T)
    held_normwise(f"decode_step_megakernel act_quant OPT mode vs plain, 24 layers, "
                  f"b={OPT_B}", cfg, packed, inputs, 70, 71, act_quant=True)
    print_grids("decode_step_megakernel act_quant OPT mode", packed, cfg,
                {OPT_B: (inputs, None)}, 70, 71, act_quant=True)
    inputs[5].copy_(torch.tensor([OPT_PAD] * 2 + [0] * (OPT_B - 2), dtype=torch.int32))
    inputs[6].fill_(1)
    call = dict(config=cfg, kv_limit=71, act_quant=True)
    ms = time_ms(lambda: decode_step_megakernel(packed, *inputs, 70, **call), 30, flush)
    plain_ms = time_ms(lambda: decode_step_megakernel_plain(packed, *inputs, 70, **call),
                       5, flush)
    weight_only_ms = time_ms(lambda: decode_step_megakernel(
        packed, *inputs, 70, config=cfg, kv_limit=71), 30, flush)
    n_pos = int((71 - inputs[5]).sum())
    bound_ms, bound_by, n_bytes, _ = mega_bound(packed, cfg, inputs, n_pos, n_pos,
                                                act_quant=True)
    print(f"[phase 2] decode_step_megakernel act_quant OPT mode at b={OPT_B}, 24 layers, "
          f"kv_limit 71: {ms} ms, plain {plain_ms} ms; the weight-only mode on the same "
          f"inputs {weight_only_ms} ms; bound {n_bytes / 1e9:.4f} GB -> {bound_ms:.4f} ms "
          f"({bound_by}) (median per call, L2 flushed)")
    rows["opt"] = dict(max_abs_err=shallow_err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bound_ms, bound_by=bound_by)
    del packed, inputs
    torch.cuda.empty_cache()
    return rows


def wide_config(D: int):
    """A 1-layer OPT trunk D wide (ffn 4 D, heads of 64: the kernel's head
    dim) with a gated xattn block and a small ViT."""
    from flamingo_mini_tpu_torch import FlamingoConfig
    return FlamingoConfig(
        lm="facebook/opt-1.3b", dim=D, dim_visual=64, xattn_every=1,
        compute_dtype="bfloat16", resampler_depth=1, resampler_num_latents=64,
        lm_arch_overrides=dict(vocab_size=512, max_position_embeddings=64,
                               hidden_size=D, ffn_dim=4 * D, num_hidden_layers=1,
                               num_attention_heads=D // 64, word_embed_proj_dim=D),
        vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=1, num_attention_heads=4,
                                   image_size=32, patch_size=16))


def wide_trunk_model(dev, D: int = 4096):
    """``wide_config`` D wide, int8, bf16: at opt-6.7b's width (D=4096) a
    trunk the kernel takes at any row count in both modes; at D=8192 one
    whose rows its LayerNorm cannot hold in registers."""
    from flamingo_mini_tpu_torch import FlamingoModel
    model = FlamingoModel(wide_config(D), device=dev, seed=3)
    return model.quantize_int8().to_bf16()


# row counts on both sides of the kernel's wide mode and passes
D4096_ROWS = (27, 28, 64, 65, 73, 128, 255, 256, 257, 2048)


def phase2_refusal(dev):
    """The refusal before any work: on a D=8192 trunk (wider than the
    kernel's LayerNorm holds in registers) a w8a8 greedy call of 8 rows, a
    w8a8 beam call of 3 x 3 and a weight-only greedy call of 8 rows each
    raise ValueError before vision and prefill, launching nothing. At
    D=4096 both modes pass the check at ``D4096_ROWS``: the kernel stages
    int8 in the w8a8 mode, its plan leaves room for the LayerNorm's scale
    and bias, and its shared memory stops growing with the rows past a pass
    of 256 in both."""
    from flamingo_mini_tpu_torch import generation
    from flamingo_mini_tpu_torch.models import flamingo
    from flamingo_mini_tpu_torch.ops import megadecode
    model = wide_trunk_model(dev, 8192)
    ran = []

    def recorder(name, fn):
        def run(*a, **k):
            ran.append(name)
            return fn(*a, **k)
        return run
    messages = []
    for b, kw in ((8, dict(w8a8=True)), (3, dict(num_beams=3, w8a8=True)), (8, {})):
        ids = torch.ones((b, 4), dtype=torch.long, device=dev)
        pixels = torch.zeros((b, 1, 3, 32, 32), device=dev, dtype=torch.bfloat16)
        zero_counts()
        with patched(generation, "_prefill", recorder("prefill", generation._prefill)), \
                patched(flamingo, "encode_resample_visuals",
                        recorder("vision", flamingo.encode_resample_visuals)):
            try:
                model.generate(ids, pixel_values=pixels, max_length=16, megakernel=True,
                               **kw)
            except ValueError as e:
                messages.append(str(e))
            else:
                raise AssertionError(f"{b} rows at D=8192 ran on the megakernel ({kw})")
        counts = read_counts()
        assert not ran and not any(counts.values()), (ran, counts)
    for act_quant, message in ((True, messages[0]), (False, messages[-1])):
        try:
            megadecode.check_fits(model.config, 8, 16, 64, act_quant=act_quant, device=dev)
        except ValueError as e:
            assert str(e) == message, (str(e), message)
        else:
            raise AssertionError(f"the kernel took a D=8192 trunk (act_quant={act_quant})")
    config4096 = wide_config(4096)
    for rows in D4096_ROWS:
        for act_quant in (True, False):
            megadecode.check_fits(config4096, rows, 16, 64, act_quant=act_quant, device=dev)
    print(f"[phase 2] refusal at D=8192 before vision and prefill (nothing launched): "
          f"w8a8 greedy 8 rows {messages[0]!r}; w8a8 beams 3 x 3 and weight-only greedy "
          f"8 rows refused too; at D=4096 {D4096_ROWS} rows pass the check in both modes")
    del model
    torch.cuda.empty_cache()


def attention_inputs(dev, dtype, b, h, n_q, n_kv, seed, head_dim=HEAD_DIM):
    """q (b, h, n_q, d) and k, v (b, h, n_kv, d), d = ``head_dim``, as the
    models hand them to the kernels: ``split_heads`` views of (b, n, h * d)
    projections."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def proj(n):
        x = (0.5 * torch.randn((b, n, h * head_dim), generator=gen, device=dev)).to(dtype)
        return x.view(b, n, h, head_dim).transpose(1, 2)
    return proj(n_q), proj(n_kv), proj(n_kv)


def left_pad_bias(dev, dtype, b, n, pads):
    """GPT-2's (b, n) padding bias for rows left-padded by ``pads[r]``
    slots: 0 on real tokens, float32 min cast to ``dtype`` on pads (in bf16
    that is -inf). A causal pad query sees only pads at or before itself:
    a fully masked row."""
    real = torch.arange(n, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
    return torch.where(real, 0.0, torch.finfo(torch.float32).min).to(dtype)


def media_text_time(dev, b, n_q, n_media, seed):
    """(b, n_q) int32 media counts: every row holds 0 (no image yet), each
    of 1..n_media, and n_media + 1 (past the media count)."""
    rs = np.random.RandomState(seed)
    tt = rs.randint(0, n_media + 2, (b, n_q))
    tt[:, :n_media + 2] = np.arange(n_media + 2)[:n_q]
    return torch.tensor(tt, dtype=torch.int32, device=dev)


def media_mix(dev, mix, b, n_q, n_media, seed):
    """(b, n_q) int32 text_time of one of MEDIA_MIXES. ``span``: rows 0-7 of
    each 16-row slice after image 1, rows 8-15 after image 2 (odd batch rows
    the other way round); ``zero slice``: rows 0-15 of every batch row and
    all of row 1 before any image, the rest after image 1; ``past``: every
    row past the media count, row 0 at -1; ``timed``: the first half of the
    rows after image 1, the second after the last image (with one image,
    every row after it: the prefill and the forward as generate runs them)."""
    if mix == "random":
        return media_text_time(dev, b, n_q, n_media, seed)
    r = np.arange(n_q)
    tt = np.ones((b, n_q), np.int64)
    if mix == "span":
        lo = (r % 16) < min(8, (n_q + 1) // 2)
        tt[0::2] = np.where(lo, 1, n_media)
        tt[1::2] = np.where(lo, n_media, 1)
    elif mix == "zero slice":
        tt[:, :16] = 0
        tt[1 % b] = 0
    elif mix == "past":
        tt[:] = n_media + 1
        tt[0] = -1
    elif mix == "timed":
        tt[:, n_q // 2:] = n_media
    return torch.tensor(tt, dtype=torch.int32, device=dev)


def held_to_plain(label, got, want, dtype):
    """Max abs error of a kernel against its plain version; float32 within
    1e-5 of the output's scale, bf16 within 2 bf16 ulps of it."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), label
    err = float((got - want).abs().max())
    tol = (1e-5 * float(want.abs().max()) if dtype == torch.float32
           else bf16_ulps(want, 2))
    assert err <= tol, f"{label}: max err {err} > {tol}"
    return err


def attention_bound(b, h, n_q, n_kv, itemsize, extra_bytes=0, pairs=None,
                    head_dim=HEAD_DIM):
    """(bound ms, what bounds it): q, k, v read and the output written once;
    two multiply-adds per (query, key, dim) pair for QK^T and PV."""
    n_bytes = itemsize * head_dim * b * h * (2 * n_q + 2 * n_kv) + extra_bytes
    pairs = b * h * n_q * n_kv if pairs is None else pairs
    return bound(n_bytes, 4 * pairs * head_dim)


def phase2_fused_attention(dev, flush):
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, h, n_q, n_kv) in ATT_SHAPES.items():
            q, k, v = attention_inputs(dev, dtype, b, h, n_q, n_kv, seed=n_kv)
            kw = dict(scale=HEAD_DIM ** -0.5)
            if name.endswith("forward"):   # causal, rows 0 and 1 left-padded by 8
                kw.update(causal=True, row_bias=left_pad_bias(
                    dev, dtype, b, n_q, [GPT2_PAD, GPT2_PAD] + [0] * (b - 2)))
            got = fused_attention(q, k, v, **kw)
            worst = max(worst, held_to_plain(f"fused_attention {name} {dtype}", got,
                                             fused_attention_plain(q, k, v, **kw), dtype))
    print(f"[phase 2] fused_attention vs plain at the ViT {ATT_SHAPES['vit']}, "
          f"resampler {ATT_SHAPES['resampler']}, ViT-B/32 {ATT_SHAPES['vit-b/32']}, "
          f"8-frame resampler {ATT_SHAPES['video resampler']} and causal GPT-2 and "
          f"OPT-1.3B forward {ATT_SHAPES['gpt2 forward']}, {ATT_SHAPES['opt forward']} "
          f"and the OPT-125m training trunk {ATT_SHAPES['opt-125m forward']} "
          f"shapes (b, h, n_q, n_kv), the last three with two rows left-padded by "
          f"{GPT2_PAD} (fully masked pad queries), bf16 and "
          f"float32: max abs err {worst} (tolerance: f32 1e-5 of the output "
          "scale, bf16 2 ulp of it)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (b, h, n_q, n_kv) in ATT_SHAPES.items():
        q, k, v = attention_inputs(dev, torch.bfloat16, b, h, n_q, n_kv, seed=1)
        kw, lib_kw = dict(scale=HEAD_DIM ** -0.5), dict(scale=HEAD_DIM ** -0.5)
        extra, pairs = 0, None
        if name.endswith("forward"):
            # float32, as the trunks build it once per forward for every layer
            rb = left_pad_bias(dev, torch.bfloat16, b, n_q,
                               [GPT2_PAD, GPT2_PAD] + [0] * (b - 2)).float()
            kw.update(causal=True, row_bias=rb)
            causal = torch.ones(n_q, n_kv, dtype=torch.bool, device=dev).tril()
            lib_kw["attn_mask"] = torch.where(causal, rb[:, None, None, :].float(),
                                              float("-inf")).to(torch.bfloat16)
            extra, pairs = 2 * b * n_kv, b * h * n_q * (n_q + 1) // 2
        ms = time_ms(lambda: fused_attention(q, k, v, **kw), 50, flush)
        plain_ms = time_ms(lambda: fused_attention_plain(q, k, v, **kw), 20, flush)
        library_ms = time_ms(lambda: sdpa(q, k, v, **lib_kw), 50, flush)
        host = host_us(lambda: fused_attention(q, k, v, **kw))
        bound_ms, bound_by = attention_bound(b, h, n_q, n_kv, 2, extra, pairs)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
                         host_us=host)
        print(f"[phase 2] fused_attention {name} {(b, h, n_q, n_kv)} bf16: {ms} ms, "
              f"plain {plain_ms} ms, scaled_dot_product_attention {library_ms} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}) (median per call, L2 flushed); "
              f"wrapper host {host:.1f} us per call")
    return out


SM90_N_KV = (1, 63, 64, 65, 127, 128, 129, 257)
SM90_N_Q = (1, 65, 129, 257)
# back to back on one stream: (b, h, n_q, n_kv); the last one streams
SM90_BACK_TO_BACK = ((2, 3, 65, 129), (32, 16, 257, 257), (1, 2, 1, 1),
                     (8, 16, 64, 64), (2, 4, 300, 5000))


def phase2_sm90_edges(dev):
    """The bf16 kernels (the Hopper tile) against their plain versions at
    the tile's edges -> the worst max abs error."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain, fused_attention, fused_attention_plain)
    bf, scale, worst, n = torch.bfloat16, HEAD_DIM ** -0.5, 0.0, 0
    gen = torch.Generator(device=dev).manual_seed(11)
    for n_kv in SM90_N_KV:
        for n_q in SM90_N_Q:
            q, k, v = attention_inputs(dev, bf, 2, 3, n_q, n_kv, seed=n_q * 1000 + n_kv)
            pads = [min(5, n_kv - 1), 0]
            cases = {
                "plain": (q, k, v, dict(scale=scale)),
                "contiguous": (q.contiguous(), k.contiguous(), v.contiguous(),
                               dict(scale=scale)),
                "causal, left-padded": (q, k, v, dict(
                    scale=scale, causal=True, row_bias=left_pad_bias(dev, bf, 2, n_kv, pads))),
                "bias": (q, k, v, dict(scale=scale, bias=torch.randn(
                    (2, 1, n_q, n_kv), generator=gen, device=dev))),
            }
            for label, (qq, kk, vv, kw) in cases.items():
                got = fused_attention(qq, kk, vv, streaming=False, **kw)
                worst = max(worst, held_to_plain(
                    f"fused_attention bf16 {label} (2, 3, {n_q}, {n_kv})", got,
                    fused_attention_plain(qq, kk, vv, **kw), bf))
                n += 1
    ins = [attention_inputs(dev, bf, *shape, seed=i)
           for i, shape in enumerate(SM90_BACK_TO_BACK)]
    outs = [fused_attention(q, k, v, scale=scale) for q, k, v in ins]
    for (q, k, v), got in zip(ins, outs):
        plain = flash_attention_plain if k.shape[2] > 2048 else fused_attention_plain
        worst = max(worst, held_to_plain(f"back to back {tuple(k.shape)}", got,
                                         plain(q, k, v, scale=scale), bf))
    q, k, v = attention_inputs(dev, bf, 1, 2, 100, 3000, seed=3)
    kw = dict(scale=scale, causal=True, row_bias=left_pad_bias(dev, bf, 1, 3000, [8]))
    worst = max(worst, held_to_plain("flash_attention bf16 3000 keys", flash_attention(
        q, k, v, **kw), flash_attention_plain(q, k, v, **kw), bf))
    print(f"[phase 2] the Hopper tile (bf16) vs plain at its edges: n_kv {SM90_N_KV} by "
          f"n_q {SM90_N_Q} (b=2, 3 heads), plain strided and contiguous, causal with a "
          f"left-padded row, with a bias ({n} calls); back to back {SM90_BACK_TO_BACK} "
          f"before one synchronize; streaming at 3000 keys (24 tiles), causal, "
          f"left-padded: max abs err {worst} (2 bf16 ulps of each output's scale)")
    return worst


def phase2_flash_attention(dev, flush):
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain)
    b, h, n = FLASH_SHAPE
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(dev, dtype, b, h, n, n, seed=7)
        for causal in (False, True):
            # row 0 left-padded by 8: with causal, its first queries are
            # fully masked; the 4000 keys pad to 4096 (blocks of 256)
            kw = dict(scale=HEAD_DIM ** -0.5, causal=causal,
                      row_bias=left_pad_bias(dev, dtype, b, n, [GPT2_PAD, 0]))
            got = flash_attention(q, k, v, **kw)
            worst = max(worst, held_to_plain(f"flash_attention causal={causal} {dtype}",
                                             got, flash_attention_plain(q, k, v, **kw),
                                             dtype))
    print(f"[phase 2] flash_attention (streaming) vs plain at (b, h, n) = "
          f"{FLASH_SHAPE}, keys padded to 4096, causal and not, row 0 "
          f"left-padded by {GPT2_PAD}, bf16 and float32: max abs err {worst}")
    q, k, v = attention_inputs(dev, torch.bfloat16, b, h, n, n, seed=8)
    kw = dict(scale=HEAD_DIM ** -0.5)
    ms = time_ms(lambda: flash_attention(q, k, v, **kw), 20, flush)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), 5, flush)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **kw), 20, flush)
    host = host_us(lambda: flash_attention(q, k, v, **kw))
    bound_ms, bound_by = attention_bound(b, h, n, n, 2)
    print(f"[phase 2] flash_attention {FLASH_SHAPE} bf16, not causal: {ms} ms, plain "
          f"{plain_ms} ms, scaled_dot_product_attention {library_ms} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}) (median per call, L2 flushed); wrapper "
          f"host {host:.1f} us per call")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=worst)


def phase2_media_xattn(dev, flush):
    """``fused_media_xattn`` against its plain version at MEDIA_SHAPES and
    MEDIA_EDGE_SHAPES under every MEDIA_MIXES mix, bf16 (the Hopper kernel)
    and float32 (the mma.sync tile): one launch a call, 2 bf16 ulps or 1e-5
    of the output's scale, rows with text_time 0 exactly 0, rows past the
    media count the mean of V; two bf16 calls bit-equal. Then each of
    MEDIA_SHAPES timed under its ``timed`` mix (bf16, L2 flushed and clean)
    beside its plain version, SDPA under the media mask (a boolean mask; no
    zeroing, none needed there), its bound and the wrapper's host us per
    call. -> {shape: kernel row}."""
    from flamingo_mini_tpu_torch.ops.media_xattn import (
        fused_media_xattn, fused_media_xattn_plain, plan)
    kw = dict(scale=1.0, n_visual=MEGA_NV)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, n_q, n_media) in {**MEDIA_SHAPES, **MEDIA_EDGE_SHAPES}.items():
            q, k, v = attention_inputs(dev, dtype, b, MEGA_XH, n_q,
                                       n_media * MEGA_NV, seed=n_q + n_media)
            for mix in MEDIA_MIXES:
                tt = media_mix(dev, mix, b, n_q, n_media, seed=n_media)
                before = fused_media_xattn.launches
                got = fused_media_xattn(q, k, v, tt, **kw)
                assert fused_media_xattn.launches == before + 1
                want = fused_media_xattn_plain(q, k, v, tt, **kw)
                label = f"fused_media_xattn {name} {mix} {dtype}"
                err = held_to_plain(label, got, want, dtype)
                tol = (1e-5 * float(want.float().abs().max()) if dtype == torch.float32
                       else bf16_ulps(want.float(), 2))
                if err >= worst.get(str(dtype), (-1.0,))[0]:
                    diff = (got.float() - want.float()).abs()
                    at = tuple(int(i) for i in np.unravel_index(int(diff.argmax()),
                                                                diff.shape))
                    worst[str(dtype)] = (err, tol, (name, mix, at,
                                                    int(tt[at[0], at[2]])))
                zero = (tt == 0)[:, None, :, None].expand_as(got)
                assert bool((got[zero] == 0).all()), label
                past = ((tt > n_media) | (tt < 0))[:, None, :, None].expand_as(got)
                if bool(past.any()):
                    mean_v = v.float().mean(dim=2, keepdim=True).expand_as(got)
                    held_to_plain(f"{label}: rows past the media count",
                                  got.float()[past], mean_v[past], dtype)
    b, n_q, n_media = MEDIA_SHAPES["two images"]
    q, k, v = attention_inputs(dev, torch.bfloat16, b, MEGA_XH, n_q, n_media * MEGA_NV, 3)
    tt = media_mix(dev, "span", b, n_q, n_media, seed=0)
    first, second = (fused_media_xattn(q, k, v, tt, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    print(f"[phase 2] fused_media_xattn vs plain at {MEDIA_SHAPES} and "
          f"{MEDIA_EDGE_SHAPES} (b, n_token, n_media), {MEGA_XH} heads, {MEGA_NV} "
          f"latents per image, text_time mixes {MEDIA_MIXES}, bf16 (the Hopper kernel) "
          f"and float32 (the mma.sync tile), one launch a call: worst (max abs err, "
          f"tolerance, (shape, mix, (b, head, row, dim), text_time there)) {worst}; "
          "rows with text_time 0 exactly 0, rows past the media count the mean of "
          "V; two bf16 calls bit-equal")
    max_err = max(w[0] for w in worst.values())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (b, n_q, n_media) in MEDIA_SHAPES.items():
        n_kv = n_media * MEGA_NV
        q, k, v = attention_inputs(dev, torch.bfloat16, b, MEGA_XH, n_q, n_kv, 2)
        tt = media_mix(dev, "timed", b, n_q, n_media, seed=0)

        def fn():
            return fused_media_xattn(q, k, v, tt, **kw)
        ms = time_ms(fn, 50, flush)
        clean_ms = time_ms(fn, 50, flush, clean=True)
        plain_ms = time_ms(lambda: fused_media_xattn_plain(q, k, v, tt, **kw), 20, flush)
        media_time = torch.arange(n_kv, device=dev) // MEGA_NV + 1
        mask = (tt[:, :, None] == media_time)[:, None]
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=1.0), 50, flush)
        host = host_us(fn)
        # every K/V byte is some row's (each batch row attends each image);
        # each row's products over its own medium's keys
        bound_ms, bound_by = attention_bound(b, MEGA_XH, n_q, n_kv, 2,
                                             extra_bytes=4 * b * n_q,
                                             pairs=b * MEGA_XH * n_q * MEGA_NV)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                         host_us=host, clean_ms=clean_ms)
        print(f"[phase 2] fused_media_xattn {name} {(b, MEGA_XH, n_q, n_kv)} bf16, "
              f"text_time {f'1 then {n_media}' if n_media > 1 else 1}, plan "
              f"{tuple(plan(b, MEGA_XH, n_q, n_kv))}: {ms} ms, L2 clean {clean_ms} ms, "
              f"plain {plain_ms} ms, scaled_dot_product_attention under the media mask "
              f"{library_ms} ms, bound {bound_ms:.5f} ms ({bound_by}) (median per call, "
              f"L2 flushed); wrapper host {host:.1f} us per call")
    # the bounds at 13 and 20 images as ab_kernels.py times them: 8 x 40
    # tokens, text_time 1 on the first half of the rows and the last image
    # on the second. Counted by what the inputs need (q, out, text_time and
    # the K/V of the two images the rows attend: the kernel loads no other
    # tile), beside the count of every key
    for n_media in (13, 20):
        b, n_q = 8, 40
        pairs = b * MEGA_XH * n_q * MEGA_NV
        needed = attention_bound(b, MEGA_XH, n_q, 2 * MEGA_NV, 2, extra_bytes=4 * b * n_q,
                                 pairs=pairs)
        every = attention_bound(b, MEGA_XH, n_q, n_media * MEGA_NV, 2,
                                extra_bytes=4 * b * n_q, pairs=pairs)
        print(f"[phase 2] fused_media_xattn bound at {n_media} images "
              f"{(b, MEGA_XH, n_q, n_media * MEGA_NV)}, rows attending images 1 and "
              f"{n_media}: {needed[0]:.6f} ms ({needed[1]}; the attended images' K/V), "
              f"{every[0]:.6f} ms counting every key")
    return out


def first_layers(model, n: int, **config):
    """flamingo-mini ``model``'s first ``n`` trunk layers and their xattn
    blocks, sharing its tensors (MINI's widths, ``config`` added)."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    p = model.params
    return FlamingoModel(
        FlamingoConfig(**MINI, **config, lm_arch_overrides=dict(n_layer=n)),
        params=dict(p, lm=dict(p["lm"], blocks=p["lm"]["blocks"][:n]),
                    xattn={k: v for k, v in p["xattn"].items() if int(k) < n}),
        device=model.device)


@contextlib.contextmanager
def patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def logit_gap(logits: torch.Tensor) -> torch.Tensor:
    """(b, V) logits -> each row's top-2 gap in bf16 ulps of its top logit."""
    return pick_gap(logits.to(torch.bfloat16).float())


def gap_recorder(gaps, pick):
    """A stand-in for ``lm_head_argmax`` that records the plain head's top-2
    logit gap (in bf16 ulps) at every step and returns ``pick``'s token."""
    def head(w8, scale, x, *, n_valid):
        logits = torch.matmul(x.float(), w8.float().t()) * scale
        gaps.append(logit_gap(logits[:, :n_valid]))
        return pick(w8, scale, x, n_valid=n_valid)
    return head


def prefill_recorder(gaps, prefill):
    """A stand-in for ``generation._prefill`` that records the top-2 gap of
    the logits that pick the first generated token."""
    def run(*args, **kw):
        out = prefill(*args, **kw)
        gaps.append(logit_gap(out[0]))
        return out
    return run


@contextlib.contextmanager
def recorded(gaps, head):
    """Greedy generate with ``head`` as its fused head, recording the top-2
    gap of every pick: gaps[0] the prefill's, gaps[j] decode step j's."""
    from flamingo_mini_tpu_torch import generation
    with patched(generation, "_prefill", prefill_recorder(gaps, generation._prefill)), \
            patched(generation, "lm_head_argmax", gap_recorder(gaps, head)):
        yield


@contextlib.contextmanager
def plain_attention():
    """Route the attention kernels of the use_pallas path through their
    plain versions."""
    from flamingo_mini_tpu_torch.models import clip_vit, gpt2, opt, resampler, xattn
    from flamingo_mini_tpu_torch.ops.fused_attention import fused_attention_plain
    from flamingo_mini_tpu_torch.ops.media_xattn import fused_media_xattn_plain
    with patched(clip_vit, "fused_attention", fused_attention_plain), \
            patched(resampler, "fused_attention", fused_attention_plain), \
            patched(gpt2, "fused_attention", fused_attention_plain), \
            patched(opt, "fused_attention", fused_attention_plain), \
            patched(xattn, "fused_media_xattn", fused_media_xattn_plain):
        yield


@contextlib.contextmanager
def plain_trunk():
    """Route the trunk's kernels (decode attention, the megakernel, the
    attention kernels of the use_pallas path) through their plain versions.
    Both trunks' decode attention is ``gpt2.cached_attention``'s."""
    from flamingo_mini_tpu_torch.models import gpt2
    from flamingo_mini_tpu_torch.ops import megadecode
    from flamingo_mini_tpu_torch.ops.decode_attention import (
        decode_attention_beam_plain, decode_attention_plain)
    with patched(gpt2, "decode_attention", decode_attention_plain), \
            patched(gpt2, "decode_attention_beam", decode_attention_beam_plain), \
            patched(megadecode, "decode_step_megakernel",
                    megadecode.decode_step_megakernel_plain), \
            plain_attention():
        yield


@contextlib.contextmanager
def plain_kernels(gaps):
    """Route every path through the kernels' plain versions, recording the
    plain picks' top-2 logit gaps (``recorded``)."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax_plain
    with plain_trunk(), recorded(gaps, lm_head_argmax_plain):
        yield


def pick_gap(values: torch.Tensor) -> torch.Tensor:
    """(b, V) float32 values an argmax picks from -> each row's top-2 gap
    in bf16 ulps of its top value."""
    top2 = values.topk(2).values
    ulp = 2.0 ** (torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    return ((top2[:, 0] - top2[:, 1]) / ulp).cpu()


@contextlib.contextmanager
def recorded_picks(gaps, steps=None):
    """Generate with every pick (``generation._select_token``) recording the
    top-2 gap of what its argmax takes (``pick_gap``: the processed logits;
    sampling, the warped logits plus the noise), gaps[j] for generated
    token j; sampling, with ``steps``, also each pick's processed logits
    and noise on the host."""
    from flamingo_mini_tpu_torch import generation
    select = generation._select_token

    def run(logits, dc, noise):
        values = logits.float()
        if dc.do_sample:
            if steps is not None:
                steps.append((values.cpu(), noise.cpu()))
            values = noise + generation.warp(values, dc)
        gaps.append(pick_gap(values))
        return select(logits, dc, noise)
    with patched(generation, "_select_token", run):
        yield


def compare_top_k_samples(label, gen, ref_gen, steps, ref_steps, k: int):
    """Two top-k sampled runs under one seed (the same noise): every token
    lies in its own run's top k at its step (the k-th largest logit or
    above), and rows are equal up to each row's first near-tie, at the pick
    that parts: the reference's top two of the warped logits plus the noise
    lie within 8 bf16 ulps of the top, or a pick lies within 8 bf16 ulps of
    the top-k cut (the k-th largest logit) of the run that did not keep it,
    where rounding moves a token across the cut. Up to that pick both runs
    took the same tokens, each in the reference's top k."""
    b, n = gen.shape
    assert len(steps) == len(ref_steps) == n, (len(steps), len(ref_steps), n)
    neg = torch.finfo(torch.float32).min
    for j, (logits, _) in enumerate(steps):
        kth = logits.topk(k, dim=-1).values[:, -1]
        assert bool((logits.gather(1, gen[:, j:j + 1])[:, 0] >= kth).all()), \
            f"{label}: a token outside its own run's top {k} at step {j}"
    agreed, cut_parts = 0, 0
    for r in range(b):
        diff = torch.nonzero(gen[r] != ref_gen[r]).flatten()
        if len(diff) == 0:
            agreed += n
            continue
        j = int(diff[0])
        agreed += j
        a, w = int(gen[r, j]), int(ref_gen[r, j])
        own, ref = steps[j][0][r], ref_steps[j][0][r]
        own_cut, ref_cut = (x.topk(k).values[-1] for x in (own, ref))
        values = torch.where(ref >= ref_cut, ref, neg) + ref_steps[j][1][r]
        top2 = values.topk(2).values
        top_gap = float(top2[0] - top2[1]) / bf16_ulps(top2[0], 1)
        cut_gap = min(float(abs(ref[a] - ref_cut)) / bf16_ulps(ref_cut, 1),
                      float(abs(own[w] - own_cut)) / bf16_ulps(own_cut, 1))
        print(f"[phase 3] {label}: row {r} first differs at generated token {j}: "
              f"reference top-2 gap {top_gap:.1f} bf16 ulp; the picks' distance to "
              f"the top-{k} cut of the run that dropped them {cut_gap:.1f} bf16 ulp "
              f"(pick {a}: reference logit {float(ref[a])}, cut {float(ref_cut)}; "
              f"pick {w}: logit {float(own[w])}, cut {float(own_cut)})")
        assert top_gap <= 8.0 or cut_gap <= 8.0, \
            f"{label}: row {r} parts at a top-2 gap of {top_gap} and a cut gap of {cut_gap}"
        cut_parts += cut_gap <= 8.0
    full_rows = int((gen == ref_gen).all(dim=1).sum())
    print(f"[phase 3] {label}: every token in its own run's top {k}; {agreed}/{b * n} "
          f"tokens agree up to each row's first near-tie ({agreed / (b * n):.4f}), "
          f"{cut_parts} of the partings within 8 ulps of the cut; {full_rows}/{b} rows "
          "identical")


def compare_tokens(label, gen, ref_gen, ref_gaps):
    """Rows equal up to the first near-tie of the reference run (top-2 gap
    <= 8 bf16 ulps at the pick that parts: ref_gaps[j] for generated token
    j, the prefill's for j = 0) -> tokens compared."""
    agreed = 0
    for r in range(gen.shape[0]):
        diff = torch.nonzero(gen[r] != ref_gen[r]).flatten()
        if len(diff) == 0:
            agreed += gen.shape[1]
            continue
        j = int(diff[0])          # generated index: the prefill's pick or decode step j
        agreed += j
        gap = float(ref_gaps[j][r])
        print(f"[phase 3] {label}: row {r} first differs at generated token "
              f"{j}, reference top-2 gap {gap:.1f} bf16 ulp")
        # the runs' logits differ by rounding (a few bf16 ulps); a wrong
        # kernel parts rows where the top two are far apart
        assert gap <= 8.0, f"{label}: row {r} parts at a gap of {gap} bf16 ulp"
    full_rows = int((gen == ref_gen).all(dim=1).sum())
    n = gen.numel()
    print(f"[phase 3] {label}: {agreed}/{n} tokens agree up to each row's "
          f"first near-tie ({agreed / n:.4f}); {full_rows}/{gen.shape[0]} rows "
          "identical")


def beam_candidates(cands, k: int, vocab: int):
    """A beam run's recorded ``select_candidates`` results -> per step, per
    row, the ordered candidate sequences (generated tokens). EOS is
    unreachable, so the running beams after a step are its top k."""
    b = cands[0][0].shape[0]
    beams = [[()] * k for _ in range(b)]
    steps = []
    for _lp, idx in cands:
        parent, tok = (idx // vocab).tolist(), (idx % vocab).tolist()
        step = [[beams[r][p] + (t,) for p, t in zip(parent[r], tok[r])]
                for r in range(b)]
        steps.append(step)
        beams = [row[:k] for row in step]
    return steps


def compare_beams(label, gen, cands, ref_gen, ref_cands, k: int, vocab: int):
    """Rows equal up to the first near-tie of the reference run: at the
    first step where the two runs' chosen candidates differ (the top-k as a
    set; at the last step also the best), the reference's gap between its
    k-th and (k+1)-th candidate scores (at the last step: its best and
    second) is <= 8 bf16 ulps of the score."""
    assert len(cands) == len(ref_cands), (len(cands), len(ref_cands))
    got_c, ref_c = beam_candidates(cands, k, vocab), beam_candidates(ref_cands, k, vocab)
    last = len(ref_c) - 1
    agreed, parted = 0, 0
    for r in range(gen.shape[0]):
        parts = False
        for s in range(len(ref_c)):
            g, w = got_c[s][r], ref_c[s][r]
            parts = set(g[:k]) != set(w[:k]) or (s == last and g[0] != w[0])
            if parts:
                j = k - 1 if set(g[:k]) != set(w[:k]) else 0
                lp = ref_cands[s][0][r]
                gap = float(lp[j] - lp[j + 1])
                ulp = 2.0 ** (np.floor(np.log2(abs(float(lp[j])))) - 7)
                print(f"[phase 3] {label}: row {r} candidates part at step {s}, "
                      f"reference gap between ranks {j} and {j + 1}: {gap} "
                      f"({gap / ulp:.2f} bf16 ulp of the score {float(lp[j])})")
                assert gap <= 8 * ulp, f"{label}: row {r} parts at a gap of " \
                    f"{gap / ulp} bf16 ulp"
                parted += 1
                break
        diff = torch.nonzero(gen[r] != ref_gen[r]).flatten()
        assert parts or not len(diff), f"{label}: row {r} differs without parting"
        agreed += gen.shape[1] if len(diff) == 0 else int(diff[0])
    full_rows = int((gen == ref_gen).all(dim=1).sum())
    n = gen.numel()
    print(f"[phase 3] {label}: {agreed}/{n} tokens agree up to each row's "
          f"first near-tie ({agreed / n:.4f}); {full_rows}/{gen.shape[0]} rows "
          f"identical; candidates parted in {parted} rows")


@contextlib.contextmanager
def sample_recorder(steps):
    """Beam-sample with each step's candidates recorded on the host, in key
    order: steps[j] = (the 2k + 1 best noisy keys, the 2k candidates' flat
    indices, their scores, each one's distance from its step's top-k cut in
    bf16 ulps of the cut: its warped log-prob against the k-th largest)."""
    from flamingo_mini_tpu_torch import beam_search
    select, warp = beam_search.select_candidates, beam_search.warp
    seen = {}

    def rec_warp(logp, dc):
        y = logp.float() / dc.temperature if dc.temperature != 1.0 else logp.float()
        seen["y"] = y
        seen["kth"] = y.topk(dc.top_k, dim=-1).values[:, -1] if dc.top_k > 0 else None
        return warp(logp, dc)

    def record(flat, n, noise=None):
        scores, idx = select(flat, n, noise)
        y, kth = seen["y"], seen["kth"]
        b, V = flat.shape[0], y.shape[1]
        per = y.shape[0] // b           # 1 at the prefill's fill: one row a family
        row = torch.arange(b, device=idx.device)[:, None] * per + (idx // V) * (per > 1)
        if kth is None:
            cut = torch.full(idx.shape, float("inf"))
        else:
            c = kth[row]
            cut = (y[row, idx % V] - c).abs() / 2.0 ** (torch.floor(torch.log2(c.abs())) - 7)
        keys = (flat + noise).topk(n + 1).values
        steps.append(tuple(t.cpu() for t in (keys, idx, scores, cut)))
        return scores, idx
    with patched(beam_search, "warp", rec_warp), \
            patched(beam_search, "select_candidates", record):
        yield


def sampled_beams(steps, k: int, vocab: int):
    """A beam-sample run's recorded steps -> per step, per row, (the 2k
    drawn candidates as sequences of generated tokens, in key order; the k
    that run on, the best of them by score, stably)."""
    b = steps[0][1].shape[0]
    beams = [[()] * k for _ in range(b)]
    out = []
    for _keys, idx, scores, _cut in steps:
        parent, tok = (idx // vocab).tolist(), (idx % vocab).tolist()
        drawn = [[beams[r][p] + (t,) for p, t in zip(parent[r], tok[r])] for r in range(b)]
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices.tolist()
        beams = [[drawn[r][j] for j in order[r][:k]] for r in range(b)]
        out.append((drawn, beams))
    return out


def compare_sampled_beams(label, gen, steps, ref_gen, ref_steps, k: int, vocab: int):
    """Two beam-sample runs under one seed (the same noise). Every candidate
    that ran on, and every one that entered the pool, lay in its step's
    warped support (score above float32's finfo.min). Rows are equal up to
    the first decision that parts them, which must be a near-tie of either
    run, within 8 bf16 ulps of the value: where the drawn candidates differ
    (at the last step: the k that enter the pool), the 2k-th and (2k+1)-th
    keys (the k-th and (k+1)-th), or a candidate that only one run drew
    within 8 ulps of that run's top-k cut, where rounding moves a token
    across it; where the running beams differ, as a set or in their order
    (a beam's slot picks its noise at the next step), two neighbours among
    the k + 1 best scores of the drawn; where the returned hypothesis
    differs, the two best scores of the pool."""
    assert len(steps) == len(ref_steps), (len(steps), len(ref_steps))
    neg = torch.finfo(torch.float32).min
    last = len(steps) - 1
    for s, (_, _, scores, _) in enumerate(steps):
        kept = scores[:, :k] if s == last else scores.sort(dim=1, descending=True).values[:, :k]
        assert bool((kept > neg).all()), f"{label}: a candidate outside its support at step {s}"
    runs = (sampled_beams(steps, k, vocab), sampled_beams(ref_steps, k, vocab))
    near = lambda hi, lo: float(hi - lo) <= 8 * bf16_ulps(hi, 1)
    agreed, parted = 0, 0
    for r in range(gen.shape[0]):
        why = None
        for s in range(len(steps)):
            n_in = k if s == last else 2 * k
            (g_in, g_run), (w_in, w_run) = (run[s] for run in runs)
            sets = [set(x[r][:n_in]) for x in (g_in, w_in)]
            data = [st[s] for st in (steps, ref_steps)]
            if sets[0] != sets[1]:
                only = [[j for j, c in enumerate(x[r][:n_in]) if c not in other]
                        for x, other in ((g_in, sets[1]), (w_in, sets[0]))]
                cut = min([float(d[3][r, j]) for d, js in zip(data, only) for j in js])
                ties = [near(d[0][r, n_in - 1], d[0][r, n_in]) for d in data]
                why = (s, "drawn", ties, cut)
                assert any(ties) or cut <= 8.0, f"{label}: row {r} {why}"
                break
            if s < last and g_run[r] != w_run[r]:
                top = [d[2][r].sort(descending=True).values[:k + 1] for d in data]
                ties = [any(near(v[i], v[i + 1]) for i in range(k)) for v in top]
                why = (s, "running", ties, None)
                assert any(ties), f"{label}: row {r} {why}"
                break
            if s == last:
                best = [x[r][int(torch.argmax(d[2][r, :k]))] for x, d in zip((g_in, w_in), data)]
                if best[0] != best[1]:
                    ties = [near(*d[2][r, :k].sort(descending=True).values[:2]) for d in data]
                    why = (s, "returned", ties, None)
                    assert any(ties), f"{label}: row {r} {why}"
        diff = torch.nonzero(gen[r] != ref_gen[r]).flatten()
        assert why or not len(diff), f"{label}: row {r} differs without parting"
        if why:
            parted += 1
            print(f"[phase 3] {label}: row {r} parts at step {why[0]} ({why[1]}): "
                  f"near-ties (this run, reference) {why[2]}, a candidate only one "
                  f"run drew at {why[3]} bf16 ulp of its cut")
        agreed += gen.shape[1] if len(diff) == 0 else int(diff[0])
    full_rows = int((gen == ref_gen).all(dim=1).sum())
    print(f"[phase 3] {label}: every kept candidate in its step's support; "
          f"{agreed}/{gen.numel()} tokens agree up to each row's first near-tie "
          f"({agreed / gen.numel():.4f}); {full_rows}/{gen.shape[0]} rows identical; "
          f"decisions parted in {parted} rows")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Normwise relative error ||got - want|| / ||want|| in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def timed(fn):
    """(median ms, all ms) of 5 calls after a warm-up, CUDA events."""
    fn()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


def launch_counters():
    """The wrappers of the port's kernels, each with its ``launches``."""
    from flamingo_mini_tpu_torch.ops.decode_attention import (decode_attention,
                                                              decode_attention_beam)
    from flamingo_mini_tpu_torch.ops.fused_attention import (flash_attention,
                                                             fused_attention)
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax
    from flamingo_mini_tpu_torch.ops.media_xattn import fused_media_xattn
    from flamingo_mini_tpu_torch.ops.megadecode import decode_step_megakernel
    from flamingo_mini_tpu_torch.tools.probe_decode_kernel import (
        attn_stream_only, packed_stream, tmajor_stream)
    from flamingo_mini_tpu_torch.tools.probe_stream import stream_sum
    return (decode_attention, decode_attention_beam, lm_head_argmax,
            decode_step_megakernel, fused_attention, flash_attention,
            fused_media_xattn, stream_sum, attn_stream_only, tmajor_stream,
            packed_stream)


def zero_counts():
    for fn in launch_counters():
        fn.launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in launch_counters()}


def expect(label, counts, **nonzero):
    """Every count 0 but those named, which must be as given."""
    print(f"[phase 3] {label} launches: {counts} (expected {nonzero}, every "
          "other 0)")
    assert counts == {fn.__name__: nonzero.get(fn.__name__, 0)
                      for fn in launch_counters()}, (label, counts)


def counted(fn, gaps, ids, shape, vocab, record=None):
    """A greedy generate ``fn()`` with every launch count at 0 before it
    -> (generated tokens on the host, counts); each pick's top-2 gap is
    recorded (``recorded``, or the context ``record``). The output must
    have ``shape``, tokens in [0, vocab) and the prompts ``ids`` intact."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax
    zero_counts()
    with record or recorded(gaps, lm_head_argmax):
        tokens = fn()
    counts = read_counts()
    check_output(tokens, ids, shape, vocab)
    return tokens[:, ids.shape[1]:].cpu(), counts


def check_output(tokens, ids, shape, vocab):
    assert tokens.shape == shape, tokens.shape
    assert bool(((tokens >= 0) & (tokens < vocab)).all())
    assert torch.equal(tokens[:, :ids.shape[1]], ids)


def recorded_beam(fn, ids, shape, vocab, new_tokens, plain=False):
    """A beam generate ``fn()`` with every launch count at 0 before it ->
    (generated tokens, counts, each step's candidates); with ``plain``
    through the kernels' plain versions."""
    from flamingo_mini_tpu_torch import beam_search
    cands = []
    select = beam_search.select_candidates

    def record(flat, n):
        out = select(flat, n)
        cands.append(tuple(t.cpu() for t in out))
        return out
    zero_counts()
    with patched(beam_search, "select_candidates", record), \
            (plain_kernels([]) if plain else contextlib.nullcontext()):
        tokens = fn()
    counts = read_counts()
    check_output(tokens, ids, shape, vocab)
    assert len(cands) == new_tokens, len(cands)
    return tokens[:, ids.shape[1]:].cpu(), counts, cands


def open_gates(model):
    """At init the gates are 0 and xattn is the identity: open them."""
    for blk in model.params["xattn"].values():
        blk["alpha_attn"].fill_(0.5)
        blk["alpha_ffw"].fill_(0.5)
    return model


@contextlib.contextmanager
def launch_widths(widths):
    """Record the head width of every launch of the kernels taken at
    several widths into ``widths`` ({kernel name: {width: launches}}), at
    the point where each wrapper launches: ``decode_attention._launch``
    (greedy and beam), ``megadecode.kernel_args`` (one a megakernel
    launch) and ``fused_attention.launch`` (fused and streaming)."""
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    from flamingo_mini_tpu_torch.ops import fused_attention as fa
    from flamingo_mini_tpu_torch.ops import megadecode

    def note(name, width):
        widths.setdefault(name, {})
        widths[name][width] = widths[name].get(width, 0) + 1

    da_launch, mk_args, fa_launch = da._launch, megadecode.kernel_args, fa.launch

    def da_rec(q, k, v, npad, anc, cur, **kw):
        note("decode_attention" if anc is None else "decode_attention_beam",
             q.shape[1] // kw["n_head"])
        return da_launch(q, k, v, npad, anc, cur, **kw)

    def mk_rec(packed, *args, config, **kw):
        D, _Dff, _L, H = megadecode.trunk_dims(config.lm_arch)
        note("decode_step_megakernel", D // H)
        return mk_args(packed, *args, config=config, **kw)

    def fa_rec(fn, q, *args, **kw):
        note(fn[len("fmt_"):], q.shape[-1])
        return fa_launch(fn, q, *args, **kw)
    with patched(da, "_launch", da_rec), patched(megadecode, "kernel_args", mk_rec), \
            patched(fa, "launch", fa_rec):
        yield


def check_forward(label, model_f, rs, n_layer, n_x, limit=None):
    """The use_pallas forward with its loss at FWD_B x FWD_N, one image per
    row at its first real token, rows 0 and 1 left-padded: exact launch
    counts, fused_attention's at each tower's head width; logits (all rows,
    and the left-padded rows) and the loss within max(1e-2, 1.25 x the
    plain version's CPU-vs-card spread) of the plain-version run; with
    ``limit``, the logits within ``limit`` and the loss within 1e-2, and no
    CPU run (a multi-billion-parameter trunk takes a minute or more there).
    -> (the forward, for timing; its launch counts; fused_attention's
    launches by head width)."""
    from flamingo_mini_tpu_torch import FlamingoModel
    from flamingo_mini_tpu_torch.ops.megadecode import trunk_dims
    dev = model_f.device
    config = model_f.config
    arch = config.vision_arch
    vocab = (config.lm_arch.vocab_size + 1)
    f_ids = torch.tensor(rs.randint(0, 1000, (FWD_B, FWD_N)), device=dev)
    f_mask = torch.ones((FWD_B, FWD_N), dtype=torch.int32, device=dev)
    f_ids[:2, :GPT2_PAD], f_mask[:2, :GPT2_PAD] = 0, 0
    f_media = torch.zeros((FWD_B, FWD_N), dtype=torch.int32, device=dev)
    f_media[:2, GPT2_PAD], f_media[2:, 0] = 1, 1
    f_pixels = torch.tensor(rs.randn(FWD_B, 1, 3, arch.image_size, arch.image_size),
                            dtype=torch.float32, device=dev).to(torch.bfloat16)
    fwd = dict(media_locations=f_media, attention_mask=f_mask, pixel_values=f_pixels,
               labels=f_ids)
    widths = {}
    zero_counts()
    with launch_widths(widths):
        out_k = model_f(f_ids, **fwd)
    counts = read_counts()
    expect(f"{label} forward", counts,
           fused_attention=arch.num_hidden_layers + config.resampler_depth + n_layer,
           fused_media_xattn=n_x)
    D, _Dff, _L, H = trunk_dims(config.lm_arch)
    want = collections.Counter()
    want[arch.hidden_size // arch.num_attention_heads] += arch.num_hidden_layers
    want[config.resampler_dim_head] += config.resampler_depth
    want[D // H] += n_layer
    assert widths == {"fused_attention": dict(want)}, (label, widths, want)
    print(f"[phase 3] {label} forward: fused_attention launches by head width "
          f"{widths['fused_attention']}")
    assert out_k.logits.shape == (FWD_B, FWD_N, vocab), out_k.logits.shape
    assert bool(torch.isfinite(out_k.logits).all()) and bool(torch.isfinite(out_k.loss))
    # tensors made under inference mode carry no version counter
    with torch.inference_mode():
        out_i = model_f(f_ids, **fwd)
    err = rel_err(out_i.logits, out_k.logits)
    print(f"[phase 3] {label} forward under torch.inference_mode(): logits equal "
          f"{bool(torch.equal(out_i.logits, out_k.logits))}, normwise relative "
          f"difference {err} (tolerance 1e-3), loss {float(out_i.loss)}")
    assert err <= 1e-3, (label, err)
    with plain_attention():
        out_p = model_f(f_ids, **fwd)
    if limit is not None:
        for part, rows in (("logits, all rows", slice(None)),
                           ("logits, left-padded rows", slice(0, 2))):
            err = rel_err(out_k.logits[rows], out_p.logits[rows])
            print(f"[phase 3] {label} forward {part}: normwise relative error of the "
                  f"kernels vs plain {err} (tolerance {limit})")
            assert err <= limit, (label, part, err)
        err = rel_err(out_k.loss, out_p.loss)
        print(f"[phase 3] {label} forward loss: kernels {float(out_k.loss)}, plain "
              f"{float(out_p.loss)}; relative error {err} (tolerance 1e-2)")
        assert err <= 1e-2, (label, err)
        return (lambda: model_f(f_ids, **fwd)), counts, widths["fused_attention"]
    # the plain versions on the CPU: how far float32 sums in another order
    # move this bf16 program
    t0 = time.perf_counter()
    out_c = FlamingoModel(config, params=model_f.params, device="cpu")(
        f_ids.cpu(), **{k: t.cpu() for k, t in fwd.items()})
    cpu_s = time.perf_counter() - t0
    for part, rows in (("logits, all rows", slice(None)),
                       ("logits, left-padded rows", slice(0, 2))):
        err = rel_err(out_k.logits[rows], out_p.logits[rows])
        spread = rel_err(out_c.logits[rows], out_p.logits[rows].cpu())
        print(f"[phase 3] {label} forward {part}: normwise relative error of the "
              f"kernels vs plain {err}; plain on the CPU vs on the card {spread}")
        assert err <= max(1e-2, 1.25 * spread), (label, part, err, spread)
    err = rel_err(out_k.loss, out_p.loss)
    spread = rel_err(out_c.loss, out_p.loss.cpu())
    print(f"[phase 3] {label} forward loss: kernels {float(out_k.loss)}, plain "
          f"{float(out_p.loss)}, plain on the CPU {float(out_c.loss)} ({cpu_s:.1f} s); "
          f"relative error {err}, spread {spread} (tolerance: the larger of 1e-2 "
          "and 1.25 x the spread)")
    assert err <= max(1e-2, 1.25 * spread), (label, err, spread)
    return (lambda: model_f(f_ids, **fwd)), counts, widths["fused_attention"]


def time_generate(card, batch, paths):
    """ms per decode step ((median at N new tokens - median at N/2) /
    (N/2)), captions/s and peak memory of each (name, fn(n), N) -> {name:
    ms per step}."""
    steps = {}
    for name, fn, new_tokens in paths:
        torch.cuda.reset_peak_memory_stats()
        full_ms, full_all = timed(lambda: fn(new_tokens))
        half_ms, half_all = timed(lambda: fn(new_tokens // 2))
        step_ms = (full_ms - half_ms) / (new_tokens - new_tokens // 2)
        print(f"[phase 4] {card}: {name} path: generate {batch}x{new_tokens} "
              f"median {full_ms} ms (runs {full_all}); {new_tokens // 2} tokens "
              f"median {half_ms} ms (runs {half_all})")
        print(f"[phase 4] {card}: {name} path: {step_ms} ms per decode step, "
              f"{batch / (full_ms / 1000.0)} captions/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        steps[name] = step_ms
    return steps


def print_agreement(label, tokens, ref_tokens):
    """Share of tokens and rows equal between two runs: printed, not held
    (another numerics tier)."""
    same = float((tokens == ref_tokens).float().mean())
    rows = int((tokens == ref_tokens).all(dim=1).sum())
    print(f"[phase 3] {label}: {same:.4f} of tokens and {rows}/{tokens.shape[0]} "
          "rows identical (another numerics tier: printed, not held)")


def phase4_stream(dev, card):
    """The stream probe at STREAM_MB: the kernel against its plain version
    (float32, 1e-5 relative, on a buffer of uniform [0, 1) values so that
    the sum does not cancel), then the probe's own protocol with the launch
    count at 0 before it -> the kernel row."""
    from flamingo_mini_tpu_torch.tools import probe_stream
    gen = torch.Generator(device=dev).manual_seed(5)
    n_rows = STREAM_MB * 1024 * 1024 // (2 * probe_stream.COLS)
    x = torch.rand((n_rows, probe_stream.COLS), generator=gen, device=dev).to(torch.bfloat16)
    acc = torch.tensor(3.0, device=dev)
    got = float(probe_stream.stream_sum(x, acc, STREAM_CHUNK))
    want = float(probe_stream.stream_sum_plain(x, acc, STREAM_CHUNK))
    err = abs(got - want)
    assert err <= 1e-5 * abs(want), (got, want)
    zero_counts()
    rates = probe_stream.measure(x, STREAM_CHUNK)
    launches = read_counts()["stream_sum"]
    plain_ms = probe_stream.marginal_ms(probe_stream.stream_sum_plain, x, STREAM_CHUNK)
    n_bytes = x.numel() * x.element_size()
    bound_ms, bound_by = bound(n_bytes, n_rows * 128)
    print(f"[phase 4] {card}: stream_sum over {STREAM_MB} MB: kernel vs plain "
          f"{got} vs {want} (relative {err / abs(want)}, tolerance 1e-5); kernel "
          f"{rates['cuda']['ms']} ms per call, {rates['cuda']['GBps']} GB/s; torch.sum "
          f"{rates['torch_sum']['ms']} ms, {rates['torch_sum']['GBps']} GB/s; plain "
          f"{plain_ms} ms; bound {bound_ms} ms ({bound_by}, "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); {launches} launches (marginal of chains "
          "of 4 and 36, median of 5)")
    del x
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=rates["cuda"]["ms"], plain_ms=plain_ms,
                library_ms=rates["torch_sum"]["ms"], bound_ms=bound_ms,
                bound_by=bound_by, launches=launches)


def stream_probe_inputs(dev, layout: str, seed: int, b: int = PROBE_SHAPE[0],
                        T: int = PROBE_SHAPE[1], D: int = PROBE_SHAPE[2]):
    """q (b, D) bf16 and the layout's caches, N(0, 1) from a seed: T-major
    K, V (T, b, D), b-major (b, T, D), or one packed (T, b, 2D); the probe's
    shape (32, 192, 1024) by default."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
    if layout == "packed":
        return q, (torch.randn((T, b, 2 * D), generator=gen, device=dev)
                   .to(torch.bfloat16),)
    shape = (b, T, D) if layout == "bmajor" else (T, b, D)
    return q, tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))


def stream_probe_call(layout: str, q, caches, block_t: int, block_b, kv_limit: int,
                      plain: bool = False):
    """One call of the layout's stream kernel (or its plain version)."""
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    if layout == "bmajor":
        fn = pdk.attn_stream_only_plain if plain else pdk.attn_stream_only
        return fn(q, *caches, None, None, block_b, block_t,
                  shape=pdk.Shape(kv_limit=kv_limit))
    fn = {("tmajor", False): pdk.tmajor_stream, ("tmajor", True): pdk.tmajor_stream_plain,
          ("packed", False): pdk.packed_stream,
          ("packed", True): pdk.packed_stream_plain}[layout, plain]
    return fn(q, *caches, block_t=block_t, kv_limit=kv_limit)


def stream_probe_case(dev, layout: str, block_t: int, block_b, kv_limit: int, seed: int,
                      b: int = PROBE_SHAPE[0], T: int = PROBE_SHAPE[1],
                      D: int = PROBE_SHAPE[2]):
    """(kernel output, plain output) on seeded caches."""
    q, caches = stream_probe_inputs(dev, layout, seed, b, T, D)
    got = stream_probe_call(layout, q, caches, block_t, block_b, kv_limit)
    want = stream_probe_call(layout, q, caches, block_t, block_b, kv_limit, plain=True)
    return got, want


def phase2_decode_stream_probe(dev, flush):
    """The three decode stream kernels against their plain versions at the
    probe's shape (PROBE_CASES), bit for bit: the plain versions sum in the
    kernels' order. Each layout timed at kv_limit 128 beside its plain
    version, the bound, and ``torch.sum(dim=0)`` over the same bytes as a
    rate reference (no single PyTorch call computes the function)."""
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    worst = {}
    for i, (layout, block_t, block_b, kv_limit, b, T, D) in enumerate(PROBE_CASES):
        got, want = stream_probe_case(dev, layout, block_t, block_b, kv_limit, 40 + i,
                                      b, T, D)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst[layout] = max(worst.get(layout, 0.0), err)
        case = f"{layout} block_t={block_t} block_b={block_b} kv_limit={kv_limit} " \
               f"(b, T, D)={(b, T, D)}"
        assert bool(torch.isfinite(got).all()), case
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
            f"{case}: max err {err}"
    print(f"[phase 2] decode stream probes vs plain, {len(PROBE_CASES)} cases (layout, "
          f"block_t, block_b, kv_limit, b, T, D) {PROBE_CASES}: bit for bit "
          "(tolerance: equal)")
    out = {}
    kv_limit = pdk.KV_LIMIT
    for layout, block_t in PROBE_TIMED.items():
        q, caches = stream_probe_inputs(dev, layout, seed=60)
        ms = time_ms(lambda: stream_probe_call(layout, q, caches, block_t, None, kv_limit),
                     50, flush)
        plain_ms = time_ms(lambda: stream_probe_call(layout, q, caches, block_t, None,
                                                     kv_limit, plain=True), 20, flush)
        clean_ms = time_ms(lambda: stream_probe_call(layout, q, caches, block_t, None,
                                                     kv_limit), 50, flush, clean=True)
        wrapper_us = host_us(lambda: stream_probe_call(layout, q, caches, block_t, None,
                                                       kv_limit))
        n_rows = pdk.chunk_rows(kv_limit, block_t, pdk.T)
        n_bytes = 2 * pdk.B * n_rows * pdk.D * 2 + 2 * pdk.B * pdk.D * 2
        bound_ms, bound_by = bound(n_bytes, 0.0, n_f32_ops=(2 * n_rows + 1) * pdk.B * pdk.D)
        out[layout] = dict(max_abs_err=worst[layout], ms=ms, plain_ms=plain_ms, library_ms=None,
                           bound_ms=bound_ms, bound_by=bound_by, block_t=block_t,
                           n_bytes=n_bytes, clean_ms=clean_ms, host_us=wrapper_us,
                           plan=pdk.plan(pdk.B, pdk.D, n_rows, block_t))
    # the rate reference: one reduction over 16.78 MB (a packed cache's rows)
    _, (ckv,) = stream_probe_inputs(dev, "packed", seed=61)
    live = ckv[:kv_limit]
    sum_ms = time_ms(lambda: torch.sum(live, dim=0, dtype=torch.float32), 50, flush)
    sum_bytes = live.numel() * live.element_size()
    for layout, k in out.items():
        print(f"[phase 2] decode stream probe {layout} (block_t {k['block_t']}, kv_limit "
              f"{kv_limit}): {k['ms']} ms ({k['n_bytes'] / k['ms'] / 1e6} GB/s; "
              f"{k['clean_ms']} ms after a flush that leaves L2 clean), plain "
              f"{k['plain_ms']} ms, bound {k['bound_ms']} ms ({k['bound_by']}); library: "
              "none (no single PyTorch call computes K-sum + V-sum + q); one launch, "
              f"{k['plan']}; wrapper host {k['host_us']} us per call")
    sum_clean_ms = time_ms(lambda: torch.sum(live, dim=0, dtype=torch.float32), 50,
                           flush, clean=True)
    print(f"[phase 2] rate reference: torch.sum(dim=0, dtype=float32) over {sum_bytes} "
          f"bytes: {sum_ms} ms, {sum_bytes / sum_ms / 1e6} GB/s (median per call, L2 "
          f"flushed); {sum_clean_ms} ms after a flush that leaves L2 clean")
    # the in-situ probe's real kernel, alone at its shape, both flushes
    from flamingo_mini_tpu_torch.ops.decode_attention import decode_attention
    q, (k, v) = stream_probe_inputs(dev, "tmajor", seed=62)
    npad = torch.zeros(pdk.B, dtype=torch.int32, device=dev)
    attn = lambda: decode_attention(q, k, v, npad, kv_limit - 1, n_head=pdk.H,
                                    scale=pdk.SCALE, kv_limit=kv_limit)
    print(f"[phase 2] decode_attention at the probe's shape (kv_limit {kv_limit}): "
          f"{time_ms(attn, 50, flush)} ms L2 flushed, {time_ms(attn, 50, flush, True)} "
          "ms after a flush that leaves L2 clean")
    return out


def phase4_insitu(dev, card):
    """Both in-situ probes' protocols in process (one CUDA graph per trip
    count): first each graphed loop, 2 steps, against the same loop run
    eagerly, bit for bit (NaN-aware); then, with every launch count at 0,
    the decode probe's CLI variants (``--full``) and ``stream_bmajor_bt32``
    (``make_flat_loop(attn_stream_only, block_t=32)``) beside ``glue_only``
    (the same loop without the probed call), each kernel's share of a layer
    (its loop less ``glue_only``), one ``decode_attention`` layer split into
    the bare stream, the math and the loop's writes, and the head probe's
    two variants -> the launch counts."""
    from flamingo_mini_tpu_torch.tools import insitu
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    from flamingo_mini_tpu_torch.tools import probe_lm_head as plh
    from flamingo_mini_tpu_torch.ops import cuda_build
    gen = torch.Generator(device=dev).manual_seed(70)
    args = pdk.inputs(dev, gen)
    # glue_only: the b-major loop with the probed call left out (its cache
    # writes and axpy alone), the baseline each variant's kernel share is
    # taken against
    loops = pdk.variants(full=True) + (
        ("stream_bmajor_bt32", pdk.make_flat_loop(pdk.attn_stream_only, block_t=32)),
        ("glue_only", pdk.make_flat_loop(lambda q, *_, **__: q)))
    w8, scale, x0 = plh.inputs(dev, gen)
    rows = cuda_build.kernels().fmt_lm_head_rows_per_block()
    heads = plh.variants(w8, scale, x0, rows)
    for name, run, run_args in ([(n, r, args) for n, r in loops]
                                + [(n, r, a) for n, r, a, _ in heads]):
        same, eager, replayed = insitu.graph_equals_eager(run, run_args, reps=2)
        print(f"[phase 4] {name}: 2 steps as a CUDA graph vs eager: {float(replayed)} vs "
              f"{float(eager)}, bit for bit: {same}")
        assert same, name
    zero_counts()
    layers = {name: pdk.measure(name, run, args) for name, run in loops}
    steps = {name: plh.measure(name, run, run_args, n_bytes)
             for name, run, run_args, n_bytes in heads}
    counts = read_counts()
    per_loop = (1 + sum(pdk.REPEATS)) * pdk.NLAYER
    expect("in-situ probes (phase 4)", counts, decode_attention=per_loop,
           tmajor_stream=per_loop, packed_stream=per_loop, attn_stream_only=per_loop,
           lm_head_argmax=1 + sum(plh.REPEATS))
    for name, r in layers.items():
        print(f"[phase 4] {card}: in-situ decode probe {name} ({pdk.PROBE}): "
              f"{r['ms_per_step']} ms per step, {r['per_layer_us']} us per layer, "
              f"{r['GBps']} GB/s (2 b kv_limit D 2 bytes per layer; graphs of "
              f"{pdk.REPEATS} steps, median of {insitu.RUNS} replays)")
    us = {name: r["per_layer_us"] for name, r in layers.items()}
    for name in ("stream_bmajor_bt32", "stream_tmajor_bt32", "stream_tmajor_packed_bt16",
                 "tmajor_kernel"):
        share = us[name] - us["glue_only"]
        print(f"[phase 4] {card}: in-situ kernel share {name}: {share} us per layer "
              f"less glue_only, {2 * pdk.B * pdk.KV_LIMIT * pdk.D * 2 / (share * 1e3)} "
              "GB/s")
    print(f"[phase 4] {card}: one in-situ decode_attention layer, {us['tmajor_kernel']} "
          f"us ({pdk.PROBE}): the bare stream "
          f"{us['stream_tmajor_bt32'] - us['glue_only']} us (stream_tmajor_bt32 less "
          f"glue_only), the math {us['tmajor_kernel'] - us['stream_tmajor_bt32']} us "
          f"(tmajor_kernel less stream_tmajor_bt32), the loop's writes {us['glue_only']} "
          "us (glue_only)")
    for name, r in steps.items():
        print(f"[phase 4] {card}: in-situ head probe {name} (B{plh.B} D{plh.D} "
              f"V{plh.V}): {r['us_per_step']} us per step, {r['GBps']} GB/s of int8 "
              f"weights (graphs of {plh.REPEATS} steps; above 3,350 GB/s is L2-served)")
    print(f"[phase 4] in-situ probes' launches through the wrappers (one eager step, "
          f"then each launch once while captured; replays relaunch without Python): "
          f"{counts}")
    return counts


def sampled_head_share(dev, card, model, vocab: int, sample: dict, step_ms: float):
    """What the sampled step adds after the megakernel, alone on the card at
    OPT-1.3B's shape (L2 flushed, CUDA events, ``time_ms``): the full int8
    head (``lm_head`` at 8 rows, its float32 copy of the weight included),
    that copy alone, and the chain with the top-k draw; each beside its host
    µs per call and its share of the sampled path's step."""
    from flamingo_mini_tpu_torch import generation
    from flamingo_mini_tpu_torch.models import flamingo
    config, params = model.config, model.params
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    h = torch.randn((OPT_B, 1, OPT_D), generator=gen, device=dev).to(torch.bfloat16)
    w8 = params["lm"]["embed_tokens_q"]["w8"]
    logits = flamingo.lm_head(params, config, h)[:, -1]
    dc = generation.DecodeConfig(max_length=OPT_MAX, eos_token_id=vocab,
                                 pad_token_id=0, **sample)
    tokens = torch.randint(4, 1000, (OPT_B, OPT_MAX), generator=gen, device=dev)
    mask = torch.ones((OPT_B, OPT_MAX), dtype=torch.int32, device=dev)

    def chain():
        out = generation.process_logits(logits, dc, tokens, mask, OPT_PROMPT + 1,
                                        OPT_PROMPT)
        return generation._select_token(
            out, dc, generation.gumbel_noise(out.shape, gen, dev))
    parts = (("lm_head (int8, 8 rows)", lambda: flamingo.lm_head(params, config, h)),
             ("of which the float32 weight copy", lambda: w8.float()),
             ("chain + top-k 50 draw", chain))
    total = 0.0
    for name, fn in parts:
        ms = time_ms(fn, 20, flush)
        total += 0.0 if name.startswith("of which") else ms
        print(f"[phase 4] {card}: sampled OPT-1.3B step, {name}: {ms} ms "
              f"({ms / step_ms:.4f} of the {step_ms} ms step), host "
              f"{host_us(fn, 20):.1f} us a call")
    print(f"[phase 4] {card}: sampled OPT-1.3B step: head + chain {total} ms, "
          f"{total / step_ms:.4f} of the step (weight {tuple(w8.shape)}, "
          f"{w8.numel() * 5 / 1e6:.0f} MB read and written by the copy)")
    del flush


def opt_model(dev):
    """OPT-1.3B at ``CUT_LAYERS`` of its 24 layers: gates open, int8 trunk
    and xattn, bf16, weights from seed 1."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    config = FlamingoConfig(**OPT13, lm_arch_overrides=dict(num_hidden_layers=CUT_LAYERS))
    model = open_gates(FlamingoModel(config, device=dev, seed=1))
    return model.quantize_int8().to_bf16()


def trunk_batch(dev, rs, config):
    """BASELINE config 3's batch: 8 prompts of 8 tokens, rows 0 and 1
    left-padded by 2, one image each at the first real token -> (ids,
    media, mask, pixels)."""
    ids = torch.tensor(rs.randint(4, 1000, (OPT_B, OPT_PROMPT)), device=dev)
    mask = torch.ones((OPT_B, OPT_PROMPT), dtype=torch.int32, device=dev)
    media = torch.zeros((OPT_B, OPT_PROMPT), dtype=torch.int32, device=dev)
    for r, p in enumerate([OPT_PAD] * 2 + [0] * (OPT_B - 2)):
        ids[r, :p], mask[r, :p], media[r, p] = 1, 0, 1     # OPT's pad id is 1
    size = config.vision_arch.image_size
    pixels = torch.tensor(rs.randn(OPT_B, 1, 3, size, size), dtype=torch.float32,
                          device=dev).to(torch.bfloat16)
    return ids, media, mask, pixels


def trunk_run(model, batch, megakernel, new_tokens=OPT_NEW, max_length=OPT_MAX, **kw):
    """``model.generate`` on ``trunk_batch``'s batch, EOS unreachable."""
    ids, media, mask, pixels = batch
    return model.generate(ids, media_locations=media, attention_mask=mask,
                          pixel_values=pixels, max_length=max_length,
                          max_new_tokens=new_tokens, prefix_block=PREFIX_BLOCK,
                          eos_token_id=model.config.lm_arch.vocab_size + 1, pad_token_id=0,
                          megakernel=megakernel, **kw)


def trunk_beam_run(model, batch, megakernel, new_tokens=OPT_BEAM_NEW):
    """3 beams (lazy reordering); a beam run returns ``max_length`` tokens,
    so the cache ends with the new ones."""
    return trunk_run(model, batch, megakernel, new_tokens,
                     max_length=OPT_PROMPT + new_tokens, num_beams=BEAMS,
                     length_penalty=1.0, early_stopping=True, beam_reorder="lazy")


def check_widths(label, widths, counts, hd):
    """Every launch that ``launch_widths`` recorded at the trunk's head
    width ``hd``."""
    for name, by_width in widths.items():
        assert by_width == {hd: counts[name]}, (label, name, by_width)
    print(f"[phase 3] {label}: launches by head width {widths}")


def trunk_cells(label, model, model_f, batch, rs, plain_new=OPT_NEW, fwd_limit=None):
    """Phase 3 for an OPT trunk (``model``: int8, gates open; ``model_f``:
    its bf16 use_pallas twin) on ``trunk_batch``'s batch: greedy per layer,
    on the megakernel and w8a8 on the megakernel, 3 beams per layer and on
    the megakernel, each with its launches exact and every one at the
    trunk's head width; each path against the plain program under the
    near-tie rule, the per-layer paths over all their tokens and the
    megakernel paths over their first ``plain_new`` (the plain megakernel
    takes a third to half a second a step at 24-32 layers); the megakernel
    paths against the per-layer ones; then the use_pallas forward
    (``check_forward`` with ``fwd_limit``) -> ({path: launch counts},
    {greedy path: tokens}, the forward for timing)."""
    ids = batch[0]
    config = model.config
    vocab = config.lm_arch.vocab_size + 1
    n_layer = config.lm_arch.num_hidden_layers
    hd = config.lm_arch.hidden_size // config.lm_arch.num_attention_heads
    steps, b_steps = OPT_NEW - 1, OPT_BEAM_NEW - 1
    counts, tokens, gaps = {}, {}, {}
    for path, mk, extra in (("per layer", False, {}), ("megakernel", True, {}),
                            ("w8a8", True, dict(w8a8=True))):
        widths, gaps[path] = {}, []
        with launch_widths(widths):
            tokens[path], counts[path] = counted(
                lambda: trunk_run(model, batch, mk, **extra), gaps[path], ids,
                (OPT_B, OPT_MAX), vocab)
        expect(f"{label} {path} path", counts[path], lm_head_argmax=steps,
               **(dict(decode_step_megakernel=steps) if mk
                  else dict(decode_attention=n_layer * steps)))
        check_widths(f"{label} {path}", widths, counts[path], hd)
        new = plain_new if mk else OPT_NEW
        got = tokens[path] if new == OPT_NEW else trunk_run(
            model, batch, mk, new, OPT_PROMPT + new, **extra)[:, OPT_PROMPT:].cpu()
        p_gaps = []
        with plain_kernels(p_gaps):
            want = trunk_run(model, batch, mk, new, OPT_PROMPT + new, **extra)
        compare_tokens(f"{label} {path} vs plain ({new} tokens)", got,
                       want[:, OPT_PROMPT:].cpu(), p_gaps)
    compare_tokens(f"{label} megakernel path vs per-layer path", tokens["megakernel"],
                   tokens["per layer"], gaps["per layer"])
    print_agreement(f"{label} w8a8 vs weight-only megakernel", tokens["w8a8"],
                    tokens["megakernel"])

    beams = {}
    for path, mk in (("beam per layer", False), ("beam megakernel", True)):
        widths = {}
        with launch_widths(widths):
            b_tokens, counts[path], b_cands = recorded_beam(
                lambda: trunk_beam_run(model, batch, mk), ids,
                (OPT_B, OPT_PROMPT + OPT_BEAM_NEW), vocab, OPT_BEAM_NEW)
        expect(f"{label} {path} path", counts[path],
               **(dict(decode_step_megakernel=b_steps) if mk
                  else dict(decode_attention_beam=n_layer * b_steps)))
        check_widths(f"{label} {path}", widths, counts[path], hd)
        beams[path] = (b_tokens, b_cands)
        new = min(plain_new, OPT_BEAM_NEW) if mk else OPT_BEAM_NEW
        shape = (OPT_B, OPT_PROMPT + new)
        if new < OPT_BEAM_NEW:
            b_tokens, _, b_cands = recorded_beam(
                lambda: trunk_beam_run(model, batch, mk, new), ids, shape, vocab, new)
        p_tokens, _, p_cands = recorded_beam(
            lambda: trunk_beam_run(model, batch, mk, new), ids, shape, vocab, new,
            plain=True)
        compare_beams(f"{label} {path} vs plain ({new} tokens)", b_tokens, b_cands,
                      p_tokens, p_cands, BEAMS, vocab)
    compare_beams(f"{label} beam megakernel path vs per-layer path",
                  *beams["beam megakernel"], *beams["beam per layer"], BEAMS, vocab)

    fwd, counts["forward"], by_width = check_forward(
        label, model_f, rs, n_layer, len(model_f.params["xattn"]), limit=fwd_limit)
    counts["forward at width"] = by_width[hd]
    return counts, tokens, fwd


def opt_cells(dev, card):
    """Phase 3 and 4 for OPT-1.3B (``trunk_cells``, then top-k 50 sampling
    on the megakernel) and opt-350m (per layer), both at ``CUT_LAYERS`` of
    their 24 layers -> the OPT-1.3B runs' launch counts {path: counts}."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    rs = np.random.RandomState(1)
    model = opt_model(dev)
    config = model.config
    batch = trunk_batch(dev, rs, config)
    ids = batch[0]
    vocab = config.lm_arch.vocab_size + 1
    steps = OPT_NEW - 1
    print(f"[phase 3] the OPT cells: OPT-1.3B and opt-350m at {CUT_LAYERS} of their 24 "
          "layers (depth cut for the time limit)")
    # the uncached forward: bf16 weights not quantized
    model_f = open_gates(FlamingoModel(FlamingoConfig(
        **OPT13, use_pallas=True, lm_arch_overrides=dict(num_hidden_layers=CUT_LAYERS)),
        device=dev, seed=1)).to_bf16()
    counts, tokens, fwd = trunk_cells("OPT-1.3B", model, model_f, batch, rs)

    def run(megakernel, new_tokens=OPT_NEW, **kw):
        return trunk_run(model, batch, megakernel, new_tokens, **kw)

    # BASELINE config 3 as written: top-k 50 sampling on the megakernel,
    # the full head and the chain after each step's kernel
    sample = dict(do_sample=True, top_k=OPT_TOP_K)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    s_steps, p_steps = [], []
    s_tokens, counts["sampled"] = counted(
        lambda: run(True, generator=seeded(5), **sample), [], ids,
        (OPT_B, OPT_MAX), vocab, record=recorded_picks([], s_steps))
    expect("OPT-1.3B sampled megakernel path (top-k 50)", counts["sampled"],
           decode_step_megakernel=steps)
    with plain_trunk(), recorded_picks([], p_steps):
        p_tokens = run(True, generator=seeded(5), **sample)[:, OPT_PROMPT:].cpu()
    compare_top_k_samples("OPT-1.3B sampled megakernel vs plain, one seed", s_tokens,
                          p_tokens, s_steps, p_steps, OPT_TOP_K)
    del s_steps, p_steps
    again = run(True, generator=seeded(5), **sample)[:, OPT_PROMPT:].cpu()
    other = run(True, generator=seeded(6), **sample)[:, OPT_PROMPT:].cpu()
    assert torch.equal(again, s_tokens), "two sampled runs with one seed differ"
    assert not torch.equal(other, s_tokens), "two seeds sampled the same tokens"
    print(f"[phase 3] OPT-1.3B sampled: two runs with seed 5 bit-equal; seed 6 "
          f"{float((other != s_tokens).float().mean()):.4f} of tokens other; "
          f"{float((s_tokens != tokens['megakernel']).float().mean()):.4f} of tokens "
          "other than greedy's")

    # opt-350m: post-norm with project_in/out, per layer only
    c350 = FlamingoConfig(**OPT350, lm_arch_overrides=dict(num_hidden_layers=CUT_LAYERS))
    m350 = open_gates(FlamingoModel(c350, device=dev, seed=2))
    m350.quantize_int8().to_bf16()
    n350 = c350.lm_arch.num_hidden_layers
    max350 = OPT_PROMPT + OPT350_NEW
    gaps350 = []
    t350, c = counted(lambda: trunk_run(m350, batch, False, OPT350_NEW, max350),
                      gaps350, ids, (OPT_B, max350), vocab)
    expect("opt-350m per-layer path", c, decode_attention=n350 * (OPT350_NEW - 1),
           lm_head_argmax=OPT350_NEW - 1)
    gaps = []
    with plain_kernels(gaps):
        plain_tokens = trunk_run(m350, batch, False, OPT350_NEW, max350)
    compare_tokens("opt-350m per-layer kernels vs plain", t350,
                   plain_tokens[:, OPT_PROMPT:].cpu(), gaps)
    try:
        trunk_run(m350, batch, True, OPT350_NEW, max350)
    except ValueError as e:
        print(f"[phase 3] opt-350m with megakernel=True raises ValueError: {e}")
    else:
        raise AssertionError("opt-350m ran on the megakernel")
    del m350

    # phase 4: the OPT-1.3B paths and forward
    step_ms = time_generate(card, OPT_B, (
        ("OPT-1.3B per-layer", lambda n: run(False, n), OPT_NEW),
        ("OPT-1.3B megakernel", lambda n: run(True, n), OPT_NEW),
        ("OPT-1.3B sampled megakernel (top-k 50)", lambda n: run(True, n, **sample),
         OPT_NEW),
        ("OPT-1.3B w8a8 megakernel", lambda n: run(True, n, w8a8=True), OPT_NEW)))
    sampled_head_share(dev, card, model, vocab, sample,
                       step_ms["OPT-1.3B sampled megakernel (top-k 50)"])
    fwd_ms, fwd_all = timed(fwd)
    print(f"[phase 4] {card}: OPT-1.3B forward with loss, {FWD_B}x{FWD_N} tokens, "
          f"use_pallas: median {fwd_ms} ms (runs {fwd_all}), "
          f"{FWD_B * FWD_N / (fwd_ms / 1e3)} tokens/s")
    return counts


def kv_prefill_envelope(model, ids, media, mask, pixels):
    """The int8 KV cache's prefill logits against the head-major bf16
    cache's on the same batch: within JAX's envelope, 0.05 x absmax + 0.05
    (tests/test_quant.py:77-100)."""
    from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
    vf = model.encode_resample_visuals(pixels)
    logits = {}
    for int8 in (False, True):
        dc = DecodeConfig(max_length=MAX_LENGTH, int8_kv_cache=int8)
        with torch.inference_mode():
            logits[int8] = _prefill(model.params, model.config, dc, model.policy, ids,
                                    media, mask, vf, flat=False)[0].float()
    err = float((logits[True] - logits[False]).abs().max())
    ref = float(logits[False].abs().max())
    print(f"[phase 3] int8 KV cache prefill logits vs the bf16 head-major cache's: max "
          f"abs difference {err} (tolerance 0.05 x {ref} + 0.05)")
    assert bool(torch.isfinite(logits[True]).all()) and err < 0.05 * ref + 0.05, (err, ref)


def baseline_cells(dev, card, mini, mini_p):
    """Phase 3 and 4 for BASELINE configs 1, 4 and 5 (``BASELINE_CELLS``;
    config 4 on flamingo-mini's ``mini`` and ``mini_p`` at their depth, the others on a
    flamingo-tiny model of their own): greedy per layer and on the
    megakernel, each with use_pallas off and on, launch counts exact; the
    kernels' runs against plain-version runs, the megakernel against per
    layer and use_pallas against use_pallas=False, up to each row's first
    near-tie; both paths timed -> {config: {path: counts}}."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    counts = {}
    for key, (base, b, L, new, n_img, frames) in BASELINE_CELLS.items():
        stamp(f"{key} start")
        config = FlamingoConfig(**base)
        if base is MINI:
            model, model_p, config = mini, mini_p, mini.config
        else:
            model = open_gates(FlamingoModel(config, device=dev, seed=3))
            model.quantize_int8().to_bf16()
            model_p = FlamingoModel(FlamingoConfig(**base, use_pallas=True),
                                    params=model.params, device=dev)
        # bench_extended.py's batch: images at m * (L // n_img), no padding
        rs = np.random.RandomState(0)
        ids = torch.tensor(rs.randint(0, 1000, (b, L)), device=dev)
        media = torch.zeros((b, L), dtype=torch.int32, device=dev)
        media[:, ::max(L // n_img, 1)] = 1
        mask = torch.ones((b, L), dtype=torch.int32, device=dev)
        size = config.vision_arch.image_size
        shape = (b, n_img) + ((frames,) if frames > 1 else ()) + (3, size, size)
        pixels = torch.tensor(rs.randn(*shape), dtype=torch.float32,
                              device=dev).to(torch.bfloat16)
        vocab = config.lm_arch.vocab_size + 1
        n_layer, steps, max_length = config.lm_arch.n_layer, new - 1, L + new
        kernels = dict(fused_attention=config.vision_arch.num_hidden_layers
                       + config.resampler_depth, fused_media_xattn=len(model.params["xattn"]))
        label = (f"{key} ({config.lm}, b={b}, {L}-token prompts, {n_img} image(s)"
                 f"{f' of {frames} frames' if frames > 1 else ''} a row, {new} new tokens)")

        def run(megakernel, new_tokens=new, m=model):
            return m.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=max_length,
                              max_new_tokens=new_tokens, prefix_block=PREFIX_BLOCK,
                              eos_token_id=vocab, pad_token_id=0, megakernel=megakernel)

        c, tokens, gaps = counts.setdefault(key, {}), {}, {}
        for path, megakernel, m in (("per layer", False, model), ("megakernel", True, model),
                                    ("use_pallas per layer", False, model_p),
                                    ("use_pallas megakernel", True, model_p)):
            gaps[path] = []
            tokens[path], c[path] = counted(lambda: run(megakernel, m=m), gaps[path], ids,
                                            (b, max_length), vocab)
            want = dict(lm_head_argmax=steps, **(kernels if m is model_p else {}))
            want["decode_step_megakernel" if megakernel else "decode_attention"] = \
                steps * (1 if megakernel else n_layer)
            expect(f"{label} {path}", c[path], **want)
        for path, megakernel in (("per layer", False), ("megakernel", True)):
            plain_gaps = []
            with plain_kernels(plain_gaps):
                plain_tokens = run(megakernel)
            torch.cuda.synchronize()
            compare_tokens(f"{key} {path} kernels vs plain", tokens[path],
                           plain_tokens[:, L:].cpu(), plain_gaps)
        for path, ref in (("megakernel", "per layer"), ("use_pallas per layer", "per layer"),
                          ("use_pallas megakernel", "megakernel")):
            compare_tokens(f"{key} {path} vs {ref}", tokens[path], tokens[ref], gaps[ref])
        stamp(f"{key} checked")
        time_generate(card, b, ((f"{key} per-layer", lambda n: run(False, n), new),
                                (f"{key} megakernel", lambda n: run(True, n), new)))
        if base is not MINI:
            del model, model_p
            torch.cuda.empty_cache()
    return counts


def contains(row, phrase) -> bool:
    n = len(phrase)
    return any(row[i:i + n] == list(phrase) for i in range(len(row) - n + 1))


def search_cells(dev, card, model, ids, media, mask, pixels, constrained_model):
    """Phase 3 and 4 of the rest of search at flamingo-mini width on
    ``model`` (int8 weight-only, bf16, batch 32, one image + 4-token
    prompt; the constrained beams' check on ``constrained_model``, all 24
    layers): beam-sample per layer and on the megakernel (launches exact,
    each against its plain-version run under one seed up to near-ties,
    one seed bit-equal twice), constrained beams and contrastive search per
    layer (no launches of the port's kernels, as in JAX; every hypothesis
    flagged complete holds its constraints; contrastive deterministic, and
    at penalty_alpha 0 greedy over the head-major cache up to near-ties),
    each path timed."""
    from flamingo_mini_tpu_torch import constrained_beam, contrastive
    from flamingo_mini_tpu_torch.generation import DecodeConfig
    config = model.config
    vocab = config.lm_arch.vocab_size + 1
    n_layer, L = config.lm_arch.n_layer, ids.shape[1]

    def sample_run(megakernel, new_tokens=BEAM_NEW_TOKENS, seed=SAMPLE_SEED):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=BEAM_MAX_LENGTH,
                              max_new_tokens=new_tokens, prefix_block=PREFIX_BLOCK,
                              eos_token_id=vocab, pad_token_id=0, megakernel=megakernel,
                              num_beams=BEAMS, do_sample=True,
                              temperature=SAMPLE_TEMPERATURE, top_k=SAMPLE_TOP_K,
                              generator=torch.Generator(device=dev).manual_seed(seed))

    def recorded_sample(megakernel, plain=False):
        steps = []
        zero_counts()
        with sample_recorder(steps), (plain_kernels([]) if plain
                                      else contextlib.nullcontext()):
            tokens = sample_run(megakernel)
        c = read_counts()
        check_output(tokens, ids, (BATCH, BEAM_MAX_LENGTH), vocab)
        assert len(steps) == BEAM_NEW_TOKENS, len(steps)
        return tokens[:, L:].cpu(), c, steps

    stamp("search start")
    beam_steps = BEAM_NEW_TOKENS - 1
    runs = {}
    for path, megakernel in (("beam-sample per layer", False),
                             ("beam-sample megakernel", True)):
        tokens, counts, steps = recorded_sample(megakernel)
        expect(path, counts, **({"decode_step_megakernel": beam_steps} if megakernel
                                else {"decode_attention_beam": n_layer * beam_steps}))
        plain_tokens, _, plain_steps = recorded_sample(megakernel, plain=True)
        compare_sampled_beams(f"{path} vs plain, one seed", tokens, steps, plain_tokens,
                              plain_steps, BEAMS, vocab)
        runs[path] = tokens, steps
    compare_sampled_beams("beam-sample megakernel vs per layer, one seed",
                          *runs["beam-sample megakernel"], *runs["beam-sample per layer"],
                          BEAMS, vocab)
    again = sample_run(True)[:, L:].cpu()
    other = sample_run(True, seed=SAMPLE_SEED + 1)[:, L:].cpu()
    same = torch.equal(again, runs["beam-sample megakernel"][0])
    print(f"[phase 3] beam-sample megakernel: one seed twice bit-equal {same}; another "
          f"seed {float((other != again).float().mean()):.4f} of tokens other")
    assert same and not torch.equal(other, again)
    stamp("beam-sample checked")

    # constrained beams: the pools and their complete flags recorded
    max_length = L + SEARCH_NEW
    pools = []
    impl = constrained_beam.constrained_beam_impl

    def record_pools(*args, **kw):
        out = impl(*args, **kw)
        pools.append(tuple(t.cpu() for t in out))
        return out

    def constrained_run(new_tokens=SEARCH_NEW, m=model):
        return m.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=max_length,
                              max_new_tokens=new_tokens, prefix_block=PREFIX_BLOCK,
                              eos_token_id=vocab, pad_token_id=0, num_beams=BEAMS,
                              force_words_ids=FORCE_WORDS)
    zero_counts()
    with patched(constrained_beam, "constrained_beam_impl", record_pools):
        tokens = constrained_run(m=constrained_model)
    expect("constrained beams per layer", read_counts())
    check_output(tokens, ids, (BATCH, max_length), vocab)
    seqs, scores, complete = pools[0]
    # HF's semantics: a beam that completed its constraints runs on only
    # while a child of it is among the step's best 2k (EOS is unreachable)
    assert bool(complete.any()), "no hypothesis completed its constraints"
    spec = constrained_beam.normalize_force_words(FORCE_WORDS)
    for row in seqs[complete][:, L:].tolist():
        for alts in spec:
            assert any(contains(row, alt) for alt in alts), (row, alts)
    assert torch.equal(tokens.cpu(), seqs[:, 0])
    print(f"[phase 3] constrained beams: {int(complete[:, 0].sum())}/{BATCH} rows return "
          f"a complete hypothesis, {int(complete.sum())}/{complete.numel()} of the pools' "
          "hypotheses flagged complete, each holding the phrase and one alternative of "
          f"the set after the prompt; best scores {scores[:4, 0].tolist()}...")

    # contrastive search: deterministic; at penalty_alpha 0 greedy over the
    # head-major cache
    def contrastive_run(new_tokens=SEARCH_NEW):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=max_length,
                              max_new_tokens=new_tokens, eos_token_id=vocab,
                              pad_token_id=0, penalty_alpha=CONTRAST_ALPHA,
                              top_k=CONTRAST_TOP_K)
    zero_counts()
    tokens = contrastive_run()
    expect("contrastive search per layer", read_counts())
    check_output(tokens, ids, (BATCH, max_length), vocab)
    again = contrastive_run()
    print(f"[phase 3] contrastive search: two runs bit-equal {torch.equal(tokens, again)}")
    assert torch.equal(tokens, again)
    dc = DecodeConfig(max_length=max_length, max_new_tokens=SEARCH_NEW, eos_token_id=vocab,
                      pad_token_id=0, top_k=CONTRAST_TOP_K)
    with torch.inference_mode():
        alpha0 = contrastive.contrastive_generate(
            model.params, config, dc, model.policy, ids, media, mask,
            pixel_values=pixels)[:, L:].cpu()
    gaps = []
    greedy, _ = counted(lambda: model.generate(
        ids, media_locations=media, attention_mask=mask, pixel_values=pixels,
        max_length=max_length, max_new_tokens=SEARCH_NEW, eos_token_id=vocab,
        pad_token_id=0, flat_kv_cache=False), [], ids, (BATCH, max_length), vocab,
        record=recorded_picks(gaps))
    compare_tokens("contrastive search at penalty_alpha 0 vs greedy (head-major cache)",
                   alpha0, greedy, gaps)
    print_agreement("contrastive search (penalty_alpha 0.6) vs greedy", tokens[:, L:].cpu(),
                    greedy)
    stamp("search checked")
    # beam-sample's own step work on the card, alone: the warpers over the
    # (96, V) log-probs; the noise, its transform and the top 2k of the
    # (32, 3V) keys with the scores gathered
    from flamingo_mini_tpu_torch import beam_search
    from flamingo_mini_tpu_torch.generation import warp
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dc = DecodeConfig(num_beams=BEAMS, do_sample=True, temperature=SAMPLE_TEMPERATURE,
                      top_k=SAMPLE_TOP_K)
    logp = torch.log_softmax(torch.randn((BATCH * BEAMS, vocab), device=dev), dim=-1)
    flat = torch.randn((BATCH, BEAMS * vocab), device=dev) - 20.0

    def draw():
        g = -torch.log(-torch.log(beam_search.uniform_noise(flat.shape, gen, dev)))
        return beam_search.select_candidates(flat, 2 * BEAMS, g)
    warp_ms, draw_ms = time_ms(lambda: warp(logp, dc), 20, flush), time_ms(draw, 20, flush)
    del flush
    print(f"[phase 4] {card}: beam-sample step work alone: the warpers (temperature, "
          f"top-k {SAMPLE_TOP_K}) over ({BATCH * BEAMS}, {vocab}) {warp_ms} ms; the noise "
          f"and the top {2 * BEAMS} of ({BATCH}, {BEAMS * vocab}) keys {draw_ms} ms "
          "(median per call, L2 flushed)")
    time_generate(card, BATCH, (
        ("beam-sample per-layer", lambda n: sample_run(False, n), BEAM_NEW_TOKENS),
        ("beam-sample megakernel", lambda n: sample_run(True, n), BEAM_NEW_TOKENS),
        ("constrained beams per-layer", constrained_run, SEARCH_NEW),
        ("contrastive per-layer", contrastive_run, SEARCH_NEW)))


def search_card_vs_cpu(dev):
    """Beam-sample per layer (top-k 1: ties at finfo.min; and temperature
    0.7, top-k 20), constrained beams and contrastive search at SMALL's
    float32 shape on the card and on the CPU with the same weights and
    noise: the card's stable sorts must order ties as the CPU's. Beam-sample
    rows equal up to near-ties (``compare_sampled_beams``), the other two
    identical; and ``torch.sort(stable=True)`` itself on rows full of ties."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel, beam_search
    stamp("search card vs CPU start")
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.int64):
        x = torch.randint(0, 4, (64, 150_774), generator=gen).to(dtype)
        for descending in (False, True):
            want = torch.sort(x, dim=1, descending=descending, stable=True).indices
            got = torch.sort(x.to(dev), dim=1, descending=descending, stable=True).indices
            assert torch.equal(got.cpu(), want), (dtype, descending)
    print("[phase 3] torch.sort(stable=True) on the card orders 64 rows of 150,774 values "
          "with four distinct values as the CPU does (float32 and int64, both directions)")
    config = FlamingoConfig(**SMALL)
    cpu = open_gates(FlamingoModel(config, device="cpu", seed=7))
    card = FlamingoModel(config, params=cpu.params, device=dev)
    rs = np.random.RandomState(9)
    ids = rs.randint(5, 250, (SMALL_B, SMALL_L))
    mask = np.ones((SMALL_B, SMALL_L), np.int32)
    media = np.zeros((SMALL_B, SMALL_L), np.int32)
    media[:, 0] = 1
    ids[1, :2], mask[1, :2], media[1] = 0, 0, 0
    media[1, 2] = 1
    pixels = rs.randn(SMALL_B, 1, 3, 32, 32).astype(np.float32)
    vocab = config.lm_arch.vocab_size + 1

    def run(m, steps=None, **kw):
        """One generate on ``m`` with beam-sample's noise drawn on the host
        from one seed (and its steps recorded into ``steps``) -> the
        generated tokens on the host."""
        noise = torch.Generator().manual_seed(11)
        draw = lambda shape, g, device: torch.rand(
            shape, generator=noise).clamp_min(1e-20).to(device)
        with patched(beam_search, "uniform_noise", draw), \
                (contextlib.nullcontext() if steps is None else sample_recorder(steps)):
            return m.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=SMALL_MAX,
                              eos_token_id=vocab, pad_token_id=0, **kw)[:, SMALL_L:].cpu()
    for top in (dict(top_k=1), dict(top_k=20, temperature=0.7)):
        kw = dict(num_beams=BEAMS, do_sample=True, **top)
        want_steps, got_steps = [], []
        want, got = run(cpu, want_steps, **kw), run(card, got_steps, **kw)
        compare_sampled_beams(f"beam-sample {top}, card vs CPU (float32)", got, got_steps,
                              want, want_steps, BEAMS, vocab)
    for label, kw in (("constrained beams", dict(num_beams=BEAMS, force_words_ids=[
                          [40, 41, 42], [[60, 61], [70, 71]]])),
                      ("contrastive search", dict(penalty_alpha=CONTRAST_ALPHA,
                                                  top_k=CONTRAST_TOP_K))):
        want, got = run(cpu, **kw), run(card, **kw)
        rows = int((got == want).all(dim=1).sum())
        print(f"[phase 3] {label}, card vs CPU (float32): {rows}/{SMALL_B} rows identical")
        assert torch.equal(got, want), (label, got, want)
    stamp("search card vs CPU done")


def synthetic_vocab(path: str, seed: int = 0, n_merges: int = VOCAB_MERGES) -> str:
    """Write a seeded ``vocab.json`` + ``merges.txt`` of GPT-2's size into
    the directory ``path`` -> ``path``: the 256 byte symbols (ids 0-255),
    then ``n_merges`` merges in rank order, each of an existing symbol and
    a printable ASCII one whose concatenation is new (it takes the next
    id): first "Ġ<", so that "<" and " <" get different ids as in GPT-2,
    and those spelling the prompt's words (``PROMPT_WORDS``: the prompt
    is 6 tokens, as GPT-2's vocabulary makes it), then random ones;
    ``<|endoftext|>`` last (id 50,256). Linear in the merges."""
    from flamingo_mini_tpu_torch.tokenizer import bytes_to_unicode
    byte_sym = bytes_to_unicode()
    symbols = [byte_sym[b] for b in range(256)]
    vocab = {sym: i for i, sym in enumerate(symbols)}
    merges = []

    def merge(a, b):
        merges.append((a, b))
        vocab[a + b] = len(vocab)
        symbols.append(a + b)
    merge("Ġ", "<")
    for word in PROMPT_WORDS:
        for i in range(1, len(word)):
            merge(word[:i], word[i])
    printable = [byte_sym[b] for b in range(ord("!"), ord("~") + 1)]
    rs = np.random.RandomState(seed)
    while len(merges) < n_merges:
        a = symbols[rs.randint(len(symbols))]
        b = printable[rs.randint(len(printable))]
        if a + b not in vocab:
            merge(a, b)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def caption_images(seed: int, n: int):
    """n seeded uint8 images: IMAGE_SHAPES' color sizes in turn, the last
    two grayscale."""
    rs = np.random.RandomState(seed)
    color = [s for s in IMAGE_SHAPES if len(s) == 3]
    gray = [s for s in IMAGE_SHAPES if len(s) == 2]
    shapes = [color[i % len(color)] for i in range(n - len(gray))] + gray
    return [rs.randint(0, 256, s).astype(np.uint8) for s in shapes]


def counted_captions(model, fn):
    """``fn()`` (a ``generate_captions`` call on ``model``) with every launch
    count at 0 before it -> (captions, the tokens its ``generate``
    returned, counts)."""
    out = {}
    generate = model.generate

    def recording(*args, **kw):
        out["tokens"] = generate(*args, **kw)
        return out["tokens"]
    zero_counts()
    model.generate = recording
    try:
        captions = fn()
    finally:
        del model.generate
    return captions, out["tokens"], read_counts()


def same_bits(label, got, want):
    """Two parameter trees (``flatten_tree`` form) equal key for key, bit
    for bit."""
    assert sorted(got) == sorted(want), (label, sorted(set(got) ^ set(want))[:5])
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), (label, k)
    print(f"[phase 3] {label}: {len(want)} leaves bit-equal to the saved params")


def check_captions(label, proc, captions, tokens, ids, vocab):
    """Each caption is its row's decode (special tokens skipped) with the
    tags removed; the output has its prompt and ids in range."""
    check_output(tokens, ids, (ids.shape[0], tokens.shape[1]), vocab)
    rows = tokens.tolist()
    want = [proc.remove_tags(proc.tokenizer.decode(r, skip_special_tokens=True))
            for r in rows]
    assert captions == want, label
    print(f"[phase 3] {label}: {len(captions)} captions, each its row's decode; "
          f"caption 0 {captions[0][:60]!r}...")


def entry_point_cells(dev, card, model, model_p, vocab_dir):
    """Phase 3 and 4 of the public entry point on the flamingo-mini
    ``model`` (int8, bf16) and its use_pallas twin ``model_p``: captions
    from uint8 images through ``generate_captions`` (megakernel, per layer,
    use_pallas megakernel), launches exact, tokens bit-equal to
    ``generate`` on the processor's own tensors, pixels against the CPU,
    captions against the decode; timed beside ``generate`` alone, the
    preprocessing and ``batch_decode``."""
    from flamingo_mini_tpu_torch import FlamingoProcessor
    from flamingo_mini_tpu_torch.ops.image import preprocess_images
    stamp("entry point start")
    config = model.config
    proc = FlamingoProcessor(config, vocab_path=vocab_dir, device=dev)
    tok = proc.tokenizer
    vocab = config.lm_arch.vocab_size + 1
    assert len(tok) == vocab == 50258 and proc.eoc_token_id == 50257
    assert tok.eos_token_id == 50256 and proc.leq_ids[0] != proc.leq_ids[1]
    assert tok._get_native() is not None, "the C++ merger did not build"
    images = caption_images(0, BATCH)
    ids, media, mask = proc.encode_text(CAPTION_PROMPT)
    L = ids.shape[1]
    assert ids.device == dev and int(media.sum()) == 1
    print(f"[phase 3] entry point: prompt {CAPTION_PROMPT!r} -> {L} tokens "
          f"{ids[0].tolist()}, media {media[0].tolist()}; {len(images)} images of "
          f"{sorted(set(im.shape for im in images))}")
    pixels = proc.preprocess_images(images)
    arch = config.vision_arch
    cpu = preprocess_images(images, size=arch.image_size, crop=arch.image_size,
                            mean=arch.image_mean, std=arch.image_std, device="cpu")
    assert pixels.device == dev and pixels.dtype == torch.float32
    assert tuple(pixels.shape) == (BATCH, 3, arch.image_size, arch.image_size)
    err = float((pixels.cpu() - cpu).abs().max())
    print(f"[phase 3] entry point: pixels on the card vs the same function on the "
          f"CPU: max abs difference {err} (tolerance 1e-4)")
    assert err <= 1e-4, err
    n_layer, steps = config.lm_arch.n_layer, NEW_TOKENS - 1
    kw = dict(max_length=L + NEW_TOKENS, max_new_tokens=NEW_TOKENS,
              prefix_block=PREFIX_BLOCK, eos_token_id=vocab, pad_token_id=0)
    rows = (ids.repeat(BATCH, 1), media.repeat(BATCH, 1), mask.repeat(BATCH, 1))

    def captions(m, megakernel):
        return m.generate_captions(proc, images=images, prompt=CAPTION_PROMPT,
                                   megakernel=megakernel, **kw)

    def generate(m, megakernel):
        return m.generate(rows[0], media_locations=rows[1], attention_mask=rows[2],
                          pixel_values=pixels[:, None], megakernel=megakernel, **kw)

    pallas = dict(fused_attention=arch.num_hidden_layers + config.resampler_depth,
                  fused_media_xattn=len(model.params["xattn"]))
    tokens = {}
    for path, m, megakernel, want in (
            ("megakernel", model, True,
             dict(decode_step_megakernel=steps, lm_head_argmax=steps)),
            ("per layer", model, False,
             dict(decode_attention=n_layer * steps, lm_head_argmax=steps)),
            ("use_pallas megakernel", model_p, True,
             dict(decode_step_megakernel=steps, lm_head_argmax=steps, **pallas))):
        caps, tokens[path], counts = counted_captions(m, lambda: captions(m, megakernel))
        expect(f"entry point generate_captions, {path}", counts, **want)
        ref = generate(m, megakernel)
        assert torch.equal(tokens[path], ref), path
        print(f"[phase 3] entry point {path}: tokens bit-equal to generate on the "
              "processor's ids, media and pixels")
        check_captions(f"entry point {path}", proc, caps, tokens[path], rows[0], vocab)
    print_agreement("entry point per layer vs megakernel", tokens["per layer"][:, L:].cpu(),
                    tokens["megakernel"][:, L:].cpu())
    stamp("entry point checked")

    cap_ms, cap_all = timed(lambda: captions(model, True))
    gen_ms, gen_all = timed(lambda: generate(model, True))
    pre_ms, pre_all = timed(lambda: proc.preprocess_images(images))
    host = tokens["megakernel"].cpu()
    dec = []
    for _ in range(5):
        t0 = time.perf_counter()
        tok.batch_decode(host, skip_special_tokens=True)
        dec.append((time.perf_counter() - t0) * 1e3)
    dec_ms = statistics.median(dec)
    print(f"[phase 4] {card}: entry point, megakernel, {BATCH} images x {NEW_TOKENS} "
          f"tokens: generate_captions median {cap_ms} ms (runs {cap_all}), "
          f"{BATCH / (cap_ms / 1e3)} captions/s; generate alone median {gen_ms} ms "
          f"(runs {gen_all}), {BATCH / (gen_ms / 1e3)} captions/s; preprocessing of "
          f"{BATCH} images median {pre_ms} ms (runs {pre_all}); batch_decode median "
          f"{dec_ms} ms (runs {dec}); the call less generate {cap_ms - gen_ms} ms")


def config1_from_pretrained(dev, card, vocab_dir):
    """BASELINE config 1 via ``from_pretrained``: flamingo-tiny seeded in
    float32, saved in both layouts, loaded from the npz and from
    ``config.json`` + ``model.safetensors`` (``vision_params``), each
    bit-equal to the saved params; the checkpoint converter's ``main`` on
    that HF-layout checkpoint with its CLIP tower as a local
    ``--clip-checkpoint`` and the vocab files beside it (they are copied;
    the converted checkpoint loads bit-equal to the saved params); then
    int8 and bf16 on all of them, captions from uint8 images per layer and
    on the megakernel (the converted model on the megakernel), launches
    exact, the loaded and converted models' tokens bit-equal to the
    in-memory model's; captions/s."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel, FlamingoProcessor
    from flamingo_mini_tpu_torch.modeling_flamingo import flatten_tree
    from flamingo_mini_tpu_torch.tools import convert_checkpoint
    from flamingo_mini_tpu_torch.utils.hf_export import export_clip_vit
    from flamingo_mini_tpu_torch.utils.safetensors_io import save_file
    stamp("config 1 via from_pretrained start")
    base, b, _, new, _, _ = BASELINE_CELLS["config 1"]
    config = FlamingoConfig(**base)
    saved = open_gates(FlamingoModel(config, device=dev, seed=3))
    want = flatten_tree(saved.params)
    assert all(v.dtype == np.float32 for v in want.values())
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        both, hf = os.path.join(tmp, "both"), os.path.join(tmp, "hf")
        t0 = time.perf_counter()
        saved.save_pretrained(both, save_format="both")
        save_s = time.perf_counter() - t0
        os.makedirs(hf)
        shutil.copy(os.path.join(both, "config.json"), hf)
        os.link(os.path.join(both, "model.safetensors"), os.path.join(hf, "model.safetensors"))
        sizes = {n: os.path.getsize(os.path.join(both, n)) for n in sorted(os.listdir(both))}
        # config.json holds the architecture, not the compute dtype (as in
        # JAX and the reference): a bf16 caller sets it on the loaded config
        loaded = FlamingoConfig.from_pretrained(hf)
        assert loaded.to_dict() == config.to_dict()
        loaded.compute_dtype = config.compute_dtype
        t0 = time.perf_counter()
        from_npz = FlamingoModel.from_pretrained(both, config=loaded, device=dev)
        npz_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        from_hf = FlamingoModel.from_pretrained(hf, config=loaded,
                                                vision_params=saved.params["vision"],
                                                device=dev)
        hf_s = time.perf_counter() - t0
        clip, conv = os.path.join(tmp, "clip"), os.path.join(tmp, "converted")
        os.makedirs(clip)
        save_file(export_clip_vit(saved.params["vision"]),
                  os.path.join(clip, "model.safetensors"))
        for name in ("vocab.json", "merges.txt"):
            shutil.copy(os.path.join(vocab_dir, name), hf)
        t0 = time.perf_counter()
        convert_checkpoint.main([hf, conv, "--clip-checkpoint", clip, "--device", "cuda"])
        conv_s = time.perf_counter() - t0
        for name in ("vocab.json", "merges.txt"):
            with open(os.path.join(hf, name), "rb") as a, \
                    open(os.path.join(conv, name), "rb") as b_:
                assert a.read() == b_.read(), name
        converted = FlamingoModel.from_pretrained(conv, config=loaded, device=dev)
    print(f"[phase 3] config 1 via from_pretrained: saved {sizes} in {save_s:.1f} s; "
          f"loaded the npz in {npz_s:.1f} s, config.json + model.safetensors in "
          f"{hf_s:.1f} s; tools/convert_checkpoint.py on the HF layout + a local CLIP "
          f"checkpoint -> npz in {conv_s:.1f} s, vocab files copied")
    same_bits("config 1 from the npz", flatten_tree(from_npz.params), want)
    same_bits("config 1 from model.safetensors + vision_params",
              flatten_tree(from_hf.params), want)
    same_bits("config 1 converted by tools/convert_checkpoint.py",
              flatten_tree(converted.params), want)
    for m in (saved, from_npz, from_hf, converted):
        m.quantize_int8().to_bf16()
    proc = FlamingoProcessor(config, vocab_path=vocab_dir, device=dev)
    images = caption_images(1, b)
    L = proc.encode_text(CAPTION_PROMPT)[0].shape[1]
    vocab = config.lm_arch.vocab_size + 1
    steps, n_layer = new - 1, config.lm_arch.n_layer
    kw = dict(max_length=L + new, max_new_tokens=new, prefix_block=PREFIX_BLOCK,
              eos_token_id=vocab, pad_token_id=0)
    ids = proc.encode_text(CAPTION_PROMPT)[0].repeat(b, 1)

    def captions(m, megakernel):
        return m.generate_captions(proc, images=images, prompt=CAPTION_PROMPT,
                                   megakernel=megakernel, **kw)
    for path, megakernel, want_counts in (
            ("per layer", False, dict(decode_attention=n_layer * steps,
                                      lm_head_argmax=steps)),
            ("megakernel", True, dict(decode_step_megakernel=steps,
                                      lm_head_argmax=steps))):
        ref = None
        for label, m in (("in memory", saved), ("from the npz", from_npz),
                         ("from model.safetensors", from_hf),
                         *((("converted", converted),) if megakernel else ())):
            caps, tokens, c = counted_captions(m, lambda: captions(m, megakernel))
            expect(f"config 1 {label}, {path}", c, **want_counts)
            check_captions(f"config 1 {label}, {path}", proc, caps, tokens, ids, vocab)
            if ref is None:
                ref = tokens, caps
            else:
                assert torch.equal(tokens, ref[0]) and caps == ref[1], (label, path)
                print(f"[phase 3] config 1 {label}, {path}: tokens bit-equal to the "
                      "in-memory model's")
    stamp("config 1 via from_pretrained checked")
    for path, megakernel in (("per layer", False), ("megakernel", True)):
        ms, runs = timed(lambda: captions(from_npz, megakernel))
        print(f"[phase 4] {card}: config 1 via from_pretrained ({config.lm}, b={b}, "
              f"{L}-token prompt, {new} new tokens), {path}: generate_captions median "
              f"{ms} ms (runs {runs}), {b / (ms / 1e3)} captions/s")
    del saved, from_npz, from_hf, converted
    torch.cuda.empty_cache()


def scoring_cells(dev, card, model, model_p, vocab_dir):
    """``score_sequences`` at flamingo-mini width with use_pallas off and on:
    launches exact, the same top-k set but at near-ties of the candidate
    logits (printed), kept scores within 1.25 x the plain version's
    CPU-vs-card spread normwise (no 1e-2 floor: this is the only check of
    ``fused_media_xattn`` at pass 2's shape, the chosen rows re-entering
    the cache), every other row at float32 min; scored sequences/s."""
    from flamingo_mini_tpu_torch import FlamingoModel, FlamingoProcessor, scoring
    from flamingo_mini_tpu_torch.ops import topk
    stamp("scoring start")
    config = model.config
    proc = FlamingoProcessor(config, vocab_path=vocab_dir, device=dev)
    tag, tag_media, _ = proc.encode_text("<image>")
    rs = np.random.RandomState(7)
    prefix = rs.randint(0, 50256, SCORE_PREFIX)
    suffix = rs.randint(0, 50256, (SCORE_N, SCORE_SUFFIX))
    # the first suffix token from a pool of 6: rows tie in groups
    suffix[:, 0] = rs.choice(rs.randint(0, 50256, 6), SCORE_N)
    body = np.concatenate([np.tile(prefix, (SCORE_N, 1)), suffix], axis=1)
    ids = torch.cat([tag.repeat(SCORE_N, 1), torch.tensor(body, device=dev)], dim=1)
    media = torch.cat([tag_media.repeat(SCORE_N, 1),
                       torch.zeros(body.shape, dtype=torch.int32, device=dev)], dim=1)
    mask = torch.ones_like(media)
    n_true = tag.shape[1] + SCORE_PREFIX
    assert scoring.get_common_prefix_length(ids.cpu().numpy()) == n_true
    pixels = proc.preprocess_images(caption_images(2, 1))          # (1, 3, 224, 224)
    f32_min = torch.finfo(torch.float32).min
    arch = config.vision_arch

    def score(m):
        return m.score_sequences(ids, media, mask, pixel_values=pixels, k=SCORE_K)

    def recorded_score(m):
        seen = {}

        def rec(x, k):
            seen["cand"] = x.float().cpu()
            return topk.top_k(x, k)
        with patched(scoring, "top_k", rec):
            out = score(m)
        return out, seen["cand"]

    runs = {}
    for path, m, want in (("use_pallas off", model, {}),
                          ("use_pallas", model_p,
                           dict(fused_attention=arch.num_hidden_layers + config.resampler_depth,
                                fused_media_xattn=2 * len(model.params["xattn"])))):
        zero_counts()
        runs[path] = recorded_score(m)
        expect(f"score_sequences, {path}", read_counts(), **want)
    cpu_model = FlamingoModel(config, params=model.params, device="cpu")
    t0 = time.perf_counter()
    s_cpu = cpu_model.score_sequences(ids.cpu(), media.cpu(), mask.cpu(),
                                      pixel_values=pixels.cpu(), k=SCORE_K)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    kept = {}
    for path, (s, cand) in runs.items():
        assert s.shape == (SCORE_N,) and s.dtype == torch.float32
        keep = s != f32_min
        assert int(keep.sum()) == SCORE_K, (path, int(keep.sum()))
        assert bool(torch.isfinite(s[keep]).all()) and bool((s[keep] < 0).all())
        assert bool((s[~keep] == f32_min).all())
        kept[path] = set(keep.nonzero()[:, 0].tolist())
        print(f"[phase 3] score_sequences, {path}: kept rows {sorted(kept[path])}, "
              f"scores {s[keep].tolist()}; candidate logits {cand.tolist()}")
    # rows kept by one run only: each at a near-tie of that run's k-th
    # candidate logit (8 bf16 ulps) in both runs
    for row in kept["use_pallas off"] ^ kept["use_pallas"]:
        for path, (_, cand) in runs.items():
            cut = torch.sort(cand, descending=True, stable=True)[0][SCORE_K - 1]
            gap = float((cand[row] - cut).abs())
            print(f"[phase 3] score_sequences: row {row} kept by one run only: "
                  f"{path}'s candidate logit {float(cand[row])} vs its k-th "
                  f"{float(cut)} (gap {gap}, 8 bf16 ulps {bf16_ulps(cut, 8)})")
            assert gap <= bf16_ulps(cut, 8), (row, path, gap)
    s_off, s_on = runs["use_pallas off"][0], runs["use_pallas"][0]
    keep_cpu = set((s_cpu != f32_min).nonzero()[:, 0].tolist())
    both = sorted(kept["use_pallas off"] & kept["use_pallas"] & keep_cpu)
    err = rel_err(s_on[both], s_off[both])
    spread = rel_err(s_cpu[both], s_off[both].cpu())
    print(f"[phase 3] score_sequences: kept scores, use_pallas vs off: normwise "
          f"relative error {err}; the plain version on the CPU ({cpu_s:.1f} s) vs the "
          f"card: {spread} (tolerance: 1.25 x the spread; "
          f"{len(both)} rows kept by all three)")
    assert err <= 1.25 * spread, (err, spread)
    stamp("scoring checked")
    for path, m in (("use_pallas off", model), ("use_pallas", model_p)):
        ms, all_ms = timed(lambda: score(m))
        print(f"[phase 4] {card}: score_sequences, {path}, {SCORE_N} candidates of "
              f"{ids.shape[1]} tokens ({n_true}-token common prefix), k={SCORE_K}: "
              f"median {ms} ms (runs {all_ms}), {SCORE_N / (ms / 1e3)} scored "
              "sequences/s")


def scripts_cells(dev, card, model, model24, model_f):
    """The ported scripts on the card. The fidelity tool's measurement
    (``tools.int8_fidelity.compare``) on the seeded flamingo-mini (all 24
    layers: bf16 ``model_f``'s weights, int8 ``model24``'s, gates open), one
    batch of FID_B captions x FID_NEW tokens, bf16 and int8 per layer and
    w8a8 on the megakernel, launches exact; the pair report printed. The six
    examples in-process through ``main(["--device", "cuda"])``, each ending
    with its usual line (batch_serving with ``FLAMINGO_INT8=1``). (The
    converter runs in ``config1_from_pretrained``, on its checkpoint.)
    Profiling, on phase 3's warm flamingo-mini ``model`` (its first
    MINI_LAYERS layers): ``trace`` around one megakernel generate (its
    CUDA kernel events name the megakernel's and the head's symbols), a
    ``PhaseTimer`` over encode, prefill and decode, and ``debug_nans``: on,
    a clean generate passes and a NaN planted in the pixels raises
    ``FloatingPointError``; off, it does not."""
    import glob
    import io
    from unittest import mock
    from flamingo_mini_tpu_torch.examples import (batch_serving, export_to_torch,
                                                  few_shot_prompt, image_captioning,
                                                  model_stats, video_captioning)
    from flamingo_mini_tpu_torch.tools import int8_fidelity
    from flamingo_mini_tpu_torch.utils import profiling
    stamp("scripts start")
    config = model24.config
    n_layer, steps = config.lm_arch.n_layer, FID_NEW - 1
    zero_counts()
    pairs = int8_fidelity.compare(config, model_f.params, model24.params, captions=FID_B,
                                  batch=FID_B, decode_tokens=FID_NEW, w8a8=True, device=dev)
    expect("fidelity tool (bf16 and int8 per layer, w8a8 megakernel)", read_counts(),
           decode_attention=2 * n_layer * steps, lm_head_argmax=2 * steps,
           decode_step_megakernel=steps)
    for name, stats in pairs.items():
        print(f"[phase 3] fidelity tool at flamingo-mini width (24 layers, random weights, "
              f"gates 0.5), {FID_B} captions x {FID_NEW} tokens: {name} {stats.report()}")
    stamp("scripts: fidelity done")

    for module in (image_captioning, batch_serving, few_shot_prompt, video_captioning,
                   model_stats, export_to_torch):
        name = module.__name__.rsplit(".", 1)[-1]
        out = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ), contextlib.redirect_stdout(out):
            for key in ("FLAMINGO_CKPT", "FLAMINGO_IMAGE", "FLAMINGO_INT8"):
                os.environ.pop(key, None)
            if name == "batch_serving":
                os.environ["FLAMINGO_INT8"] = "1"
            module.main(["--device", "cuda"])
        text = out.getvalue()
        print("\n".join(f"[phase 3] example {name}: {line}" for line in text.splitlines()
                        if name != "model_stats" or "params" in line))
        assert any(line.startswith(EXAMPLE_LINES[name]) for line in text.splitlines()), name
        print(f"[phase 3] example {name} ran on the card in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    stamp("scripts: examples done")

    arch = config.vision_arch
    rs = np.random.RandomState(6)
    ids = torch.tensor(rs.randint(0, 1000, (PROF_B, PROMPT_LEN)), device=dev)
    media = torch.zeros_like(ids, dtype=torch.int32)
    media[:, 0] = 1
    mask = torch.ones_like(media)
    px = torch.tensor(rs.randn(PROF_B, 1, 3, arch.image_size, arch.image_size),
                      dtype=torch.float32, device=dev).to(torch.bfloat16)
    kw = dict(media_locations=media, attention_mask=mask, max_length=PROMPT_LEN + PROF_NEW,
              prefix_block=PREFIX_BLOCK, eos_token_id=config.lm_arch.vocab_size + 1,
              pad_token_id=0, megakernel=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        with profiling.trace(tmp), profiling.annotate("megakernel generate"):
            model.generate(ids, pixel_values=px, **kw)
        (path,) = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {sym: sum(sym in k for k in kernels)
             for sym in ("decode_megakernel_sm90", "lm_head_kernel")}
    print(f"[phase 3] profiling.trace around a megakernel generate ({PROF_B} x {PROF_NEW}): "
          f"{len(kernels)} CUDA kernel events, by the port's symbols {named}; spans "
          f"{sorted({e['name'] for e in events if e.get('cat') == 'user_annotation'})}")
    assert all(named.values()), named
    stamp("scripts: trace done")
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("encode"):
            feats = timer.fence(model.encode_resample_visuals(px))
        with timer.phase("prefill"):
            timer.fence(model.generate(ids, visual_features=feats, max_new_tokens=1, **kw))
        with timer.phase("decode"):
            timer.fence(model.generate(ids, visual_features=feats, **kw))
    print(f"[phase 4] {card}: PhaseTimer over a megakernel generate ({PROF_B} x "
          f"{PROF_NEW}; 'prefill' is a generate of one token, 'decode' the whole one, "
          f"both on the encoded features): {timer.summary()}")
    stamp("scripts: PhaseTimer done")
    bad = px.clone()
    bad[0, 0, 0, 7, 7] = float("nan")
    profiling.debug_nans(True)
    try:
        model.generate(ids, pixel_values=px, **kw)
        try:
            model.generate(ids, pixel_values=bad, **kw)
            raise AssertionError("debug_nans: a NaN in the pixels did not raise")
        except FloatingPointError as e:
            print(f"[phase 3] debug_nans on: a clean generate passes; a NaN in the pixels "
                  f"raises FloatingPointError ({e})")
    finally:
        profiling.debug_nans(False)
    out = model.generate(ids, pixel_values=bad, **kw)
    assert out.shape == (PROF_B, PROMPT_LEN + PROF_NEW)
    print("[phase 3] debug_nans off: the same generate returns")
    torch.cuda.empty_cache()
    stamp("scripts done")


def attention_leaves(dev, b, h, n_q, n_kv, seed):
    """``attention_inputs`` in bf16 whose (b, n, h * 64) projections are
    leaves that require grad -> (q, k, v, [the three leaves])."""
    q, k, v = attention_inputs(dev, torch.bfloat16, b, h, n_q, n_kv, seed)
    leaves = [t.transpose(1, 2).reshape(b, -1, h * HEAD_DIM).detach().requires_grad_()
              for t in (q, k, v)]
    return (*(x.view(b, -1, h, HEAD_DIM).transpose(1, 2) for x in leaves), leaves)


def training_ops(dev, flush, card):
    """The recompute backward of ``fused_attention`` and ``fused_media_xattn``
    at the training step's shapes (``TRAIN_OPS``): through the wrappers on
    inputs that require grad, dq, dk and dv bit for bit those of autograd
    through the plain version for the same upstream gradient, the output
    bit for bit the kernel's under no_grad; then the kernel forward, the
    forward with its recompute backward, and the plain forward and backward
    timed (L2 flushed)."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (fused_attention,
                                                             fused_attention_plain)
    from flamingo_mini_tpu_torch.ops.media_xattn import (fused_media_xattn,
                                                         fused_media_xattn_plain)
    for name, (b, h, n_q, n_kv, pad) in TRAIN_OPS.items():
        q, k, v, leaves = attention_leaves(dev, b, h, n_q, n_kv, seed=n_kv + h)
        if name == "media":
            tt = media_text_time(dev, b, n_q, 1, seed=3)
            kw = dict(text_time=tt, scale=HEAD_DIM ** -0.5, n_visual=n_kv)
            kernel = lambda q, k, v: fused_media_xattn(q, k, v, kw["text_time"],
                                                       scale=kw["scale"], n_visual=n_kv)
            plain = lambda q, k, v: fused_media_xattn_plain(
                q, k, v, kw["text_time"], scale=kw["scale"], n_visual=n_kv)
        else:
            kw = dict(scale=HEAD_DIM ** -0.5)
            if pad is not None:
                pads = [GPT2_PAD, 3] + [0] * (b - 2)
                real = torch.arange(n_kv, device=dev)[None, :]
                lim = torch.tensor(pads, device=dev)[:, None]
                real = real >= lim if pad == "left" else real < n_kv - lim
                kw.update(causal=True, row_bias=torch.where(
                    real, 0.0, torch.finfo(torch.float32).min).to(torch.bfloat16).float())
            kernel = lambda q, k, v: fused_attention(q, k, v, **kw)
            plain = lambda q, k, v: fused_attention_plain(q, k, v, **kw)
        up = torch.randn((b, h, n_q, HEAD_DIM), device=dev).to(torch.bfloat16)
        out = kernel(q, k, v)
        got = torch.autograd.grad(out, leaves, up)
        want = torch.autograd.grad(plain(q, k, v), leaves, up)
        with torch.no_grad():
            fwd = kernel(q, k, v)
        assert torch.equal(out.detach(), fwd), name
        for part, g, w in zip("qkv", got, want):
            assert torch.equal(g, w), (name, part, rel_err(g, w))
        fwd_ms = time_ms(lambda: kernel(*(t.detach() for t in (q, k, v))), 20, flush)
        both_ms = time_ms(lambda: torch.autograd.grad(kernel(q, k, v), leaves, up), 20, flush)
        plain_ms = time_ms(lambda: torch.autograd.grad(plain(q, k, v), leaves, up), 20,
                           flush)
        print(f"[phase 3] {card}: training {name} {(b, h, n_q, n_kv)} bf16: dq, dk, dv of "
              f"the recompute backward bit-equal to autograd through the plain version; "
              f"kernel forward {fwd_ms} ms, forward + recompute backward {both_ms} ms "
              f"(backward {both_ms - fwd_ms} ms), plain forward + backward {plain_ms} ms "
              "(median per call, L2 flushed)")


@torch.no_grad()
def grads_rel_err(got, want) -> float:
    """Normwise relative error over a list of gradients, leaf by leaf on
    ``want``'s device, in float64 sums."""
    num = den = 0.0
    for g, w in zip(got, want):
        w = w.float()
        num += float((g.to(w.device).float() - w).double().square().sum())
        den += float(w.double().square().sum())
    return (num / den) ** 0.5


def loss_and_grads(params, config, policy, batch, mask):
    """The training loss of ``params`` on ``batch`` under ``policy`` and its
    gradients at the leaves ``mask`` marks trainable (pytree order)."""
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.utils.params import trainable_leaves
    leaves = [leaf for _, leaf in trainable_leaves(params, mask)]
    loss = F.forward(params, config, batch["input_ids"], policy=policy,
                     media_locations=batch["media_locations"],
                     attention_mask=batch["attention_mask"],
                     pixel_values=batch["pixel_values"], labels=batch["labels"]).loss
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True,
                                              materialize_grads=True)


def training_cell(dev, card, label, cfg, n_timed, vocab_dir, checks):
    """Phase 3 and 4 of one training configuration, bf16 over float32
    parameters, use_pallas, gates 0.5, a batch of TRAIN_B x TRAIN_N collated
    by ``DataCollator`` from ``SyntheticCaptionDataset`` over the synthetic
    vocabulary and put on the card by ``prefetch_to_device``: the kernels'
    loss and gradients against use_pallas off on the card (normwise, within
    max(1e-2, 1.25 x the same program's CPU-vs-card spread)); TRAIN_WARM +
    ``n_timed`` steps, the first with every launch count at 0 (exact
    counts), each between CUDA events: median step ms and spread,
    samples/s, tokens/s, peak memory; the loss finite and lower after the
    steps; frozen leaves bit for bit and no gradient reaching the vision
    tower; the split (encode + resample, forward, forward + backward, clip
    + AdamW, each its own timed call). ``checks``: the extra checks run in
    this cell ("dropout", "remat", "eval", "checkpoint"). -> the step's
    launch counts."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel, FlamingoProcessor
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.ops.layers import policy_for
    from flamingo_mini_tpu_torch.tokenizer import BPETokenizer
    from flamingo_mini_tpu_torch.train import (DataCollator, FlamingoTrainer,
                                               SyntheticCaptionDataset, TrainingArguments)
    from flamingo_mini_tpu_torch.train.data import SyntheticEvalDataset, prefetch_to_device
    from flamingo_mini_tpu_torch.train.trainer import AdamW, clip_by_global_norm
    from flamingo_mini_tpu_torch.utils.params import leaves_with_path, tree_map
    stamp(f"training {label} start")
    config = FlamingoConfig(**cfg, use_pallas=True)
    model = open_gates(FlamingoModel(config, device=dev, seed=0))
    # the synthetic GPT-2-size vocabulary for both trunks: the eos is
    # <|endoftext|>, the pad of the right-padded batches
    proc = FlamingoProcessor(config, tokenizer=BPETokenizer.gpt2(vocab_dir), device="cpu")
    ds = SyntheticCaptionDataset(size=TRAIN_B)
    host = DataCollator(proc, length=TRAIN_N)([ds[i] for i in range(TRAIN_B)])
    (batch,) = prefetch_to_device(iter([host]), dev, cast_pixels=model.policy.cast)
    out_dir = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    args = TrainingArguments(output_dir=out_dir, learning_rate=TRAIN_LR, warmup_steps=1,
                             eval_every_steps=None, report_to="none",
                             per_device_eval_batch_size=TRAIN_EVAL_IMAGES,
                             eval_coco_captioning_end=TRAIN_EVAL_IMAGES)
    trainer = FlamingoTrainer(model, args)
    n_fa = config.vision_arch.num_hidden_layers + config.resampler_depth \
        + F.n_lm_layers(config)
    n_mx = len(model.params["xattn"])
    n_train = sum(leaf.numel() for leaf in trainer.trainable_leaves)
    print(f"[phase 3] training {label}: {len(trainer.trainable_leaves)} trainable leaves, "
          f"{n_train} parameters; batch {TRAIN_B} x {TRAIN_N} tokens, "
          f"{int(host['attention_mask'].sum())} real")

    # the kernels against use_pallas off, at step 0's parameters
    zero_counts()
    loss_k, grads_k = trainer.gradients(batch)
    expect(f"training {label} loss and gradients", read_counts(),
           fused_attention=n_fa, fused_media_xattn=n_mx)
    off = FlamingoConfig(**cfg)
    fast = policy_for(off.compute_dtype, off.use_pallas)
    loss_o, grads_o = loss_and_grads(model.params, off, fast, batch, trainer.mask)
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.detach().cpu().requires_grad_(t.requires_grad),
                          model.params)
    loss_c, grads_c = loss_and_grads(cpu_params, off, fast,
                                     {k: t.cpu() for k, t in batch.items()}, trainer.mask)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    for part, err, spread in (
            ("loss", rel_err(loss_k, loss_o), rel_err(loss_c, loss_o.cpu())),
            ("trainable gradients", grads_rel_err(grads_k, grads_o),
             grads_rel_err(grads_o, grads_c))):
        print(f"[phase 3] training {label} {part}: normwise relative error of the "
              f"kernels vs use_pallas=False {err}; use_pallas=False on the CPU vs the "
              f"card {spread} (limit: the larger of 1e-2 and 1.25 x that)")
        assert err <= max(1e-2, 1.25 * spread), (label, part, err, spread)
    print(f"[phase 3] training {label}: loss kernels {float(loss_k)}, use_pallas=False "
          f"{float(loss_o)}, on the CPU {float(loss_c)} ({cpu_s:.1f} s)")
    del grads_o, grads_c

    # the steps
    frozen = {path: leaf.detach().clone() for path, leaf in leaves_with_path(model.params)
              if not leaf.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(TRAIN_WARM + n_timed):
        if i == 0:
            zero_counts()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        losses.append(trainer.train_step_on(batch))
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        if i == 0:
            step_counts = read_counts()
            expect(f"training {label} step", step_counts, fused_attention=n_fa,
                   fused_media_xattn=n_mx)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for path, leaf in leaves_with_path(model.params):
        if path in frozen:
            assert torch.equal(leaf, frozen[path]), (label, path)
    del frozen
    vision = [leaf for _, leaf in leaves_with_path(model.params["vision"])]
    for leaf in vision:
        leaf.requires_grad_()
    vis_grads = torch.autograd.grad(trainer.loss(batch, trainer.step), vision,
                                    allow_unused=True)
    assert all(g is None for g in vis_grads), label
    for leaf in vision:
        leaf.requires_grad_(False)
    timed_ms = times[TRAIN_WARM:]
    step_ms = statistics.median(timed_ms)
    print(f"[phase 3] training {label}: losses {losses}; frozen leaves bit-equal after "
          f"{len(losses)} steps; vision gradients None")
    print(f"[phase 4] {card}: training {label}, batch {TRAIN_B} x {TRAIN_N}, bf16, "
          f"use_pallas: step median {step_ms} ms over {n_timed} steps (min "
          f"{min(timed_ms)}, max {max(timed_ms)}; steps {timed_ms}; warm-up "
          f"{times[:TRAIN_WARM]}), {TRAIN_B / (step_ms / 1e3)} samples/s, "
          f"{TRAIN_B * TRAIN_N / (step_ms / 1e3)} tokens/s, peak memory {peak:.2f} GiB")

    # the split, each part its own timed call
    with torch.no_grad():
        vis_ms, _ = timed(lambda: F.encode_resample_visuals(
            model.params, config, batch["pixel_values"], policy=model.policy))
        fwd_ms, _ = timed(lambda: trainer.loss(batch, trainer.step))
    fb_ms, _ = timed(lambda: trainer.gradients(batch))
    grads = trainer.gradients(batch)[1]
    opt = AdamW([leaf.detach().clone() for leaf in trainer.trainable_leaves],
                lambda s: TRAIN_LR)

    def opt_step():
        clip_by_global_norm(grads, 1.0)
        opt.update(grads)
    opt_ms, _ = timed(opt_step)
    del opt, grads
    print(f"[phase 4] {card}: training {label} split (median of 5 calls each): encode + "
          f"resample {vis_ms} ms, forward with loss {fwd_ms} ms, forward + backward "
          f"{fb_ms} ms (backward {fb_ms - fwd_ms} ms), clip + AdamW {opt_ms} ms, the "
          f"step's rest {step_ms - fb_ms - opt_ms} ms")

    if "dropout" in checks:
        args.enable_dropout = True
        zero_counts()
        loss_d, _ = trainer.gradients(batch)
        expect(f"training {label} with dropout", read_counts(),
               fused_attention=n_fa - F.n_lm_layers(config), fused_media_xattn=n_mx)
        again, _ = trainer.gradients(batch)
        args.enable_dropout = False
        loss_n, _ = trainer.gradients(batch)
        assert torch.equal(loss_d, again) and not torch.equal(loss_d, loss_n)
        print(f"[phase 3] training {label} with dropout: loss {float(loss_d)} twice "
              f"bit-equal at one seed; without dropout {float(loss_n)}")
    if "remat" in checks:
        runs = {}
        for name, remat in (("plain", False), ("again", False), ("remat", True)):
            args.remat = remat
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            runs[name] = trainer.gradients(batch)
            runs[name] += (read_counts(), torch.cuda.max_memory_allocated() / 2**30)
        args.remat = False
        expect(f"training {label} with remat (forward and its recompute)", runs["remat"][2],
               fused_attention=2 * n_fa, fused_media_xattn=2 * n_mx)
        spread = grads_rel_err(runs["again"][1], runs["plain"][1])
        err = grads_rel_err(runs["remat"][1], runs["plain"][1])
        print(f"[phase 3] training {label} with remat: loss {float(runs['remat'][0])} vs "
              f"{float(runs['plain'][0])}; gradients normwise relative error {err} "
              f"(the same step twice without remat: {spread}); peak memory of one "
              f"forward + backward {runs['remat'][3]:.2f} GiB with remat, "
              f"{runs['plain'][3]:.2f} GiB without ({card})")
        assert torch.equal(runs["remat"][0], runs["plain"][0])
        assert err <= max(1e-6, 1.25 * spread), (err, spread)
        del runs
    if "eval" in checks:
        trainer.eval_dataset = SyntheticEvalDataset(
            SyntheticCaptionDataset(size=TRAIN_EVAL_IMAGES, seed=10_000))
        trainer.processor = proc
        t0 = time.perf_counter()
        metrics = trainer.evaluate()
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        print(f"[phase 3] training {label} evaluate() over {TRAIN_EVAL_IMAGES} synthetic "
              f"images: {sorted(metrics)}: {metrics} ({time.perf_counter() - t0:.1f} s)")
    if "checkpoint" in checks:
        path = trainer.save_checkpoint()
        want_loss = trainer.train_step_on(batch)
        fresh = FlamingoTrainer(open_gates(FlamingoModel(config, device=dev, seed=0)), args)
        fresh.load_checkpoint(path)
        assert fresh.step == trainer.step - 1
        got_loss = fresh.train_step_on(batch)
        once = [leaf.detach().clone() for leaf in fresh.trainable_leaves]
        fresh.load_checkpoint(path)
        fresh.train_step_on(batch)
        spread = grads_rel_err(fresh.trainable_leaves, once)
        err = grads_rel_err(fresh.trainable_leaves, trainer.trainable_leaves)
        print(f"[phase 3] training {label} checkpoint at step {fresh.step - 1}: the "
              f"next step's loss {got_loss} resumed, {want_loss} uninterrupted; "
              f"parameters after it normwise {err} apart (the resumed step twice: "
              f"{spread})")
        assert got_loss == want_loss and err <= max(1e-7, 1.25 * spread), (err, spread)
        del fresh, once
    shutil.rmtree(out_dir, ignore_errors=True)
    stamp(f"training {label} done")
    return step_counts


def training_cells(dev, card, vocab_dir):
    """Phase 3 and 4 of training (``flamingo_mini_tpu_torch.train``): the
    recompute backward per op, then flamingo-mini and the OPT-125m recipe
    (``training_cell``). -> {configuration: the step's launch counts}."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    training_ops(dev, flush, card)
    del flush
    counts = {}
    for label, (cfg, n_timed, checks) in TRAIN_CELLS.items():
        counts[label] = training_cell(dev, card, label, cfg, n_timed, vocab_dir, checks)
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the parallel tier: two ranks on the one card
# ---------------------------------------------------------------------------


GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "send/recv")


def start_ranks(target, *args):
    """PAR_RANKS processes of ``target(rank, port, *args)``, started by
    ``spawn`` (CUDA does not survive ``fork``) on a free local port."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, port, *args)) for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, deadline: float):
    """Wait for the processes until ``deadline`` (``time.monotonic()``),
    killing any still running then -> (exit codes, whether one was late)."""
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    return [p.exitcode for p in procs], bool(late)


@contextlib.contextmanager
def captured(store, key, module, name):
    """``module.name`` (a kernel's wrapper, as the model code looks it up)
    records the inputs of its first call in the block under ``key`` in
    ``store`` (detached copies on the host), and runs as it does."""
    fn = getattr(module, name)

    def run(*args, **kw):
        if key not in store:
            host = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t
            store[key] = (name, [host(a) for a in args],
                          {k: host(v) for k, v in kw.items()})
        return fn(*args, **kw)
    with patched(module, name, run):
        yield


def gloo_probe_rank(rank, port, op, path):
    """One rank of the probe of ``op`` on CUDA tensors over gloo (a pair of
    processes of its own: an op gloo does not take on CUDA tensors may abort
    the process, as a device pointer handed to the socket does) -> writes
    "native" or "wrong result" to ``path`` and the rank."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from flamingo_mini_tpu_torch.parallel import distributed_init
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    distributed_init(f"127.0.0.1:{port}", PAR_RANKS, rank, backend="gloo", timeout=60)
    world = PAR_RANKS
    x = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok = bool((y == world * (world + 1) / 2).all())
    elif op == "broadcast":
        y = x.clone()
        dist.broadcast(y, src=0)
        ok = bool((y == 1).all())
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
    else:
        y = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                       dist.P2POp(dist.irecv, y, (rank - 1) % world)])
        for req in reqs:
            req.wait()
        ok = bool((y == (rank - 1) % world + 1).all())
    torch.cuda.synchronize()
    with open(f"{path} {rank}", "w") as f:
        f.write("native" if ok else "wrong result")
    dist.destroy_process_group()


def gloo_probe(work):
    """Start the probe of which collectives gloo takes on CUDA tensors
    between two processes on the card, each op in a pair of processes of
    its own, all pairs at once (``parallel/comm.py`` stages the ones outside
    its documented ``GLOO_CUDA_OPS`` through pinned host memory by rule,
    whatever this finds) -> a function that waits for them -> {op:
    "native", "wrong result", or how the processes ended}."""
    paths = {op: os.path.join(work, "probe " + op.replace("/", " ")) for op in GLOO_PROBE_OPS}
    pairs = {op: start_ranks(gloo_probe_rank, op, paths[op]) for op in GLOO_PROBE_OPS}

    def results():
        deadline = time.monotonic() + 120
        found = {}
        for op, pair in pairs.items():
            codes, _ = join_ranks(pair, deadline)
            got = []
            for r, code in enumerate(codes):
                if code == 0 and os.path.exists(f"{paths[op]} {r}"):
                    with open(f"{paths[op]} {r}") as f:
                        got.append(f.read())
                else:
                    got.append(f"the process ended with code {code}")
            found[op] = got[0] if len(set(got)) == 1 else " / ".join(got)
        return found
    return results


def weight_bytes(params) -> int:
    from flamingo_mini_tpu_torch.utils.params import leaves_with_path
    return sum(x.numel() * x.element_size() for _, x in leaves_with_path(params))


def par_gen(model, inputs, new_tokens, rows=None, **kw):
    ids, media, mask, pixels = (x[:rows] for x in inputs)
    vocab = model.config.lm_arch.vocab_size + 1
    return model.generate(ids, media_locations=media, attention_mask=mask,
                          pixel_values=pixels, max_length=ids.shape[1] + new_tokens,
                          prefix_block=PREFIX_BLOCK, eos_token_id=vocab,
                          pad_token_id=0, **kw)


def parallel_serving(dev, rank, say):
    """On each of the two ranks: DP greedy over a (2, 1) mesh (b=32, 16 rows
    a rank, 32 new tokens) on the megakernel and per layer with the fused
    head, DP top-k 50 sampling on the megakernel from a seeded CUDA
    generator; TP=2 greedy and 3 beams over a (1, 2) mesh per layer over
    the head-major cache, use_pallas on (the ViT, resampler and media
    kernels on the rank's heads). Each against the rank's own one-rank run
    on the card: greedy tokens up to the reference's near-ties (8 bf16
    ulps), samples by ``compare_top_k_samples``, beams by ``compare_beams``.
    The megakernel's step alone and with the other rank's beside it. The
    weights and peak memory of one rank's TP path against the one-rank
    path's. The inputs of TP greedy's first ViT, resampler and media-xattn
    kernel calls (``captured``, for ``par_kernel_rows``). -> outputs and
    counts."""
    import torch.distributed as dist
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    from flamingo_mini_tpu_torch.models import clip_vit, resampler, xattn
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax
    from flamingo_mini_tpu_torch.parallel import create_mesh
    dp, tp = create_mesh((PAR_RANKS, 1)), create_mesh((1, PAR_RANKS))
    cfg = dict(MINI, lm_arch_overrides=dict(n_layer=MINI_LAYERS))
    model = open_gates(FlamingoModel(FlamingoConfig(**cfg), device=dev, seed=0))
    model.quantize_int8().to_bf16()
    config = model.config
    vocab, n_layer, steps = config.lm_arch.vocab_size + 1, MINI_LAYERS, PAR_NEW - 1
    rs = np.random.RandomState(0)
    arch = config.vision_arch
    ids = torch.tensor(rs.randint(0, 1000, (PAR_B, PROMPT_LEN)), device=dev)
    media = torch.zeros((PAR_B, PROMPT_LEN), dtype=torch.int32, device=dev)
    media[:, 0] = 1
    mask = torch.ones((PAR_B, PROMPT_LEN), dtype=torch.int32, device=dev)
    pixels = torch.tensor(rs.randn(PAR_B, 1, 3, arch.image_size, arch.image_size),
                          dtype=torch.float32, device=dev).to(torch.bfloat16)
    inputs = (ids, media, mask, pixels)
    own = slice(rank * PAR_B // PAR_RANKS, (rank + 1) * PAR_B // PAR_RANKS)
    out, counts = {}, {}

    def dp_run(**kw):
        zero_counts()
        tokens = par_gen(model, inputs, PAR_NEW, mesh=dp, **kw)
        return tokens[:, PROMPT_LEN:].cpu(), read_counts()

    for path, kw, want in (
            ("DP megakernel", dict(megakernel=True),
             dict(decode_step_megakernel=steps, lm_head_argmax=steps)),
            ("DP per layer", {}, dict(decode_attention=n_layer * steps,
                                      lm_head_argmax=steps))):
        tokens, counts[path] = dp_run(**kw)
        expect(f"parallel rank {rank} {path}", counts[path], **want)
        gaps = []
        with recorded(gaps, lm_head_argmax):
            ref = par_gen(model, inputs, PAR_NEW, **kw)[:, PROMPT_LEN:].cpu()
        compare_tokens(f"parallel rank {rank} {path} vs one rank", tokens, ref, gaps)
        out[path] = tokens
    # sampling: the same seed on both ranks and in the one-rank run
    steps_dp, steps_one = [], []
    with recorded_picks([], steps_dp):
        tokens, counts["DP sampling"] = dp_run(
            megakernel=True, do_sample=True, top_k=OPT_TOP_K,
            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))
    expect(f"parallel rank {rank} DP top-k sampling", counts["DP sampling"],
           decode_step_megakernel=steps)
    with recorded_picks([], steps_one):
        ref = par_gen(model, inputs, PAR_NEW, megakernel=True, do_sample=True,
                      top_k=OPT_TOP_K, generator=torch.Generator(device=dev).manual_seed(
                          SAMPLE_SEED))[:, PROMPT_LEN:].cpu()
    local = [(logits[own], noise[own]) for logits, noise in steps_one]
    compare_top_k_samples(f"parallel rank {rank} DP top-k {OPT_TOP_K} sampling vs one "
                          "rank (this rank's rows)", tokens[own], ref[own], steps_dp,
                          local, OPT_TOP_K)
    out["DP sampling"] = tokens

    # the megakernel's step alone on the card, then with the other rank's
    def mega_step_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        par_gen(model, inputs, PAR_NEW, rows=PAR_B // PAR_RANKS, megakernel=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    alone = None
    for turn in range(PAR_RANKS):
        dist.barrier()
        if turn == rank:
            mega_step_ms()
            alone = statistics.median(mega_step_ms() for _ in range(3))
    dist.barrier()
    mega_step_ms()
    together = statistics.median(mega_step_ms() for _ in range(3))
    out["mega generate ms"] = (alone, together)
    say(f"megakernel generate, {PAR_B // PAR_RANKS} rows, {PAR_NEW} new tokens: "
        f"{alone} ms alone on the card, {together} ms with the other rank's beside it "
        f"(host clock, median of 3; two processes time-slice the card)")

    # TP=2, use_pallas: the one-rank run first, then the rank's slice only
    model_p = FlamingoModel(FlamingoConfig(**cfg, use_pallas=True), params=model.params,
                            device=dev)
    del model
    tp_in = tuple(x[:PAR_TP_B] for x in inputs)
    full_bytes = weight_bytes(model_p.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gaps = []
    with recorded_picks(gaps):
        ref = par_gen(model_p, tp_in, PAR_TP_NEW, flat_kv_cache=False)[:, PROMPT_LEN:].cpu()
    one_peak = torch.cuda.max_memory_allocated()
    ref_b, _, ref_cands = recorded_beam(
        lambda: par_gen(model_p, tp_in, PAR_BEAM_NEW, num_beams=BEAMS,
                        flat_kv_cache=False), tp_in[0], (PAR_TP_B, PROMPT_LEN + PAR_BEAM_NEW),
        vocab, PAR_BEAM_NEW)
    one_alloc = torch.cuda.memory_allocated()
    model_p.shard_(tp)
    torch.cuda.empty_cache()
    tp_bytes = weight_bytes(model_p.params)
    tp_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cap = out["captured"] = {}
    zero_counts()
    with captured(cap, "TP ViT", clip_vit, "fused_attention"), \
            captured(cap, "TP resampler", resampler, "fused_attention"), \
            captured(cap, "TP media prefill", xattn, "fused_media_xattn"):
        tokens = par_gen(model_p, tp_in, PAR_TP_NEW, mesh=tp, tensor_parallel=True)
    counts["TP greedy"] = read_counts()
    tp_peak = torch.cuda.max_memory_allocated()
    n_fa = arch.num_hidden_layers + config.resampler_depth
    expect(f"parallel rank {rank} TP=2 greedy, use_pallas", counts["TP greedy"],
           fused_attention=n_fa, fused_media_xattn=n_layer)
    check_output(tokens, tp_in[0], (PAR_TP_B, PROMPT_LEN + PAR_TP_NEW), vocab)
    compare_tokens(f"parallel rank {rank} TP=2 greedy vs one rank", tokens[:, PROMPT_LEN:].cpu(),
                   ref, gaps)
    out["TP greedy"] = tokens[:, PROMPT_LEN:].cpu()
    beams, counts["TP beams"], cands = recorded_beam(
        lambda: par_gen(model_p, tp_in, PAR_BEAM_NEW, num_beams=BEAMS, mesh=tp,
                        tensor_parallel=True),
        tp_in[0], (PAR_TP_B, PROMPT_LEN + PAR_BEAM_NEW), vocab, PAR_BEAM_NEW)
    expect(f"parallel rank {rank} TP=2 beams, use_pallas", counts["TP beams"],
           fused_attention=n_fa, fused_media_xattn=n_layer)
    compare_beams(f"parallel rank {rank} TP=2 {BEAMS} beams vs one rank", beams, cands,
                  ref_b, ref_cands, BEAMS, vocab)
    out["TP beams"] = beams
    out["memory"] = dict(full_bytes=full_bytes, tp_bytes=tp_bytes, one_peak=one_peak,
                         tp_peak=tp_peak, one_alloc=one_alloc, tp_alloc=tp_alloc)
    say(f"TP=2 weights on this rank {tp_bytes} bytes against {full_bytes} on one rank "
        f"({tp_bytes / full_bytes:.4f}); allocated {tp_alloc} against {one_alloc}; peak "
        f"during TP greedy ({PAR_TP_B} rows, {PAR_TP_NEW} new tokens) {tp_peak} bytes "
        f"against the one-rank path's {one_peak} ({tp_peak / one_peak:.4f})")
    del model_p
    torch.cuda.empty_cache()
    return out, counts


def summed_loss_and_grads(params, config, policy, batch, mask):
    """``loss_and_grads`` of the summed token loss: (sum, token count,
    gradients of the sum)."""
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.utils.params import trainable_leaves
    leaves = [leaf for _, leaf in trainable_leaves(params, mask)]
    loss = F.forward(params, config, batch["input_ids"], policy=policy,
                     media_locations=batch["media_locations"],
                     attention_mask=batch["attention_mask"],
                     pixel_values=batch["pixel_values"], labels=batch["labels"],
                     loss_reduction="none").loss.sum()
    labels = batch["labels"]
    return loss.detach(), labels.shape[0] * (labels.shape[1] - 1), torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)


def par_train_model(dev, use_pallas=True, dtype="bfloat16"):
    """flamingo-mini at its first MINI_LAYERS layers for the parallel
    training and ring checks: ``dtype`` compute over float32 parameters,
    gates 0.5, the trainable leaves requiring grad -> (model, trainable
    mask)."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    from flamingo_mini_tpu_torch.utils.params import set_requires_grad
    model = open_gates(FlamingoModel(FlamingoConfig(**dict(
        MINI, lm_arch_overrides=dict(n_layer=MINI_LAYERS), use_pallas=use_pallas,
        compute_dtype=dtype)), device=dev, seed=1))
    mask = model.trainable_mask()
    set_requires_grad(model.params, mask)
    return model, mask


def par_batch(work, dev, policy):
    """The global training batch ``parallel_cells`` wrote, on ``dev``."""
    batch = {k: v.to(dev) for k, v in torch.load(os.path.join(work, "batch.pt")).items()}
    batch["pixel_values"] = policy.cast(batch["pixel_values"])
    return batch


def par_ring_inputs(dev, vision_arch):
    """PAR_RING_B x PAR_RING_N tokens, two images a row (the second at
    token 600), labels the tokens."""
    rs = np.random.RandomState(2)
    b, n = PAR_RING_B, PAR_RING_N
    ids = torch.tensor(rs.randint(0, 50000, (b, n)), device=dev)
    media = torch.zeros((b, n), dtype=torch.int32, device=dev)
    media[:, 0] = 1
    media[:, 600] = 1
    pixels = torch.tensor(rs.randn(b, 2, 3, vision_arch.image_size, vision_arch.image_size),
                          dtype=torch.float32, device=dev).to(torch.bfloat16)
    return ids, dict(media_locations=media, pixel_values=pixels, labels=ids)


def parallel_training(dev, rank, say, work):
    """On each rank: two DP steps over a (2, 1) mesh and one TP step over
    (1, 2), flamingo-mini at its first MINI_LAYERS layers (``par_train_model``),
    use_pallas, lr 1e-3 after a 1-step warm-up (step 0 at lr 0, so both DP
    steps see the initial parameters), the global batch of TRAIN_B x TRAIN_N
    (4 rows a rank under DP). The rank's one-rank run on the card: the loss
    and gradients on the global batch, and on its two halves summed in
    float32 (what DP computes: held to 1e-6). Each step's loss and
    gradients (TP's slices gathered) against the global one-rank run; then
    TP's loss and gradients in float32 compute against the one-rank run in
    float32, where no bf16 rounding lies between them. The errors are
    returned for ``parallel_cells`` to hold; the inputs of the first DP
    step's first trunk attention kernel call (``captured``). -> (errors,
    counts, captured)."""
    from flamingo_mini_tpu_torch.models import gpt2
    from flamingo_mini_tpu_torch.train import FlamingoTrainer, TrainingArguments
    counts, errors, cap = {}, {}, {}
    # (label, mesh shape, TP, compute dtype, training steps)
    runs = (("DP", (PAR_RANKS, 1), False, "bfloat16", 2),
            ("TP", (1, PAR_RANKS), True, "bfloat16", 1),
            ("TP float32", (1, PAR_RANKS), True, "float32", 0))
    for label, shape, tp, dtype, steps in runs:
        model, mask = par_train_model(dev, dtype=dtype)
        batch = par_batch(work, dev, model.policy)
        ref = loss_and_grads(model.params, model.config, model.policy, batch, mask)
        if label == "DP":
            half = TRAIN_B // PAR_RANKS
            parts = [summed_loss_and_grads(model.params, model.config, model.policy,
                                           {k: v[h * half:(h + 1) * half]
                                            for k, v in batch.items()}, mask)
                     for h in range(PAR_RANKS)]
            count = sum(p[1] for p in parts)
            split = (sum(p[0] for p in parts) / count,
                     [sum(gs) / count for gs in zip(*(p[2] for p in parts))])
        args = TrainingArguments(output_dir=os.path.join(work, f"train{rank}"),
                                 learning_rate=TRAIN_LR, warmup_steps=1,
                                 eval_every_steps=None, report_to="none",
                                 mesh_shape=shape, tensor_parallel=tp)
        trainer = FlamingoTrainer(model, args)
        n_fa = model.config.vision_arch.num_hidden_layers + model.config.resampler_depth
        for step in range(steps):
            loss, grads = trainer.gradients(batch)
            whole = [trainer.whole_leaf(n, g) for n, g in zip(trainer.trainable_names, grads)]
            errors[f"{label} step {step} loss"] = rel_err(loss, ref[0])
            errors[f"{label} step {step} gradients"] = grads_rel_err(whole, ref[1])
            if label == "DP":
                exact = (rel_err(loss, split[0]), grads_rel_err(whole, split[1]))
                say(f"DP step {step}: loss and gradients against the one-rank run's "
                    f"halves summed (what DP computes) {exact} (limit 1e-6)")
                assert max(exact) <= 1e-6, exact
            zero_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with contextlib.ExitStack() as stack:
                if label == "DP" and step == 0:
                    stack.enter_context(captured(cap, "DP trunk", gpt2, "fused_attention"))
                e0.record()
                step_loss = trainer.train_step_on(batch)
                e1.record()
                e1.synchronize()
            counts[f"{label} training step"] = read_counts()
            expect(f"parallel rank {rank} {label} training step {step}",
                   counts[f"{label} training step"],
                   fused_attention=n_fa + MINI_LAYERS, fused_media_xattn=MINI_LAYERS)
            say(f"{label} training step {step} (mesh {shape}): loss {step_loss}, one rank "
                f"{float(ref[0])}; relative error of the loss "
                f"{errors[f'{label} step {step} loss']}, of the gradients (normwise, "
                f"{len(whole)} trainable leaves) {errors[f'{label} step {step} gradients']}; "
                f"step {e0.elapsed_time(e1)} ms (gloo on one card: no measure of NCCL "
                "or NVLink)")
            assert step_loss == float(loss), (step_loss, float(loss))
        if label == "TP float32":
            loss, grads = trainer.gradients(batch)
            whole = [trainer.whole_leaf(n, g) for n, g in zip(trainer.trainable_names, grads)]
            errors["TP float32 loss"] = rel_err(loss, ref[0])
            errors["TP float32 gradients"] = grads_rel_err(whole, ref[1])
            say(f"TP (mesh {shape}) in float32 compute against one rank in float32: "
                f"relative error of the loss {errors['TP float32 loss']} (loss "
                f"{float(loss)}, one rank {float(ref[0])}), of the gradients "
                f"{errors['TP float32 gradients']}")
        del trainer, model, ref, grads, whole
        torch.cuda.empty_cache()
    return errors, counts, cap


def parallel_ring(dev, rank, say):
    """On each rank: flamingo-mini at its first MINI_LAYERS layers
    (``par_train_model``) forward with its loss over ``par_ring_inputs``,
    ``context_mesh`` over the two ranks (512 tokens a rank through ring
    attention), the trainable gradients summed over the ranks, against the
    rank's one-rank forward on the card; in bf16 (the launches counted, the
    inputs of the first media-xattn kernel call ``captured``), then in
    float32 compute. The errors of the logits, the loss and the gradients
    are returned for ``parallel_cells`` to hold. -> (errors, counts,
    captured)."""
    from flamingo_mini_tpu_torch.models import xattn
    from flamingo_mini_tpu_torch.parallel import comm, create_mesh
    from flamingo_mini_tpu_torch.utils.params import trainable_leaves
    mesh = create_mesh((PAR_RANKS, 1))
    errors, counts, cap = {}, {}, {}
    for dtype, label in (("bfloat16", "ring"), ("float32", "ring float32")):
        model, mask = par_train_model(dev, dtype=dtype)
        leaves = [leaf for _, leaf in trainable_leaves(model.params, mask)]
        ids, kw = par_ring_inputs(dev, model.config.vision_arch)
        ref = model(ids, **kw)
        ref_grads = torch.autograd.grad(ref.loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        zero_counts()
        with contextlib.ExitStack() as stack:
            if dtype == "bfloat16":
                stack.enter_context(captured(cap, "ring media", xattn, "fused_media_xattn"))
            got = model(ids, **kw, context_mesh=mesh)
            grads = torch.autograd.grad(got.loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if dtype == "bfloat16":
            counts["ring forward"] = read_counts()
            expect(f"parallel rank {rank} ring forward with its loss and gradients",
                   counts["ring forward"],
                   fused_attention=model.config.vision_arch.num_hidden_layers
                   + model.config.resampler_depth, fused_media_xattn=MINI_LAYERS)
        grads = [comm.all_reduce(g, mesh.get_group("data")) for g in grads]
        assert got.logits.shape == ref.logits.shape and bool(torch.isfinite(got.logits).all())
        found = {f"{label} logits": rel_err(got.logits.detach(), ref.logits.detach()),
                 f"{label} loss": rel_err(got.loss.detach(), ref.loss.detach()),
                 f"{label} gradients": grads_rel_err(grads, ref_grads)}
        say(f"ring forward ({dtype} compute) over {PAR_RING_B} x {PAR_RING_N} tokens, "
            f"{PAR_RING_N // PAR_RANKS} a rank: relative errors against one rank {found} "
            f"(loss {float(got.loss)} vs {float(ref.loss)})")
        errors.update(found)
        del model, ref, got, grads, ref_grads, leaves
        torch.cuda.empty_cache()
    return errors, counts, cap


def ring_spreads(dev):
    """The ring check's plain program's CPU-vs-card spreads (use_pallas off,
    the one-rank forward over ``par_ring_inputs``: logits, loss, trainable
    gradients): the card's run first (before the ranks start), then
    ``cpu()`` runs the CPU's (while they run) -> {kind: spread}. (The bf16
    training checks are held to 1e-2 alone, at least as tight as the rule;
    the float32 checks are the tight ones, ``PAR_F32_LIMITS``.)"""
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.ops.layers import FAST
    from flamingo_mini_tpu_torch.utils.params import trainable_leaves, tree_map
    model, mask = par_train_model(dev, use_pallas=False)
    config = model.config
    ids, kw = par_ring_inputs(dev, config.vision_arch)

    def run(params, ids, kw):
        leaves = [leaf for _, leaf in trainable_leaves(params, mask)]
        out = F.forward(params, config, ids, policy=FAST, **kw)
        grads = torch.autograd.grad(out.loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return out.logits.detach().cpu(), out.loss.detach().cpu(), [g.cpu() for g in grads]
    card = run(model.params, ids, kw)
    cpu_params = tree_map(lambda t: t.detach().cpu().requires_grad_(t.requires_grad),
                          model.params)
    cpu_in = (ids.cpu(), {k: v.cpu() for k, v in kw.items()})
    del model
    torch.cuda.empty_cache()

    def cpu():
        t0 = time.perf_counter()
        got = run(cpu_params, *cpu_in)
        spreads = {"ring logits": rel_err(got[0], card[0]),
                   "ring loss": rel_err(got[1], card[1]),
                   "ring gradients": grads_rel_err(got[2], card[2])}
        print(f"[phase 3] parallel: the ring program's CPU-vs-card spreads {spreads} "
              f"({time.perf_counter() - t0:.1f} s on the CPU)")
        return spreads
    return cpu


def par_kernel_rows(dev, flush, cases):
    """The attention kernels at the inputs the ranks gave them (``captured``
    on rank 0: its local heads under TP, its rows under DP, its 512 tokens
    in the ring): each held to its plain version on the card by the phase-2
    rule (2 bf16 ulps of the output's scale, ``held_to_plain``), then timed
    beside it, the library call (SDPA; under the media mask for
    ``fused_media_xattn``) and its bound (the keys each query needs) ->
    {case: kernel row}."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    from flamingo_mini_tpu_torch.ops.media_xattn import (
        fused_media_xattn, fused_media_xattn_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    out = {}
    for key, (name, args, kw) in cases.items():
        args, kw = [on(a) for a in args], {k: on(v) for k, v in kw.items()}
        q, k, v = args[:3]
        b, h, n_q, dh = q.shape
        n_kv = k.shape[2]
        assert dh == HEAD_DIM, (key, q.shape)
        if name == "fused_attention":
            kernel, plain = fused_attention, fused_attention_plain
            lib_kw, extra, pairs = dict(scale=kw["scale"]), 0, None
            if kw.get("causal"):
                rb = kw.get("row_bias")
                causal = torch.ones(n_q, n_kv, dtype=torch.bool, device=dev).tril()
                if rb is None:
                    lib_kw["attn_mask"] = causal
                else:
                    lib_kw["attn_mask"] = torch.where(
                        causal, rb[:, None, None, :].float(), float("-inf")).to(q.dtype)
                    extra = rb.numel() * rb.element_size()
                pairs = b * h * n_q * (n_q + 1) // 2
        else:
            kernel, plain = fused_media_xattn, fused_media_xattn_plain
            tt = args[3]
            media_time = torch.arange(n_kv, device=dev) // kw["n_visual"] + 1
            lib_kw = dict(scale=kw["scale"], attn_mask=(tt[:, :, None] == media_time)[:, None])
            # each query with an image reads that image's latents
            extra, pairs = 4 * tt.numel(), h * kw["n_visual"] * int((tt > 0).sum())
        err = held_to_plain(f"{name} at {key} {tuple(q.shape)}, {n_kv} keys",
                            kernel(*args, **kw), plain(*args, **kw), q.dtype)
        ms = time_ms(lambda: kernel(*args, **kw), 50, flush)
        plain_ms = time_ms(lambda: plain(*args, **kw), 20, flush)
        library_ms = time_ms(lambda: sdpa(q, k, v, **lib_kw), 50, flush)
        bound_ms, bound_by = attention_bound(b, h, n_q, n_kv, q.element_size(), extra, pairs)
        out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, max_abs_err=err)
        print(f"[phase 2] {name} at {key} (rank 0's inputs: {tuple(q.shape)} q, {n_kv} "
              f"keys, {q.dtype}): max abs err against plain {err} (2 bf16 ulps of the "
              f"output's scale); {ms} ms, plain {plain_ms} ms, scaled_dot_product_attention "
              f"{library_ms} ms, bound {bound_ms:.5f} ms ({bound_by}) (median per call, "
              "L2 flushed)")
    return out


def par_decode_rows(dev, flush):
    """The DP ranks' decode kernels at a rank's rows (PAR_B / PAR_RANKS):
    ``decode_attention`` and ``lm_head_argmax`` by their phase-2 checks and
    timing at that batch, the megakernel by ``mega_timed`` (its plain
    version, about 0.25 s a call, timed over 5) -> {kernel: kernel row}."""
    b = PAR_B // PAR_RANKS
    return {"decode_attention": phase2_decode_attention(dev, flush, b=b),
            "lm_head_argmax": phase2_lm_head(dev, flush, B=b),
            "decode_step_megakernel": mega_timed(dev, flush, b, plain_iters=5)}


def parallel_rank(rank, port, work):
    """One of the two ranks of ``parallel_cells`` (a process of its own):
    gloo on the one card, then serving, training and ring attention; its
    outputs to ``work/rank<r>.pt``. Any failure raises: a nonzero exit."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import torch.distributed as dist
    from flamingo_mini_tpu_torch.parallel import distributed_init
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # NCCL refuses two ranks on one card: gloo, staged through host memory
    distributed_init(f"127.0.0.1:{port}", PAR_RANKS, rank, backend="gloo",
                     timeout=PAR_TIMEOUT)

    t0 = time.perf_counter()

    def say(msg):
        print(f"[parallel rank {rank}, {time.perf_counter() - t0:.1f} s] {msg}", flush=True)
    out = {}
    served, counts = parallel_serving(dev, rank, say)
    out.update(served)
    say("serving done")
    errors, trained, cap_train = parallel_training(dev, rank, say, work)
    say("training done")
    ring_errors, ring, cap_ring = parallel_ring(dev, rank, say)
    say("ring done")
    # the ring memory tool's measurement, one more job on the same ranks
    from flamingo_mini_tpu_torch.tools import ring_crossover
    t1 = time.perf_counter()
    out["ring tool"] = ring_crossover.measure_rank((RING_TOOL_SEQ,), dev)
    out["ring tool s"] = time.perf_counter() - t1
    say(f"ring tool done in {out['ring tool s']:.2f} s")
    out["errors"] = {**errors, **ring_errors}
    out["counts"] = {**counts, **trained, **ring}
    out["captured"].update({**cap_train, **cap_ring})
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def parallel_limit(name: str, spreads) -> tuple:
    """The limit of a parallel check's relative error against one rank ->
    (limit, how it was set): a float32 check's ``PAR_F32_LIMITS``; a bf16
    one's the larger of 1e-2 and 1.25 x the plain program's CPU-vs-card
    spread, where one was taken."""
    if "float32" in name:
        return PAR_F32_LIMITS[name.split()[-1]], "float32 compute"
    spread = spreads.get(name)
    how = (f"the larger of 1e-2 and 1.25 x the plain program's CPU-vs-card spread, "
           f"{'not taken' if spread is None else spread}")
    return max(1e-2, 1.25 * (spread or 0.0)), how


def parallel_cells(dev, card, vocab_dir):
    """Phase 3 and 4 of the parallel tier on the one card: the kernels are
    built (phase 1), so the ranks load the library from ``build/`` and
    never build; the global training batch (DataCollator over the synthetic
    vocabulary) is written for them; gloo's probe, whose every op that does
    not run natively on CUDA tensors must be one ``comm.py`` stages; two
    ranks start by ``spawn`` (CUDA does not survive ``fork``) and run
    ``parallel_rank``; a rank that fails or outlasts PAR_TIMEOUT fails the
    run. Every rank's tokens must be the same, and every error against one
    rank within ``parallel_limit``. Then the kernels at the ranks' shapes
    (``par_kernel_rows``, ``par_decode_rows``). -> (rank 0's launch counts
    per path, the kernel rows at the ranks' shapes)."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoProcessor
    from flamingo_mini_tpu_torch.parallel.comm import GLOO_CUDA_OPS
    from flamingo_mini_tpu_torch.tokenizer import BPETokenizer
    from flamingo_mini_tpu_torch.train import DataCollator, SyntheticCaptionDataset
    stamp("parallel cells start")
    work = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    config = FlamingoConfig(**MINI)
    proc = FlamingoProcessor(config, tokenizer=BPETokenizer.gpt2(vocab_dir), device="cpu")
    ds = SyntheticCaptionDataset(size=TRAIN_B)
    host = DataCollator(proc, length=TRAIN_N)([ds[i] for i in range(TRAIN_B)])
    torch.save({k: torch.as_tensor(v) for k, v in host.items()},
               os.path.join(work, "batch.pt"))
    probe = gloo_probe(work)
    cpu_spreads = ring_spreads(dev)
    torch.cuda.empty_cache()
    procs = start_ranks(parallel_rank, work)
    deadline = time.monotonic() + PAR_TIMEOUT
    stamp("parallel ranks started")
    spreads = cpu_spreads()                 # on the host while the ranks run
    stamp("parallel CPU spreads done")
    found = probe()
    unstaged = [op for op, got in found.items() if got != "native"
                and set(GLOO_PROBE_COMM[op]) & GLOO_CUDA_OPS]
    print(f"[phase 3] parallel: gloo on CUDA tensors between two processes on the card: "
          f"{found}; comm.py stages every op outside {sorted(GLOO_CUDA_OPS)} through "
          f"pinned host memory, so every op that is not native here is staged: "
          f"{not unstaged}", flush=True)
    codes, late = join_ranks(procs, deadline)
    assert not unstaged, f"gloo does not take {unstaged} on CUDA tensors, and comm.py " \
        "does not stage them"
    assert not late and codes == [0] * PAR_RANKS, \
        f"parallel ranks: exit codes {codes}{' (past the time limit)' if late else ''}"
    outs = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(PAR_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    for key in ("DP megakernel", "DP per layer", "DP sampling", "TP greedy", "TP beams"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    for r, out in enumerate(outs):
        for name, err in out["errors"].items():
            limit, how = parallel_limit(name, spreads)
            print(f"[phase 3] parallel rank {r} {name}: relative error against one rank "
                  f"{err} (limit {limit}: {how})")
            assert err <= limit, (r, name, err, limit)
    print("[phase 3] parallel: every rank returned the same tokens on every path")
    for r, out in enumerate(outs):
        for path, c in out["counts"].items():
            print(f"[phase 3] parallel rank {r} {path} launches: "
                  f"{ {k: v for k, v in c.items() if v} }")
        m = out["memory"]
        print(f"[phase 4] {card}: parallel rank {r} TP=2 weights {m['tp_bytes']} bytes vs "
              f"{m['full_bytes']} one rank ({m['tp_bytes'] / m['full_bytes']:.4f}); peak "
              f"memory during TP greedy {m['tp_peak'] / 2**30:.3f} GiB vs "
              f"{m['one_peak'] / 2**30:.3f} GiB one rank "
              f"({m['tp_peak'] / m['one_peak']:.4f}); megakernel generate "
              f"{PAR_B // PAR_RANKS} rows alone {out['mega generate ms'][0]} ms, beside "
              f"the other rank {out['mega generate ms'][1]} ms")
    for row in outs[0]["ring tool"]:
        print(f"[phase 4] {card}: ring tool (tools/ring_crossover.py) over the "
              f"{PAR_RANKS} ranks on the card: {json.dumps(row)}")
    print(f"[phase 3] ring tool job inside the parallel ranks: "
          f"{[round(out['ring tool s'], 2) for out in outs]} s a rank")
    stamp("parallel cells checked")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {**par_kernel_rows(dev, flush, outs[0]["captured"]), **par_decode_rows(dev, flush)}
    del flush
    torch.cuda.empty_cache()
    stamp("parallel cells done")
    return outs[0]["counts"], rows


# ---------------------------------------------------------------------------
# OPT-2.7B and OPT-6.7B: head widths 80 and 128
# ---------------------------------------------------------------------------


def wide_decode_beam(dev, flush, D, H, hd):
    """decode_attention_beam at a wide trunk's 3 beams (8 families, 24
    rows, a 128-slot cache): its edges, then timed at the beam loop's last
    step (cur 38, kv_limit 40) -> kernel row."""
    b, kb = OPT_B, BEAMS
    B = b * kb
    edges = attention_edges(dev, B, kb, D, OPT_T, seed=B + hd, head_dim=hd)
    print_edges(f"decode_attention_beam edges at {B} rows in families of {kb}, D={D}, "
                f"{H} heads of {hd}, T={OPT_T}", edges)
    rs = np.random.RandomState(hd)
    q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32, device=dev)
               .to(torch.bfloat16) for s in ((B, D), (OPT_T, B, D), (OPT_T, B, D)))
    npad = torch.tensor(np.repeat([OPT_PAD] * 2 + [0] * (b - 2), kb), dtype=torch.int32,
                        device=dev)
    anc = random_ancestry(dev, b, kb, seed=hd, anc_len=OPT_PROMPT + OPT_BEAM_NEW)
    t_lim = OPT_PROMPT + OPT_BEAM_NEW
    return dict(max_abs_err=max(err for err, _tol, _where in edges.values()),
                **time_beam_attention(dev, flush, q, k, v, anc, npad, t_lim - 2, t_lim, H,
                                      kb, hd ** -0.5))


def wide_fused_attention(dev, flush, H, hd):
    """fused_attention and flash_attention at heads ``hd`` wide against
    their plain versions: the trunk's prefill (8, H, 8, 8) and forward
    (8, H, 64, 64), causal with rows 0 and 1 left-padded, bf16 (the Hopper
    tile) and float32 (the mma.sync tile); the Hopper tile at its edges
    (WIDE_N_KV by WIDE_N_Q, b=2, 3 heads: strided, contiguous, causal and
    left-padded, with a bias); streaming at WIDE_FLASH keys in both dtypes,
    causal and not. The forward shape and the streaming one timed ->
    (forward row, streaming row)."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain, fused_attention, fused_attention_plain)
    scale, worst, n = hd ** -0.5, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, n_q, pad in (("prefill", OPT_PROMPT, OPT_PAD), ("forward", WIDE_FWD[2],
                                                                   GPT2_PAD)):
            b = WIDE_FWD[0]
            q, k, v = attention_inputs(dev, dtype, b, H, n_q, n_q, seed=n_q + hd,
                                       head_dim=hd)
            kw = dict(scale=scale, causal=True, row_bias=left_pad_bias(
                dev, dtype, b, n_q, [pad, pad] + [0] * (b - 2)))
            worst = max(worst, held_to_plain(f"fused_attention {name} heads of {hd} {dtype}",
                                             fused_attention(q, k, v, **kw),
                                             fused_attention_plain(q, k, v, **kw), dtype))
            n += 1
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(hd)
    for n_kv in WIDE_N_KV:
        for n_q in WIDE_N_Q:
            q, k, v = attention_inputs(dev, bf, 2, 3, n_q, n_kv, seed=n_q * 1000 + n_kv,
                                       head_dim=hd)
            pads = [min(5, n_kv - 1), 0]
            cases = {
                "strided": (q, k, v, dict(scale=scale)),
                "contiguous": (q.contiguous(), k.contiguous(), v.contiguous(),
                               dict(scale=scale)),
                "causal, left-padded": (q, k, v, dict(
                    scale=scale, causal=True, row_bias=left_pad_bias(dev, bf, 2, n_kv, pads))),
                "bias": (q, k, v, dict(scale=scale, bias=torch.randn(
                    (2, 1, n_q, n_kv), generator=gen, device=dev))),
            }
            for label, (qq, kk, vv, kw) in cases.items():
                worst = max(worst, held_to_plain(
                    f"fused_attention bf16 heads of {hd} {label} (2, 3, {n_q}, {n_kv})",
                    fused_attention(qq, kk, vv, streaming=False, **kw),
                    fused_attention_plain(qq, kk, vv, **kw), bf))
                n += 1
    fb, fh, fn = WIDE_FLASH
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(dev, dtype, fb, fh, fn, fn, seed=hd + 1, head_dim=hd)
        for causal in (False, True):
            kw = dict(scale=scale, causal=causal,
                      row_bias=left_pad_bias(dev, dtype, fb, fn, [GPT2_PAD]))
            worst = max(worst, held_to_plain(
                f"flash_attention heads of {hd} causal={causal} {dtype}",
                flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw), dtype))
            n += 1
    print(f"[phase 2] fused_attention and flash_attention at heads of {hd}: the trunk's "
          f"prefill (8, {H}, {OPT_PROMPT}) and forward {WIDE_FWD[:1] + (H,) + WIDE_FWD[2:]} "
          f"causal, two rows left-padded, bf16 and float32; the Hopper tile at n_kv "
          f"{WIDE_N_KV} by n_q {WIDE_N_Q} (strided, contiguous, causal left-padded, bias); "
          f"streaming at {WIDE_FLASH} causal and not, both dtypes ({n} calls): max abs "
          f"err {worst} (f32 1e-5, bf16 2 ulp of each output's scale)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, _h, n_q = WIDE_FWD
    q, k, v = attention_inputs(dev, bf, b, H, n_q, n_q, seed=1, head_dim=hd)
    rb = left_pad_bias(dev, bf, b, n_q, [GPT2_PAD, GPT2_PAD] + [0] * (b - 2)).float()
    kw = dict(scale=scale, causal=True, row_bias=rb)
    keep = torch.ones(n_q, n_q, dtype=torch.bool, device=dev).tril()
    lib_kw = dict(scale=scale, attn_mask=torch.where(keep, rb[:, None, None, :],
                                                     float("-inf")).to(bf))
    rows = {}
    fwd_ms = time_ms(lambda: fused_attention(q, k, v, **kw), 50, flush)
    rows["forward"] = dict(
        ms=fwd_ms, plain_ms=time_ms(lambda: fused_attention_plain(q, k, v, **kw), 20, flush),
        library_ms=time_ms(lambda: sdpa(q, k, v, **lib_kw), 50, flush), max_abs_err=worst,
        **dict(zip(("bound_ms", "bound_by"), attention_bound(
            b, H, n_q, n_q, 2, 2 * b * n_q, b * H * n_q * (n_q + 1) // 2, head_dim=hd))))
    q, k, v = attention_inputs(dev, bf, fb, fh, fn, fn, seed=8, head_dim=hd)
    kw = dict(scale=scale)
    rows["flash"] = dict(
        ms=time_ms(lambda: flash_attention(q, k, v, **kw), 20, flush),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw), 5, flush),
        library_ms=time_ms(lambda: sdpa(q, k, v, **kw), 20, flush), max_abs_err=worst,
        **dict(zip(("bound_ms", "bound_by"), attention_bound(fb, fh, fn, fn, 2,
                                                             head_dim=hd))))
    for name, r in rows.items():
        print(f"[phase 2] {'fused_attention' if name == 'forward' else 'flash_attention'} "
              f"heads of {hd}, {name} shape bf16: {r['ms']} ms, plain {r['plain_ms']} ms, "
              f"SDPA {r['library_ms']} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}) "
              "(median per call, L2 flushed)")
    return rows["forward"], rows["flash"]


def wide_megakernel(dev, D, H, hd):
    """The megakernel's OPT mode at a wide trunk's width (D, H heads of
    ``hd``, ffn 4 D, xattn 8 heads of 64 before every other layer, 64
    latents, a 128-slot cache) against its plain version, 1-2 layers:
    greedy b in {1, 3, 8} and 3 beams of 8 families at OPT_PAIRS' (cur,
    kv_limit), weight-only within 2 bf16 ulps, w8a8 bit for bit -> the
    largest abs error."""
    dims = dict(family="opt", D=D, H=H)
    worst, n = [0.0, 0.0, None], 0
    for n_layer, every in ((1, 1), (2, 2)):
        cfg, packed = random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                   seed=500 + hd + n_layer, **dims)
        for rows, kb in ((1, 1), (3, 1), (OPT_B, 1), (OPT_B * BEAMS, BEAMS)):
            inputs = mega_inputs(dev, cfg, rows, seed=600 + rows + hd, T=OPT_T)
            anc = None
            if kb > 1:
                inputs = list(inputs)
                inputs[5] = family_npad(dev, rows // kb, kb)
                anc = random_ancestry(dev, rows // kb, kb, seed=rows + hd, anc_len=OPT_T)
            for cur, kv_limit in (OPT_PAIRS[n % 4], OPT_PAIRS[(n + 1) % 4]):
                for q in (False, True):
                    label = (f"heads of {hd} layers={n_layer} rows={rows} cur={cur} "
                             f"kv_limit={kv_limit} {'w8a8' if q else 'weight-only'}")
                    errs = mega_errors(cfg, packed, inputs, cur, kv_limit, beam_anc=anc,
                                       act_quant=q)
                    held_to_ulps(label, errs, worst)
                    for name, (got, want) in errs.items():
                        assert not q or torch.equal(got, want), f"{label} {name}: not bit-equal"
                n += 1
        del packed
    torch.cuda.empty_cache()
    print(f"[phase 2] decode_step_megakernel OPT mode at D={D}, {H} heads of {hd}, 1-2 "
          f"layers, greedy b in {{1, 3, {OPT_B}}} and {BEAMS} beams of {OPT_B} families, "
          f"{2 * n} (cur, kv_limit) cases a mode: weight-only max error {worst[0]} bf16 "
          f"ulp (tolerance 2), max abs error {worst[1]}, largest at {worst[2]}; w8a8 bit "
          "for bit its plain version")
    return worst[1]


def phase2_wide_heads(dev, flush):
    """Every kernel taken at head widths 80 and 128 against its plain
    version at OPT-2.7B's and OPT-6.7B's shapes and at its edges ->
    {trunk: {kernel: row}} (the megakernel's row times come from the trunk
    cells)."""
    out = {}
    for label, (D, H, hd) in WIDE_HEADS.items():
        rows = {}
        rows["decode_attention"] = phase2_decode_attention(
            dev, flush, b=OPT_B, D=D, H=H, T=OPT_T, curs=(8, 39, 70), limits=(40, 71))
        rows["decode_attention_beam"] = wide_decode_beam(dev, flush, D, H, hd)
        rows["fused_attention"], rows["flash_attention"] = wide_fused_attention(
            dev, flush, H, hd)
        rows["megakernel_err"] = wide_megakernel(dev, D, H, hd)
        out[label] = rows
        stamp(f"phase 2 at {label}'s head width {hd} done")
    return out


def wide_trunk_cells(dev, card, flush):
    """OPT-2.7B and OPT-6.7B (WIDE) at full width and 32 layers:
    ``trunk_cells`` (the megakernel paths held to the plain program over
    their first WIDE_PLAIN_NEW tokens, the forward to WIDE_FWD_LIMIT), the
    forward's time, the 32-layer megakernel step timed alone, the megakernel
    path's captions/s and ms a step once the forward's bf16 model is freed.
    Each model freed before the next ->
    {trunk: {path: launch counts}, "mega": {trunk: {mode: kernel row}}}."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    from flamingo_mini_tpu_torch.ops import megadecode
    out = {"mega": {}}
    for label, kw in WIDE.items():
        D, H, hd = WIDE_HEADS[label]
        rs = np.random.RandomState(3)
        config = FlamingoConfig(**kw, **WIDE_COMMON)
        n_layer = config.lm_arch.num_hidden_layers
        assert (config.lm_arch.hidden_size, config.lm_arch.num_attention_heads) == (D, H)
        model = open_gates(FlamingoModel(config, device=dev, seed=7))
        model.quantize_int8().to_bf16()
        # the uncached forward: bf16 weights not quantized
        model_f = open_gates(FlamingoModel(FlamingoConfig(**kw, **WIDE_COMMON,
                                                          use_pallas=True),
                                           device=dev, seed=7)).to_bf16()
        torch.cuda.empty_cache()
        batch = trunk_batch(dev, rs, config)
        print(f"[phase 3] {label}: D={D}, {H} heads of {hd}, {n_layer} layers, ffn "
              f"{config.lm_arch.ffn_dim}, xattn on {len(model.params['xattn'])} layers; "
              f"batch {OPT_B}, {OPT_PROMPT}-token prompts, rows 0-1 left-padded by "
              f"{OPT_PAD}")
        out[label], _tokens, fwd = trunk_cells(label, model, model_f, batch, rs,
                                               plain_new=WIDE_PLAIN_NEW,
                                               fwd_limit=WIDE_FWD_LIMIT)
        fwd_ms, fwd_all = timed(fwd)
        print(f"[phase 4] {card}: {label} forward with loss, {FWD_B}x{FWD_N} tokens, "
              f"use_pallas: median {fwd_ms} ms (runs {fwd_all}), "
              f"{FWD_B * FWD_N / (fwd_ms / 1e3)} tokens/s")
        del model_f, fwd
        torch.cuda.empty_cache()

        # the step alone at 32 layers: the model's own packed weights, the
        # greedy loop's last step (rows 0 and 1 left-padded, every row an
        # image); time_ms spins the card before each call
        packed = megadecode.pack_decode_weights(model.params, config)
        inputs = mega_inputs(dev, config, OPT_B, seed=99, T=OPT_T)
        xk, xv, kc, vc, x, npad, tt = inputs
        npad.copy_(torch.tensor([OPT_PAD] * 2 + [0] * (OPT_B - 2), dtype=torch.int32))
        tt.fill_(1)
        n_pos = int((71 - npad).sum())
        mk_rows = {}
        for mode, q in (("weight-only", False), ("w8a8", True)):
            call = dict(config=config, kv_limit=71, act_quant=q)
            ms = time_ms(lambda: megadecode.decode_step_megakernel(
                packed, xk, xv, kc, vc, x, npad, tt, 70, **call), 20, flush)
            plain_ms = time_ms(lambda: megadecode.decode_step_megakernel_plain(
                packed, xk, xv, kc, vc, x, npad, tt, 70, **call), 1, flush)
            b_ms, b_by, n_bytes, n_ops = mega_bound(packed, config, inputs, n_pos, n_pos,
                                                    act_quant=q)
            mk_rows[mode] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                                 bound_by=b_by)
            print(f"[phase 4] {card}: {label} decode_step_megakernel {mode} at b={OPT_B}, "
                  f"{n_layer} layers, kv_limit 71: {ms} ms, plain {plain_ms} ms; bound "
                  f"{n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} GFLOP -> {b_ms:.4f} ms "
                  f"({b_by}) (median per call, L2 flushed)")
        out["mega"][label] = mk_rows
        del packed, inputs, xk, xv, kc, vc, x

        torch.cuda.empty_cache()
        # phase 4: the megakernel path's captions/s, ms a step and peak
        # memory with only its own model on the card
        time_generate(card, OPT_B, ((f"{label} megakernel",
                                     lambda n: trunk_run(model, batch, True, n), OPT_NEW),))
        del model, batch
        torch.cuda.empty_cache()
        stamp(f"{label} cells done")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel, beam_search
    from flamingo_mini_tpu_torch.models import gpt2
    from flamingo_mini_tpu_torch.ops import cuda_build

    # the numerics the port states: full float32 products, float32 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)

    # phase 1: device and build
    card = card_line()
    print(card)
    print(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    lib = cuda_build.build()
    cuda_build.kernels()
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("[phase 1] ptxas", line.strip())
            elif line.startswith("# nvcc "):
                print("[phase 1]", line[2:].strip())
    print(f"[phase 1] built {os.path.relpath(lib, REPO)}")
    sm90_sass(lib)
    stamp("phase 1 done")

    # phase 2: kernels against their plain versions on the card
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    attn = phase2_decode_attention(dev, flush)
    attn["max_abs_err"] = max(attn["max_abs_err"], narrow_attention(dev))
    attn_opt = phase2_decode_attention(dev, flush, b=OPT_B, D=OPT_D, H=OPT_H, T=OPT_T,
                                       curs=(8, 39, 70), limits=(40, 71))
    head = phase2_lm_head(dev, flush, widths=(1040, 8192))
    head_opt = phase2_lm_head(dev, flush, B=OPT_B, D=OPT_D, V=OPT_V)
    mega = phase2_megakernel(dev, flush)
    mega_opt = phase2_megakernel_opt(dev, flush)
    attn_beam = phase2_decode_attention_beam(dev, flush)
    attn_beam["max_abs_err"] = max(attn_beam["max_abs_err"], narrow_attention(dev, kb=3))
    mega_beam = phase2_megakernel_beam(dev, flush)
    edges = phase2_megakernel_edges(dev)
    for row in (mega, mega_opt, mega_beam):
        row["max_abs_err"] = max(row["max_abs_err"], edges)
    mega_widths = phase2_megakernel_widths(dev, flush)
    fa = phase2_fused_attention(dev, flush)
    flash = phase2_flash_attention(dev, flush)
    edges = phase2_sm90_edges(dev)
    for row in (*fa.values(), flash):
        row["max_abs_err"] = max(row["max_abs_err"], edges)
    mx = phase2_media_xattn(dev, flush)
    phase2_w8a8_linear(dev)
    mega_w8 = phase2_megakernel_w8a8(dev, flush)
    w8_edges = phase2_megakernel_w8a8_edges(dev)
    for row in mega_w8.values():
        row["max_abs_err"] = max(row["max_abs_err"], w8_edges)
    phase2_refusal(dev)
    probe = phase2_decode_stream_probe(dev, flush)
    stamp("phase 2 at head widths 80 and 128 start")
    wide = phase2_wide_heads(dev, flush)
    del flush
    torch.cuda.empty_cache()
    stamp("phase 2 done")

    # phase 3: the slice end to end at flamingo-mini width, both paths, on
    # its first MINI_LAYERS layers (``model``); all 24 (``model24``) for the
    # constrained-search check, the forward and scoring
    model24 = open_gates(FlamingoModel(FlamingoConfig(**MINI), device=dev, seed=0))
    model24.quantize_int8().to_bf16()
    model = first_layers(model24, MINI_LAYERS)
    config = model.config
    print(f"[phase 3] flamingo-mini's decode paths, BASELINE config 4 and the entry "
          f"point at {MINI_LAYERS} of its 24 layers (depth cut for the time limit)")
    rs = np.random.RandomState(0)
    ids = torch.tensor(rs.randint(0, 1000, (BATCH, PROMPT_LEN)), device=dev)
    media = torch.zeros((BATCH, PROMPT_LEN), dtype=torch.int32, device=dev)
    media[:, 0] = 1
    mask = torch.ones((BATCH, PROMPT_LEN), dtype=torch.int32, device=dev)
    arch = config.vision_arch
    pixels = torch.tensor(rs.randn(BATCH, 1, 3, arch.image_size, arch.image_size),
                          dtype=torch.float32, device=dev).to(torch.bfloat16)
    vocab = config.lm_arch.vocab_size + 1
    steps = NEW_TOKENS - 1
    n_layer = config.lm_arch.n_layer

    def run(megakernel, new_tokens=NEW_TOKENS, m=model, rows=BATCH, **kw):
        return m.generate(ids[:rows], media_locations=media[:rows],
                          attention_mask=mask[:rows], pixel_values=pixels[:rows],
                          max_length=MAX_LENGTH, max_new_tokens=new_tokens,
                          prefix_block=PREFIX_BLOCK, eos_token_id=vocab,
                          pad_token_id=0, megakernel=megakernel, **kw)

    def counted_run(megakernel, gaps, m=model):
        return counted(lambda: run(megakernel, m=m), gaps, ids, (BATCH, MAX_LENGTH),
                       vocab)

    layer_gaps, mega_gaps = [], []
    layer_tokens, layer_counts = counted_run(False, layer_gaps)
    expect("per-layer path", layer_counts, decode_attention=n_layer * steps,
           lm_head_argmax=steps)
    mega_tokens, mega_counts = counted_run(True, mega_gaps)
    expect("megakernel path", mega_counts, lm_head_argmax=steps,
           decode_step_megakernel=steps)

    plain_runs = {}
    for megakernel, tokens, label in ((False, layer_tokens, "per-layer kernels vs plain"),
                                      (True, mega_tokens, "megakernel vs plain")):
        gaps = []
        with plain_kernels(gaps):
            plain_tokens = run(megakernel)
        torch.cuda.synchronize()
        plain_runs[megakernel] = plain_tokens[:, PROMPT_LEN:].cpu(), gaps
        compare_tokens(label, tokens, plain_runs[megakernel][0], gaps)
    compare_tokens("megakernel path vs per-layer path", mega_tokens, layer_tokens,
                   layer_gaps)

    # phase 3, the logits chain on the megakernel: greedy with processors
    # (the fused head off, the full head and the chain after each step)
    procs = dict(no_repeat_ngram_size=3, repetition_penalty=1.2)
    proc_tokens, proc_counts = counted(
        lambda: run(True, **procs), [], ids, (BATCH, MAX_LENGTH), vocab,
        record=recorded_picks([]))
    expect("megakernel path with processors", proc_counts,
           decode_step_megakernel=steps)
    gaps = []
    with plain_trunk(), recorded_picks(gaps):
        plain_tokens = run(True, **procs)[:, PROMPT_LEN:].cpu()
    compare_tokens("megakernel with processors vs plain", proc_tokens, plain_tokens,
                   gaps)
    full = torch.cat([ids.cpu(), proc_tokens], dim=1)
    grams = [set() for _ in range(BATCH)]
    for r in range(BATCH):
        for j in range(full.shape[1] - 2):
            gram = tuple(full[r, j:j + 3].tolist())
            assert gram not in grams[r], f"row {r} repeats the 3-gram {gram}"
            grams[r].add(gram)
    print(f"[phase 3] megakernel with processors: no row repeats a 3-gram; "
          f"{float((proc_tokens != mega_tokens).float().mean()):.4f} of tokens other "
          "than plain greedy's")
    # scores: the full head (the fused head off), tokens held to the plain
    # fused-head greedy run
    scored = {}

    def scored_run():
        scored["out"] = run(True, return_scores=True, output_scores=True)
        return scored["out"][0]
    sc_tokens, sc_counts = counted(scored_run, [], ids, (BATCH, MAX_LENGTH), vocab,
                                   record=contextlib.nullcontext())
    expect("megakernel path with scores", sc_counts, decode_step_megakernel=steps)
    _, seq_scores, step_scores = scored["out"]
    assert seq_scores.shape == (BATCH,) and step_scores.shape == (BATCH, MAX_LENGTH)
    assert bool(torch.isfinite(step_scores).all()) and bool((seq_scores < 0).all())
    assert bool((step_scores[:, :PROMPT_LEN] == 0).all())
    rel = float(((step_scores.sum(dim=1) - seq_scores).abs() / seq_scores.abs()).max())
    print(f"[phase 3] megakernel with scores: sequence scores {seq_scores[:4].tolist()}"
          f"...; per-step scores summed vs sequence scores: relative {rel} "
          "(tolerance 1e-3)")
    assert rel <= 1e-3, rel
    compare_tokens("megakernel with scores (full head) vs plain fused-head greedy",
                   sc_tokens, *plain_runs[True])

    # phase 3, w8a8: the same weights on the megakernel's act_quant mode
    w8_gaps = []
    w8_tokens, w8_counts = counted(lambda: run(True, w8a8=True), w8_gaps, ids,
                                   (BATCH, MAX_LENGTH), vocab)
    expect("w8a8 megakernel path", w8_counts, lm_head_argmax=steps,
           decode_step_megakernel=steps)
    gaps = []
    with plain_kernels(gaps):
        plain_tokens = run(True, w8a8=True)
    torch.cuda.synchronize()
    compare_tokens("w8a8 megakernel vs plain", w8_tokens,
                   plain_tokens[:, PROMPT_LEN:].cpu(), gaps)
    print_agreement("w8a8 vs weight-only megakernel", w8_tokens, mega_tokens)
    # an odd batch: the first 3 rows, on the kernel as given; quantization
    # is per row, so they are the batch of 32's first rows
    odd_tokens, odd_counts = counted(lambda: run(True, rows=3, w8a8=True), [], ids[:3],
                                     (3, MAX_LENGTH), vocab)
    expect("w8a8 odd batch (b=3)", odd_counts, lm_head_argmax=steps,
           decode_step_megakernel=steps)
    compare_tokens("w8a8 odd batch (b=3) vs the same rows at b=32", odd_tokens,
                   w8_tokens[:3], [g[:3] for g in w8_gaps])

    # phase 3, use_pallas: the same weights; the ViT, the resampler and the
    # xattn prefill run the attention kernels (the GPT-2 prefill writes the
    # cache and stays on attend, as in the JAX package)
    model_p = first_layers(model24, MINI_LAYERS, use_pallas=True)
    n_vit, n_res = config.vision_arch.num_hidden_layers, config.resampler_depth
    n_x = len(model.params["xattn"])
    pallas_gaps = []
    pallas_tokens, pallas_counts = counted_run(True, pallas_gaps, m=model_p)
    expect("use_pallas megakernel path", pallas_counts,
           fused_attention=n_vit + n_res, fused_media_xattn=n_x,
           decode_step_megakernel=steps, lm_head_argmax=steps)
    gaps = []
    with plain_kernels(gaps):
        plain_tokens = run(True, m=model_p)
    torch.cuda.synchronize()
    compare_tokens("use_pallas megakernel path vs plain", pallas_tokens,
                   plain_tokens[:, PROMPT_LEN:].cpu(), gaps)
    compare_tokens("use_pallas megakernel path vs use_pallas=False", pallas_tokens,
                   mega_tokens, mega_gaps)

    # phase 3, the uncached forward with its loss: the same weights in bf16,
    # not quantized
    model_f = open_gates(FlamingoModel(FlamingoConfig(**MINI, use_pallas=True),
                                       device=dev, seed=0)).to_bf16()
    fwd, fwd_counts, _ = check_forward("flamingo-mini", model_f, rs,
                                       model_f.config.lm_arch.n_layer,
                                       len(model_f.params["xattn"]))

    # phase 3, beams: batch 32 x 3 beams, 64 new tokens, lazy reorder
    def beam_run(megakernel, new_tokens=BEAM_NEW_TOKENS, **kw):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=BEAM_MAX_LENGTH,
                              max_new_tokens=new_tokens, prefix_block=PREFIX_BLOCK,
                              eos_token_id=vocab, pad_token_id=0,
                              megakernel=megakernel, num_beams=BEAMS,
                              length_penalty=1.0, early_stopping=True,
                              **{"beam_reorder": "lazy", **kw})

    def recorded_beam_run(megakernel, plain=False, **kw):
        return recorded_beam(lambda: beam_run(megakernel, **kw), ids,
                             (BATCH, BEAM_MAX_LENGTH), vocab, BEAM_NEW_TOKENS, plain)

    beam_steps = BEAM_NEW_TOKENS - 1
    layer_b_tokens, layer_b_counts, layer_b_cands = recorded_beam_run(False)
    expect("beam per-layer path", layer_b_counts,
           decode_attention_beam=n_layer * beam_steps)
    mega_b_tokens, mega_b_counts, mega_b_cands = recorded_beam_run(True)
    expect("beam megakernel path", mega_b_counts, decode_step_megakernel=beam_steps)
    for megakernel, tokens, cands, label in (
            (False, layer_b_tokens, layer_b_cands, "beam per-layer kernels vs plain"),
            (True, mega_b_tokens, mega_b_cands, "beam megakernel vs plain")):
        plain_tokens, _, plain_cands = recorded_beam_run(megakernel, plain=True)
        compare_beams(label, tokens, cands, plain_tokens, plain_cands, BEAMS, vocab)
    compare_beams("beam megakernel path vs per-layer path", mega_b_tokens,
                  mega_b_cands, layer_b_tokens, layer_b_cands, BEAMS, vocab)
    # beams on the megakernel's w8a8 mode
    w8_b_tokens, w8_b_counts, w8_b_cands = recorded_beam_run(True, w8a8=True)
    expect("w8a8 beam megakernel path", w8_b_counts, decode_step_megakernel=beam_steps)
    plain_tokens, _, plain_cands = recorded_beam_run(True, plain=True, w8a8=True)
    compare_beams("w8a8 beam megakernel vs plain", w8_b_tokens, w8_b_cands, plain_tokens,
                  plain_cands, BEAMS, vocab)
    print_agreement("w8a8 vs weight-only beam megakernel", w8_b_tokens, mega_b_tokens)

    # phase 3, the KV-cache variants per layer, plain attention and the full
    # head as in the JAX package (no kernel launches): greedy over the
    # head-major bf16 cache against the flat cache's run; over the int8
    # cache, its prefill logits within JAX's envelope of the bf16 cache's
    # (0.05 x absmax + 0.05, tests/test_quant.py:77-100) and its tokens'
    # agreement printed (another numerics tier); beams with the gather
    # reorder and lazily over the head-major cache, against the lazy flat
    # cache's beams
    stamp("KV-cache variants start")
    hm_tokens, hm_counts = counted(lambda: run(False, flat_kv_cache=False), [], ids,
                                   (BATCH, MAX_LENGTH), vocab, record=recorded_picks([]))
    expect("head-major cache per-layer path", hm_counts)
    compare_tokens("head-major cache vs flat cache, per layer", hm_tokens, layer_tokens,
                   layer_gaps)
    i8_tokens, i8_counts = counted(lambda: run(False, int8_kv_cache=True), [], ids,
                                   (BATCH, MAX_LENGTH), vocab, record=recorded_picks([]))
    expect("int8 KV cache per-layer path", i8_counts)
    print_agreement("int8 KV cache vs head-major bf16 cache", i8_tokens, hm_tokens)
    kv_prefill_envelope(model, ids, media, mask, pixels)
    for label, kw in (("gather reorder (head-major cache)", dict(beam_reorder="gather")),
                      ("lazy reorder over the head-major cache", dict(flat_kv_cache=False))):
        g_tokens, g_counts, g_cands = recorded_beam_run(False, **kw)
        expect(f"beam per-layer path, {label}", g_counts)
        compare_beams(f"beams, {label}, vs the flat cache's lazy beams", g_tokens, g_cands,
                      layer_b_tokens, layer_b_cands, BEAMS, vocab)
    stamp("phase 3 (flamingo-mini) done")

    # phase 4: timing (CUDA events around whole generate calls)
    time_generate(card, BATCH, (
        ("per-layer", lambda n: run(False, n), NEW_TOKENS),
        ("megakernel", lambda n: run(True, n), NEW_TOKENS),
        ("beam per-layer", lambda n: beam_run(False, n), BEAM_NEW_TOKENS),
        ("beam megakernel", lambda n: beam_run(True, n), BEAM_NEW_TOKENS),
        ("use_pallas megakernel", lambda n: run(True, n, m=model_p), NEW_TOKENS),
        ("w8a8 megakernel", lambda n: run(True, n, w8a8=True), NEW_TOKENS),
        ("w8a8 beam megakernel", lambda n: beam_run(True, n, w8a8=True),
         BEAM_NEW_TOKENS),
        ("head-major cache per-layer", lambda n: run(False, n, flat_kv_cache=False),
         KV_TIMED_NEW),
        ("int8 KV cache per-layer", lambda n: run(False, n, int8_kv_cache=True),
         KV_TIMED_NEW)))
    # the beam step's head: the full int8 lm_head at 96 rows (its float32
    # copy of the weights included) and the candidate selection
    lm = model.params["lm"]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    h = torch.randn((BATCH * BEAMS, 1, config.dim), device=dev).to(torch.bfloat16)
    head_ms = time_ms(lambda: gpt2.lm_head(lm, h, n_valid=vocab), 20, flush)
    flat = torch.randn((BATCH, BEAMS * vocab), device=dev)
    select_ms = time_ms(lambda: beam_search.select_candidates(flat, 2 * BEAMS), 20, flush)
    del flush
    print(f"[phase 4] {card}: beam step head: lm_head at {BATCH * BEAMS} rows "
          f"{head_ms} ms, candidate selection (stable sort of {BATCH} x "
          f"{BEAMS * vocab}) {select_ms} ms (median per call, L2 flushed)")
    print(f"[phase 4] {card}: decode_step_megakernel beam mode at 160 rows "
          f"{mega_beam['ms160']} ms vs {mega_beam['ms']} ms at {BATCH * BEAMS} rows")
    # the fixed cost of a generate: encode + resample at batch 32
    for label, m in (("use_pallas=False", model), ("use_pallas", model_p)):
        enc_ms, enc_all = timed(lambda: m.encode_resample_visuals(pixels))
        print(f"[phase 4] {card}: encode + resample, {BATCH} images, {label}: median "
              f"{enc_ms} ms (runs {enc_all})")
    fwd_ms, fwd_all = timed(fwd)
    print(f"[phase 4] {card}: forward with loss, {FWD_B}x{FWD_N} tokens, use_pallas: "
          f"median {fwd_ms} ms (runs {fwd_all}), {FWD_B * FWD_N / (fwd_ms / 1e3)} "
          "tokens/s")
    stamp("phase 4 (flamingo-mini) done")

    # phase 3 and 4 of BASELINE configs 1, 4 (on the same flamingo-mini) and 5
    baseline = baseline_cells(dev, card, model, model_p)
    # phase 3 and 4 of the rest of search on the same flamingo-mini
    search_cells(dev, card, model, ids, media, mask, pixels, model24)
    search_card_vs_cpu(dev)
    # phase 3 and 4 of the public entry point: captions and scoring on the
    # same flamingo-mini, BASELINE config 1 via from_pretrained
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as vocab_dir:
        synthetic_vocab(vocab_dir)
        entry_point_cells(dev, card, model, model_p, vocab_dir)
        scoring_cells(dev, card, model24, FlamingoModel(
            FlamingoConfig(**MINI, use_pallas=True), params=model24.params, device=dev),
            vocab_dir)
        config1_from_pretrained(dev, card, vocab_dir)
        # the ported scripts: fidelity, examples, converter, profiling
        scripts_cells(dev, card, model, model24, model_f)
        del model, model_p, model24, model_f, fwd
        torch.cuda.empty_cache()
        # phase 3 and 4 of training: flamingo-mini and the OPT-125m recipe
        train_counts = training_cells(dev, card, vocab_dir)
        # phase 3 and 4 of the parallel tier: two ranks on the one card
        par_counts, par_rows = parallel_cells(dev, card, vocab_dir)

    # phase 3 and 4 of the OPT cells
    stamp("OPT cells start")
    opt_counts = opt_cells(dev, card)
    stamp("OPT cells done")
    # phase 3 and 4 of OPT-2.7B and OPT-6.7B (heads 80 and 128 wide)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    wide_counts = wide_trunk_cells(dev, card, flush)
    del flush
    torch.cuda.empty_cache()
    # phase 4: the stream probe (its own entry point's path)
    stream = phase4_stream(dev, card)
    # phase 4: the in-situ decode and head probes (their own entry points' path)
    insitu_counts = phase4_insitu(dev, card)
    stamp("phase 4 done")

    kernel_rows = (
        ("decode_attention", attn),
        ("decode_attention (OPT-1.3B: b=8, D=2048, 32 heads, T=128)", attn_opt),
        ("lm_head_argmax", head),
        ("lm_head_argmax (OPT-1.3B: B=8, D=2048, V=50273)", head_opt),
        ("decode_step_megakernel", mega),
        ("decode_step_megakernel OPT mode (OPT-1.3B, b=8)", mega_opt),
        ("decode_attention_beam", attn_beam),
        ("decode_step_megakernel beam mode", mega_beam),
        ("fused_attention (ViT shape)", fa["vit"]),
        ("fused_attention (resampler shape)", fa["resampler"]),
        ("fused_attention (GPT-2 forward shape)", fa["gpt2 forward"]),
        ("fused_attention (OPT-1.3B forward shape)", fa["opt forward"]),
        ("flash_attention", flash),
        ("fused_media_xattn (prefill shape)", mx["prefill"]),
        ("fused_media_xattn (forward shape)", mx["forward"]),
        ("fused_media_xattn (two images, text_time 1 then 2)", mx["two images"]),
        ("fused_media_xattn (four images, text_time 1 then 4)", mx["four images"]),
        ("fused_attention (ViT-B/32 shape)", fa["vit-b/32"]),
        ("fused_attention (8-frame resampler shape)", fa["video resampler"]),
        ("fused_attention (OPT-125m training trunk shape)", fa["opt-125m forward"]),
        ("decode_step_megakernel (flamingo-tiny: D=768, 12 layers, b=32)",
         mega_widths["tiny"]),
        ("decode_step_megakernel (256 media latents: D=1024, 24 layers, b=8)",
         mega_widths["media4"]),
        ("decode_step_megakernel act_quant (w8a8)", mega_w8["greedy"]),
        ("decode_step_megakernel act_quant beam mode", mega_w8["beam"]),
        ("decode_step_megakernel act_quant OPT mode (OPT-1.3B, b=8)", mega_w8["opt"]),
        ("stream_sum", stream),
        ("attn_stream_only (b-major)", probe["bmajor"]),
        ("make_tmajor_stream (T-major)", probe["tmajor"]),
        ("make_tmajor_packed_loop (packed K||V)", probe["packed"]))
    wide_rows = []   # (name, source, replaces, launches, row) at heads 80 and 128
    for label, (D, H, hd) in WIDE_HEADS.items():
        w, c, mk = wide[label], wide_counts[label], wide_counts["mega"][label]
        for mode in ("weight-only", "w8a8"):
            mk[mode]["max_abs_err"] = w["megakernel_err"]
        shape = f"{label}: b={OPT_B}, D={D}, {H} heads of {hd}"
        wide_rows += [
            (f"decode_attention ({shape}, T={OPT_T})", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:153",
             c["per layer"]["decode_attention"], w["decode_attention"]),
            (f"decode_attention_beam ({shape}, {BEAMS} beams)", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:350",
             c["beam per layer"]["decode_attention_beam"], w["decode_attention_beam"]),
            (f"decode_step_megakernel OPT mode ({shape}, 32 layers)",
             "decode_megakernel_sm90.cuh", "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             c["megakernel"]["decode_step_megakernel"], mk["weight-only"]),
            (f"decode_step_megakernel act_quant OPT mode ({shape}, 32 layers)",
             "decode_megakernel_sm90.cuh", "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             c["w8a8"]["decode_step_megakernel"], mk["w8a8"]),
            (f"fused_attention ({label} forward trunk: (8, {H}, 64, 64) heads of {hd}; "
             "launches at that width)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270", c["forward at width"],
             w["fused_attention"]),
            (f"flash_attention ({WIDE_FLASH} heads of {hd})", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:156", c["forward"]["flash_attention"],
             w["flash_attention"])]
    kernel_rows += tuple((name, k) for name, _src, _rep, _n, k in wide_rows)
    for name, k in kernel_rows:
        print(f"[phase 4] {card}: {name} {k['ms']} ms vs plain {k['plain_ms']} "
              f"ms, library {k['library_ms']} ms, bound {k['bound_ms']} ms "
              f"({k['bound_by']}) (median per call, L2 flushed)")

    rows = []
    for name, source, replaces, launches, k in (
            ("decode_attention", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:153",
             layer_counts["decode_attention"], attn),
            ("decode_attention (OPT-1.3B shape)", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:153",
             opt_counts["per layer"]["decode_attention"], attn_opt),
            ("lm_head_argmax", "lm_head_argmax.cu",
             "flamingo_mini_tpu/ops/pallas_lmhead.py:71",
             mega_counts["lm_head_argmax"], head),
            ("lm_head_argmax (OPT-1.3B shape)", "lm_head_argmax.cu",
             "flamingo_mini_tpu/ops/pallas_lmhead.py:71",
             opt_counts["megakernel"]["lm_head_argmax"], head_opt),
            ("decode_step_megakernel", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             mega_counts["decode_step_megakernel"], mega),
            ("decode_step_megakernel (OPT mode)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             opt_counts["megakernel"]["decode_step_megakernel"], mega_opt),
            ("decode_step_megakernel (OPT mode, top-k 50 sampling: BASELINE config 3)",
             "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             opt_counts["sampled"]["decode_step_megakernel"], mega_opt),
            ("decode_attention_beam", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:350",
             layer_b_counts["decode_attention_beam"], attn_beam),
            ("decode_step_megakernel (beam mode)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             mega_b_counts["decode_step_megakernel"], mega_beam),
            ("fused_attention", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             pallas_counts["fused_attention"], fa["vit"]),
            ("fused_attention (OPT-1.3B forward shape)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             opt_counts["forward"]["fused_attention"], fa["opt forward"]),
            ("flash_attention (fused_attention's streaming variant)",
             "attention_sm90.cuh", "flamingo_mini_tpu/ops/pallas_attn.py:156",
             pallas_counts["flash_attention"], flash),
            ("fused_media_xattn", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             pallas_counts["fused_media_xattn"], mx["prefill"]),
            ("fused_media_xattn (forward shape)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             fwd_counts["fused_media_xattn"], mx["forward"]),
            ("decode_step_megakernel (act_quant: w8a8)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             w8_counts["decode_step_megakernel"], mega_w8["greedy"]),
            ("decode_step_megakernel (act_quant, beam mode)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             w8_b_counts["decode_step_megakernel"], mega_w8["beam"]),
            ("decode_step_megakernel (act_quant, OPT mode)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             opt_counts["w8a8"]["decode_step_megakernel"], mega_w8["opt"]),
            ("decode_step_megakernel (flamingo-tiny, D=768: BASELINE config 1)",
             "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             baseline["config 1"]["megakernel"]["decode_step_megakernel"],
             mega_widths["tiny"]),
            ("decode_step_megakernel (four images, 256 media latents: BASELINE config 4)",
             "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             baseline["config 4"]["megakernel"]["decode_step_megakernel"],
             mega_widths["media4"]),
            ("fused_attention (ViT-B/32: BASELINE config 1)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             baseline["config 1"]["use_pallas megakernel"]["fused_attention"],
             fa["vit-b/32"]),
            ("fused_attention (8-frame resampler: BASELINE config 5)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             baseline["config 5"]["use_pallas megakernel"]["fused_attention"],
             fa["video resampler"]),
            ("fused_media_xattn (four images: BASELINE config 4)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             baseline["config 4"]["use_pallas megakernel"]["fused_media_xattn"],
             mx["four images"]),
            ("fused_attention (training step, flamingo-mini: forward; backward "
             "recomputes the plain version)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             train_counts["flamingo-mini"]["fused_attention"], fa["gpt2 forward"]),
            ("fused_media_xattn (training step, flamingo-mini)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             train_counts["flamingo-mini"]["fused_media_xattn"], mx["forward"]),
            ("fused_attention (training step, OPT-125m recipe)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             train_counts["OPT-125m recipe"]["fused_attention"], fa["opt-125m forward"]),
            ("fused_media_xattn (training step, OPT-125m recipe)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             train_counts["OPT-125m recipe"]["fused_media_xattn"], mx["forward"]),
            ("decode_step_megakernel (DP greedy over 2 ranks on the card, 16 rows a "
             "rank: launches per rank; times at 16 rows)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             par_counts["DP megakernel"]["decode_step_megakernel"],
             par_rows["decode_step_megakernel"]),
            ("decode_step_megakernel (DP top-k 50 sampling over 2 ranks: launches per "
             "rank; times at 16 rows)", "decode_megakernel_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_megadecode.py:966",
             par_counts["DP sampling"]["decode_step_megakernel"],
             par_rows["decode_step_megakernel"]),
            ("lm_head_argmax (DP greedy over 2 ranks, megakernel path: launches per rank; "
             "times at 16 rows)", "lm_head_argmax.cu",
             "flamingo_mini_tpu/ops/pallas_lmhead.py:71",
             par_counts["DP megakernel"]["lm_head_argmax"], par_rows["lm_head_argmax"]),
            ("decode_attention (DP greedy per layer over 2 ranks: launches per rank; "
             "times at 16 rows)", "decode_attention.cu",
             "flamingo_mini_tpu/ops/pallas_decode.py:153",
             par_counts["DP per layer"]["decode_attention"], par_rows["decode_attention"]),
            ("fused_attention (TP=2 greedy and beams, a rank's 8 of 16 heads: launches "
             "per rank per generate; times at rank 0's ViT inputs)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             par_counts["TP greedy"]["fused_attention"], par_rows["TP ViT"]),
            ("fused_media_xattn (TP=2 prefill, a rank's 4 of 8 heads: launches per rank "
             "per generate; times at rank 0's inputs)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             par_counts["TP greedy"]["fused_media_xattn"], par_rows["TP media prefill"]),
            ("fused_attention (DP training step over 2 ranks, 4 rows a rank: launches per "
             "rank; times at rank 0's trunk inputs)", "attention_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_attn.py:270",
             par_counts["DP training step"]["fused_attention"], par_rows["DP trunk"]),
            ("fused_media_xattn (ring forward over 2 ranks, 512 tokens a rank: launches "
             "per rank; times at rank 0's inputs)", "media_xattn_sm90.cuh",
             "flamingo_mini_tpu/ops/pallas_xattn.py:122",
             par_counts["ring forward"]["fused_media_xattn"], par_rows["ring media"]),
            ("stream_sum (bandwidth probe)", "stream_probe.cu",
             "tools/probe_stream.py:24", stream["launches"], stream),
            ("attn_stream_only (decode stream probe, b-major cache)",
             "decode_stream_probe.cu", "tools/probe_decode_kernel.py:37",
             insitu_counts["attn_stream_only"], probe["bmajor"]),
            ("make_tmajor_stream (decode stream probe, T-major cache)",
             "decode_stream_probe.cu", "tools/probe_decode_kernel.py:76",
             insitu_counts["tmajor_stream"], probe["tmajor"]),
            ("make_tmajor_packed_loop (decode stream probe, packed K||V cache)",
             "decode_stream_probe.cu", "tools/probe_decode_kernel.py:149",
             insitu_counts["packed_stream"], probe["packed"]), *wide_rows):
        rows.append({"name": name, "route": "cuda",
                     "source": f"flamingo_mini_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
