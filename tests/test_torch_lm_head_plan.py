"""The lm_head kernel's deal over its persistent grid, on the CPU.

``lm_head_argmax``'s CUDA kernel (csrc/lm_head_argmax.cu) runs only on the
card (tests/test_torch_gpu.py holds it against its plain version there,
and ``smem_bytes`` against the kernel's own layout); ``ops/lm_head.py``
mirrors its deal, computed from the shapes. Here: the deal covers every
(row group, vocab tile, weight chunk) once, each warpgroup's ring is
filled in the order it is consumed, a group's K-slices cover its chunks
once (one slice where its rows fit whole) within the staged rows' room,
and the shared memory fits at every row count and width, K tails (D=1040)
and widths past 6,144 (6208, 8192) included. No JAX.
"""
import numpy as np
import pytest
import torch

from flamingo_mini_tpu_torch.ops import lm_head as lh

H100_SMEM = 232448   # shared memory a block may opt in to on an H100


# (Vp, D, B, blocks): the main path's head, OPT-1.3B's, the odd w8a8 batch,
# past one row group, a grid wider than the tiles
HEADS = [(51200, 1024, 32, 132), (51200, 2048, 8, 132), (51200, 1024, 3, 132),
         (51200, 1024, 65, 132), (51200, 2048, 33, 132), (2048, 1024, 5, 132),
         (4096, 4096, 17, 7), (51200, 1040, 32, 132), (4096, 6208, 33, 7),
         (4096, 8192, 8, 7), (2048, 8192, 40, 5)]


@pytest.mark.parametrize("Vp,D,B,blocks", HEADS)
def test_head_deal_covers_every_tile_once(Vp, D, B, blocks):
    """``lm_head_argmax``'s persistent grid (one block per SM, at most one
    per tile): every (row group, vocab tile, weight chunk) is streamed once
    and consumed once, each by one warpgroup; each warpgroup's ring is
    filled in the order the warpgroup consumes it; the shares are
    contiguous and in block order."""
    n_tiles = Vp // lh.TILE
    grid = min(blocks, n_tiles)
    nk, rows = lh.n_chunks(D), lh.MAX_N
    groups = -(-B // rows)
    seen = np.zeros((groups, n_tiles, nk), dtype=np.int64)
    last = -1
    for block in range(grid):
        producer, consumers = lh.schedule(block, grid, n_tiles, D, B)
        t0 = block * n_tiles // grid
        for w, entries in enumerate(consumers):
            assert [e for e in producer if e[0] == w] == entries, (block, w)
            assert [e[1] for e in entries] == list(range(len(entries)))
            assert all((tile - t0) % lh.GROUPS == w for _w, _j, _r0, tile, _c in entries)
        assert len(producer) == sum(len(e) for e in consumers)
        for _w, _j, r0, tile, c in producer:
            seen[r0 // rows, tile, c] += 1
        tiles = sorted({tile for _w, _j, _r, tile, _c in producer})
        if tiles:
            assert tiles[0] == last + 1 and tiles == list(range(tiles[0], tiles[-1] + 1))
            last = tiles[-1]
    assert (seen == 1).all()


@pytest.mark.parametrize("D", [1024, 2048, 4096, 6144, 1040, 6208, 8192])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 33, 64, 65, 128])
def test_head_shared_memory_fits(D, B):
    """The head kernel's shared memory fits the card at every width, and
    every group's K-slices cover its chunks once, in order, each slice's
    staged rows within the room the layout gives the first group's: whole
    (one slice) up to 3,072 wide at 32 rows, in slices past it."""
    assert lh.smem_bytes(D, B) <= H100_SMEM
    room = lh.smem_bytes(D, B) - lh.smem_bytes(1, B) + lh.group_n(min(B, lh.MAX_N)) * 128
    for r0 in range(0, B, lh.MAX_N):
        rows = min(lh.MAX_N, B - r0)
        cover = [c for c0, nc in lh.slices(D, rows) for c in range(c0, c0 + nc)]
        assert cover == list(range(lh.n_chunks(D)))
        n = lh.group_n(rows)
        assert all(n * nc * 128 <= min(room, lh.STAGE_BYTES) for _c0, nc in lh.slices(D, rows))
        assert (len(lh.slices(D, rows)) == 1) == (n * lh.n_chunks(D) * 128 <= lh.STAGE_BYTES)


def _wide_model(D: int):
    """A 1-layer OPT trunk D wide with a gated xattn block and a small ViT,
    int8, bf16, on the CPU (chip_smoke.wide_config's shape)."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    config = FlamingoConfig(
        lm="facebook/opt-1.3b", dim=D, dim_visual=64, xattn_every=1,
        compute_dtype="bfloat16", resampler_depth=1, resampler_num_latents=8,
        lm_arch_overrides=dict(vocab_size=512, max_position_embeddings=64,
                               hidden_size=D, ffn_dim=2 * D, num_hidden_layers=1,
                               num_attention_heads=8, word_embed_proj_dim=D),
        vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=1, num_attention_heads=4,
                                   image_size=32, patch_size=16))
    return FlamingoModel(config, device="cpu", seed=3).quantize_int8().to_bf16()


@pytest.mark.parametrize("D", [1040, 1000])
def test_fused_head_width_is_decided_before_vision_and_prefill(D, monkeypatch):
    """A trunk whose width is not a multiple of 64 (1040; 1000, whose int8
    rows are not a multiple of 16 bytes either), ``fused_head=True``: greedy generate asks ``lm_head.check_fits`` with
    the head's (D, b) before it encodes the images or runs the prompt, and
    a refusal there is the only one: the call then raises before any work.
    Unrefused, it decodes, the head's weight padded once to whole 16-byte
    rows, and picks the tokens of ``fused_head=False``."""
    from flamingo_mini_tpu_torch import generation
    from flamingo_mini_tpu_torch.models import flamingo
    model = _wide_model(D)
    ids = torch.ones((2, 4), dtype=torch.long)
    pixels = torch.zeros((2, 1, 3, 32, 32), dtype=torch.bfloat16)
    asked, ran = [], []

    def refuse(width, rows, device):
        asked.append((width, rows))
        raise ValueError("head too wide")
    with monkeypatch.context() as m:
        m.setattr(generation.lm_head, "check_fits", refuse)
        m.setattr(flamingo, "encode_resample_visuals", lambda *a, **k: ran.append("vision"))
        m.setattr(generation, "_prefill", lambda *a, **k: ran.append("prefill"))
        with pytest.raises(ValueError, match="head too wide"):
            model.generate(ids, pixel_values=pixels, max_length=10)
    assert asked == [(D, 2)] and not ran
    padded = []
    real_pad = generation.pad_head_weights
    monkeypatch.setattr(generation, "pad_head_weights",
                        lambda wq, bv: padded.append(real_pad(wq, bv)) or padded[-1])
    fused = model.generate(ids, pixel_values=pixels, max_length=10)
    plain = model.generate(ids, pixel_values=pixels, max_length=10, fused_head=False)
    assert len(padded) == 1 and padded[0]["w8"].shape[1] == -(-D // 16) * 16
    assert fused.shape == (2, 10) and torch.equal(fused, plain)
