"""K2's launch sizing at the fleet's deep padded envelope (fault C.3).

The deep 4-tree ensemble's fleet bucket is 32 levels x 256 LUTs with a
128-word input segment. Under TMR one word's block of the staged walk
(every replica's descriptors and level slots in shared memory) needs
344,588 B, over the H100's 232,448 B, so K2 used to refuse it before the
first dispatch. The wrapper now picks the split walk there (a block a
replica, then a vote pass), whose block for one word is 115,204 B. These
checks need no card: they are the sizes the wrapper launches with. The
split walk's decomposition (each replica walked alone, then the 2-of-3
vote and the disagreement words) is held equal to the plain twin here;
the kernel itself is held equal on the card
(tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core.tmr import majority_vote_words
from repro_torch.kernels import build
from repro_torch.kernels.lut_eval import bitsliced as bs

DEEP = dict(in_seg=128, n_levels=32, m_pad=256)
SERVED = [dict(in_seg=256, n_levels=13, m_pad=128),     # the served stack
          dict(in_seg=256, n_levels=16, m_pad=128)]     # its fleet bucket


@pytest.mark.parametrize("n_sms", [1, 132])
@pytest.mark.parametrize("words", [1, 2, 16, 256])
def test_deep_tmr_envelope_gets_a_tile_within_shared_memory(words, n_sms):
    tile = bs.word_tile(3, DEEP["in_seg"], DEEP["n_levels"], DEEP["m_pad"],
                        words, n_chips=1, n_sms=n_sms)
    assert 1 <= tile <= words
    smem = bs.smem_bytes(3, DEEP["in_seg"], DEEP["n_levels"], DEEP["m_pad"],
                         tile)
    assert smem <= build.SMEM_LIMIT_BYTES


def test_deep_envelope_paths_and_block_bytes():
    args = (DEEP["in_seg"], DEEP["n_levels"], DEEP["m_pad"])
    # the staged walk's one-word block under TMR, as the refusal reported
    assert bs._block_bytes(3, *args, 1) == 344_588
    assert bs.walk_path(3, *args) == "split"
    assert bs.smem_bytes(3, *args, 1) == 115_204
    # plain, the staged walk already fits
    assert bs.walk_path(1, *args) == "staged"
    assert bs.smem_bytes(1, *args, 1) == 115_204
    # 4 words of one replica fit: 81,920 B of descriptors + 33,284 B a word
    assert bs.word_tile(3, *args, 256) == 4
    assert bs.smem_bytes(3, *args, 4) == 81_920 + 4 * 33_284
    # the scratch holds every replica row's descriptors on either walk
    assert bs.scratch_bytes(1, 3, 32, 256) == 3 * 81_920


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("env", SERVED, ids=["13x128", "16x128"])
def test_served_envelopes_keep_the_staged_walk(env, R):
    args = (env["in_seg"], env["n_levels"], env["m_pad"])
    assert bs.walk_path(R, *args) == "staged"
    for tile in (1, bs.word_tile(R, *args, 16, n_chips=4, n_sms=132)):
        assert bs.smem_bytes(R, *args, tile) == bs._block_bytes(
            R, *args, tile)


def test_refusal_stays_for_an_envelope_neither_walk_takes():
    # past the streamed walk too: one word's net buffer alone (the input
    # segment and every level's slots) exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        bs.word_tile(3, 128, 240, 256, 16)
    with pytest.raises(ValueError, match="shared memory"):
        bs.walk_path(1, 128, 230, 256)


@pytest.mark.parametrize("upset", [False, True])
def test_split_decomposition_equals_the_plain_twin(upset):
    """What the split walk computes, in torch ops on the CPU: each replica
    row walked alone (R=1), then the vote and the disagreement words."""
    C, R, L, M, in_seg, n_in, O = 2, 3, 6, 16, 32, 20, 7
    src, tables, outs = chip_smoke.synthetic_walk_stack(
        torch, np, C, R, L, M, in_seg, n_in, O, seed=3, device="cpu")
    if upset:
        tables[1, :, :4, ::3] = 1.0 - tables[1, :, :4, ::3]
    rng = np.random.default_rng(4)
    bits = torch.as_tensor(rng.integers(0, 2, (C, 5 * 32 - 3, n_in)))
    seg = bs.input_words(bits, n_in, in_seg)
    want_v, want_d = bs.eval_seg_voted_plain(src, tables, outs, seg, R)
    rows = torch.repeat_interleave(seg, R, dim=0)
    rep = bs.eval_seg_voted_plain(src, tables, outs, rows, 1)[0]
    g = rep.reshape(C, R, *rep.shape[1:])
    voted = majority_vote_words(g[:, 0], g[:, 1], g[:, 2])
    dis = torch.zeros_like(want_d)
    for o in range(O):
        dis |= (g ^ voted[:, None])[..., o]
    assert torch.equal(voted, want_v) and torch.equal(dis, want_d)
    if upset:
        assert bool(dis.any())
