#!/usr/bin/env python3
"""chip_smoke.py's phase 18 alone, over every CUDA card of the machine.
Run from the repo root:

    python3 benchmarks/torch_slab_cards.py

Phase 18 (a) serves the 4 chips' stream of chip_smoke.py phase 4 on
plans of 2 and 4 slabs, here with slab i on card i mod the card count
(on one card: every slab on cuda:0, as chip_smoke.py runs it), every
event checked against the numpy oracle, K1/K2/B6 launched once a slab a
dispatch, an upset on the last slab healed, a rebind 1 -> 4 -> 2 slabs
mid-stream, and served events/s at 1, 2 and 4 slabs in rotating rounds.
With two or more cards phase 18 (b) follows: the stream over 4 (or 2)
cards with each slab's tensors checked on its card, a live rebind from
cuda:0 to cuda:1, and a fleet over every card whose buckets land on
disjoint cards. Any failure exits non-zero.

Every line is JSON; the last names the card and its power limit.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_slab_cards: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.bdt_infer import bdt_infer as bdt
    from repro_torch.kernels.lut_eval import bitsliced as bs
    from repro_torch.kernels.lut_eval import lut_eval as le
    from repro_torch.kernels.sparse_pack import sparse_pack as sp
    from repro_torch.kernels.yprofile import ops as yp

    counters = {"yprofile": yp.yprofile_traced,
                "eval_words_voted": bs.eval_seg_voted,
                "lut_eval": le.lut_eval_stacked,
                "lut_eval_banded": le.lut_eval_banded_stacked,
                "bdt_infer": bdt.bdt_traverse,
                "sparse_pack_decode": sp.decode_pack,
                "sparse_pack_keep_words": sp.pack_keep_words,
                "decode_dense": sp.decode_dense}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    build.build()
    chips = [cs.train_chip(2024 + i, depth=5 - (i % 2), leaves=10 - (i % 3))
             for i in range(cs.N_CHIPS)]
    swap_chip = cs.train_chip(31, depth=4, leaves=8)
    stream = FrameStream(FrameStreamConfig(n_sensors=cs.N_CHIPS,
                                           batch=cs.SERVE_EVENTS))
    blocks = [[stream.batch_at(step, s) for s in range(cs.N_CHIPS)]
              for step in range(cs.SERVE_BATCHES)]
    want = cs.oracle(np, chips, swap_chip, blocks, yp)
    want0 = cs.oracle(np, chips, chips[0], blocks, yp)
    flips = cs.effective_flips(np, chips, want0)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    slabs = cs.serve_slabs(torch, np, chips, swap_chip, blocks, want, want0,
                           flips, counters, cards)
    slabs["rates"] = cs.slab_rates(np, chips, blocks, cards)
    cs.emit("slabs", ok=True, card=card, **slabs)
    if len(cards) >= 2:
        fleet_chips = list(chips) + [cs.train_chip(seed, depth=d, leaves=lv)
                                     for seed, d, lv in cs.FLEET_EXTRA]
        fstream = FrameStream(FrameStreamConfig(
            n_sensors=cs.FLEET_TENANTS, batch=cs.SERVE_EVENTS, seed=703))
        fblocks = [[fstream.batch_at(step, t)
                    for t in range(cs.FLEET_TENANTS)]
                   for step in range(cs.FLEET_STEPS)]
        fwant = cs.fleet_oracle(np, fleet_chips, fblocks, yp)
        multi = cs.slabs_multi_card(torch, np, chips, swap_chip, blocks,
                                    want, fleet_chips, fblocks, fwant,
                                    counters)
        cs.emit("slabs_multi_card", ok=True, card=card, **multi)
    else:
        cs.emit("slabs_multi_card", skipped="1 card")
    print(json.dumps({"cards": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
