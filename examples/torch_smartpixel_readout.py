"""Full §5 reproduction at paper scale on the PyTorch port: 500k
smart-pixel tracks (examples/smartpixel_readout.py, served by
``repro_torch`` on a CUDA card).

    PYTHONPATH=src python examples/torch_smartpixel_readout.py [--events 500000]
    PYTHONPATH=src python examples/torch_smartpixel_readout.py --device cpu --events 20000

It takes every flag of examples/smartpixel_readout.py, and ``--device``
(the card by default; ``cpu`` runs each kernel's plain PyTorch twin, and
only when asked). It imports nothing of the JAX package.

Produces every §5 number: float operating point, quantized Table 1,
LUT count vs the 448 capacity, the NN baseline that does NOT fit,
the 100% fabric-vs-golden agreement on the full dataset (through the
port's fabric kernels, in 65,536-event chunks), and the at-source data
reduction; then trains the NN that would not fit, for its accuracy.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.bdt import (
    GradientBoostedClassifier, operating_point_at_signal_eff,
)
from repro_torch.core.nn_baseline import MLPSpec, lut_cost, mlp_proba, train_mlp
from repro_torch.core.readout import KernelBackend, ReadoutChip
from repro_torch.data.smartpixel import SmartPixelConfig, generate, train_test_split
from repro_torch.device import resolve_device

CHUNK = 65_536


def main(argv=None):
    """Run the §5 reproduction; returns its numbers as a dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--device", default=None,
                    help="where the fabric kernels and the NN run: the "
                         "CUDA card by default, or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"generating {args.events:,} tracks ...")
    t0 = time.time()
    data = generate(SmartPixelConfig(n_events=args.events, seed=args.seed))
    tr, te = train_test_split(data)
    print(f"  {time.time()-t0:.1f}s; pileup fraction {data['label'].mean():.3f}")

    print("training the paper's BDT (1 tree, depth 5) ...")
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=5, max_leaf_nodes=10, min_samples_leaf=500
    ).fit(tr["features"], tr["label"])

    score_f = clf.predict_proba(te["features"])
    print("\n-- float model (paper: bkg rejection 4.35% @ sig eff 97.53%) --")
    _, se, br = operating_point_at_signal_eff(score_f, te["label"], 0.9753)
    print(f"  closest achievable point: sig_eff={se:.4f} bkg_rej={br:.4f}")

    print("\n-- quantized ap_fixed<28,19> model (paper Table 1) --")
    q = clf.quantized()
    score_q = q.predict_proba(te["features"])
    print("  target | sig_eff | bkg_rej | paper_rej")
    for target, paper in [(0.964, 0.058), (0.978, 0.039), (0.996, 0.011)]:
        _, se, br = operating_point_at_signal_eff(score_q, te["label"], target)
        print(f"  {target:.3f}  | {se:.4f} | {br:.4f} | {paper:.3f}")

    print("\n-- synthesis + fit (paper: 294 LUTs in 448) --")
    chip = ReadoutChip.build(clf, fabric="efpga_28nm")
    u = chip.config.utilization()
    print(f"  BDT: {u['luts']} LUTs, depth {u['depth']}, "
          f"{u['lut_utilization']:.0%} of the 28nm fabric")
    nn = lut_cost(MLPSpec())
    print(f"  NN baseline: {nn['lut_total']} LUTs (paper: >6000) -> does NOT fit")

    print(f"\n-- fabric execution on all {args.events:,} events "
          f"(paper: 100% match vs golden) --")
    backend = KernelBackend(device=device)
    t0 = time.time()
    n, n_match = 0, 0
    # the test split, then the train split: the paper runs the full 500k
    for split in (te, tr):
        for lo in range(0, len(split["features"]), CHUNK):
            v = chip.verify_vs_golden(split["features"][lo : lo + CHUNK],
                                      backend=backend)
            n += int(v["n"])
            n_match += int(v["n_match"])
    dt = time.time() - t0
    print(f"  {n_match:,}/{n:,} = {n_match/n:.2%} in {dt:.1f}s "
          f"({n/dt:,.0f} events/s on {device})")
    assert n_match == n

    print("\n-- at-source data reduction (40 MHz front-end) --")
    chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.97)
    rep = chip.data_reduction_report(te["features"], te["label"])
    for k, v in rep.items():
        print(f"  {k}: {v:.4g}")

    print("\n-- optional: train the NN that wouldn't fit (accuracy reference) --")
    params, norm, loss = train_mlp(tr["features"][:100_000],
                                   tr["label"][:100_000].astype(np.float32),
                                   steps=150, device=device)
    p_nn = mlp_proba(params, norm, te["features"][:50_000])
    _, se_nn, br_nn = operating_point_at_signal_eff(
        p_nn, te["label"][:50_000], 0.978)
    print(f"  NN @ sig_eff~0.978: bkg_rej={br_nn:.4f} "
          f"(better model, but 6000+ LUTs > 448 — the paper's point)")
    print("\nDONE.")
    return {"device": str(device), "n": n, "n_match": n_match,
            "luts": int(u["luts"]), "nn_lut_total": int(nn["lut_total"]),
            "nn_loss": loss, "nn_bkg_rej": float(br_nn),
            "events_per_s": n / dt}


if __name__ == "__main__":
    main()
