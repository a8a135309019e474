"""Quickstart on the PyTorch port: the paper's §5 pipeline end to end in
under a minute (the port of examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

simulate smart-pixel sensor -> train a single depth-5 BDT -> quantize to
ap_fixed<28,19> -> synthesize to LUT4s -> place on the 28nm eFPGA ->
encode/decode the bitstream -> classify on the fabric (the port's fabric
kernels on the CUDA card by default; ``--device cpu`` runs their plain
PyTorch twins, and only when asked) -> verify 100% against the golden
model -> report the data-rate reduction. It imports nothing of the JAX
package.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.bdt import GradientBoostedClassifier
from repro_torch.core.readout import KernelBackend, ReadoutChip
from repro_torch.data.smartpixel import SmartPixelConfig, generate, train_test_split
from repro_torch.device import resolve_device


def main(argv=None):
    """Run the quickstart; returns the fabric-vs-golden check's numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=60_000)
    ap.add_argument("--device", default=None,
                    help="where the fabric kernels run: the CUDA card by "
                         "default, or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"== 1. simulate the smart-pixel dataset (reduced: "
          f"{args.events // 1000}k tracks) ==")
    data = generate(SmartPixelConfig(n_events=args.events, seed=2024))
    tr, te = train_test_split(data)
    print(f"   {len(tr['label']):,} train / {len(te['label']):,} test tracks; "
          f"{tr['label'].mean():.1%} pileup")

    print("== 2. train the paper's model: 1 tree, depth 5 ==")
    clf = GradientBoostedClassifier(
        n_estimators=1, max_depth=5, max_leaf_nodes=10, min_samples_leaf=500
    ).fit(tr["features"], tr["label"])
    t = clf.trees[0]
    print(f"   {t.n_internal} thresholds, {len(t.used_features())} inputs used "
          f"(paper: 9 thresholds, 7 inputs)")

    print("== 3. quantize + synthesize + place on the 28nm eFPGA ==")
    chip = ReadoutChip.build(clf, fabric="efpga_28nm")
    cal = chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.97)
    u = chip.config.utilization()
    print(f"   {u['luts']} LUTs of 448 ({u['lut_utilization']:.0%}) "
          f"(paper: 294); bitstream {len(chip.bitstream):,} bytes")
    print(f"   calibrated: sig_eff={cal['signal_efficiency']:.3f} "
          f"bkg_rej={cal['background_rejection']:.3f}")

    print(f"== 4. run the fabric on the test set (kernel backend, {device}) ==")
    v = chip.verify_vs_golden(te["features"],
                              backend=KernelBackend(device=device))
    print(f"   fabric vs golden: {int(v['n_match']):,}/{int(v['n']):,} "
          f"match = {v['accuracy']:.1%} (paper: 100%)")

    rep = chip.data_reduction_report(te["features"], te["label"])
    print(f"== 5. at-source reduction: keep {rep['fraction_kept']:.1%} of hits, "
          f"link {rep['link_rate_in_gbps']:.1f} -> "
          f"{rep['link_rate_out_gbps']:.1f} Gb/s ==")
    if v["accuracy"] != 1.0:
        raise SystemExit(f"fabric disagrees with the golden model on "
                         f"{int(v['n'] - v['n_match'])} events")
    print("OK — paper §5 reproduced.")
    return {**v, "device": str(device)}


if __name__ == "__main__":
    main()
