"""One dry-run cell of the PyTorch port on a production mesh, and its
roofline terms on the H100 (the port's examples/dryrun_cell.py).

Runs the cell's step once on a fake world of the mesh's size
(launch/dryrun.py: DTensors of fake tensors, no device memory), then
divides its per-device FLOPs, bytes and collective wire bytes by the
H100 SXM5 constants of launch/mesh.py:

    PYTHONPATH=src python examples/torch_dryrun_cell.py --arch gemma-7b \\
        --shape train_4k --mesh single

It runs on the host's CPU only; a full-size cell takes a minute or more.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def terms(summary):
    """compute / memory / collective seconds of one cell on the H100."""
    from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

    t = {"compute": summary["flops_per_device"] / PEAK_FLOPS_BF16,
         "memory": summary["bytes_per_device"] / HBM_BW,
         "collective": summary["collective_wire_bytes_per_device"] / ICI_BW}
    return t, max(t, key=t.get)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import MESHES, lower_cell

    name = "multi_pod_2x16x16" if args.mesh == "multi" else "single_pod_16x16"
    s = lower_cell(args.arch, args.shape, MESHES[name], name)
    t, bottleneck = terms(s)
    print(f"\n{args.arch} x {args.shape} on {name} ({s['n_devices']} "
          "devices, H100 SXM5 80GB constants)")
    print(f"  compute    {t['compute']:.3e} s  "
          f"({s['flops_per_device']:.3e} FLOP/device)")
    print(f"  memory     {t['memory']:.3e} s  "
          f"({s['bytes_per_device']:.3e} B/device, unfused)")
    print(f"  collective {t['collective']:.3e} s  "
          f"({s['collective_wire_bytes_per_device']:.3e} wire B/device, "
          f"{s['collective_count']} collectives)")
    print(f"  bottleneck: {bottleneck}")
    print(f"  peak memory/device: {s['memory']['peak_bytes'] / 2**30:.2f} "
          f"GiB  fits: {s['fits_hbm']}  (step {s['lower_s']} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
