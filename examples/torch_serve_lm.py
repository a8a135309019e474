"""Serve a small LM with batched requests through the port's KV-cache
decode path, on the CUDA card (the port of examples/serve_lm.py).

    PYTHONPATH=src python examples/torch_serve_lm.py
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --preset smoke --arch mamba2-130m

Runs ``repro_torch.launch.serve`` in this process with the reference
example's defaults (``--preset tiny --batch 8 --prompt-len 16 --gen
48``); every flag given here is passed on after them, so a later one
wins. The token-LM families serve (dense, moe, ssm, hybrid at their smoke
widths with ``--preset smoke --arch``); the driver refuses encdec and the
VLM, as the reference's does.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve

DEFAULTS = ["--preset", "tiny", "--batch", "8", "--prompt-len", "16",
            "--gen", "48"]


def main(argv=None):
    return serve.main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
