"""Train a small LM end to end with the port's training substrate
(optimizer, deterministic pipeline, atomic checkpoints, resume), on the
CUDA card (the port of examples/train_lm.py).

    PYTHONPATH=src python examples/torch_train_lm.py            # ~4.5M params, 200 steps
    PYTHONPATH=src python examples/torch_train_lm.py --steps 50 # shorter
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

Runs ``repro_torch.launch.train`` in this process with the reference
example's defaults (``--preset tiny --steps 200 --batch 16 --seq 128 --lr
2e-3 --ckpt-dir checkpoints/example_lm --ckpt-every 50 --resume``); every
flag given here is passed on after them, so a later one wins. The corpus
is a fixed random Markov chain (entropy bound log(4) = 1.386 nats), so the
loss visibly converges toward a known floor. Kill it mid-run and run it
again: it resumes from its checkpoint.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train

DEFAULTS = ["--preset", "tiny", "--steps", "200", "--batch", "16", "--seq",
            "128", "--lr", "2e-3", "--ckpt-dir", "checkpoints/example_lm",
            "--ckpt-every", "50", "--resume"]


def main(argv=None):
    return train.main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
