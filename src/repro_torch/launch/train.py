"""Training driver: config -> device -> train loop with fault tolerance
(the port of the JAX package's launch/train.py), on the card.

Runs real steps on one device (the CUDA card by default; ``--device cpu``
only when asked), with:
  * automatic resume from the latest atomic checkpoint (--resume),
  * periodic checkpointing (--ckpt-every) through train/checkpoint.py, in
    the reference's on-disk format,
  * deterministic shard-recomputable data (data/pipeline.py
    ``TokenPipeline``, the reference's batches bit for bit),
  * a step watchdog (--step-timeout) that saves and aborts the run (exit
    code 75) so the scheduler restarts it from the checkpoint.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
      --steps 50 --batch 8 --seq 256   # reduced run of a real config

``TINY`` is also the serving driver's default preset (launch/serve.py).
The full config path trains float32 parameters in one microbatch, as the
reference's does. ``--mesh-data``/``--mesh-model`` go through
``make_host_mesh``: one device; a larger plan raises ``NotPortedError``
(ROADMAP A.18). Parameters come from a generator on the device seeded
with ``--seed``, so they are not the JAX driver's; the batches are.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_opt_init, make_train_step

TINY = ArchConfig(
    name="tiny-lm",
    family="dense",
    source="(reduced in-repo preset)",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1024,
    vocab=512,
    head_dim=32,
    mlp="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    optimizer="adamw",
    remat="none",
    loss_chunk=128,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--preset", default=None, choices=["tiny", "smoke"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/run")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-kind", default="markov",
                    choices=["markov", "uniform"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="abort (exit 75) if one step exceeds this many "
                         "seconds")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default, or 'cpu'")
    args = ap.parse_args(argv)
    device = make_host_mesh(args.mesh_data, args.mesh_model,
                            args.device).device

    if args.preset == "tiny" or args.arch is None:
        cfg = TINY
    elif args.preset == "smoke":
        cfg = smoke_config(args.arch)
    else:
        cfg = dataclasses.replace(
            get_arch(args.arch), num_microbatches=1, act_shard="none",
            param_dtype="float32",
        )
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("this driver trains token-LM families; see examples/")

    data = TokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed, kind=args.data_kind))

    opt_cfg = OptimizerConfig(name=cfg.optimizer, lr=args.lr,
                              warmup_steps=min(50, args.steps // 4),
                              total_steps=args.steps)
    params = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    opt_state = make_opt_init(cfg, opt_cfg)(params)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step, state = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = make_train_step(cfg, opt_cfg, donate=True)
    t_run = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if args.step_timeout and dt > args.step_timeout and step > start_step:
            print(f"[watchdog] step {step} took {dt:.1f}s > "
                  f"{args.step_timeout}s — aborting for restart")
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      extra={"aborted": True})
            return 75
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {tok_s:,.0f} tok/s",
                  flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})

    ckpt.save(args.steps, {"params": params, "opt": opt_state})
    bound = data.entropy_bound_nats()
    print(f"done in {time.time()-t_run:.1f}s; final loss "
          f"{np.mean(losses[-10:]):.4f} (entropy bound {bound:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
