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
reference's does. Parameters come from a generator on the device seeded
with ``--seed``, so they are not the JAX driver's; the batches are.

``--mesh-data``/``--mesh-model`` > 1 train on a (data, model)
``DeviceMesh`` over a world of data x model ranks, started by torchrun
(``launch.mesh.init_world``: gloo on the CPU or for ranks sharing a
card, NCCL otherwise):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --preset tiny \
      --device cpu --mesh-data 2

Every rank makes the same params and global batch; params, optimizer
state and batch are placed as DTensors by the sharding rules
(``parallel/sharding``), the grads reduce-scattered to their ZeRO-2
shards. Rank 0 alone logs and writes checkpoints, which every rank
gathers first (the same files as one device's).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ReadoutMesh, init_world, make_host_mesh
from repro_torch.models import registry
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.transport import transport_for
from repro_torch.train import elastic
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
    own_world = False
    if args.mesh_data * args.mesh_model > 1:
        own_world = init_world(resolve_device(args.device).type)
    try:
        return _run(args)
    finally:
        if own_world:
            dist.destroy_process_group()


def _run(args) -> int:
    mesh = make_host_mesh(args.mesh_data, args.mesh_model, args.device)
    sharded = not isinstance(mesh, ReadoutMesh)
    if sharded:
        device = torch.device(mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        rank0 = dist.get_rank() == 0
    else:
        device, rank0 = mesh.device, True
    log = print if rank0 else (lambda *a, **k: None)

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
        log(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    transport = transport_for(mesh) if sharded else None
    grad_specs = None
    if sharded:
        with transport:
            host_params = params
            params = elastic.reshard_params(cfg, mesh, host_params)
            opt_state = elastic.reshard_opt_state(cfg, mesh, opt_state,
                                                  host_params)
        del host_params
        grad_specs = shd.named(mesh, shd.grad_specs(cfg, mesh, params))
        batch_sh = shd.named(mesh, shd.batch_specs(
            cfg, mesh, ShapeSpec("cli", args.seq, args.batch, "train")))

    def save(step, **extra):
        state = {"params": params, "opt": opt_state}
        if sharded:
            with transport:
                state = elastic.gather_to_host(state)
        if rank0:
            ckpt.save(step, state, extra=extra or None)

    step_fn = make_train_step(cfg, opt_cfg, grad_specs=grad_specs,
                              donate=True)
    t_run = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        t0 = time.time()
        if sharded:
            with transport:
                batch = {k: shd.distribute(v, batch_sh[k], src_data_rank=None)
                         for k, v in batch.items()}
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if sharded:
            # one verdict for every rank: the slowest rank's time
            worst = torch.tensor([dt], dtype=torch.float64, device=device)
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)
            dt = float(worst)
        if args.step_timeout and dt > args.step_timeout and step > start_step:
            log(f"[watchdog] step {step} took {dt:.1f}s > "
                f"{args.step_timeout}s — aborting for restart")
            save(step + 1, aborted=True)
            return 75
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / max(dt, 1e-9)
            log(f"step {step:5d}  loss {loss:7.4f}  "
                f"gnorm {float(metrics['grad_norm']):7.3f}  "
                f"lr {float(metrics['lr']):.2e}  {tok_s:,.0f} tok/s",
                flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)

    save(args.steps)
    bound = data.entropy_bound_nats()
    log(f"done in {time.time()-t_run:.1f}s; final loss "
        f"{np.mean(losses[-10:]):.4f} (entropy bound {bound:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
