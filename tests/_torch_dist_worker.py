"""The rank side of tests/test_torch_distributed.py: one process of a gloo
world on the CPU (a FileStore in the test's tmp_path, no TCP port), which
runs one case and has rank 0 write its results to ``out/<case>.npz``.
Imports neither JAX nor the JAX package (the test holds the results
against them)."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 8, 32
TP_ARCHS = ("gemma-7b", "deepseek-moe-16b")
DP_ARCHS = ("mamba2-130m", "zamba2-1.2b")


def train_opt():
    from repro_torch.train.optimizer import OptimizerConfig

    return OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=0,
                           weight_decay=0.01)


def batches():
    """TINY's three training batches (global, on the CPU)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import TINY

    pipe = TokenPipeline(DataConfig(vocab=TINY.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
            for i in range(TRAIN_STEPS)]


def pod_data(seed=0):
    """The reference _POD_SCRIPT's params and batch."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (8, 4)).astype(np.float32)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    y = rng.normal(0, 1, (16, 4)).astype(np.float32)
    return w, x, y


def psum_partial(rank):
    return (np.random.default_rng(100 + rank).normal(0, 1, (5, 7))
            * (1 + 3 * rank)).astype(np.float32)


def tp_cfg(arch):
    """The arch's smoke config with the full config's activation sharding
    (sequence parallel over "model"); the tests place it under the "tp"
    profile's specs."""
    from repro_torch.configs import get_arch, smoke_config

    return dataclasses.replace(smoke_config(arch), act_shard=get_arch(
        arch).act_shard, act_dp_axes=("data",), attn_chunk=16)


def dp_cfg(arch):
    """The arch's smoke config under the data-parallel profile's
    activation pinning (batch over "data")."""
    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(arch), act_shard="batch",
                               act_dp_axes=("data",), attn_chunk=16)


def tp_batch(cfg):
    g = torch.Generator().manual_seed(7)
    tok = lambda: torch.randint(0, cfg.vocab, (4, 32), generator=g,
                                dtype=torch.int32)
    return {"tokens": tok(), "labels": tok()}


def _save(out, case, **arrays):
    np.savez(os.path.join(out, f"{case}.npz"), **arrays)


def run(rank, case, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store_{case}",
                            rank=rank, world_size=world)
    try:
        CASES[case.split("-")[0]](rank, case, world, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def case_psum(rank, case, world, out):
    from repro_torch.parallel.compression import quantized_psum

    got = quantized_psum({"g": torch.from_numpy(psum_partial(rank))},
                         dist.group.WORLD)["g"]
    if rank == 0:
        _save(out, case, sum=got.numpy())


def case_pod(rank, case, world, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.compression import (
        make_compressed_value_and_grad)

    mesh = init_device_mesh("cpu", (2, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    w, x, y = pod_data()
    specs = {"x": shd.P("pod", None), "y": shd.P("pod", None)}
    batch = {k: shd.distribute(torch.from_numpy(v), shd.NamedSharding(
        mesh, specs[k]), src_data_rank=None) for k, v in (("x", x), ("y", y))}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    vag = make_compressed_value_and_grad(loss_fn, mesh, specs)
    loss, grads = vag({"w": torch.from_numpy(w)}, batch)
    g = grads["w"].full_tensor()
    if rank == 0:
        _save(out, case, loss=loss.full_tensor().numpy(), g=g.numpy())


def case_train(rank, case, world, out):
    """TINY on a (data=2, model=1) mesh: three AdamW steps with the
    ZeRO-2 grad specs, params gathered to the host."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import TINY
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    from repro_torch.train import tree as T
    from repro_torch.train.train_step import make_opt_init, make_train_step

    mesh = make_host_mesh(2, 1, device="cpu")
    host = registry.init_params(TINY, torch.Generator().manual_seed(SEED))
    params = elastic.reshard_params(TINY, mesh, host)
    opt = elastic.reshard_opt_state(
        TINY, mesh, make_opt_init(TINY, train_opt())(host), host)
    step_fn = make_train_step(
        TINY, train_opt(), donate=True,
        grad_specs=shd.named(mesh, shd.grad_specs(TINY, mesh, host)))
    bsh = shd.named(mesh, shd.batch_specs(TINY, mesh, _shape()))
    losses = []
    for batch in batches():
        batch = {k: shd.distribute(v, bsh[k], src_data_rank=None)
                 for k, v in batch.items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    host_out = elastic.gather_to_host(params)
    if rank == 0:
        _save(out, case, losses=np.array(losses),
              **{f"p/{k}": v for k, v in T.items(host_out)})


def _shape():
    from repro_torch.configs.base import ShapeSpec

    return ShapeSpec("t", TRAIN_SEQ, TRAIN_BATCH, "train")


def case_reshard(rank, case, world, out):
    """The reference _RESHARD_SCRIPT (smoke gemma-7b) on a (2, 2) or (2, 1)
    plan, and TINY under the "tp" profile's specs (its leaves really
    shard over "model"); plus a checkpoint restored with ``shardings``."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import TINY
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    from repro_torch.train import tree as T
    from repro_torch.train.checkpoint import CheckpointManager

    data, model = (2, 2) if world == 4 else (2, 1)
    mesh = make_host_mesh(data, model, device="cpu")
    cfg = smoke_config("gemma-7b")
    host = elastic.gather_to_host(
        registry.init_params(cfg, torch.Generator().manual_seed(SEED)))
    back = elastic.gather_to_host(elastic.reshard_params(cfg, mesh, host))
    shd.profile_of = lambda c: "tp"
    tiny = registry.init_params(TINY, torch.Generator().manual_seed(SEED))
    placed = elastic.reshard_params(TINY, mesh, tiny)
    n_sharded = sum(any(p.is_shard() for p in x.placements)
                    for x in T.leaves(placed))
    tiny_back = elastic.gather_to_host(placed)
    ckpt = CheckpointManager(os.path.join(out, f"ckpt_{case}"))
    if rank == 0:
        ckpt.save(1, tiny_back)
    dist.barrier()
    _, restored = ckpt.restore(tiny, shardings=shd.named(
        mesh, shd.param_specs(TINY, mesh, tiny)))
    same = all(tuple(a.placements) == tuple(b.placements) for a, b in zip(
        T.leaves(restored), T.leaves(placed)))
    restored = elastic.gather_to_host(restored)
    if rank == 0:
        _save(out, case, n_sharded=n_sharded, same_placements=same,
              **{f"gemma/{k}": v for k, v in T.items(back)},
              **{f"tiny/{k}": v for k, v in T.items(tiny_back)},
              **{f"restored/{k}": v for k, v in T.items(restored)})


def case_tp(rank, case, world, out):
    """Loss and grads of an arch's smoke config placed under the "tp"
    profile's specs on a (data=1, model=2) mesh: the shard-by-shard
    attention, the vocab-sharded embedding and cross entropy, the pinned
    sequence-parallel residual and (MoE) the expert-parallel experts."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    from repro_torch.train import tree as T
    from repro_torch.train.train_step import (make_loss_fn, sharded_context,
                                              value_and_grad)

    kind, arch = case.split("-", 1)
    if kind == "tp":
        cfg = tp_cfg(arch)
        shd.profile_of = lambda c: "tp"
        mesh = make_host_mesh(1, 2, device="cpu")
    else:
        cfg = dp_cfg(arch)
        mesh = make_host_mesh(2, 1, device="cpu")
    host = registry.init_params(cfg, torch.Generator().manual_seed(SEED))
    params = elastic.reshard_params(cfg, mesh, host)
    bsh = shd.named(mesh, shd.batch_specs(cfg, mesh, _tp_shape()))
    batch = {k: shd.distribute(v, bsh[k], src_data_rank=None)
             for k, v in tp_batch(cfg).items()}
    with sharded_context(params):
        loss, grads = value_and_grad(make_loss_fn(cfg))(params, batch)
    loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    grads = elastic.gather_to_host(grads)
    if rank == 0:
        _save(out, case, loss=loss.numpy(),
              **{f"g/{k}": v for k, v in T.items(grads)})


def _tp_shape():
    from repro_torch.configs.base import ShapeSpec

    return ShapeSpec("t", 32, 4, "train")


CASES = {"psum": case_psum, "pod": case_pod, "train": case_train,
         "reshard": case_reshard, "tp": case_tp, "dp": case_tp}
