"""Rank workers for tests/test_torch_parallel*.py: module-level functions
that ``flamo_tpu_torch.parallel.launch.spawn`` can start (each rank
re-imports this module, which imports no JAX)."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from flamo_tpu_torch.models import (build_colorless_sfdn,
                                    sfdn_masked_train_step)
from flamo_tpu_torch.parallel import get_mesh, get_mesh_2d, replicate
from flamo_tpu_torch.parallel.fused import (make_masked_sharded_sfdn_step,
                                            masked_sharded_sfdn_loss)
from flamo_tpu_torch.parallel.mesh import (allreduce_grads, axis_index,
                                           same_on_axis, shard_block,
                                           take_block)


def raise_on(rank, world, bad: int):
    """Rank ``bad`` raises; the others block in an all-reduce that the
    failed rank never joins."""
    if rank == bad:
        raise ValueError(f"rank {rank} refuses")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)


def sleep_on(rank, world, seconds: float):
    """Every rank sleeps past the caller's deadline."""
    time.sleep(seconds)


def mesh_checks(rank, world) -> dict:
    """The mesh helpers on ``world`` ranks: blocks, replication, the
    gradient sum, the same-on-axis check, the 2-D mesh's coordinates,
    the masked loss's batch check, and the masked step on its own mask
    schedule."""
    out = {}
    mesh = get_mesh(world, "bins")
    out["blocks"] = [shard_block(M, mesh, "bins") for M in (7, 8, 9)]
    x = torch.arange(5.0)
    out["take"] = take_block(x, 3, 4).tolist()
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank))
        lin.bias.fill_(float(rank) + 0.5)
    replicate(lin, mesh)
    out["replicated"] = [float(lin.weight.max()), float(lin.bias.max())]
    lin.weight.grad = torch.full_like(lin.weight, float(rank + 1))
    lin.bias.grad = None
    allreduce_grads(lin.parameters(), mesh, "bins")
    out["grad_sum"] = float(lin.weight.grad[0, 0])
    out["bias_grad"] = lin.bias.grad
    same_on_axis(torch.arange(4), mesh, "bins", "masks")
    try:
        same_on_axis(torch.arange(4) + rank, mesh, "bins", "masks")
        out["differ"] = None
    except ValueError as e:
        out["differ"] = str(e)
    try:
        get_mesh(world + 1)
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    if world % 2 == 0:
        m2 = get_mesh_2d(2, world // 2)
        out["coords"] = (axis_index(m2, "seed"), axis_index(m2, "bins"))
    model = build_colorless_sfdn(nfft=256, delays=(13, 17, 19, 23),
                                 n_stages=1, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    M = 129
    X = torch.ones((2, M, 1), dtype=torch.complex64)
    mask = torch.arange(0, M, 4)
    try:
        masked_sharded_sfdn_loss(model, X, torch.ones((2, M, 1)), mask, mesh)
        out["batch"] = None
    except ValueError as e:
        out["batch"] = str(e)
    share = masked_sharded_sfdn_loss(model, X[:1], torch.ones((1, M, 1)),
                                     mask, mesh, sparsity_weight=0.0)
    total = share.detach().clone()
    dist.all_reduce(total)
    out["masked_total"] = float(total)
    # the masked step on its own mask schedule, drawn from one generator
    # on every rank, against the unsharded masked step's
    models = [build_colorless_sfdn(nfft=256, delays=(13, 17, 19, 23),
                                   n_stages=1, device="cpu",
                                   generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    x = torch.zeros((1, M, 1))
    x[:, 0] = 1.0
    t = torch.ones((1, M, 1))
    steps = [make(m, **kw, n_samples=32,
                  generator=torch.Generator().manual_seed(5),
                  solve_method="ge_cached")[0]
             for make, m, kw in ((make_masked_sharded_sfdn_step, models[0],
                                  {"mesh": mesh}),
                                 (sfdn_masked_train_step, models[1], {}))]
    out["own_schedule"] = [[float(step(x, t, i)) for i in range(2)]
                           for step in steps]
    return out
