"""Data-parallel training over a mesh axis (counterpart of
``flamo_tpu/parallel/dp.py``).

Batches shard over the mesh's ``axis_name``; parameters and optimizer
state are replicated.  Each step takes the rank's mean loss over its
shard, sums the gradients over the axis and divides them by its size
(JAX's ``pmean``), then updates: Adam on identical gradients keeps the
parameters identical on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flamo_tpu_torch.parallel.mesh import (allreduce_grads,
                                           axis_index, axis_size, replicate)


def make_dp_train_step(loss_fn, optimizer_factory, mesh,
                       axis_name: str = "batch"):
    """Build ``(step, init)`` for data-parallel training.

    ``step(model, optimizer, inputs, targets)`` takes the GLOBAL batch
    (every rank passes the same tensors), keeps this rank's shard of its
    leading axis (:func:`shard_batch`), differentiates
    ``loss_fn(model, inputs, targets)`` there (a mean over the batch),
    averages the gradients over the axis, steps ``optimizer`` and returns
    the global mean loss (detached).  A batch that the axis does not
    divide raises ``ValueError`` before any work.

    ``optimizer_factory(model)`` builds each rank's optimizer; call it
    through the returned ``init(model)``, which also replicates the mesh's
    first rank's weights.  Returns ``(step, init)``."""
    n = axis_size(mesh, axis_name)

    def init(model):
        replicate(model, mesh)
        return optimizer_factory(model)

    def step(model, optimizer, inputs, targets):
        if inputs.shape[0] % n:
            raise ValueError(
                f"batch {inputs.shape[0]} not divisible by mesh axis "
                f"'{axis_name}' of size {n}")
        x, t = shard_batch((inputs, targets), mesh, axis_name)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, x, t)
        loss.backward()
        params = [p for g in optimizer.param_groups for p in g["params"]]
        allreduce_grads(params, mesh, axis_name)
        for p in params:
            if p.grad is not None:
                p.grad.div_(n)
        optimizer.step()
        total = loss.detach().clone()
        dist.all_reduce(total, group=mesh.get_group(axis_name))
        return total / n

    return step, init


def shard_batch(tree, mesh, axis_name: str = "batch"):
    """This rank's shard of the leading axis of each tensor of ``tree`` (a
    tensor, or a tuple or list of them); the axis size must divide it."""
    n = axis_size(mesh, axis_name)
    i = axis_index(mesh, axis_name)

    def part(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh "
                             f"axis '{axis_name}' of size {n}")
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]

    if isinstance(tree, (tuple, list)):
        return type(tree)(part(x) for x in tree)
    return part(tree)
