"""Multi-seed ensemble training (counterpart of
``flamo_tpu/parallel/ensemble.py``).

S independently seeded instances of one model train at once: their
parameters are stacked on a leading seed axis
(``torch.func.stack_module_state``) and the loss runs over the members
with ``torch.func.vmap`` of a ``functional_call``.  Adam is elementwise,
so one Adam over the stacked tensors is S independent Adams.  With a
``'seed'`` mesh every rank holds its share of the members and nothing
crosses ranks until the losses are gathered.

``vmap`` cannot cross a hand-written kernel's launch (its wrapper hands
raw device pointers to the library), so a loss that reaches one runs its
members one after another: ``vmap=False``.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.parallel.mesh import axis_index, axis_size


class _Loss(nn.Module):
    """``loss_fn(model, inputs, targets)`` as a module, so that
    ``functional_call`` swaps the model's tensors for a member's."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, inputs, targets):
        return self.loss_fn(self.model, inputs, targets)


class MultiSeedEnsemble:
    """Train ``n_seeds`` instances of ``model_fn(generator) -> model``,
    member i drawn from ``torch.Generator().manual_seed(base_seed + i)``.

    Example::

        ens = MultiSeedEnsemble(build, n_seeds=8, mesh=get_mesh(2, 'seed'))
        losses = ens.fit(colorless_loss, inputs, targets, n_steps=100)
        best = ens.best_model()

    With a mesh, each rank builds and trains only its members (the axis
    size must divide ``n_seeds``); every rank of the mesh must make the
    same calls."""

    def __init__(self, model_fn: Callable, n_seeds: int, mesh=None,
                 axis_name: str = "seed", base_seed: int = 0,
                 vmap: bool = True):
        self.n_seeds = n_seeds
        self.mesh = mesh
        self.axis_name = axis_name
        self.vmap = vmap
        n = 1 if mesh is None else axis_size(mesh, axis_name)
        if n_seeds % n:
            raise ValueError(f"{n_seeds} seeds not divisible by mesh axis "
                             f"'{axis_name}' of size {n}")
        per = n_seeds // n
        self.first = 0 if mesh is None else axis_index(mesh, axis_name) * per
        self.members = [
            model_fn(torch.Generator().manual_seed(base_seed + i))
            for i in range(self.first, self.first + per)]
        self.template = self.members[0]
        self.losses = None

    def _stacked(self):
        """(trainable, frozen) stacked state of the members: name ->
        (S_local, ...) tensor; the trainable ones are leaves that take a
        gradient."""
        params, buffers = torch.func.stack_module_state(self.members)
        grad = {k: p.requires_grad
                for k, p in self.template.named_parameters()}
        trainable = {k: v for k, v in params.items() if grad[k]}
        frozen = {k: v.detach() for k, v in params.items()
                  if k not in trainable}
        frozen.update(buffers)
        return trainable, frozen

    def _fit_vmap(self, loss_fn, inputs, targets, n_steps, lr):
        trainable, frozen = self._stacked()
        opt = torch.optim.Adam(list(trainable.values()), lr=lr)
        base = _Loss(copy.deepcopy(self.template).to("meta"), loss_fn)

        def member(tr, fz):
            state = {"model." + k: v for k, v in {**tr, **fz}.items()}
            return torch.func.functional_call(base, state,
                                              (inputs, targets))

        history = []
        for _ in range(n_steps):
            opt.zero_grad(set_to_none=True)
            losses = torch.func.vmap(member)(trainable, frozen)
            losses.sum().backward()
            opt.step()
            history.append(losses.detach())
        with torch.no_grad():
            for i, m in enumerate(self.members):
                for k, p in m.named_parameters():
                    if k in trainable:
                        p.copy_(trainable[k][i])
        return torch.stack(history)

    def _fit_loop(self, loss_fn, inputs, targets, n_steps, lr):
        opts = [masked_optimizer(m, lr=lr) for m in self.members]
        history = []
        for _ in range(n_steps):
            row = []
            for m, opt in zip(self.members, opts):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(m, inputs, targets)
                loss.backward()
                opt.step()
                row.append(loss.detach())
            history.append(torch.stack(row))
        return torch.stack(history)

    def fit(self, loss_fn: Callable, inputs, targets, n_steps: int = 100,
            lr: float = 1e-3) -> torch.Tensor:
        """Train every member ``n_steps`` Adam steps on
        ``loss_fn(model, inputs, targets)`` (a scalar) and return the
        (n_steps, n_seeds) losses before each step, all seeds on every
        rank.  Each member's optimizer starts afresh."""
        run = self._fit_vmap if self.vmap else self._fit_loop
        local = run(loss_fn, inputs, targets, n_steps, lr)
        losses = local.new_zeros((n_steps, self.n_seeds))
        losses[:, self.first:self.first + local.shape[1]] = local
        if self.mesh is not None:
            dist.all_reduce(losses,
                            group=self.mesh.get_group(self.axis_name))
        self.losses = losses
        return losses

    def model_at(self, seed_idx: int):
        """Member ``seed_idx``'s model, on every rank (its owner
        broadcasts its tensors into a copy of this rank's first member)."""
        per = len(self.members)
        owner, i = divmod(int(seed_idx), per)
        if self.mesh is None:
            return self.members[i]
        model = copy.deepcopy(self.members[i] if owner * per == self.first
                              else self.template)
        group = self.mesh.get_group(self.axis_name)
        src = dist.get_global_rank(group, owner)
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                view = torch.view_as_real(t) if t.is_complex() else t
                dist.broadcast(view, src=src, group=group)
        return model

    def best_model(self):
        """The model of the seed with the lowest final loss."""
        if self.losses is None:
            raise RuntimeError("call fit() first")
        return self.model_at(int(torch.argmin(self.losses[-1])))
