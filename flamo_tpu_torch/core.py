"""Module base and the trainable-only optimizer (counterpart of
``flamo_tpu/core.py``).

In the JAX package a module is an immutable pytree and a boolean mask
marks the trainable ``param`` leaves.  Here a module is an
``nn.Module`` whose raw parameters are ``nn.Parameter``s, and a module is
trainable exactly when its ``param`` has ``requires_grad`` set.
"""

from __future__ import annotations

import torch
from torch import nn


class Module(nn.Module):
    """Base class of every DSP module and container in the port."""

    @property
    def device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        raise AttributeError(f"{type(self).__name__} holds no tensors")


def trainable_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether the optimizer may change it."""
    return {name: p.requires_grad for name, p in model.named_parameters()}


def masked_optimizer(model: nn.Module, lr: float = 1e-3,
                     optimizer=torch.optim.Adam, **kwargs):
    """``optimizer`` over the trainable parameters only.

    Frozen parameters are not handed to the optimizer, so they get no
    state and no update, as optax's ``set_to_zero`` partition does in
    the JAX package."""
    params = [p for p in model.parameters() if p.requires_grad]
    return optimizer(params, lr=lr, **kwargs)


class TopologyMismatch(ValueError):
    """A model is not of the topology that a fused objective needs.  The
    ``extract_*`` operand functions raise it, and the Trainer's dispatch
    refuses a candidate on it and on nothing else."""
