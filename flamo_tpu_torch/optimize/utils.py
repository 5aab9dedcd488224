"""Optimization utilities (counterpart of ``flamo_tpu/optimize/utils.py``)."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from flamo_tpu_torch.utils import next_key


def generate_partitions(tensor: torch.Tensor, n_samples: int, n_sets: int,
                        seed: int | None = None, generator=None):
    """``n_sets`` shuffled equal partitions of a tensor, stacked to
    (n_sets * (len // n_samples), n_samples).  The permutations are drawn
    on the CPU from ``generator`` (or a new one seeded with ``seed``) and
    applied on the tensor's device."""
    if seed is not None:
        generator = torch.Generator().manual_seed(int(seed))
    generator = next_key(generator)
    length = tensor.shape[0]
    n_partitions = length // n_samples
    if length % n_samples != 0:
        warnings.warn("Tensor length is not divisible by n_samples so there "
                      "will be some samples left out.", stacklevel=2)
    sets = []
    for _ in range(n_sets):
        perm = torch.randperm(length, generator=generator)
        shuffled = tensor[perm.to(tensor.device)]
        sets.append(shuffled[:n_partitions * n_samples].reshape(
            n_partitions, n_samples))
    return torch.cat(sets, dim=0)


def run_in_chunks(step, n_steps: int, steps_per_call: int, start: int = 0,
                  on_chunk=None) -> np.ndarray:
    """Run ``step(i)`` for the global steps ``i = start .. start + n_steps
    - 1`` in chunks of at most ``steps_per_call`` and return the (n_steps,)
    float32 loss history.  ``step`` returns its loss as a 0-d tensor on
    the device; a chunk's losses stay there and reach the host in one copy
    at the chunk's end, where ``on_chunk(losses)`` sees them.  Exactly
    ``n_steps`` steps run (the last chunk may be shorter), the counterpart
    of the JAX package's ``lax.scan`` of ``steps_per_call`` steps a call."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    history = []
    done = 0
    while done < n_steps:
        k = min(steps_per_call, n_steps - done)
        losses = torch.stack([step(start + done + j) for j in range(k)])
        history.append(losses.cpu().numpy())
        if on_chunk is not None:
            on_chunk(history[-1])
        done += k
    return (np.concatenate(history) if history
            else np.zeros(0, dtype=np.float32))
