"""Optimization utilities (counterpart of ``flamo_tpu/optimize/utils.py``)."""

from __future__ import annotations

import warnings

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
