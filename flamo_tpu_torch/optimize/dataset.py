"""Datasets and loaders (counterpart of ``flamo_tpu/optimize/dataset.py``).

A dataset is one (input, target) pair expanded along dim 0, as in the
reference; the loader is a small batcher with static batch shapes
(drop_last).  The split and the shuffled batch order come from numpy's
``default_rng(seed)``, as in the JAX package, so both packages visit the
same indices in the same order.  The tensors live on an explicit device:
the CUDA card by default (raising without one), or the CPU when asked,
and a batch is gathered on that device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flamo_tpu_torch.utils import complex_dtype_for, resolve_device


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` on ``device``; a real tensor in ``dtype`` (default: torch's
    default float type, as the JAX package's float32 default), a complex
    one in the matching complex type."""
    x = torch.as_tensor(x, device=device)
    real = torch.get_default_dtype() if dtype is None else dtype
    if x.is_complex():
        return x.to(complex_dtype_for(real))
    return x.to(real)


class Dataset:
    """Single (input, target) pair expanded along dim 0 to ``expand``
    items (a broadcast view, no copy)."""

    def __init__(self, input=None, target=None, expand: int = 1, dtype=None,
                 device=None):
        device = resolve_device(device)
        if input is None:
            input = np.random.randn(1, 1)
        if target is None:
            target = np.random.randn(1, 1)
        input = _as_tensor(input, dtype, device)
        target = _as_tensor(target, dtype, device)
        self.expand = int(expand)
        self.input = input.expand((self.expand, *input.shape[1:]))
        self.target = target.expand((self.expand, *target.shape[1:]))

    @property
    def device(self) -> torch.device:
        return self.input.device

    def __len__(self):
        return self.target.shape[0]

    def __getitem__(self, index):
        return self.input[index], self.target[index]

    def gather(self, indices):
        """The items at ``indices``, stacked along dim 0 on the device."""
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.long,
                                  device=self.device)
        return self.input[indices], self.target[indices]


class DatasetColorless(Dataset):
    """Impulse input, all-ones (flat magnitude) target (arXiv:2402.11216)."""

    def __init__(self, input_shape: tuple, target_shape: tuple,
                 expand: int = 1000, dtype: torch.dtype = torch.float32,
                 device=None):
        device = resolve_device(device)
        input = torch.zeros(input_shape, dtype=dtype, device=device)
        input[:, 0, :] = 1.0
        target = torch.ones(target_shape, dtype=dtype, device=device)
        super().__init__(input=input, target=target, expand=expand,
                         dtype=dtype, device=device)


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        return self.dataset[self.indices[index]]

    def gather(self, indices):
        return self.dataset.gather(self.indices[np.asarray(indices)])


class DataLoader:
    """Static-shape batcher: ``len(dataset) // batch_size`` batches a pass
    (drop_last), in the order of ``default_rng(seed).shuffle`` when
    ``shuffle``; the generator advances once a pass, as JAX's does."""

    def __init__(self, dataset, batch_size: int = 2000, shuffle: bool = True,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if hasattr(self.dataset, "gather"):
                yield self.dataset.gather(idx)
            else:
                xs, ys = zip(*(self.dataset[i] for i in idx))
                yield torch.stack(xs), torch.stack(ys)


def get_dataloader(dataset, batch_size: int = 2000, shuffle: bool = True,
                   seed: Optional[int] = None):
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      seed=seed)


def split_dataset(dataset, split: float, seed: Optional[int] = None):
    """Random train/valid split: the first ``int(len * split)`` items of
    ``default_rng(seed).permutation(len)`` train."""
    n = len(dataset)
    train_size = int(n * split)
    perm = np.random.default_rng(seed).permutation(n)
    return (_Subset(dataset, perm[:train_size]),
            _Subset(dataset, perm[train_size:]))


def load_dataset(dataset, batch_size: int = 2000, split: float = 0.8,
                 shuffle: bool = True, seed: Optional[int] = None):
    """Split, then one loader for each part (both shuffled from ``seed``)."""
    train_set, valid_set = split_dataset(dataset, split, seed=seed)
    return (get_dataloader(train_set, batch_size=batch_size, shuffle=shuffle,
                           seed=seed),
            get_dataloader(valid_set, batch_size=batch_size, shuffle=shuffle,
                           seed=seed))


def stack_loader(loader):
    """One pass of ``loader`` stacked to ``(S, B, ...)`` inputs and targets
    for :meth:`Trainer.fit_scan_epochs`; the batch order is frozen at
    stacking time.  Raises ValueError on an empty loader."""
    xs, ys = zip(*iter(loader))
    return torch.stack(xs), torch.stack(ys)
