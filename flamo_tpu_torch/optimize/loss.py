"""Losses of the FDN and active-acoustics objectives (counterpart of the
matching subset of ``flamo_tpu/optimize/loss.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from flamo_tpu_torch.functional import eigvals
from flamo_tpu_torch.optimize.utils import generate_partitions
from flamo_tpu_torch.utils import next_key, resolve_device


class sparsity_loss:
    """FDN mixing-matrix sparsity (arXiv:2402.11216):
    -(sum|A| - N sqrt N) / (N (sqrt N - 1)), with A the mapped feedback
    matrix of ``model.get_core().feedback_loop``."""

    name = "sparsity"

    def __call__(self, y_pred, y_true, model):
        core = model.get_core()
        try:
            mixing_matrix = core.feedback_loop.feedback
            A = mixing_matrix.map(mixing_matrix.param)
        except (AttributeError, KeyError):
            mixing_matrix = core.feedback_loop.feedback.mixing_matrix
            A = mixing_matrix.map(mixing_matrix.param)
        A = torch.real(A) if A.is_complex() else A
        N = A.shape[-1]
        if A.ndim == 3:
            return torch.mean(
                (torch.sum(torch.abs(A), dim=(-2, -1)) - N * math.sqrt(N))
                / (N * (1 - math.sqrt(N))))
        return -(torch.sum(torch.abs(A)) - N * math.sqrt(N)) \
            / (N * (math.sqrt(N) - 1))


class mse_loss:
    """MSE of the summed prediction channels against the target with its
    last axis squeezed when that axis is 1."""

    name = "MSE"

    def __init__(self, nfft: int | None = None, **kwargs):
        self.nfft = nfft

    def __call__(self, y_pred, y_true):
        y_pred_sum = torch.sum(y_pred, dim=-1)
        if y_true.shape[-1] == 1:
            y_true = torch.squeeze(y_true, dim=-1)
        return torch.mean((y_pred_sum - y_true) ** 2)


class masked_mse_loss:
    """MSE over random partitions of the bin axis.

    The partitions of cycle ``c = step // n_masks`` are a pure function of
    a base seed (drawn once from ``generator``) and c: a fresh
    ``torch.Generator`` seeded from both draws them, so every caller that
    names a step sees the same mask.  They are not JAX's masks (another
    PRNG).  The masks live on ``device`` (default the CUDA card, raising
    without one, as every entry point; ``device="cpu"`` to run there); the
    last cycle's are kept, so a training loop draws each cycle once."""

    name = "maskedMSE"
    stateful = True

    def __init__(self, nfft: int, n_samples: int, n_sets: int = 1,
                 regenerate_mask: bool = True, generator=None, device=None,
                 **kwargs):
        self.nfft = nfft
        self.n_samples = n_samples
        self.n_sets = n_sets
        self.regenerate_mask = regenerate_mask
        self.device = resolve_device(device)
        self._base_seed = int(torch.randint(
            0, 2**62, (1,), generator=next_key(generator)))
        self._cached = None
        self.mask_indices = self.masks_for_cycle(0)
        self.n_masks = self.mask_indices.shape[0]
        self._calls = 0
        self._cycle = 0

    def masks_for_cycle(self, cycle: int) -> torch.Tensor:
        """(n_masks, n_samples) bin indices of regeneration cycle
        ``cycle``."""
        cycle = int(cycle)
        if self._cached is None or self._cached[0] != cycle:
            seed = np.random.SeedSequence(
                [self._base_seed, cycle]).generate_state(1, np.uint64)[0]
            masks = generate_partitions(
                torch.arange(self.nfft // 2 + 1, device=self.device),
                self.n_samples, self.n_sets,
                generator=torch.Generator().manual_seed(int(seed)))
            self._cached = (cycle, masks)
        return self._cached[1]

    def pre_step(self):
        """Host-side hook before each step of a loop that does not pass
        ``step``: advances ``mask_indices`` to the next cycle when the
        masks of this one are used up."""
        self._calls += 1
        if self.regenerate_mask:
            cycle = (self._calls - 1) // self.n_masks
            if cycle != self._cycle:
                self._cycle = cycle
                self.mask_indices = self.masks_for_cycle(cycle)

    def __call__(self, y_pred, y_true, step=None, state=None):
        if step is None:
            masks = self.mask_indices if state is None else state
            mask = masks[0]
        elif self.regenerate_mask:
            step = int(step)
            mask = self.masks_for_cycle(step // self.n_masks)[
                step % self.n_masks]
        else:
            masks = self.mask_indices if state is None else state
            mask = masks[int(step) % masks.shape[0]]
        mask = mask.to(y_pred.device)
        return torch.mean((y_pred[:, mask] - y_true[:, mask]) ** 2)


class mse_evs:
    """Eigenvalue-magnitude MSE over cycling bin partitions: the
    active-acoustics training objective.  ``y_pred`` is the loop-matrix
    spectrum (B, M, N, N) (``ActiveAcoustics.F_MM`` on diag-embedded
    impulses), ``y_true`` the target magnitudes (B, M, N).  Step ``step``
    reads partition ``step % n_masks`` of ``ceil(freq_points / iter_num)``
    bins, so every bin is seen once per cycle; the eigenvalues come from
    :func:`flamo_tpu_torch.functional.eigvals` (``torch.linalg.eigvals``
    and its autograd).  The partitions are drawn from ``generator``
    (another PRNG than JAX's) and live on ``device`` (default the CUDA
    card, raising without one, as every entry point; ``device="cpu"`` to
    run there), so a step on that device copies none; ``mask_indices``
    may be replaced by the caller's."""

    name = "MSE_evs"
    stateful = True

    def __init__(self, iter_num: int, freq_points: int, generator=None,
                 device=None, **kwargs):
        self.iter_num = int(iter_num)
        self.freq_points = int(freq_points)
        self.device = resolve_device(device)
        n_samples = int(math.ceil(freq_points / iter_num))
        self.mask_indices = generate_partitions(
            torch.arange(self.freq_points, device=self.device), n_samples, 1,
            generator=generator)
        self.n_masks = self.mask_indices.shape[0]

    def __call__(self, y_pred, y_true, step=None, state=None):
        masks = self.mask_indices if state is None else state
        i = 0 if step is None else int(step) % masks.shape[0]
        idx = masks[i].to(y_pred.device)
        evs_pred = torch.abs(eigvals(y_pred[:, idx]))
        return torch.mean((evs_pred - y_true[:, idx]) ** 2)
