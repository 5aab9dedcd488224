"""Velvet-noise filters (counterpart of ``flamo_tpu/auxiliary/velvet.py``).

Velvet noise is sparse +-1/0 pseudo-random noise used in artificial
reverberation (Valimaki & Prawda 2021).  The impulses are drawn from an
explicit ``torch.Generator`` at construction and again by
:meth:`VelvetNoiseFilter.resample`, which draws in place and returns the
module (the JAX package returns a new module; the draws are another
PRNG's than JAX's, and a filter carried over from JAX copies its drawn
``param``).
"""

from __future__ import annotations

import math

import torch

from flamo_tpu_torch.processor.dsp import Filter, _identity
from flamo_tpu_torch.utils import next_key


class VelvetNoiseFilter(Filter):
    """FIR filter whose taps are a velvet-noise sequence per channel pair.

    size: (length, N_out, N_in); ``density`` in impulses a second; one
    impulse per grid cell of Td = sample_rate / density samples, the
    first at 0, the others jittered within their cell by ``delta`` (in
    (0, 1]), signs +-1, indices clipped to length - 1."""

    def __init__(self, size=(1, 1, 1), density: float = 1000.0,
                 delta: float = 1.0, sample_rate: int = 48000, nfft=2**11,
                 requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        if not 0 < delta <= 1:
            raise ValueError("Delta must be in range (0, 1]")
        self.density = density
        self.sample_rate = sample_rate
        self.Td = sample_rate / density
        self.delta = delta
        self.floor_impulses = math.floor(size[0] / self.Td)
        super().__init__(size=size, nfft=nfft, map=_identity,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def init_param(self, generator):
        return self._generate(generator)

    def _generate(self, generator) -> torch.Tensor:
        """Velvet sequences for all channel pairs, (T, N_out, N_in), drawn
        on the CPU: the jitter first, then the signs."""
        T, n_out, n_in = self.size
        n_seq = n_out * n_in
        F = self.floor_impulses
        grid = torch.arange(F, dtype=self.dtype) * self.Td
        jitter = torch.rand((n_seq, F), generator=generator, dtype=self.dtype)
        idx = torch.ceil(grid[None, :] + self.delta * jitter * (self.Td - 1))
        idx = idx.to(torch.int64)
        idx[:, 0] = 0
        idx = torch.clamp(idx, 0, T - 1)
        signs = (2 * torch.randint(0, 2, (n_seq, F), generator=generator)
                 - 1).to(self.dtype)
        seq = torch.zeros((n_seq, T), dtype=self.dtype)
        rows = torch.arange(n_seq)[:, None].expand(idx.shape)
        seq[rows, idx] = signs
        return seq.T.reshape(T, n_out, n_in)

    def resample(self, generator=None) -> "VelvetNoiseFilter":
        """Draw fresh impulses from ``generator`` (default the global
        stream) into ``param``, in place, and return the module."""
        seq = self._generate(next_key(generator))
        with torch.no_grad():
            self.param.copy_(seq.to(self.param.device))
        return self
