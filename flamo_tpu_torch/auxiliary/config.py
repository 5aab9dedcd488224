"""Configuration of :class:`~flamo_tpu_torch.auxiliary.reverb.HomogeneousFDN`
(counterpart of ``flamo_tpu/auxiliary/config.py``), a dataclass: the JAX
package's fields and defaults, checked when it is made.  An unknown key
raises ``TypeError`` (the JAX package's pydantic model forbids extra keys
with a ``ValidationError``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.reverb import coprime_delay_lengths
from flamo_tpu_torch.utils import resolve_device


def _torch_dtype(value) -> torch.dtype:
    """A dtype given as a torch dtype, a numpy dtype or its name, as a
    torch dtype."""
    if isinstance(value, torch.dtype):
        return value
    name = np.dtype(value).name
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype {value!r} has no torch counterpart")
    return dtype


@dataclass
class HomogeneousFDNConfig:
    """The FDN's order N, sampling, FFT size and alias decay, its delay
    lengths in samples (drawn from ``delay_range_ms`` by
    :func:`~flamo_tpu_torch.auxiliary.reverb.coprime_delay_lengths` when
    not given), which modules train, and the loop's ``solve_method`` ('ge',
    'ge_nopivot', 'pallas' or 'lu').  ``device`` None is the CUDA card
    (raising without one); ``dtype`` is held as a torch dtype."""

    N: int = 6
    alias_decay_db: int = 0
    rt60: Optional[float] = None
    sample_rate: int = 48000
    nfft: int = 96000
    device: Optional[object] = None
    dtype: object = torch.float32
    delays: Optional[List[int]] = None
    delay_range_ms: List[float] = field(default_factory=lambda: [20.0, 50.0])
    input_gain_grad: bool = True
    output_gain_grad: bool = True
    delays_grad: bool = False
    mixing_matrix_grad: bool = True
    attenuation_grad: bool = True
    is_delay_int: bool = True
    solve_method: str = "ge"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dtype = _torch_dtype(self.dtype)
        if self.delays is None:
            self.delay_length_samps()
        elif len(self.delays) != self.N:
            raise ValueError(f"Length of delays ({len(self.delays)}) must "
                             f"match N ({self.N})")

    def delay_length_samps(self) -> List[int]:
        """Coprime delay-line lengths for ``delay_range_ms`` (unseeded),
        set as ``delays`` and returned."""
        self.delays = coprime_delay_lengths(self.N, self.delay_range_ms,
                                            self.sample_rate)
        return self.delays
