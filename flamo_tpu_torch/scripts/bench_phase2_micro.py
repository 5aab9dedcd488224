"""Micro-benchmark of the attenuated-FDN step kernel's phase 2 (the (K, N)
SOS tap-cotangent loop of K5) on the CUDA card: the counterpart of
``scripts/bench_phase2_micro.py``, through the four hand-written kernels
of :mod:`flamo_tpu_torch.ops.phase2_micro` (K10).

Every variant runs the distinct section passes once.  It separates the
cost of the per-section arithmetic (Horner, divide: ``noreduce``, per-bin
sums over every pass and one reduction a block) from that of a reduction
a pass (``lanered``: one warp tree a pass, the cross-warp sum deferred),
and times what the function itself costs in its two formulations
(``full``: the sums in registers and one reduction a block of three
values; ``ps``: the prefix and suffix products of each channel, one
divide a channel), at the JAX script's sizes, which are K5's in the
attenuated FDN: nfft = 96000, P = 3 taps, K = 12 sections, N = 6
channels (S = 2 K N = 144 section passes), the cotangent ``t`` of ones
over the script's 48128 bins (48001 padded to whole 1024-bin tiles, so
bins past Nyquist are summed too) and taps uniform in [0.5, 1.5) from
seed 0.

Run on the card (it times by CUDA events, so it needs one):

    python -m flamo_tpu_torch.scripts.bench_phase2_micro [variant ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from flamo_tpu_torch.ops.phase2_micro import VARIANTS, phase2_micro
from flamo_tpu_torch.utils import resolve_device

NFFT = 96000
P = 3
K = 12
N = 6
# the JAX script's bin count: nfft // 2 + 1 bins padded to 1024-bin tiles
M_PADDED = -(-(NFFT // 2 + 1) // 1024) * 1024


def inputs(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's operands: ``t`` (2, 48128) of ones and the taps
    ``c`` (P, K, N), on ``device`` (default the card)."""
    dev = resolve_device(device)
    c = np.random.default_rng(0).uniform(0.5, 1.5, (P, K, N))
    return (torch.ones((2, M_PADDED), dtype=torch.float32, device=dev),
            torch.tensor(c.astype(np.float32), device=dev))


def _window_us(fn, k: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / k


def run(variant: str, k: int = 50, device=None):
    """The best of three windows of ``k`` calls (kernel and partial sum) of
    ``variant``, timed by CUDA events on the card ``device`` (default the
    card); prints and returns the (3,) result and the microseconds per
    call."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"run times the CUDA kernels by CUDA events; "
                         f"device {str(dev)!r} is no CUDA card")
    t, c = inputs(dev)

    def call():
        return phase2_micro(variant, t, c, NFFT)

    value = call()
    torch.cuda.synchronize(dev)
    with torch.cuda.device(dev):
        us = min(_window_us(call, k) for _ in range(3))
    print(f"{variant:9s}: {us:8.1f} us/call")
    return value, us


def main(argv: list[str]) -> int:
    dev = resolve_device()
    print(f"nfft={NFFT}, P={P}, K={K}, N={N}, {M_PADDED} bins on "
          f"{torch.cuda.get_device_name(dev)}")
    for variant in argv or VARIANTS:
        run(variant, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
