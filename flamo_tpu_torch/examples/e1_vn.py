"""Velvet-noise filter (counterpart of ``examples/e1_vn.py``): a SISO
``VelvetNoiseFilter`` of nfft / 8 taps at 1000 impulses a second in an
rfft / irfft Shell, its impulse response, then a fresh draw.

    python -m flamo_tpu_torch.examples.e1_vn [--device cpu]

``resample`` draws in place (the JAX package returns a new module), so
the Shell renders the new impulses without a new core.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.auxiliary.velvet import VelvetNoiseFilter
from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device


def main(args):
    device = resolve_device(args.device)
    nfft = args.nfft
    v = VelvetNoiseFilter(size=(nfft // 8, 1, 1), density=1000.0,
                          sample_rate=args.samplerate, nfft=nfft,
                          device=device)
    model = system.Shell(core=v, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.iFFT(nfft))
    x = signal_gallery(1, nfft, 1, "impulse", device=device)
    with torch.no_grad():
        y = model(x)
        nz = int(torch.sum(torch.abs(y) > 1e-6))
        print(f"velvet IR: {nz} nonzero samples of {nfft}")
        if nz != v.floor_impulses:
            raise RuntimeError(f"{nz} impulses, not {v.floor_impulses}")
        v.resample()
        y2 = model(x)
    differs = bool(torch.abs(y - y2).max() > 0)
    print("resampled differs:", differs)
    if not differs:
        raise RuntimeError("resample drew the same impulses")
    return y, y2


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096).parse_args()))
