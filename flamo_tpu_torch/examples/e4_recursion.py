"""Closed-loop Recursion (counterpart of ``examples/e4_recursion.py``):
three integer delays and a 0.6 attenuation in the feedforward path
against an orthogonal feedback, its input-free IRs and magnitude
responses, and its stability: the open-loop matrix's spectral radius
over probed bins stays below 1.

    python -m flamo_tpu_torch.examples.e4_recursion [--device cpu]

The IRs and the diagonal magnitudes go to ``e4_loop.npz`` in
``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import get_eigenvalues
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

N = 3


def build(nfft: int, device):
    """(model, loop): the Recursion in an FFT/iFFT Shell."""
    kw = dict(nfft=nfft, device=device)
    delays = dsp.parallelDelay(size=(N,), max_len=300, isint=True, **kw)
    atten = dsp.parallelGain(size=(N,), **kw)
    atten.assign_value(0.6 * torch.ones(N))
    ff = system.Series(OrderedDict({"delays": delays,
                                    "attenuation": atten}))
    fb = dsp.Matrix(size=(N, N), matrix_type="orthogonal", **kw)
    loop = system.Recursion(fF=ff, fB=fb)
    model = system.Shell(core=loop, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.iFFT(nfft))
    return model, loop


def open_loop_radius(loop, nfft: int) -> float:
    """max |eigenvalue| of F(z) B(z) = I - P(z) over every 64th bin below
    Nyquist, P = ``probe_recursion``."""
    z = torch.exp(1j * 2 * torch.pi * torch.arange(
        0, nfft // 2, 64, device=loop.device) / nfft).to(torch.complex64)
    with torch.no_grad():
        P = torch.stack([loop.probe_recursion(zz) for zz in z])
        eye = torch.eye(N, dtype=P.dtype, device=P.device)
        return float(torch.abs(get_eigenvalues(eye - P)).max())


def main(args):
    model, loop = build(args.nfft, resolve_device(args.device))
    ir = model.get_time_response(fs=args.samplerate, identity=True)
    print("closed-loop input-free IRs:", tuple(ir.shape))
    energy = float(torch.sum(ir ** 2))
    print("loop IR energy:", energy)
    if not np.isfinite(energy):
        raise RuntimeError("the loop's IR energy is not finite")
    H = model.get_freq_response(fs=args.samplerate, identity=True)
    np.savez(os.path.join(args.train_dir, "e4_loop.npz"),
             ir=ir[0].cpu().numpy(),
             mag=torch.abs(torch.diagonal(H[0], dim1=-2, dim2=-1))
             .cpu().numpy())
    rho = open_loop_radius(loop, args.nfft)
    print(f"open-loop spectral radius over probed bins: {rho:.3f} (< 1)")
    if not rho < 1.0:
        raise RuntimeError(f"open-loop spectral radius {rho} >= 1")
    return rho


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096).parse_args()))
