"""Consistency of the three response paths (counterpart of
``examples/e10_probe.py``): a three-channel FDN's z-plane probe over the
rfft grid, its core's forward on an all-ones spectrum and its Shell's
rendered frequency response agree to < 5e-3.

    python -m flamo_tpu_torch.examples.e10_probe [--device cpu]

The probe is batched over the grid with ``torch.func.vmap`` (JAX's vmap);
the three responses go to ``e10_responses.npz`` in ``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

N = 3
DELAYS = (89, 97, 107)
TOL = 5e-3


def build(nfft: int, device):
    """(model, core): input gain -> Recursion(delays, 0.8 attenuation;
    orthogonal feedback) -> output gain, in an FFT/iFFT Shell."""
    kw = dict(nfft=nfft, device=device)
    dl = dsp.parallelDelay(size=(N,), max_len=max(DELAYS) + 1, isint=True,
                           **kw)
    dl.assign_value(dl.sample2s(torch.tensor(DELAYS, dtype=torch.float32)))
    att = dsp.parallelGain(size=(N,), **kw)
    att.assign_value(0.8 * torch.ones(N))
    fb = dsp.Matrix(size=(N, N), matrix_type="orthogonal", **kw)
    loop = system.Recursion(
        fF=system.Series(OrderedDict({"d": dl, "a": att})), fB=fb)
    core = system.Series(OrderedDict({
        "i": dsp.Gain(size=(N, 1), **kw), "l": loop,
        "o": dsp.Gain(size=(1, N), **kw)}))
    model = system.Shell(core=core, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.iFFT(nfft))
    return model, core


def response_paths(model, core, fs: int):
    """(H_render, H_probe, H_fwd), each (M,) complex on the host."""
    nfft = model.nfft
    M = nfft // 2 + 1
    device = model.device
    with torch.no_grad():
        H_render = model.get_freq_response(fs=fs)[0, :, 0]
        zs = torch.exp(1j * 2 * torch.pi * torch.arange(M, device=device)
                       / nfft).to(torch.complex64)
        H_probe = torch.func.vmap(lambda z: model.probe(z)[0, 0])(zs)
        X = torch.ones((1, M, 1), dtype=torch.complex64, device=device)
        H_fwd = core(X)[0, :, 0]
    return tuple(h.cpu().numpy() for h in (H_render, H_probe, H_fwd))


def path_errors(H_render, H_probe, H_fwd) -> dict:
    return {"probe - render": float(np.abs(H_probe - H_render).max()),
            "forward - render": float(np.abs(H_fwd - H_render).max()),
            "probe - forward": float(np.abs(H_probe - H_fwd).max())}


def main(args):
    model, core = build(args.nfft, resolve_device(args.device))
    paths = response_paths(model, core, args.samplerate)
    np.savez(os.path.join(args.train_dir, "e10_responses.npz"),
             **dict(zip(("render", "probe", "forward"), paths)))
    errors = path_errors(*paths)
    for name, err in errors.items():
        print(f"|{name}| = {err:.2e}")
    if not all(err < TOL for err in errors.values()):
        raise RuntimeError(f"the three response paths differ: {errors}")
    print("all three response paths agree")
    return errors


if __name__ == "__main__":
    main(setup(example_parser(nfft=2048).parse_args()))
