"""Time-aliasing mitigation (counterpart of
``examples/e6_anti_aliasing.py``): one four-channel FDN (delays 179,
211, 233, 251, attenuation 0.9995 a sample, an orthogonal feedback)
rendered with alias decay 0 and 30 dB; the 30 dB envelope must lower the
energy that wraps around into the frame before the first arrival.

    python -m flamo_tpu_torch.examples.e6_anti_aliasing [--device cpu]
        [--backend auto|pallas|xla]

``--backend auto`` (the default) solves the loop with the fused FDN
kernel K2 on the card (``Recursion(solve_method='pallas')``, through the
diagonal / flat split) and with the pivoted elimination 'ge' on the CPU.
Both IRs go to ``e6_alias.npz`` in ``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (example_parser, pick_backend,
                                              setup)
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

N = 4
DELAYS = (179, 211, 233, 251)
HEAD = slice(0, 178)  # the samples before the first delayed arrival


def build(nfft: int, alias_db: float, seed: int, device,
          solve_method: str = "ge"):
    """The FDN Shell: Series(input gain, Recursion(Series(delays,
    attenuation), orthogonal matrix), output gain) between rfft and irfft,
    every module at ``alias_db``.  The matrix is drawn from ``seed``, the
    two gains from ``seed + 1`` each (the same draws, as the JAX example's
    shared key)."""
    def gen(s):
        return torch.Generator().manual_seed(s)

    kw = dict(nfft=nfft, alias_decay_db=alias_db, device=device)
    dl = dsp.parallelDelay(size=(N,), max_len=max(DELAYS) + 1, isint=True,
                           generator=gen(seed), **kw)
    dl.assign_value(dl.sample2s(torch.tensor(DELAYS, dtype=torch.float32)))
    att = dsp.parallelGain(size=(N,), generator=gen(seed), **kw)
    att.assign_value(0.9995 ** torch.tensor(DELAYS, dtype=torch.float32))
    fb = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                    generator=gen(seed), **kw)
    ig = dsp.Gain(size=(N, 1), generator=gen(seed + 1), **kw)
    og = dsp.Gain(size=(1, N), generator=gen(seed + 1), **kw)
    loop = system.Recursion(
        fF=system.Series(OrderedDict({"d": dl, "a": att})), fB=fb,
        solve_method=solve_method)
    core = system.Series(OrderedDict({"i": ig, "l": loop, "o": og}))
    return system.Shell(core=core, input_layer=dsp.FFT(nfft),
                        output_layer=dsp.iFFT(nfft))


def impulse_responses(nfft: int, seed: int, device,
                      solve_method: str = "ge") -> dict:
    """alias decay (0 and 30 dB) -> the FDN's IR (nfft,), the alias
    envelope undone."""
    return {db: build(nfft, db, seed, device, solve_method)
            .get_time_response()[0, :, 0] for db in (0.0, 30.0)}


def pre_onset_energy(ir) -> float:
    return float(torch.sum(ir[HEAD] ** 2))


def main(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    irs = impulse_responses(args.nfft, args.seed, device,
                            "pallas" if backend == "pallas" else "ge")
    e0, e30 = (pre_onset_energy(irs[db]) for db in (0.0, 30.0))
    print("pre-onset energy alias=0 :", e0)
    print("pre-onset energy alias=30:", e30)
    if not e30 < e0:
        raise RuntimeError("the 30 dB envelope did not reduce the aliasing")
    print("aliasing reduced by the 30 dB decay envelope")
    path = os.path.join(args.train_dir, "e6_alias.npz")
    np.savez(path, ir0=irs[0.0].cpu().numpy(), ir30=irs[30.0].cpu().numpy())
    print("IRs:", path)
    return irs


def parser():
    ap = example_parser(nfft=8192)
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="'pallas': the loop on the kernel K2; 'xla': the "
                         "pivoted elimination; 'auto': 'pallas' on the "
                         "card, 'xla' on the CPU")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
