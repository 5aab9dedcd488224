"""Manual module chaining (counterpart of
``examples/e2_chaining_filters.py``): a SISO parallelGain -> Delay chain,
its 2-in 3-out version, ``assign_value`` and ``requires_grad``.

    python -m flamo_tpu_torch.examples.e2_chaining_filters [--device cpu]

``assign_value`` writes in place and returns the module itself, as the
reference's modules do (the JAX package returns a new module and leaves
the original untouched).  The IRs go to ``e2_chaining.npz`` in
``--train_dir``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.core import trainable_mask
from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.processor import dsp
from flamo_tpu_torch.utils import resolve_device


def _chain(args, g, d, in_ch: int, device):
    x = signal_gallery(1, args.nfft, in_ch, "impulse", fs=args.samplerate,
                       device=device)
    with torch.no_grad():
        return dsp.iFFT(args.nfft)(d(g(dsp.FFT(args.nfft)(x))))


def scenario_siso(args, device):
    """parallelGain -> Delay on an impulse: one scaled, delayed impulse."""
    g = dsp.parallelGain(size=(1,), nfft=args.nfft, device=device)
    d = dsp.Delay(size=(1, 1), max_len=700, isint=True, nfft=args.nfft,
                  fs=args.samplerate, device=device)
    y = _chain(args, g, d, 1, device)
    delay_samples = float(d.s2sample(d.param[0, 0]))
    peak = int(torch.argmax(torch.abs(y[0, :, 0])))
    print(f"siso chain: gain {float(g.param[0]):.2f}, delay "
          f"{delay_samples:.0f} samples, IR peak at {peak}")
    if abs(peak - round(delay_samples)) > 1:
        raise RuntimeError("the IR's peak is not at the delay")
    return y


def scenario_mimo(args, device):
    """2 in, 3 out: the parallelGain acts channel-wise, the Delay matrix
    mixes, so each output holds two delayed impulses."""
    in_ch, out_ch = 2, 3
    g = dsp.parallelGain(size=(in_ch,), nfft=args.nfft, device=device)
    d = dsp.Delay(size=(out_ch, in_ch), max_len=1000, isint=True,
                  nfft=args.nfft, fs=args.samplerate, device=device)
    y = _chain(args, g, d, in_ch, device)
    print(f"mimo chain: output {tuple(y.shape)} (two impulses per channel)")
    if tuple(y.shape) != (1, args.nfft, out_ch):
        raise RuntimeError(f"output shape {tuple(y.shape)}")
    return y


def scenario_assign_values(args, device):
    """assign_value writes in place and returns the module: the chain
    then carries the assigned gains and delays."""
    in_ch, out_ch = 2, 3
    g = dsp.parallelGain(size=(in_ch,), nfft=args.nfft, device=device)
    d = dsp.Delay(size=(out_ch, in_ch), max_len=1000, isint=True,
                  nfft=args.nfft, fs=args.samplerate, device=device)
    g2 = g.assign_value(torch.tensor([0.5, -1.0]))
    d2 = d.assign_value(d.sample2s(torch.tensor(
        [[100.0, 400.0], [200.0, 500.0], [300.0, 600.0]])))
    if g2 is not g or d2 is not d:
        raise RuntimeError("assign_value did not return the module itself")
    y = _chain(args, g2, d2, in_ch, device)
    y0 = y[0, :, 0].cpu().numpy()
    print(f"assigned delays: peaks at {np.sort(np.argsort(np.abs(y0))[-2:])}")
    # output 0 = 0.5 delta(n - 100) - 1.0 delta(n - 400)
    if not (abs(y0[100] - 0.5) < 1e-4 and abs(y0[400] + 1.0) < 1e-4):
        raise RuntimeError("the assigned chain's IR is wrong")
    print("assign_value writes in place and returns the module")
    return y


def scenario_requires_grad(args, device):
    """requires_grad decides which parameters the optimizer may change."""
    g = dsp.Gain(size=(2, 1), nfft=args.nfft, requires_grad=True,
                 device=device)
    bq = dsp.parallelBiquad(size=(2,), n_sections=1, filter_type="highpass",
                            nfft=args.nfft, fs=args.samplerate, device=device)
    if trainable_mask(g) != {"param": True} or \
            trainable_mask(bq) != {"param": False}:
        raise RuntimeError("the trainable masks are wrong")
    print("requires_grad -> trainable mask: gain True, frozen biquad False")


def main(args):
    device = resolve_device(args.device)
    irs = {"siso": scenario_siso(args, device),
           "mimo": scenario_mimo(args, device),
           "assigned": scenario_assign_values(args, device)}
    scenario_requires_grad(args, device)
    np.savez(os.path.join(args.train_dir, "e2_chaining.npz"),
             **{k: v[0].cpu().numpy() for k, v in irs.items()})
    return irs


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096).parse_args()))
