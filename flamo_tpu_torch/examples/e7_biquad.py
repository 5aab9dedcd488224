"""Biquad matching (counterpart of ``examples/e7_biquad.py``): three
scenarios.

* ``biquad``: train a 2 x 1 two-section highpass Biquad against the
  magnitude of a random highpass cascade (fc ~ U(0, fs/2), gain ~
  U(-1, 1) dB);
* ``parallel_biquad``: the diagonal variant, 2 channels;
* ``fixed``: a 1 x 2 highpass Biquad trained to a known two-section
  cascade.

    python -m flamo_tpu_torch.examples.e7_biquad [--device cpu]
        [--scenario biquad|parallel_biquad|fixed|all]

Each writes its losses and a ``.npz`` of the target, initial and trained
magnitudes into ``--train_dir``.  The targets are drawn from a
``torch.Generator`` seeded by ``--seed`` (another PRNG than JAX's).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (PlainMSE, example_parser,
                                              filter_shell, setup,
                                              train_filter_to_target)
from flamo_tpu_torch.functional import (biquad2tf, highpass_filter,
                                        signal_gallery)
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.trainer import Trainer
from flamo_tpu_torch.processor import dsp
from flamo_tpu_torch.utils import resolve_device


def cascade_target(b, a, nfft: int, device) -> torch.Tensor:
    """The response of the (3, K, ...) cascade (b, a), product over its
    sections, (M, ...) complex64 on ``device`` (numpy's rffts in float64,
    as the JAX example)."""
    B = np.fft.rfft(b.cpu().numpy(), nfft, axis=0)
    A = np.fft.rfft(a.cpu().numpy(), nfft, axis=0)
    return torch.tensor(np.prod(B, axis=1) / np.prod(A, axis=1),
                        dtype=torch.complex64, device=device)


def impulse_target(args, target_filter, in_ch: int, mimo: bool):
    """|target_filter| applied to an impulse in every input channel,
    (1, M, out)."""
    x = signal_gallery(1, n_samples=args.nfft, n=in_ch,
                       signal_type="impulse", fs=args.samplerate,
                       device=target_filter.device)
    X = torch.fft.rfft(x, args.nfft, dim=1)
    if mimo:
        return torch.abs(torch.einsum("mji,bmi->bmj", target_filter, X))
    return torch.abs(target_filter[None] * X)


def random_highpass_target(args, seed: int, shape, device):
    generator = torch.Generator().manual_seed(seed)
    fc = args.samplerate / 2 * torch.rand(shape, generator=generator)
    gain = torch.rand(shape, generator=generator) * 2.0 - 1.0
    b, a = highpass_filter(fc=fc, gain=gain, fs=args.samplerate)
    return cascade_target(b, a, args.nfft, device)


def scenario_biquad(args, device, **kw):
    """(filter, target magnitude, input channels, tag)."""
    in_ch, out_ch, n_sections = 1, 2, 2
    target = impulse_target(args, random_highpass_target(
        args, args.seed, (n_sections, out_ch, in_ch), device), in_ch,
        mimo=True)
    filt = dsp.Biquad(size=(out_ch, in_ch), n_sections=n_sections,
                      filter_type="highpass", nfft=args.nfft,
                      fs=args.samplerate, requires_grad=True,
                      alias_decay_db=30, device=device, **kw)
    return filt, target, in_ch, "biquad"


def scenario_parallel_biquad(args, device, **kw):
    ch, n_sections = 2, 2
    target = impulse_target(args, random_highpass_target(
        args, args.seed + 1, (n_sections, ch), device), ch, mimo=False)
    filt = dsp.parallelBiquad(size=(ch,), n_sections=n_sections,
                              filter_type="highpass", nfft=args.nfft,
                              fs=args.samplerate, requires_grad=True,
                              alias_decay_db=30, device=device, **kw)
    return filt, target, ch, "parallel_biquad"


def scenario_fixed(args, device, **kw):
    """(filter, target magnitude (1, M, 1), input): a 1 x 2 highpass Biquad
    and the magnitude of a known two-section cascade, an impulse of M
    samples in each of two channels."""
    nfft = args.nfft
    filt = dsp.Biquad(size=(1, 2), n_sections=2, filter_type="highpass",
                      nfft=nfft, fs=args.samplerate, requires_grad=True,
                      device=device, **kw)
    b1, a1 = highpass_filter(fc=4000.0, gain=4.0, fs=args.samplerate)
    b2, a2 = highpass_filter(fc=8000.0, gain=-2.0, fs=args.samplerate)
    target = torch.abs(biquad2tf(b1, a1, nfft)
                       * biquad2tf(b2, a2, nfft))[None, :, None]
    x = signal_gallery(1, nfft // 2 + 1, 2, "impulse", device=device)
    return filt, target.to(device), x


def fixed_trainer(args, filt, target, x, log: bool = True):
    """The fixed demo's Trainer (the Trainer's own schedule and patience)
    and its loaders."""
    ds = Dataset(input=x, target=target, expand=args.num, device=x.device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(filter_shell(filt, args.nfft),
                      max_epochs=args.max_epochs, lr=args.lr, log=log,
                      train_dir=args.train_dir)
    trainer.register_criterion(PlainMSE(), 1)
    return trainer, tl, vl


def example_fixed(args, device):
    """A 1 x 2 highpass Biquad trained to a known two-section cascade."""
    filt, target, x = scenario_fixed(args, device)
    trainer, tl, vl = fixed_trainer(args, filt, target, x)
    with torch.no_grad():
        H_init = torch.abs(filt.response())[:, 0, 0]
    trainer.train(tl, vl)
    with torch.no_grad():
        H_opt = torch.abs(trainer.net.get_core().response())[:, 0, 0]
    np.savez(os.path.join(args.train_dir, "e7_biquad_mag.npz"),
             target=target[0, :, 0].cpu().numpy(),
             init=H_init.cpu().numpy(), optimized=H_opt.cpu().numpy())
    np.savez(os.path.join(args.train_dir, "e7_biquad_losses.npz"),
             train=np.asarray(trainer.train_loss),
             valid=np.asarray(trainer.valid_loss))
    print("e7_biquad[fixed] final loss:", trainer.train_loss[-1])
    if not (len(trainer.train_loss) < 2
            or trainer.train_loss[-1] < trainer.train_loss[0] * 1.05):
        raise RuntimeError("fixed: the loss rose by more than 5 %")
    return trainer


SCENARIOS = {"biquad": scenario_biquad,
             "parallel_biquad": scenario_parallel_biquad}


def main(args):
    device = resolve_device(args.device)
    names = (list(SCENARIOS) + ["fixed"] if args.scenario == "all"
             else [args.scenario])
    for name in names:
        print(f"--- e7_biquad scenario: {name} ---")
        if name == "fixed":
            example_fixed(args, device)
        else:
            filt, target, in_ch, tag = SCENARIOS[name](args, device)
            train_filter_to_target(args, filt, target, in_ch, tag=tag)


def parser():
    ap = example_parser(nfft=4096, max_epochs=5, lr=1e-2, num=16,
                        batch_size=2)
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["biquad", "parallel_biquad", "fixed", "all"])
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
