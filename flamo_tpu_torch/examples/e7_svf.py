"""SVF matching (counterpart of ``examples/e7_svf.py``): three scenarios.

* ``svf``: train a 2 x 1 cascade of four state-variable filters (free
  mixing coefficients, ``filter_type=None``) against the magnitude of a
  random SVF cascade;
* ``parallel_svf``: the diagonal variant, 2 channels;
* ``lowshelf``: a two-section lowshelf SVF trained to a closed-form
  lowshelf (800 Hz, -6 dB).

    python -m flamo_tpu_torch.examples.e7_svf [--device cpu]
        [--scenario svf|parallel_svf|lowshelf|all]

Each writes its losses and a ``.npz`` of the target, initial and trained
magnitudes into ``--train_dir``.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.examples._common import (example_parser, setup,
                                              train_filter_to_target)
from flamo_tpu_torch.examples.e7_biquad import cascade_target, impulse_target
from flamo_tpu_torch.functional import biquad2tf, svf
from flamo_tpu_torch.processor import dsp
from flamo_tpu_torch.utils import resolve_device


def random_svf_target(args, seed: int, shape, device):
    """A random SVF cascade: fc ~ U(0, fs/2), R ~ U(0.2, 1.2) (damped, its
    poles inside the unit circle), free mixing m ~ U(-1, 1)."""
    generator = torch.Generator().manual_seed(seed)
    fc = args.samplerate / 2 * torch.rand(shape, generator=generator)
    R = torch.rand(shape, generator=generator) + 0.2
    m = torch.rand(tuple(shape) + (3,), generator=generator) * 2.0 - 1.0
    b, a = svf(fc, R, m=m, filter_type=None, fs=args.samplerate)
    return cascade_target(b, a, args.nfft, device)


def scenario_svf(args, device):
    in_ch, out_ch, n_sections = 1, 2, 4
    target = impulse_target(args, random_svf_target(
        args, args.seed, (n_sections, out_ch, in_ch), device), in_ch,
        mimo=True)
    filt = dsp.SVF(size=(out_ch, in_ch), n_sections=n_sections,
                   filter_type=None, nfft=args.nfft, fs=args.samplerate,
                   requires_grad=True, alias_decay_db=0, device=device)
    return filt, target, in_ch, "svf"


def scenario_parallel_svf(args, device):
    ch, n_sections = 2, 4
    target = impulse_target(args, random_svf_target(
        args, args.seed + 1, (n_sections, ch), device), ch, mimo=False)
    filt = dsp.parallelSVF(size=(ch,), n_sections=n_sections,
                           filter_type=None, nfft=args.nfft,
                           fs=args.samplerate, requires_grad=True,
                           alias_decay_db=0, device=device)
    return filt, target, ch, "parallel_svf"


def scenario_lowshelf(args, device):
    b, a = svf(torch.tensor(800.0), torch.tensor(1.0),
               G=torch.tensor(10 ** (-6 / 20)), filter_type="lowshelf",
               fs=args.samplerate)
    target = torch.abs(biquad2tf(b, a, args.nfft))[None, :, None]
    filt = dsp.SVF(size=(1, 1), n_sections=2, filter_type="lowshelf",
                   nfft=args.nfft, fs=args.samplerate, requires_grad=True,
                   device=device)
    return filt, target.to(device), 1, "lowshelf"


SCENARIOS = {"svf": scenario_svf, "parallel_svf": scenario_parallel_svf,
             "lowshelf": scenario_lowshelf}


def main(args):
    device = resolve_device(args.device)
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        print(f"--- e7_svf scenario: {name} ---")
        filt, target, in_ch, tag = SCENARIOS[name](args, device)
        train_filter_to_target(args, filt, target, in_ch, tag=tag)


def parser():
    ap = example_parser(nfft=4096, max_epochs=5, lr=5e-2, num=16,
                        batch_size=2)
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["svf", "parallel_svf", "lowshelf", "all"])
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
