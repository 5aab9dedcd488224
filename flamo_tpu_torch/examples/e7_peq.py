"""PEQ matching (counterpart of ``examples/e7_peq.py``): two scenarios
under each of the two band designs, 'biquad' (RBJ) and 'svf'.

* ``peq``: train a 2 x 1 six-band parametric EQ to reproduce the
  response of another, randomly initialized PEQ (self-identification);
* ``parallel_peq``: the diagonal variant, 2 channels.

    python -m flamo_tpu_torch.examples.e7_peq [--device cpu]
        [--scenario peq|parallel_peq|all] [--design biquad|svf|all]

Each writes its losses and a ``.npz`` of the target, initial and trained
magnitudes into ``--train_dir``.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.examples._common import (example_parser, setup,
                                              train_filter_to_target)
from flamo_tpu_torch.processor import dsp
from flamo_tpu_torch.utils import resolve_device

N_BANDS = 6


def scenario_peq(args, device, design: str, **kw):
    """(filter, target magnitude, input channels, tag): the target is the
    (M, out, in) response of a random PEQ applied to an impulse in every
    input channel."""
    in_ch, out_ch = 1, 2
    common = dict(size=(out_ch, in_ch), n_bands=N_BANDS, design=design,
                  nfft=args.nfft, fs=args.samplerate, device=device)
    target_src = dsp.PEQ(**common)
    with torch.no_grad():
        target = torch.abs(torch.sum(target_src.response(), dim=-1))[None]
    filt = dsp.PEQ(**common, requires_grad=True, **kw)
    return filt, target, in_ch, f"peq_{design}"


def scenario_parallel_peq(args, device, design: str, **kw):
    ch = 2
    common = dict(size=(ch,), n_bands=N_BANDS, design=design,
                  nfft=args.nfft, fs=args.samplerate, device=device)
    target_src = dsp.parallelPEQ(**common)
    with torch.no_grad():
        target = torch.abs(target_src.response())[None]  # (1, M, ch)
    filt = dsp.parallelPEQ(**common, requires_grad=True, **kw)
    return filt, target, ch, f"parallel_peq_{design}"


SCENARIOS = {"peq": scenario_peq, "parallel_peq": scenario_parallel_peq}


def main(args):
    device = resolve_device(args.device)
    designs = ["biquad", "svf"] if args.design == "all" else [args.design]
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for design in designs:
        for name in names:
            print(f"--- e7_peq scenario: {name} ({design} design) ---")
            filt, target, in_ch, tag = SCENARIOS[name](args, device, design)
            train_filter_to_target(args, filt, target, in_ch, tag=tag)


def parser():
    ap = example_parser(nfft=4096, max_epochs=3, lr=1e-2, num=16,
                        batch_size=2)
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["peq", "parallel_peq", "all"])
    ap.add_argument("--design", type=str, default="all",
                    choices=["biquad", "svf", "all"])
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
