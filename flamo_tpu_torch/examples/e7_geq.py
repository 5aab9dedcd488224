"""GEQ matching (counterpart of ``examples/e7_geq.py``): four scenarios.

* ``geq``: train a 2 x 1 octave GEQ's command gains (alias decay 30 dB)
  to the magnitude of an accurate-GEQ design of random target gains
  (+-6 dB);
* ``parallel_geq``: the diagonal variant, 2 channels (+-12 dB);
* ``accurate_geq``: a 2 x 1 ``AccurateGEQ`` (not trainable) assigned
  random target gains (+-12 dB): its design-time fit must reproduce the
  designed target's magnitude within 1e-2 of its range, without training;
* ``accurate_parallel_geq``: the diagonal variant.

    python -m flamo_tpu_torch.examples.e7_geq [--device cpu]
        [--scenario geq|parallel_geq|accurate_geq|accurate_parallel_geq|all]
        [--backend auto|pallas|xla]

``--backend auto`` (the default) evaluates every cascade with the
hand-written kernel K4 on the card and with the plain cascade on the CPU.
Each scenario writes a ``.npz`` of its magnitudes (and the trained ones
their losses) into ``--train_dir``.  The target gains are drawn from a
``torch.Generator`` seeded by ``--seed`` (another PRNG than JAX's).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.eq import accurate_geq, eq_freqs
from flamo_tpu_torch.examples._common import (example_parser, pick_backend,
                                              setup, train_filter_to_target)
from flamo_tpu_torch.examples.e7_biquad import impulse_target
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

ACCURATE_TOL = 1e-2  # of the target's range (at least 1)


def random_gains(seed: int, shape, db: float) -> torch.Tensor:
    """Linear gains uniform in [10^(-db/20), 10^(db/20)], (n_gains,
    *shape), drawn on the CPU from ``seed``."""
    n_gains = len(eq_freqs(interval=1)[0]) + 2
    lo, hi = 10 ** (-db / 20), 10 ** (db / 20)
    u = torch.rand((n_gains, *shape),
                   generator=torch.Generator().manual_seed(seed))
    return lo + (hi - lo) * u


def design_target_filter(args, gains: torch.Tensor, device) -> torch.Tensor:
    """The accurate design of each channel's dB gains as a complex (M,
    ...) response: prod(rfft(b)) / prod(rfft(a)) over the sections, the
    rffts numpy's in float64, zeros of A replaced by 1e-12."""
    center, shelving = eq_freqs(interval=1)
    g = gains.cpu().numpy()
    chans = g.reshape(g.shape[0], -1)
    bs, as_ = zip(*(accurate_geq(20 * np.log10(chans[:, c]),
                                 center_freq=center.numpy(),
                                 shelving_crossover=shelving.numpy(),
                                 fs=args.samplerate)
                    for c in range(chans.shape[1])))
    b = torch.stack(bs, -1).reshape((3, -1) + g.shape[1:]).numpy()
    a = torch.stack(as_, -1).reshape((3, -1) + g.shape[1:]).numpy()
    B = np.fft.rfft(b.astype(np.float64), args.nfft, axis=0)
    A = np.fft.rfft(a.astype(np.float64), args.nfft, axis=0)
    A[A == 0] = 1e-12
    return torch.tensor(np.prod(B, axis=1) / np.prod(A, axis=1),
                        dtype=torch.complex64, device=device)


def scenario_geq(args, device, **kw):
    """(filter, target magnitude (1, M, 2), input channels, tag)."""
    in_ch, out_ch = 1, 2
    gains = random_gains(args.seed, (out_ch, in_ch), 6.0)
    target = impulse_target(args, design_target_filter(args, gains, device),
                            in_ch, mimo=True)
    filt = dsp.GEQ(size=(out_ch, in_ch), octave_interval=1, nfft=args.nfft,
                   fs=args.samplerate, requires_grad=True, alias_decay_db=30,
                   device=device, **kw)
    return filt, target, in_ch, "geq"


def scenario_parallel_geq(args, device, **kw):
    ch = 2
    gains = random_gains(args.seed + 1, (ch,), 12.0)
    target = impulse_target(args, design_target_filter(args, gains, device),
                            ch, mimo=False)
    filt = dsp.parallelGEQ(size=(ch,), octave_interval=1, nfft=args.nfft,
                           fs=args.samplerate, requires_grad=True,
                           alias_decay_db=30, device=device, **kw)
    return filt, target, ch, "parallel_geq"


def scenario_accurate(args, device, parallel: bool = False, **kw):
    """(AccurateGEQ assigned the target gains, target magnitude (1, M,
    2), input channels, tag): the MIMO 2 x 1 module, or the diagonal one
    of 2 channels with ``parallel``."""
    if parallel:
        ch = 2
        gains = random_gains(args.seed + 3, (ch,), 12.0)
        filt = dsp.parallelAccurateGEQ(
            size=(ch,), octave_interval=1, nfft=args.nfft,
            fs=args.samplerate, alias_decay_db=0, device=device, **kw)
        in_ch, tag = ch, "accurate_parallel_geq"
    else:
        in_ch, out_ch = 1, 2
        gains = random_gains(args.seed + 2, (out_ch, in_ch), 12.0)
        filt = dsp.AccurateGEQ(size=(out_ch, in_ch), octave_interval=1,
                               nfft=args.nfft, fs=args.samplerate,
                               alias_decay_db=0, device=device, **kw)
        tag = "accurate_geq"
    target = impulse_target(args, design_target_filter(args, gains, device),
                            in_ch, mimo=not parallel)
    filt.assign_value(gains)
    return filt, target, in_ch, tag


def accurate_error(filt, target) -> tuple[float, float, torch.Tensor]:
    """(max |target - |H||, the target's range, H): H the frequency
    response (1, M, out) of the |.| Shell of ``filt``, one response of
    the module."""
    model = system.Shell(core=filt, input_layer=dsp.FFT(filt.nfft),
                         output_layer=dsp.Transform(torch.abs))
    H = model.get_freq_response()
    err = float(torch.max(torch.abs(target - torch.abs(H))))
    return err, float(torch.max(target)), H


def example_accurate(args, device, parallel: bool = False, **kw):
    """The accurate design reproduces the designed target without
    training: the error within ACCURATE_TOL of the target's range."""
    filt, target, _, tag = scenario_accurate(args, device, parallel, **kw)
    err, rng, H = accurate_error(filt, target)
    np.savez(os.path.join(args.train_dir, f"magnitude_response_{tag}.npz"),
             target=target[0].cpu().numpy(),
             response=torch.abs(H[0]).cpu().numpy())
    print(f"e7_geq[{tag}] max |target - design| = {err:.2e} (target range "
          f"{rng:.2f})")
    if not err < ACCURATE_TOL * max(rng, 1.0):
        raise RuntimeError(f"{tag}: the design is {err:.3e} from its target")
    return err


SCENARIOS = {"geq": scenario_geq, "parallel_geq": scenario_parallel_geq}


def main(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    names = (list(SCENARIOS) + ["accurate_geq", "accurate_parallel_geq"]
             if args.scenario == "all" else [args.scenario])
    for name in names:
        print(f"--- e7_geq scenario: {name} (cascade {backend}) ---")
        if name in SCENARIOS:
            filt, target, in_ch, tag = SCENARIOS[name](
                args, device, cascade_backend=backend)
            train_filter_to_target(args, filt, target, in_ch, tag=tag)
        else:
            example_accurate(args, device, parallel="parallel" in name,
                             cascade_backend=backend)


def parser():
    ap = example_parser(nfft=4096, max_epochs=3, lr=5e-2, num=16,
                        batch_size=2)
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["geq", "parallel_geq", "accurate_geq",
                             "accurate_parallel_geq", "all"])
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="the cascades' route: 'pallas' the kernel K4, "
                         "'xla' the plain cascade; 'auto' 'pallas' on the "
                         "card and 'xla' on the CPU")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
