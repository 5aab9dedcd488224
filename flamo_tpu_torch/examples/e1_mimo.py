"""MIMO processors (counterpart of ``examples/e1_mimo.py``): the Matrix
gallery, a 2 x 3 integer Delay on impulses, and a two-section lowpass
Biquad trained to the magnitude of a 2 kHz lowpass.

    python -m flamo_tpu_torch.examples.e1_mimo [--device cpu]
        [--backend auto|pallas|xla]

``--backend auto`` (the default) evaluates the Biquad's cascade with the
kernel K4 on the card and with the plain cascade on the CPU.  The delay
IR, the magnitudes and the losses go to ``e1_mimo.npz`` in
``--train_dir``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (PlainMSE, example_parser,
                                              pick_backend, setup)
from flamo_tpu_torch.functional import (biquad2tf, lowpass_filter,
                                        signal_gallery)
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.trainer import Trainer
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

GALLERY = ("random", "identity", "orthogonal", "hadamard", "rotation")


def gallery(nfft: int, device) -> dict:
    """matrix type -> max |U U^T - I| of a 4 x 4 Matrix of that type."""
    out = {}
    for mtype in GALLERY:
        m = dsp.Matrix(size=(4, 4), nfft=nfft, matrix_type=mtype,
                       device=device)
        with torch.no_grad():
            U = m.map(m.param)
            eye = torch.eye(4, device=U.device)
            out[mtype] = float(torch.abs(U @ U.T - eye).max())
    return out


def mimo_delay(nfft: int, device) -> torch.Tensor:
    """The (1, nfft, 2) IR of a 2 x 3 integer Delay on an impulse in each
    of its 3 inputs."""
    d = dsp.Delay(size=(2, 3), max_len=500, isint=True, nfft=nfft,
                  device=device)
    x = signal_gallery(1, nfft, 3, "impulse", device=device)
    with torch.no_grad():
        return dsp.iFFT(nfft)(d(dsp.FFT(nfft)(x)))


def biquad_fit(args, device, backend: str):
    """Train a 1 x 1 two-section lowpass Biquad to |H| of a 2 kHz, 2 dB
    lowpass; returns (trainer, target (M,), initial and trained |H|)."""
    nfft = args.nfft
    bq = dsp.Biquad(size=(1, 1), n_sections=2, filter_type="lowpass",
                    nfft=nfft, fs=args.samplerate, requires_grad=True,
                    device=device, cascade_backend=backend)
    model = system.Shell(core=bq, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.Transform(torch.abs))
    b, a = lowpass_filter(fc=2000.0, gain=2.0, fs=args.samplerate)
    target = torch.abs(biquad2tf(b, a, nfft))[None, :, None].to(device)
    ds = Dataset(input=signal_gallery(1, nfft // 2 + 1, 1, "impulse",
                                      device=device),
                 target=target, expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=args.train_dir)
    trainer.register_criterion(PlainMSE(), 1)
    with torch.no_grad():
        H_init = torch.abs(bq.response())[:, 0, 0]
    trainer.train(tl, vl)
    with torch.no_grad():
        H_opt = torch.abs(trainer.net.get_core().response())[:, 0, 0]
    return trainer, target[0, :, 0], H_init, H_opt


def main(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    for mtype, err in gallery(args.nfft, device).items():
        print(f"{mtype:>10}: ||U U^T - I|| = {err}")
    y = mimo_delay(args.nfft, device)
    print("MIMO delay output:", tuple(y.shape))
    trainer, target, H_init, H_opt = biquad_fit(args, device, backend)
    np.savez(os.path.join(args.train_dir, "e1_mimo.npz"),
             delay_ir=y[0].cpu().numpy(), target=target.cpu().numpy(),
             init=H_init.cpu().numpy(), optimized=H_opt.cpu().numpy(),
             train_loss=np.asarray(trainer.train_loss),
             valid_loss=np.asarray(trainer.valid_loss))
    print(f"e1 done (cascade {backend}); final loss", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError("the Biquad's loss is not finite")
    return trainer


def parser():
    ap = example_parser(nfft=4096, max_epochs=3, lr=1e-2)
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="the Biquad's cascade: 'pallas' the kernel K4, "
                         "'xla' the plain cascade; 'auto' 'pallas' on the "
                         "card and 'xla' on the CPU")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
