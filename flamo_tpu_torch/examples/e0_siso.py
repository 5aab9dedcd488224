"""SISO basics (counterpart of ``examples/e0_siso.py``): the rfft / irfft
round trip, a parallelGain on an impulse, ``assign_value`` (in place,
returning the module), and a 64-tap FIR Filter trained to an
exponentially decaying IR.

    python -m flamo_tpu_torch.examples.e0_siso [--device cpu]

The initial, trained and target IRs (first 200 samples) and the losses go
to ``e0_siso.npz`` in ``--train_dir``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import PlainMSE, example_parser, setup
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.trainer import Trainer
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device


def main(args):
    device = resolve_device(args.device)
    nfft = args.nfft

    # 1) rfft / irfft round trip
    x = signal_gallery(1, nfft, 1, "wgn", device=device)
    rt = dsp.iFFT(nfft)(dsp.FFT(nfft)(x))
    err = float(torch.abs(rt - x).max())
    print("fft/ifft roundtrip err:", err)
    if not err < 1e-3:
        raise RuntimeError(f"the round trip is {err} off")

    # 2) parallelGain on an impulse
    imp = signal_gallery(1, nfft, 1, "impulse", device=device)
    g = dsp.parallelGain(size=(1,), nfft=nfft, device=device)
    with torch.no_grad():
        y = dsp.iFFT(nfft)(g(dsp.FFT(nfft)(imp)))
    print("parallelGain scales impulse:", float(y[0, 0, 0]), "==",
          float(g.param[0]))

    # 3) Gain and assign_value, which writes in place
    gm = dsp.Gain(size=(1, 1), nfft=nfft, device=device)
    if gm.assign_value(torch.tensor([[0.5]])) is not gm or \
            float(gm.param[0, 0]) != 0.5:
        raise RuntimeError("assign_value did not write in place")

    # 4) a FIR filter trained to an exponential decay
    target_ir = signal_gallery(1, nfft, 1, "exp", rate=400.0,
                               fs=args.samplerate, device=device)
    filt = dsp.Filter(size=(64, 1, 1), nfft=nfft, requires_grad=True,
                      device=device)
    model = system.Shell(core=filt, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.iFFT(nfft))
    ds = Dataset(input=imp, target=target_ir, expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=1e-1,
                      train_dir=args.train_dir)
    trainer.register_criterion(PlainMSE(), 1)
    with torch.no_grad():
        ir_init = model(imp)[0, :200, 0].cpu().numpy()
    trainer.train(tl, vl)
    with torch.no_grad():
        ir_opt = trainer.net(imp)[0, :200, 0].cpu().numpy()
    losses = trainer.train_loss
    if not (len(losses) < 2 or losses[-1] < losses[0] or losses[0] < 1e-6):
        raise RuntimeError(f"the FIR's loss did not fall: {losses}")
    np.savez(os.path.join(args.train_dir, "e0_siso.npz"), init=ir_init,
             optimized=ir_opt, target=target_ir[0, :200, 0].cpu().numpy(),
             train_loss=np.asarray(losses),
             valid_loss=np.asarray(trainer.valid_loss))
    print("e0 done; final loss", losses[-1])
    return trainer


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096, max_epochs=3).parse_args()))
