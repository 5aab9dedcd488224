"""Series semantics (counterpart of ``examples/e3_series_class.py``):
composition, the construction errors, OrderedDict keys and nesting,
training one member, and the structural edits.

    python -m flamo_tpu_torch.examples.e3_series_class [--device cpu]

The errors are raised at construction with the JAX package's exception
types and messages (an IO mismatch an AssertionError; an nfft, alias
decay or duplicate-key mismatch a ValueError).  The trained IRs and the
losses go to ``e3_series.npz`` in ``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.trainer import Trainer
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device


def scenario_basic(args, device):
    """A Series behaves as the composition of its members."""
    g = dsp.parallelGain(size=(2,), nfft=args.nfft, device=device)
    d = dsp.Delay(size=(3, 2), max_len=1000, isint=True, nfft=args.nfft,
                  fs=args.samplerate, device=device)
    chain = system.Series(OrderedDict({
        "input": dsp.FFT(args.nfft), "gain": g, "delay": d,
        "output": dsp.iFFT(args.nfft)}))
    x = signal_gallery(1, args.nfft, 2, "impulse", fs=args.samplerate,
                       device=device)
    with torch.no_grad():
        err = float(torch.abs(chain(x) - dsp.iFFT(args.nfft)(
            d(g(dsp.FFT(args.nfft)(x))))).max())
    if not err < 1e-6:
        raise RuntimeError(f"the Series is {err} from the composition")
    print("Series(FFT, gain, delay, iFFT) == manual composition")


def error_cases(nfft: int, device) -> dict:
    """name -> a constructor that must raise, with the exception type it
    must raise."""
    def gain(size, **kw):
        return dsp.Gain(size=size, nfft=kw.pop("nfft", nfft), device=device,
                        **kw)

    return {
        "IO mismatch": (AssertionError, lambda: system.Series(
            gain((3, 1)), gain((2, 4)))),
        "nfft mismatch": (ValueError, lambda: system.Series(
            gain((2, 1)), gain((2, 2), nfft=nfft * 2))),
        "alias_decay_db mismatch": (ValueError, lambda: system.Series(
            gain((2, 1), alias_decay_db=0.0),
            gain((2, 2), alias_decay_db=30.0))),
        "duplicate key": (ValueError, lambda: system.Series(
            OrderedDict({"a": gain((2, 2))}),
            OrderedDict({"a": gain((2, 2))}))),
    }


def scenario_errors(args, device):
    for name, (kind, make) in error_cases(args.nfft, device).items():
        try:
            make()
        except kind as e:
            print(f"{name} caught:", str(e)[:72], "...")
        else:
            raise RuntimeError(f"{name}: should have raised")


def scenario_keys_and_nesting(args, device):
    """OrderedDict keys survive flattening; members are reachable by key
    and by attribute."""
    def gain(size):
        return dsp.Gain(size=size, nfft=args.nfft, device=device)

    inner = system.Series(OrderedDict({"a": gain((2, 1)),
                                       "b": gain((2, 2))}))
    outer = system.Series(inner, OrderedDict({"c": gain((1, 2))}))
    print("flattened keys:", outer.keys)
    if outer.keys != ("a", "b", "c") or outer["b"] is not outer.b or \
            (outer.input_channels, outer.output_channels) != (1, 1):
        raise RuntimeError("the nested Series did not flatten as expected")


def scenario_training(args, device):
    """Train the parallelGain of a Series through frozen delays to a
    target IR (L1 loss); returns the trainer, the IRs and the target."""
    in_ch, out_ch = 2, 3
    g = dsp.parallelGain(size=(in_ch,), nfft=args.nfft, requires_grad=True,
                         device=device)
    d = dsp.Delay(size=(out_ch, in_ch), max_len=1000, isint=True,
                  nfft=args.nfft, fs=args.samplerate, device=device)
    model = system.Series(OrderedDict({
        "input_layer": dsp.FFT(args.nfft), "Gains": g, "Delays": d,
        "output_layer": dsp.iFFT(args.nfft)}))
    x = signal_gallery(1, args.nfft, in_ch, "impulse", fs=args.samplerate,
                       device=device)
    target_gains = [0.5, -1.0]
    delays = np.round(d.s2sample(d.param.detach()).cpu().numpy()).astype(int)
    target = np.zeros((args.nfft, out_ch), dtype=np.float32)
    for i in range(out_ch):
        for j in range(in_ch):
            target[delays[i, j], i] += target_gains[j]

    class L1Loss:
        name = "L1"

        def __call__(self, y_pred, y_true):
            return torch.mean(torch.abs(y_pred - y_true))

    ds = Dataset(input=x, target=torch.tensor(target)[None], expand=args.num,
                 device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      patience_delta=0, train_dir=args.train_dir)
    trainer.register_criterion(L1Loss(), 1)
    with torch.no_grad():
        ir_init = model(x)
    trainer.train(tl, vl)
    with torch.no_grad():
        ir_optim = trainer.net(x)
    gains = trainer.net["Gains"].param.detach().cpu().numpy()
    print(f"trained gains {gains.round(3)} -> target {target_gains}")
    if not trainer.train_loss[-1] < trainer.train_loss[0]:
        raise RuntimeError("training did not lower the loss")
    if args.max_epochs >= 5 and not np.allclose(gains, target_gains,
                                                atol=0.2):
        raise RuntimeError(f"the gains {gains} missed {target_gains}")
    return trainer, ir_init, ir_optim, target


def scenario_utils(args, device):
    """append / prepend / insert return new Series; the original keeps
    its members."""
    def gain(size):
        return dsp.Gain(size=size, nfft=args.nfft, device=device)

    s = system.Series(gain((2, 2)))
    s2 = s.append(gain((3, 2))).prepend(gain((2, 1)))
    s3 = s2.insert(1, gain((2, 2)))
    print(f"edits: {len(s)} -> {len(s2)} -> {len(s3)} modules; "
          f"{s3.input_channels} -> {s3.output_channels} channels")
    if (len(s), len(s2), len(s3)) != (1, 3, 4):
        raise RuntimeError("the edits did not give 1, 3 and 4 modules")


def main(args):
    device = resolve_device(args.device)
    scenario_basic(args, device)
    scenario_errors(args, device)
    scenario_keys_and_nesting(args, device)
    trainer, ir_init, ir_optim, target = scenario_training(args, device)
    scenario_utils(args, device)
    np.savez(os.path.join(args.train_dir, "e3_series.npz"),
             init=ir_init[0].cpu().numpy(), optimized=ir_optim[0].cpu().numpy(),
             target=target, train_loss=np.asarray(trainer.train_loss),
             valid_loss=np.asarray(trainer.valid_loss))
    return trainer


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096, max_epochs=10, num=16,
                              lr=5e-2).parse_args()))
