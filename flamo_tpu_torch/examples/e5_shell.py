"""Shell container (counterpart of ``examples/e5_shell.py``):
construction and the layer getters and setters, the construction
errors, ``get_time_response`` / ``get_freq_response`` (with
``identity=True`` input-free responses), and training inside a Shell.

    python -m flamo_tpu_torch.examples.e5_shell [--device cpu]

The setters return a new Shell and leave the original as it is, as in the
JAX package.  The errors are raised at construction with the JAX
package's exception types.  The responses and the trained magnitude go
to ``e5_shell.npz`` in ``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.loss import mse_loss
from flamo_tpu_torch.optimize.trainer import Trainer
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device


def build_core(nfft: int, device, N: int = 3):
    return system.Series(OrderedDict({
        "in": dsp.Gain(size=(N, 1), nfft=nfft, device=device),
        "filt": dsp.parallelFilter(size=(16, N), nfft=nfft, device=device),
        "out": dsp.Gain(size=(1, N), nfft=nfft, device=device),
    }))


def scenario_shell(args, device):
    """Construction, and the setters returning a new Shell."""
    core = build_core(args.nfft, device)
    model = system.Shell(core=core, input_layer=dsp.FFT(args.nfft),
                         output_layer=dsp.iFFT(args.nfft))
    m2 = model.set_outputLayer(dsp.Transform(torch.abs))
    m3 = model.set_core(build_core(args.nfft, device, N=4))
    if not (isinstance(model.get_inputLayer(), dsp.FFT)
            and model.get_core() is core
            and isinstance(model.get_outputLayer(), dsp.iFFT)
            and isinstance(m2.get_outputLayer(), dsp.Transform)
            and m3.get_core() is not core):
        raise RuntimeError("the Shell's getters or setters misbehave")
    print("shell get/set: layer and core swaps return new Shells")


def error_cases(nfft: int, device) -> dict:
    """name -> (the exception type, a constructor that must raise it)."""
    core = build_core(nfft, device)
    return {
        "input layer IO": (AssertionError, lambda: system.Shell(
            core=core, input_layer=dsp.Gain(size=(2, 2), nfft=nfft,
                                            device=device))),
        "output layer IO": (AssertionError, lambda: system.Shell(
            core=core, output_layer=dsp.Gain(size=(4, 4), nfft=nfft,
                                             device=device))),
        "nfft mismatch": (AssertionError, lambda: system.Shell(
            core=core, input_layer=dsp.FFT(nfft * 2))),
    }


def scenario_errors(args, device):
    for name, (kind, make) in error_cases(args.nfft, device).items():
        try:
            make()
        except kind as e:
            print(f"shell {name} caught:", str(e)[:64], "...")
        else:
            raise RuntimeError(f"{name}: should have raised")


def scenario_responses(args, device):
    """The IR and the frequency response agree: rfft(IR) == H."""
    model = system.Shell(core=build_core(args.nfft, device),
                         input_layer=dsp.FFT(args.nfft),
                         output_layer=dsp.iFFT(args.nfft))
    ir = model.get_time_response(fs=args.samplerate)
    H = model.get_freq_response(fs=args.samplerate)
    if tuple(ir.shape) != (1, args.nfft, 1) or \
            tuple(H.shape) != (1, args.nfft // 2 + 1, 1):
        raise RuntimeError(f"response shapes {ir.shape}, {H.shape}")
    err = float(torch.abs(torch.fft.rfft(ir, n=args.nfft, dim=1) - H).max())
    if not err < 1e-4:
        raise RuntimeError(f"rfft(IR) is {err} from H")
    if not isinstance(model.get_inputLayer(), dsp.FFT):
        raise RuntimeError("the responses changed the input layer")
    print(f"responses: IR {tuple(ir.shape)}, H {tuple(H.shape)}")
    return ir, H


def scenario_identity(args, device):
    """identity=True: per-channel input-free IRs; a flat orthogonal
    matrix's IR at n = 0 is the matrix itself."""
    mimo = system.Shell(core=dsp.Matrix(size=(3, 3), nfft=args.nfft,
                                        matrix_type="orthogonal",
                                        device=device),
                        input_layer=dsp.FFT(args.nfft),
                        output_layer=dsp.iFFT(args.nfft))
    ir_id = mimo.get_time_response(fs=args.samplerate, identity=True)
    if tuple(ir_id.shape) != (1, args.nfft, 3, 3):
        raise RuntimeError(f"identity IR shape {tuple(ir_id.shape)}")
    U = ir_id[0, 0].cpu().numpy()
    err = float(np.abs(U @ U.T - np.eye(3)).max())
    if not err < 1e-4:
        raise RuntimeError(f"the n = 0 slice is {err} from orthogonal")
    print("identity=True input-free IRs:", tuple(ir_id.shape),
          "(n = 0 slice is the orthogonal mixing matrix)")
    return ir_id


def scenario_training(args, device):
    """Train a 64-tap FIR in an rfft / |.| Shell to the magnitude of
    0.9^n cos(0.3 n)."""
    taps = 64
    fir = dsp.Filter(size=(taps, 1, 1), nfft=args.nfft, requires_grad=True,
                     device=device)
    model = system.Shell(core=fir, input_layer=dsp.FFT(args.nfft),
                         output_layer=dsp.Transform(torch.abs))
    n = np.arange(taps)
    target_ir = (0.9 ** n * np.cos(0.3 * n)).astype(np.float32)
    target_H = np.abs(np.fft.rfft(target_ir, args.nfft))[:, None]
    x = signal_gallery(1, args.nfft, 1, "impulse", fs=args.samplerate,
                       device=device)
    ds = Dataset(input=x, target=torch.tensor(
        target_H, dtype=torch.float32)[None], expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=args.train_dir)
    trainer.register_criterion(mse_loss(), 1)
    trainer.train(tl, vl)
    H_opt = trainer.net.get_freq_response(fs=args.samplerate)
    losses = trainer.train_loss
    print(f"shell training: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not lower the loss")
    return trainer, target_H[:, 0], H_opt


def main(args):
    device = resolve_device(args.device)
    scenario_shell(args, device)
    scenario_errors(args, device)
    ir, H = scenario_responses(args, device)
    ir_id = scenario_identity(args, device)
    trainer, target_H, H_opt = scenario_training(args, device)
    np.savez(os.path.join(args.train_dir, "e5_shell.npz"),
             ir=ir[0].cpu().numpy(), H=np.abs(H[0].cpu().numpy()),
             ir_identity=ir_id[0, :64].cpu().numpy(), target=target_H,
             optimized=np.abs(H_opt[0, :, 0].cpu().numpy()),
             train_loss=np.asarray(trainer.train_loss),
             valid_loss=np.asarray(trainer.valid_loss))
    return trainer


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096, max_epochs=10, num=16,
                              lr=1e-2).parse_args()))
