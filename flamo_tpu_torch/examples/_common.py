"""Shared command-line plumbing of the port's examples (counterpart of
``examples/_common.py``, without its plots: the examples write WAVs,
``.mat`` parameters, ``.npz`` magnitudes and their losses), and the e7
filter-matching examples' training body."""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.optimize.dataset import Dataset, load_dataset
from flamo_tpu_torch.optimize.trainer import FUSED_PARITY, Trainer
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import set_seed


def example_parser(**overrides):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nfft", type=int, default=overrides.get("nfft", 96000))
    ap.add_argument("--samplerate", type=int,
                    default=overrides.get("samplerate", 48000))
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' runs on the CPU; the default is the CUDA "
                         "card, and without one the example stops")
    ap.add_argument("--batch_size", type=int,
                    default=overrides.get("batch_size", 1))
    ap.add_argument("--num", type=int, default=overrides.get("num", 64),
                    help="dataset expansion length")
    ap.add_argument("--split", type=float, default=0.8)
    ap.add_argument("--max_epochs", type=int,
                    default=overrides.get("max_epochs", 3))
    ap.add_argument("--lr", type=float, default=overrides.get("lr", 1e-3))
    ap.add_argument("--train_dir", type=str, default=None)
    ap.add_argument("--patience_delta", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=overrides.get("seed", 130709))
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "float64"],
                    help="float64 makes it torch's default dtype, so tensors "
                         "made without one are float64; the modules keep "
                         "their own float32, and the card's kernels take "
                         "float32 only")
    return ap


def setup(args):
    """Seed the global generator, set torch's default dtype from
    ``--dtype``, make ``train_dir`` (default output/<time>) and write the
    arguments into it."""
    if getattr(args, "dtype", "float32") == "float64":
        torch.set_default_dtype(torch.float64)
    set_seed(args.seed)
    if args.train_dir is None:
        args.train_dir = os.path.join("output",
                                      time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(args.train_dir, exist_ok=True)
    with open(os.path.join(args.train_dir, "args.txt"), "w") as f:
        f.write("\n".join(f"{k}: {v}" for k, v in vars(args).items()))
    return args


def pick_backend(backend: str, device) -> str:
    """An example's kernel route: 'auto' is 'pallas' (the hand-written
    kernels) on the card and 'xla' (plain PyTorch) on the CPU; 'pallas'
    and 'xla' are taken as given, and a kernel that fails raises."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"backend must be 'auto', 'pallas' or 'xla', got "
                         f"{backend!r}")
    if backend == "auto":
        return "xla" if torch.device(device).type == "cpu" else "pallas"
    return backend


def fast_path(fast: str, graph0: float, fit, rise: float = 1.0):
    """An example's fast path behind the first-loss parity check, as the
    Trainer's gate: ``fit()`` -> ``(trained, history)`` trains, and its
    result is kept when its first loss ``history[0]`` (the loss before
    the first step) lies within FUSED_PARITY of the graph loss
    ``graph0``.  A failed check raises under every ``fast`` mode: the
    kernel or the model is at fault, and no fallback hides it.  A
    non-finite loss, or a last loss above ``rise`` times the first, raises
    too; an error of a kernel propagates."""
    trained, history = fit()
    if not np.isfinite(history).all():
        raise RuntimeError("the fast path produced a non-finite loss")
    rel = abs(float(history[0]) - graph0) / max(1e-9, abs(graph0))
    if rel >= FUSED_PARITY:
        raise RuntimeError(f"fast path ({fast}) parity gate failed: first "
                           f"loss {float(history[0]):.7g} against the "
                           f"graph's {graph0:.7g}, rel {rel:.1e} (tol "
                           f"{FUSED_PARITY:g})")
    if history[-1] > history[0] * rise:
        raise RuntimeError(f"the fast path's loss did not fall: "
                           f"{history[0]:.6g} -> {history[-1]:.6g}")
    print(f"fast path: {len(history)} steps, loss {history[0]:.5f} -> "
          f"{history[-1]:.5f} (graph parity rel={rel:.1e})")
    return trained, history


class PlainMSE:
    """Elementwise MSE, the reference filter examples' ``nn.MSELoss()``."""

    name = "MSE"

    def __call__(self, y_pred, y_true):
        return torch.mean((y_pred - y_true) ** 2)


def filter_shell(filt, nfft: int):
    """The e7 examples' model: ``filt`` between an rfft input layer and an
    |.| output layer."""
    return system.Shell(core=filt, input_layer=dsp.FFT(nfft,
                                                       dtype=filt.dtype),
                        output_layer=dsp.Transform(torch.abs,
                                                   dtype=filt.dtype))


def filter_trainer(args, filt, target_mag, in_ch: int, log: bool = True):
    """The e7 Trainer on the Shell of ``filt``: an impulse in each of
    ``in_ch`` channels against ``target_mag`` (1, M, out), expanded to
    ``args.num`` items and split into loaders, PlainMSE, Adam at
    ``args.lr`` decaying every 25 epochs.  Returns (trainer, train
    loader, valid loader)."""
    device = filt.param.device
    model = filter_shell(filt, args.nfft)
    x = signal_gallery(1, n_samples=args.nfft, n=in_ch,
                       signal_type="impulse", fs=args.samplerate,
                       device=device)
    ds = Dataset(input=x, target=target_mag, expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      step_size=25, patience_delta=1e-5, log=log,
                      train_dir=args.train_dir)
    trainer.register_criterion(PlainMSE(), 1)
    return trainer, tl, vl


def train_filter_to_target(args, filt, target_mag, in_ch, tag,
                           assert_improves=True):
    """Shared body of the e7 filter-matching examples: train the Shell of
    ``filt`` (:func:`filter_trainer`) and write its losses
    (``losses_<tag>.txt``) and the target, initial and trained
    magnitudes (``magnitude_response_<tag>.npz``, each (M, out)) to
    ``args.train_dir``.  The loss must be finite and, with
    ``assert_improves``, must not rise.  Returns the Trainer."""
    trainer, tl, vl = filter_trainer(args, filt, target_mag, in_ch)
    estimation_init = trainer.net.get_freq_response()
    trainer.train(tl, vl)
    estimation = trainer.net.get_freq_response()
    np.savez(os.path.join(args.train_dir, f"magnitude_response_{tag}.npz"),
             target=torch.as_tensor(target_mag)[0].abs().cpu().numpy(),
             init=estimation_init[0].abs().cpu().numpy(),
             estimation=estimation[0].abs().cpu().numpy())
    with open(os.path.join(args.train_dir, f"losses_{tag}.txt"), "w") as f:
        f.write("train " + " ".join(map(str, trainer.train_loss)) + "\n")
        f.write("valid " + " ".join(map(str, trainer.valid_loss)) + "\n")
    print(f"[{tag}] final loss:", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError(f"{tag}: the final loss is not finite")
    if assert_improves and trainer.train_loss[-1] > trainer.train_loss[0]:
        raise RuntimeError(f"{tag}: training did not reduce the loss")
    return trainer
