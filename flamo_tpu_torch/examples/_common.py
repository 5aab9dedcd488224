"""Shared command-line plumbing of the port's examples (counterpart of
``examples/_common.py``, without its plots: the examples write WAVs,
``.mat`` parameters and their losses)."""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from flamo_tpu_torch.optimize.trainer import FUSED_PARITY
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
    return ap


def setup(args):
    """Seed the global generator, make ``train_dir`` (default
    output/<time>) and write the arguments into it."""
    set_seed(args.seed)
    if args.train_dir is None:
        args.train_dir = os.path.join("output",
                                      time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(args.train_dir, exist_ok=True)
    with open(os.path.join(args.train_dir, "args.txt"), "w") as f:
        f.write("\n".join(f"{k}: {v}" for k, v in vars(args).items()))
    return args


def fast_path(fast: str, graph0: float, fit, undo=None, rise: float = 1.0):
    """An example's fast path behind the first-loss parity check, as the
    Trainer's gate: ``fit()`` -> ``(trained, history)`` trains, and its
    result is kept only when its first loss ``history[0]`` (the loss
    before the first step) lies within FUSED_PARITY of the graph loss
    ``graph0``.  A refused check is the only fallback: ``undo()`` reverts
    what ``fit`` trained in place, and None is returned, printed (with
    ``fast == 'fused'`` it raises).  A non-finite loss, or a last loss
    above ``rise`` times the first, raises; an error of a kernel
    propagates."""
    trained, history = fit()
    if not np.isfinite(history).all():
        raise RuntimeError("the fast path produced a non-finite loss")
    rel = abs(float(history[0]) - graph0) / max(1e-9, abs(graph0))
    if rel >= FUSED_PARITY:
        msg = (f"fast path parity gate failed (rel={rel:.1e}, tol "
               f"{FUSED_PARITY:g})")
        if fast == "fused":
            raise RuntimeError(msg)
        if undo is not None:
            undo()
        print(msg + " - falling back")
        return None
    if history[-1] > history[0] * rise:
        raise RuntimeError(f"the fast path's loss did not fall: "
                           f"{history[0]:.6g} -> {history[-1]:.6g}")
    print(f"fast path: {len(history)} steps, loss {history[0]:.5f} -> "
          f"{history[-1]:.5f} (graph parity rel={rel:.1e})")
    return trained, history
