"""Colorless FDN (counterpart of ``examples/e8_colorless_fdn.py``): N=6
FDN, delays 887..2053, 30 dB alias decay, orthogonal feedback, trained
for a flat magnitude with mse + 0.2 sparsity.

    python -m flamo_tpu_torch.examples.e8_colorless_fdn [--device cpu]

``--fast auto`` (the default) trains on the card through
``colorless_fit`` (the fused step kernel K1) and keeps its result when
its first loss agrees with the graph loss, else raises; ``fused`` takes
that path on the CPU too, ``graph`` takes the Trainer.  Writes
ir_init.wav, ir_optim.wav and parameters_optim.mat into ``--train_dir``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (example_parser, fast_path,
                                              setup)
from flamo_tpu_torch.models import (build_colorless_fdn, colorless_fit,
                                    colorless_loss)
from flamo_tpu_torch.models.colorless_fdn import impulse_pair
from flamo_tpu_torch.optimize import (DatasetColorless, Trainer,
                                      load_dataset, mse_loss, sparsity_loss)
from flamo_tpu_torch.utils import resolve_device, save_audio


def render_ir(model, fs: int) -> np.ndarray:
    return model.get_time_response(fs=fs).squeeze().cpu().numpy()


def fast_fit(model, n_steps: int, lr: float, fast: str):
    """colorless_fit (K1) on a copy of ``model``, kept behind the
    first-loss parity check (``_common.fast_path``)."""
    with torch.no_grad():
        graph0 = float(colorless_loss(model, *impulse_pair(model)))
    return fast_path(fast, graph0, lambda: colorless_fit(
        copy.deepcopy(model), n_steps=n_steps, lr=lr))


def main(args):
    device = resolve_device(args.device)
    nfft = args.nfft
    M = nfft // 2 + 1
    delays = (887, 911, 941, 1699, 1951, 2053) if nfft >= 8192 else \
        (89, 97, 107, 113, 127, 131)
    model = build_colorless_fdn(nfft=nfft, delays=delays,
                                solve_method=args.solve, device=device)

    ir_init = render_ir(model, args.samplerate)
    save_audio(os.path.join(args.train_dir, "ir_init.wav"),
               ir_init / np.abs(ir_init).max(), fs=args.samplerate)

    dataset = DatasetColorless(input_shape=(1, M, 1), target_shape=(1, M, 1),
                               expand=args.num, device=device)
    tl, vl = load_dataset(dataset, batch_size=args.batch_size,
                          split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=args.train_dir)
    trainer.register_criterion(mse_loss(nfft=nfft), 1)
    trainer.register_criterion(sparsity_loss(), 0.2, requires_model=True)
    n_steps = args.max_epochs * args.num
    use_fast = args.fast == "fused" or (args.fast == "auto"
                                        and device.type != "cpu")
    fast = fast_fit(model, n_steps, args.lr, args.fast) if use_fast else None
    if fast is not None:
        trainer.net, history = fast
        trainer.train_loss = [float(history[0]), float(history[-1])]
    elif args.scan or use_fast:
        # the fixed pair, steps_per_call steps a chunk (exact for the
        # colorless dataset, which repeats one (input, target) pair)
        history = trainer.fit_scan(*impulse_pair(model), n_steps=n_steps)
        trainer.train_loss = [float(history[0]), float(history[-1])]
        print(f"fit_scan ({trainer.fused_path or 'graph'}): loss "
              f"{history[0]:.4f} -> {history[-1]:.4f} over {len(history)} "
              "steps")
    else:
        trainer.train(tl, vl)

    ir_optim = render_ir(trainer.net, args.samplerate)
    save_audio(os.path.join(args.train_dir, "ir_optim.wav"),
               ir_optim / np.abs(ir_optim).max(), fs=args.samplerate)

    from scipy.io import savemat

    core = trainer.net.get_core()
    savemat(os.path.join(args.train_dir, "parameters_optim.mat"), {
        "A": core.feedback_loop.feedback.param.detach().cpu().numpy(),
        "B": core.input_gain.param.detach().cpu().numpy(),
        "C": core.output_gain.param.detach().cpu().numpy(),
        "m": core.feedback_loop.feedforward.param.detach().cpu().numpy(),
    })
    print("e8_colorless_fdn final loss:", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError("the final loss is not finite")
    if trainer.train_loss[-1] > trainer.train_loss[0]:
        raise RuntimeError("training did not reduce the loss")
    return trainer


def parser():
    ap = example_parser(nfft=8192, max_epochs=5, num=32, batch_size=4,
                        lr=1e-3)
    ap.add_argument("--scan", action="store_true",
                    help="train on the fixed pair through Trainer.fit_scan")
    ap.add_argument("--fast", type=str, default="auto",
                    choices=["auto", "fused", "graph"],
                    help="'auto' trains through the fused step kernel K1 "
                         "(colorless_fit) on the card, behind a first-loss "
                         "parity check that raises when it fails; 'fused' "
                         "takes it on the CPU too; 'graph' takes the "
                         "Trainer")
    ap.add_argument("--solve", type=str, default="ge_cached",
                    choices=["ge", "ge_nopivot", "ge_cached", "lu",
                             "pallas"],
                    help="closed-loop solve of the graph path; 'pallas' is "
                         "the FDN solve kernel K2")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
