"""Colorless FDN with a ScatteringMatrix feedback (counterpart of
``examples/e8_colorless_sfdn.py``): N=6, delays 997..2099, paraunitary
scattering feedback (4 stages, sparsity 3, random m_L/m_R), trained with
masked_mse (2000-bin random partitions, regenerated) + 0.2 sparsity.

    python -m flamo_tpu_torch.examples.e8_colorless_sfdn [--device cpu]

``--fast auto`` (the default) trains on the card through
``sfdn_fit(masked=True)`` (the loop solved at each step's masked bins)
and keeps its result when its first loss agrees with the graph loss, else
raises; ``fused`` takes that path on the CPU too, ``graph`` takes the
Trainer.  Writes
ir_init.wav, ir_optim.wav and parameters_optim.mat into ``--train_dir``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (example_parser, fast_path,
                                              setup)
from flamo_tpu_torch.examples.e8_colorless_fdn import render_ir
from flamo_tpu_torch.models import build_colorless_sfdn, sfdn_fit
from flamo_tpu_torch.models.colorless_fdn import impulse_pair
from flamo_tpu_torch.optimize import (DatasetColorless, Trainer,
                                      load_dataset, masked_mse_loss,
                                      sparsity_loss)
from flamo_tpu_torch.utils import resolve_device, save_audio


def fast_fit(model, n_steps: int, lr: float, n_samples: int, fast: str):
    """sfdn_fit(masked=True) on a copy of ``model``, kept behind the
    first-loss parity check against the graph objective at the same mask
    (``_common.fast_path``)."""
    generator = torch.Generator().manual_seed(0)
    masks = masked_mse_loss(nfft=model.nfft, n_samples=n_samples,
                            generator=copy.deepcopy(generator),
                            device=model.device)
    x, t = impulse_pair(model)
    with torch.no_grad():
        graph0 = float(masks(model(x), t, step=0)
                       + 0.2 * sparsity_loss()(None, None, model))
    return fast_path(fast, graph0, lambda: sfdn_fit(
        copy.deepcopy(model), n_steps=n_steps, lr=lr, n_samples=n_samples,
        generator=generator, masked=True))


def main(args):
    device = resolve_device(args.device)
    nfft = args.nfft
    M = nfft // 2 + 1
    # the reference scenario; the delays scale down only for tiny nffts
    delays = (997, 1153, 1327, 1559, 1801, 2099) if nfft >= 8192 else \
        (97, 107, 113, 127, 131, 137)
    n_samples = min(2000, M // 4)
    model = build_colorless_sfdn(nfft=nfft, delays=delays,
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
    trainer.register_criterion(
        masked_mse_loss(nfft=nfft, n_samples=n_samples, n_sets=1,
                        regenerate_mask=True, device=device), 1)
    trainer.register_criterion(sparsity_loss(), 0.2, requires_model=True)
    n_steps = args.max_epochs * args.num
    use_fast = args.fast == "fused" or (args.fast == "auto"
                                        and device.type != "cpu")
    fast = (fast_fit(model, n_steps, args.lr, n_samples, args.fast)
            if use_fast else None)
    if fast is not None:
        trainer.net, history = fast
        trainer.train_loss = [float(history[0]), float(history[-1])]
    else:
        trainer.train(tl, vl)

    ir_optim = render_ir(trainer.net, args.samplerate)
    save_audio(os.path.join(args.train_dir, "ir_optim.wav"),
               ir_optim / np.abs(ir_optim).max(), fs=args.samplerate)

    from scipy.io import savemat

    core = trainer.net.get_core()
    ff = core.feedback_loop.feedforward
    with torch.no_grad():
        m = ff.s2sample(ff.map(ff.param))
    savemat(os.path.join(args.train_dir, "parameters_optim.mat"), {
        "A": core.feedback_loop.feedback.param.detach().cpu().numpy(),
        "B": core.input_gain.param.detach().cpu().numpy(),
        "C": core.output_gain.param.detach().cpu().numpy(),
        "m": m.cpu().numpy(),
    })
    print("e8_colorless_sfdn final loss:", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError("the final loss is not finite")
    return trainer


def parser():
    ap = example_parser(nfft=8192, max_epochs=3, num=16, batch_size=2,
                        lr=1e-3)
    ap.add_argument("--fast", type=str, default="auto",
                    choices=["auto", "fused", "graph"],
                    help="'auto' trains through the masked-bin step "
                         "(sfdn_fit(masked=True)) on the card, behind a "
                         "first-loss parity check that raises when it "
                         "fails; 'fused' takes it on the CPU too; 'graph' "
                         "takes the Trainer")
    ap.add_argument("--solve", type=str, default="ge_cached",
                    choices=["ge", "ge_nopivot", "ge_cached", "lu",
                             "pallas"],
                    help="closed-loop solve of the full (M, N, N) "
                         "scattering loop; 'pallas' is the dense solve "
                         "kernel K6")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
