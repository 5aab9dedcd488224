"""Loss landscapes (counterpart of ``examples/e9_loss_profile.py``): a
``LossProfile`` of the MSE against a flat magnitude over the attenuation
of an N=4 ``HomogeneousFDN`` (delays 89, 97, 107, 113; 9 steps from -3 to
6, 2 runs, the input gains perturbed at the start of each), then a
``LossSurface`` over the attenuation and the input gains (4 x 4 steps).

    python -m flamo_tpu_torch.examples.e9_loss_profile [--device cpu]
        [--nfft N] [--backend auto|pallas|xla]

``--backend auto`` (the default) is 'pallas' on the card, the FDN's loop
solved by the hand-written kernel K2, and 'xla' ('ge', the pivoted
elimination) on the CPU.  On 'pallas' both scans are also run on a 'ge'
build from the same seed, and the example raises when a loss differs by
``ROUTE_TOL`` of the largest or more.  The scans' ``.mat`` files, the
profile's ``<key>.npz``/``.txt`` and the surface's ``loss_surface.npz``/
``.txt`` go to ``--train_dir``.
"""

from __future__ import annotations

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.config import HomogeneousFDNConfig
from flamo_tpu_torch.auxiliary.reverb import HomogeneousFDN
from flamo_tpu_torch.examples._common import (example_parser, pick_backend,
                                              setup)
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.optimize.loss import mse_loss
from flamo_tpu_torch.optimize.surface import (LossConfig, LossProfile,
                                              LossSurface, ParameterConfig)
from flamo_tpu_torch.processor import dsp
from flamo_tpu_torch.utils import resolve_device

DELAYS = (89, 97, 107, 113)
ATTENUATION = "feedback_loop.feedforward.attenuation"
ROUTE_TOL = 1e-5


def build_model(nfft: int, backend: str, device, seed: int):
    """The N=4 HomogeneousFDN's model with an rfft input layer and an |.|
    output layer, its weights from ``seed``; 'pallas' solves its loop
    with K2."""
    cfg = HomogeneousFDNConfig(
        N=len(DELAYS), nfft=nfft, delays=list(DELAYS), alias_decay_db=0,
        device=device, solve_method="pallas" if backend == "pallas" else "ge")
    fdn = HomogeneousFDN(cfg, generator=torch.Generator().manual_seed(seed))
    return (fdn.model.set_outputLayer(dsp.Transform(torch.abs))
            .set_inputLayer(dsp.FFT(nfft)))


def _ones(shape):
    def param_map(v):
        return v * torch.ones(shape)
    return param_map


def scans(model, nfft: int, seed: int, out_dir=None) -> tuple:
    """(profile losses (2, 9, 1), surface losses (1, 4, 4, 1), the profile
    and the surface) of ``model`` on an impulse against a flat
    magnitude; the perturbations drawn from ``seed``."""
    device = model.core.input_gain.param.device
    x = signal_gallery(1, nfft, 1, "impulse", device=device)
    target = torch.ones((1, nfft // 2 + 1, 1), device=device)
    n = len(DELAYS)
    profile = LossProfile(model, LossConfig(
        criteria=[mse_loss(nfft=nfft)],
        param_config=[ParameterConfig(
            key=ATTENUATION, lower_bound=-3.0, upper_bound=6.0, n_steps=9,
            param_map=_ones(n), target_value=None)],
        n_runs=2, perturb_param="input_gain", output_dir=out_dir),
        generator=torch.Generator().manual_seed(seed))
    loss = profile.compute_loss(x, target)
    surface = LossSurface(model, LossConfig(
        criteria=[mse_loss(nfft=nfft)],
        param_config=[
            ParameterConfig(key=ATTENUATION, lower_bound=-2.0,
                            upper_bound=4.0, n_steps=4, param_map=_ones(n)),
            ParameterConfig(key="input_gain", lower_bound=-1.0,
                            upper_bound=1.0, n_steps=4,
                            param_map=_ones((n, 1)))],
        n_runs=1, output_dir=out_dir),
        generator=torch.Generator().manual_seed(seed))
    loss2 = surface.compute_loss(x, target)
    return loss, loss2, profile, surface


def route_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def main(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    model = build_model(args.nfft, backend, device, args.seed)
    loss, loss2, profile, surface = scans(model, args.nfft, args.seed,
                                          args.train_dir)
    print("loss profile:", loss.shape, "min:", float(loss.min()))
    print("loss surface:", loss2.shape)
    profile.plot_loss(loss)
    surface.plot_loss(loss2)
    if not (np.isfinite(loss).all() and np.isfinite(loss2).all()):
        raise RuntimeError("a scanned loss is not finite")
    if backend == "pallas":
        ref, ref2, _, _ = scans(build_model(args.nfft, "xla", device,
                                            args.seed), args.nfft, args.seed)
        gaps = (route_gap(loss, ref), route_gap(loss2, ref2))
        print(f"backend=pallas (K2 solve; profile and surface against 'ge' "
              f"{gaps[0]:.1e}, {gaps[1]:.1e} of the max)")
        if not max(gaps) < ROUTE_TOL:
            raise RuntimeError(f"the 'pallas' scans differ from 'ge' by "
                               f"{gaps} of the max (tol {ROUTE_TOL:g})")
    return loss, loss2


def parser():
    ap = example_parser(nfft=2048)
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="'pallas': the loop solve through K2; 'xla': the "
                         "pivoted elimination; 'auto': 'pallas' on the "
                         "card, 'xla' on the CPU")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
