"""Biquad parameters predicted by a network (counterpart of
``examples/e7_biquad_nn.py``): a small MLP maps a conditioning value to
the raw parameters of a two-section highpass Biquad, which reach the
model through ``ext_param`` (the Biquad's own parameters are frozen);
the MLP trains under Adam to match a 6 kHz highpass.

    python -m flamo_tpu_torch.examples.e7_biquad_nn [--device cpu]
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import (biquad2tf, highpass_filter,
                                        signal_gallery)
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device

K = 2  # sections
STEPS = 50


def build(args, device, cascade_backend: str = "xla"):
    """(shell, impulse, target magnitude): the frozen Biquad under the
    key 'bq' of the Shell's core."""
    nfft = args.nfft
    filt = dsp.Biquad(size=(1, 1), n_sections=K, filter_type="highpass",
                      nfft=nfft, fs=args.samplerate, requires_grad=False,
                      device=device, cascade_backend=cascade_backend)
    shell = system.Shell(core=system.Series({"bq": filt}),
                         input_layer=dsp.FFT(nfft),
                         output_layer=dsp.Transform(torch.abs))
    b, a = highpass_filter(fc=6000.0, gain=0.0, fs=args.samplerate)
    target = torch.abs(biquad2tf(b, a, nfft))[None, :, None].to(device)
    x = signal_gallery(1, nfft, 1, "impulse", device=device)
    return shell, x, target


def init_mlp(generator, sizes=(1, 32, K * 2), device=None):
    """[(W, b), ...]: W ~ 0.3 N(0, 1) drawn on the CPU, b = 0."""
    params = []
    for i in range(len(sizes) - 1):
        W = torch.randn((sizes[i], sizes[i + 1]), generator=generator) * 0.3
        params.append((W.to(device).requires_grad_(),
                       torch.zeros(sizes[i + 1], device=device,
                                   requires_grad=True)))
    return params


def predict(params, c):
    """The Biquad's raw (K, 2, 1, 1) parameters: fc = sigmoid (omega / pi in
    (0, 1)), a positive linear gain exp(.)."""
    h = c
    for i, (W, b) in enumerate(params):
        h = h @ W + b
        if i < len(params) - 1:
            h = torch.tanh(h)
    raw = h.reshape(K, 2, 1, 1)
    return torch.cat([torch.sigmoid(raw[:, 0:1]), torch.exp(raw[:, 1:2])],
                     dim=1)


def loss_fn(shell, x, target, params, cond):
    est = shell(x, ext_param={"bq": predict(params, cond)})
    return torch.mean((est - target) ** 2)


def fit(shell, x, target, params, cond, steps: int = STEPS,
        lr: float = 5e-3):
    """``steps`` Adam steps on the MLP; returns each step's loss before
    its update, (steps,)."""
    opt = torch.optim.Adam([p for layer in params for p in layer], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(shell, x, target, params, cond)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy()


def main(args):
    device = resolve_device(args.device)
    shell, x, target = build(args, device)
    params = init_mlp(torch.Generator().manual_seed(args.seed), device=device)
    cond = torch.tensor([[0.5]], device=device)
    with torch.no_grad():
        loss0 = float(loss_fn(shell, x, target, params, cond))
    losses = fit(shell, x, target, params, cond)
    print(f"NN->biquad loss: {loss0:.5f} -> {float(losses[-1]):.5f}")
    if not float(losses[-1]) < loss0:
        raise RuntimeError("the network's loss did not fall")
    return losses


if __name__ == "__main__":
    main(setup(example_parser(nfft=4096).parse_args()))
