"""Hyper-conditioned recursion (counterpart of
``examples/e4_recursion_nn.py``): two scenarios.

* ``comb_nn``: a four-channel comb, integer delays (151, 211, 239, 317)
  in the feedforward path and a 4 x 4 one-section lowpass
  :class:`LossyBiquad` (a ``Biquad`` whose map keeps every gain below
  -0.1 dB, so the loop always attenuates) in the feedback path, whose
  raw parameters an MLP stack (Linear, LayerNorm, ReLU; hidden 128 and
  64) predicts from a target magnitude response.  The targets are the
  comb's own responses to random biquad parameters; the MLP trains under
  Adam.  Each item of a batch goes through the comb in turn (one cascade
  and one loop solve an item).
* ``gains_nn``: a small MLP predicts the two loop gains of a delay /
  gain Recursion through ``ext_param``, trained to a flat magnitude.

    python -m flamo_tpu_torch.examples.e4_recursion_nn [--device cpu]
        [--scenario comb_nn|gains_nn|all] [--backend auto|pallas|xla]

``--backend auto`` (the default) is 'pallas' on the card, where the
biquad cascade runs on the kernel K4 and the loop solves on the dense
per-bin kernel K6 (``Recursion(solve_method='pallas')``), and 'xla' on
the CPU (the plain cascade and the pivoted elimination 'ge').  comb_nn
must lower its loss over all the targets (the JAX example compares the
last batch's loss with the first's, two different batches); it writes
the first item's target and estimated magnitudes to
``estimation.npz`` in ``--train_dir``.  Weights and data are drawn from
``torch.Generator``s seeded by ``--seed`` (another PRNG than JAX's).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (example_parser, pick_backend,
                                              setup)
from flamo_tpu_torch.functional import _clip, signal_gallery
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import resolve_device, set_seed

DELAYS = (151, 211, 239, 317)
N_SECTIONS, N_PARAM = 1, 2  # one lowpass section: (fc, gain)
HIDDEN = (128, 64)


def routes(backend: str) -> dict:
    """The modules' arguments of a route: the cascade's backend and the
    Recursion's solve ('pallas': K4 and K6; 'xla': plain PyTorch)."""
    return {"cascade_backend": backend,
            "solve_method": "pallas" if backend == "pallas" else "ge"}


class LossyBiquad(dsp.Biquad):
    """A Biquad whose map forces a lossy section: the lowpass/highpass
    cutoff sigmoid(x / 4) in (0, 1) and its gain 20 log10 sigmoid(x / 4)
    clipped to [-60, -0.1] dB; a bandpass's cutoffs clipped to (eps, 1 -
    eps) and its gain 20 log10 sigmoid(|x|) to [-60, 0] dB.  ``_clip``
    keeps the JAX package's gradient of 1/2 at a bound."""

    def _map_clamp(self, x):
        if self.filter_type in ("lowpass", "highpass"):
            fc = _clip(torch.sigmoid(x[:, 0] * 0.25), 0.0, 1.0)
            g = _clip(20 * torch.log10(torch.sigmoid(x[:, 1] * 0.25)),
                      -60.0, -0.1)
            return torch.stack([fc, g], dim=1)
        eps = torch.finfo(self.dtype).eps
        fc1 = _clip(x[:, 0], eps, 1 - eps)
        fc2 = _clip(x[:, 1], eps, 1 - eps)
        g = _clip(20 * torch.log10(torch.sigmoid(torch.abs(x[:, -1]))),
                  -60.0, 0.0)
        return torch.stack([fc1, fc2, g], dim=1)


def build_comb(nfft: int, fs: int, device, cascade_backend: str = "xla",
               solve_method: str = "ge"):
    """(shell, filt): the comb Recursion(delays, LossyBiquad) in an rfft /
    |.| Shell; the biquad is the Recursion's 'feedback' branch."""
    ch = len(DELAYS)
    kw = dict(nfft=nfft, device=device)
    delays = dsp.parallelDelay(size=(ch,), max_len=max(DELAYS), isint=True,
                               **kw)
    delays.assign_value(delays.sample2s(torch.tensor(DELAYS,
                                                     dtype=torch.float32)))
    filt = LossyBiquad(size=(ch, ch), n_sections=N_SECTIONS,
                       filter_type="lowpass", fs=fs, requires_grad=True,
                       cascade_backend=cascade_backend, **kw)
    comb = system.Recursion(fF=delays, fB=filt, solve_method=solve_method)
    shell = system.Shell(core=comb, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.Transform(torch.abs))
    return shell, filt


def comb_impulse(shell):
    return signal_gallery(1, shell.nfft, len(DELAYS), "impulse",
                          dtype=shell.dtype, device=shell.device)


def render(shell, imp, raw):
    """The comb's magnitude (M, ch) with the feedback biquad's raw
    parameters ``raw`` (K, P, ch, ch)."""
    return shell(imp, ext_param={"feedback": raw})[0]


def comb_targets(shell, num: int, generator):
    """``num`` targets (num, M, ch): the comb's responses to raw biquad
    parameters 2 N(0, 1), drawn on the CPU from ``generator``."""
    ch = len(DELAYS)
    raw = torch.randn((num, N_SECTIONS, N_PARAM, ch, ch),
                      generator=generator) * 2.0
    imp = comb_impulse(shell)
    with torch.no_grad():
        return torch.stack([render(shell, imp, r.to(shell.device))
                            for r in raw])


def init_mlp_stack(generator, in_dim: int, out_dim: int, hidden=HIDDEN,
                   device=None):
    """[{W, b, ln_g, ln_b}, ...]: W ~ N(0, 1) / sqrt(fan_in) drawn on the
    CPU, b and ln_b zeros, ln_g ones; trainable leaves."""
    sizes = (in_dim, *hidden, out_dim)
    params = []
    for i in range(len(sizes) - 1):
        W = torch.randn((sizes[i], sizes[i + 1]),
                        generator=generator) / np.sqrt(sizes[i])
        layer = {"W": W, "b": torch.zeros(sizes[i + 1]),
                 "ln_g": torch.ones(sizes[i + 1]),
                 "ln_b": torch.zeros(sizes[i + 1])}
        params.append({k: v.to(device).requires_grad_()
                       for k, v in layer.items()})
    return params


def mlp_leaves(params):
    return [v for layer in params for v in layer.values()]


def mlp_stack(params, x):
    """(Linear, LayerNorm (population std + 1e-6), ReLU) per hidden
    layer, then the last Linear."""
    for i, layer in enumerate(params):
        dt = torch.promote_types(x.dtype, layer["W"].dtype)  # as jnp's @
        x = x.to(dt) @ layer["W"].to(dt) + layer["b"]
        if i < len(params) - 1:
            mu = torch.mean(x, dim=-1, keepdim=True)
            sd = torch.std(x, dim=-1, keepdim=True, unbiased=False) + 1e-6
            x = torch.relu((x - mu) / sd * layer["ln_g"] + layer["ln_b"])
    return x


def predict(params, target_mag):
    """A target magnitude (M, ch) -> the biquad's raw (K, P, ch, ch)."""
    ch = len(DELAYS)
    out = mlp_stack(params, target_mag.reshape(-1))
    return out.reshape(N_SECTIONS, N_PARAM, ch, ch)


def batched_forward(shell, imp, params, target_mags):
    """The comb's magnitudes (B, M, ch) for the MLP's prediction from each
    target, one item after the other."""
    return torch.stack([render(shell, imp, predict(params, t))
                        for t in target_mags])


def comb_loss(shell, imp, params, target_mags):
    est = batched_forward(shell, imp, params, target_mags)
    return torch.mean((est - target_mags) ** 2)


def comb_setup(args, device, backend: str = "xla"):
    """(shell, impulse, targets, MLP params) of comb_nn, everything from
    ``args.seed``: the comb's delay draw from the global stream (then
    assigned), the targets from ``seed``, the MLP from ``seed + 1``."""
    set_seed(args.seed)
    shell, filt = build_comb(args.nfft, args.samplerate, device,
                             **routes(backend))
    mapped = filt.map(filt.param.detach())
    if not float(mapped[:, 1].max()) <= -0.1 + 1e-6:
        raise RuntimeError("the LossyBiquad's gain must stay below 0 dB")
    targets = comb_targets(shell, args.num,
                           torch.Generator().manual_seed(args.seed))
    params = init_mlp_stack(torch.Generator().manual_seed(args.seed + 1),
                            in_dim=(args.nfft // 2 + 1) * len(DELAYS),
                            out_dim=N_SECTIONS * N_PARAM * len(DELAYS) ** 2,
                            device=device)
    return shell, comb_impulse(shell), targets, params


def dataset_loss(shell, imp, params, targets) -> float:
    """The loss over every target, without a gradient."""
    with torch.no_grad():
        return float(comb_loss(shell, imp, params, targets))


def comb_fit(shell, imp, params, targets, lr: float, epochs: int, bs: int):
    """``epochs`` passes of Adam over the targets in batches of ``bs``
    (a last partial batch dropped); returns each step's loss, (steps,)."""
    opt = torch.optim.Adam(mlp_leaves(params), lr=lr)
    losses = []
    for _ in range(epochs):
        for i in range(0, targets.shape[0] - bs + 1, bs):
            opt.zero_grad(set_to_none=True)
            loss = comb_loss(shell, imp, params, targets[i:i + bs])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy()


def example_comb_nn(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    shell, imp, targets, params = comb_setup(args, device, backend)
    bs = max(1, args.batch_size)
    loss0 = dataset_loss(shell, imp, params, targets)
    n_steps = targets.shape[0] // bs
    losses = comb_fit(shell, imp, params, targets, args.lr,
                      args.max_epochs, bs)
    for epoch in range(args.max_epochs):
        print(f"epoch {epoch}: comb_nn loss "
              f"{losses[(epoch + 1) * n_steps - 1]:.6f}")
    last = dataset_loss(shell, imp, params, targets)
    print(f"e4_recursion_nn[comb_nn] ({backend}) loss over the "
          f"{targets.shape[0]} targets: {loss0:.6f} -> {last:.6f}")
    if not last < loss0:
        raise RuntimeError("the hyper-network failed to improve")
    with torch.no_grad():
        est = batched_forward(shell, imp, params, targets[:1])
    np.savez(os.path.join(args.train_dir, "estimation.npz"),
             freq=np.fft.rfftfreq(args.nfft, 1 / args.samplerate),
             target=targets[0, :, 0].cpu().numpy(),
             estimation=est[0, :, 0].cpu().numpy())
    return losses


# ---------------------------------------------------------------------------
# gains_nn
# ---------------------------------------------------------------------------
GAINS_N = 2
GAINS_TARGET = 0.3


def build_gains(nfft: int, device, solve_method: str = "ge"):
    """The Shell of Series(input gain, Recursion(delays, parallelGain),
    output gain); the loop gains are ``'loop.feedback'``."""
    N = GAINS_N
    delays = dsp.parallelDelay(size=(N,), max_len=200, isint=True, nfft=nfft,
                               device=device)
    gains = dsp.parallelGain(size=(N,), nfft=nfft, requires_grad=True,
                             device=device)
    loop = system.Recursion(fF=delays, fB=gains, solve_method=solve_method)
    core = system.Series(OrderedDict({
        "ig": dsp.Gain(size=(N, 1), nfft=nfft, device=device),
        "loop": loop,
        "og": dsp.Gain(size=(1, N), nfft=nfft, device=device),
    }))
    return system.Shell(core=core, input_layer=dsp.FFT(nfft),
                        output_layer=dsp.Transform(torch.abs))


def init_gains_mlp(generator, sizes=(1, 16, GAINS_N), device=None):
    """[(W, b), ...]: W ~ 0.5 N(0, 1) drawn on the CPU, b = 0."""
    params = []
    for i in range(len(sizes) - 1):
        W = torch.randn((sizes[i], sizes[i + 1]), generator=generator) * 0.5
        params.append((W.to(device).requires_grad_(),
                       torch.zeros(sizes[i + 1], device=device,
                                   requires_grad=True)))
    return params


def gains_mlp(params, c):
    """Loop gains sigmoid(.) 0.9 < 0.9: the loop stays stable."""
    h = c
    for i, (W, b) in enumerate(params):
        h = h @ W + b
        if i < len(params) - 1:
            h = torch.tanh(h)
    return torch.sigmoid(h) * 0.9


def gains_loss(shell, x, params, cond):
    est = shell(x, ext_param={"loop.feedback": gains_mlp(params, cond)[0]})
    return torch.mean((est - GAINS_TARGET) ** 2)


def gains_fit(shell, x, params, cond, steps: int, lr: float = 1e-2):
    """``steps`` Adam steps; each step's loss before its update."""
    opt = torch.optim.Adam([p for layer in params for p in layer], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = gains_loss(shell, x, params, cond)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy()


def gains_setup(args, device, backend: str = "xla"):
    """(shell, impulse, MLP params, conditioning) of gains_nn from
    ``args.seed``."""
    set_seed(args.seed)
    shell = build_gains(args.nfft, device, routes(backend)["solve_method"])
    x = signal_gallery(1, args.nfft, 1, "impulse", device=device)
    params = init_gains_mlp(torch.Generator().manual_seed(args.seed),
                            device=device)
    return shell, x, params, torch.tensor([[0.7]], device=device)


def example_gains_nn(args):
    device = resolve_device(args.device)
    backend = pick_backend(args.backend, device)
    shell, x, params, cond = gains_setup(args, device, backend)
    with torch.no_grad():
        loss0 = float(gains_loss(shell, x, params, cond))
    losses = gains_fit(shell, x, params, cond, args.max_epochs * 10)
    with torch.no_grad():
        last = float(gains_loss(shell, x, params, cond))
    print(f"e4_recursion_nn[gains_nn] ({backend}) loss: {loss0:.5f} -> "
          f"{last:.5f}")
    if not last < loss0:
        raise RuntimeError("gains_nn: the loss did not fall")
    return losses


def main(args):
    scenarios = {"comb_nn": example_comb_nn, "gains_nn": example_gains_nn}
    names = list(scenarios) if args.scenario == "all" else [args.scenario]
    for name in names:
        print(f"--- e4_recursion_nn scenario: {name} ---")
        scenarios[name](args)


def parser():
    ap = example_parser(nfft=4096, max_epochs=3, num=16, batch_size=4,
                        lr=1e-3)
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["comb_nn", "gains_nn", "all"])
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="'pallas': the cascade on K4 and the loop solves "
                         "on K6; 'xla': the plain cascade and the pivoted "
                         "elimination; 'auto': 'pallas' on the card, 'xla' "
                         "on the CPU")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
