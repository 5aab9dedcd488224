"""FDN matched to a room impulse response (counterpart of
``examples/e8_fdn.py``), the scenarios ``fdn`` and ``direct``:

* ``fdn``: an N=6 FDN, delays 593..1699 in the feedforward path, an
  orthogonal mixing matrix and a sigmoid-dB octave ``parallelGEQ`` in the
  feedback path, 30 dB alias decay undone by an ``iFFTAntiAlias`` output
  layer, trained against a target RIR with ``mss_loss`` (FFT sizes 256,
  512, 1024) + ``sparsity_loss``;
* ``direct``: the same FDN in a ``Parallel`` with a clip-mapped direct
  gain.

    python -m flamo_tpu_torch.examples.e8_fdn [--device cpu] [--nfft N]

The target is a synthetic WGN reverb (t60 0.25 s) unless ``--rir`` names
a WAV.  ``--backend auto`` (the default) is 'pallas' on the card (the
GEQ cascade through K4, the loop solve through K2) and 'xla' on the CPU
(plain cascade, pivoted elimination).  The 'pallas' model is checked
against an 'xla' build from the same seed: a first loss outside 5e-3 of
the 'xla' build's raises, as does an error of a kernel's build or launch.
Training is ``Trainer.train`` (``scan=True`` on the card).  Writes
ir_init_<scenario>.wav and ir_optim_<scenario>.wav into ``--train_dir``.
The scenarios ``accurate_geq`` and ``delay_scaled`` need the reverb
module (``auxiliary/reverb.py``), not ported yet.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.examples._common import example_parser, setup
from flamo_tpu_torch.functional import (WGN_reverb, _clip, find_onset,
                                        signal_gallery)
from flamo_tpu_torch.models.attenuated_fdn import _sigmoid_db_map
from flamo_tpu_torch.optimize import (Dataset, Trainer, load_dataset,
                                      mss_loss, sparsity_loss)
from flamo_tpu_torch.optimize.trainer import FUSED_PARITY
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import (load_audio, resolve_device, save_audio,
                                   set_seed)

DELAYS = (593, 743, 929, 1153, 1399, 1699)
ALIAS_DB = 30
MSS_NFFT = [256, 512, 1024]


def _clip_unit(x):
    """The direct gain's map, ``jnp.clip(x, -1, 1)`` with its gradient."""
    return _clip(x, -1.0, 1.0)


def _target_rir(args, nfft: int, device) -> torch.Tensor:
    """(1, nfft, 1) target: the measured WAV of ``--rir`` (first channel,
    peak-normalised, from its onset), else a WGN reverb of t60 0.25 s,
    zero-padded to nfft."""
    if args.rir:
        rir, _ = load_audio(args.rir)
        rir = torch.tensor(rir[:, :1], device=device)
        rir = rir / torch.max(torch.abs(rir))
        onset = find_onset(rir[:, 0])
        rir = rir[onset:onset + nfft]
    else:
        rir = WGN_reverb((1,), t60=0.25, samplerate=args.samplerate,
                         device=device)[:nfft]
    rir = torch.nn.functional.pad(rir, (0, 0, 0, max(0, nfft - rir.shape[0])))
    return rir[None, :, :]


def _save_ir(model, path: str, fs: int) -> np.ndarray:
    """Render the model's IR and write it as a peak-normalised WAV."""
    ir = model.get_time_response(fs=fs).squeeze().cpu().numpy()
    if not np.isfinite(ir).all():
        raise RuntimeError(f"the IR written to {path} is not finite")
    save_audio(path, ir / np.max(np.abs(ir)), fs=fs)
    return ir


def _build_reference_fdn(args, N: int, delay_lengths, alias_db: float,
                         direct: bool = False, backend: str = "xla",
                         device=None) -> system.Shell:
    """Shell(FFT -> core -> iFFTAntiAlias) with core Series(Gain(N, 1),
    Recursion(parallelDelay, Series(orthogonal Matrix, sigmoid-dB
    parallelGEQ)), Gain(1, N)), beside a clip-mapped Gain(1, 1) in a
    ``Parallel`` with ``direct``.  ``backend='pallas'`` evaluates the GEQ
    cascade with K4 (``cascade_backend``) and solves the loop with K2
    (``solve_method``); 'xla' with the plain cascade and the pivoted
    elimination 'ge'."""
    nfft = args.nfft
    device = resolve_device(device)
    common = dict(nfft=nfft, alias_decay_db=alias_db, device=device)
    ig = dsp.Gain(size=(N, 1), requires_grad=True, **common)
    og = dsp.Gain(size=(1, N), requires_grad=True, **common)
    dl = dsp.parallelDelay(size=(N,), max_len=int(max(delay_lengths)),
                           isint=True, **common)
    dl.assign_value(dl.sample2s(torch.tensor(delay_lengths,
                                             dtype=torch.float32)))
    mix = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                     requires_grad=True, **common)
    atten = dsp.parallelGEQ(
        size=(N,), octave_interval=1, fs=args.samplerate, map=_sigmoid_db_map,
        requires_grad=True,
        cascade_backend="pallas" if backend == "pallas" else "xla",
        **common)
    fb = system.Series(OrderedDict(
        {"mixing_matrix": mix, "attenuation": atten}))
    loop = system.Recursion(fF=dl, fB=fb, solve_method=(
        "pallas" if backend == "pallas" else "ge"))
    branch_a = system.Series(OrderedDict({
        "input_gain": ig, "feedback_loop": loop, "output_gain": og}))
    if direct:
        dg = dsp.Gain(size=(1, 1), requires_grad=True, map=_clip_unit,
                      **common)
        core = system.Parallel(
            branch_a, system.Series(OrderedDict({"direct": dg})))
    else:
        core = branch_a
    return system.Shell(
        core=core, input_layer=dsp.FFT(nfft),
        output_layer=dsp.iFFTAntiAlias(nfft=nfft, alias_decay_db=alias_db,
                                       device=device))


def first_loss(model, target, sample_rate: int = 48000) -> torch.Tensor:
    """The training objective at the model's current weights on the
    impulse: mss_loss(256, 512, 1024) + sparsity_loss."""
    x = signal_gallery(1, model.nfft, 1, "impulse", device=target.device)
    est = model(x)
    return (mss_loss(nfft=MSS_NFFT, sample_rate=sample_rate)(est, target)
            + sparsity_loss()(est, target, model))


def _pick_backend(args, build_fn, target, device):
    """Resolve ``--backend`` into ``(model, backend)``.  'auto' is 'xla'
    on the CPU and 'pallas' on the card.  A 'pallas' model is built beside
    an 'xla' one from the same seed and kept only when its first loss is
    within FUSED_PARITY of the 'xla' model's; otherwise this raises.  An
    error of a kernel propagates."""
    choice = args.backend
    if choice == "auto":
        choice = "xla" if device.type == "cpu" else "pallas"
    if choice == "xla":
        set_seed(args.seed)
        return build_fn("xla"), "xla"
    models, losses = {}, {}
    for be in ("xla", "pallas"):
        set_seed(args.seed)  # the same initial weights on both routes
        models[be] = build_fn(be)
        with torch.no_grad():
            losses[be] = float(first_loss(models[be], target,
                                          args.samplerate))
    rel = abs(losses["pallas"] - losses["xla"]) / max(1e-9,
                                                      abs(losses["xla"]))
    if rel >= FUSED_PARITY:
        raise RuntimeError(f"pallas backend parity gate failed: {losses}, "
                           f"rel={rel:.2e}")
    print(f"backend=pallas (K4 cascade, K2 solve; first-loss parity "
          f"rel={rel:.1e})")
    return models["pallas"], "pallas"


def _train_to_rir(args, model, tag: str, target) -> Trainer:
    """Write the initial IR, train on (impulse, target) expanded ``--num``
    times with mss_loss + sparsity_loss, write the trained IR."""
    device = target.device
    _save_ir(model, os.path.join(args.train_dir, f"ir_init_{tag}.wav"),
             args.samplerate)
    ds = Dataset(input=signal_gallery(1, args.nfft, 1, "impulse",
                                      device=device),
                 target=target, expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=args.train_dir)
    trainer.register_criterion(
        mss_loss(nfft=MSS_NFFT, sample_rate=args.samplerate), 1)
    trainer.register_criterion(sparsity_loss(), 1, requires_model=True)
    trainer.train(tl, vl, scan=args.scan or device.type != "cpu")
    _save_ir(trainer.net,
             os.path.join(args.train_dir, f"ir_optim_{tag}.wav"),
             args.samplerate)
    print(f"e8_fdn[{tag}] final loss:", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError("the final loss is not finite")
    return trainer


def example_fdn(args, direct: bool = False) -> Trainer:
    """Train the N=6 FDN (beside a direct gain with ``direct``) to the
    target RIR."""
    device = resolve_device(args.device)
    target = _target_rir(args, args.nfft, device)
    model, _ = _pick_backend(args, lambda be: _build_reference_fdn(
        args, N=len(DELAYS), delay_lengths=DELAYS, alias_db=ALIAS_DB,
        direct=direct, backend=be, device=device), target, device)
    return _train_to_rir(args, model, "direct" if direct else "fdn", target)


def example_fdn_direct(args) -> Trainer:
    return example_fdn(args, direct=True)


def _not_ported(args):
    raise NotImplementedError(
        f"e8_fdn scenario {args.scenario!r} needs auxiliary/reverb.py, not "
        "ported yet (ROADMAP queue 1, item 7)")


SCENARIOS = {"fdn": example_fdn, "direct": example_fdn_direct,
             "accurate_geq": _not_ported, "delay_scaled": _not_ported}


def main(args):
    names = ["fdn", "direct"] if args.scenario == "all" else [args.scenario]
    trainers = []
    for name in names:
        print(f"--- e8_fdn scenario: {name} ---")
        trainers.append(SCENARIOS[name](args))
    return trainers


def parser():
    ap = example_parser(nfft=8192, max_epochs=3, num=16, batch_size=2,
                        lr=1e-3)
    ap.add_argument("--rir", type=str, default=None,
                    help="path to a measured RIR wav (optional)")
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["fdn", "accurate_geq", "direct",
                             "delay_scaled", "all"],
                    help="'all' runs fdn and direct")
    ap.add_argument("--scan", action="store_true",
                    help="train each epoch through Trainer.fit_scan_epochs "
                         "(always on the card)")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="'pallas': the GEQ cascade through K4 and the loop "
                         "solve through K2; 'xla': the plain cascade and the "
                         "pivoted elimination; 'auto': 'pallas' on the card, "
                         "'xla' on the CPU.  'pallas' raises when its first "
                         "loss is outside 5e-3 of an 'xla' build's")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
