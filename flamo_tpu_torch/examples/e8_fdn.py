"""FDN matched to a room impulse response (counterpart of
``examples/e8_fdn.py``), four scenarios:

* ``fdn``: an N=6 FDN, delays 593..1699 in the feedforward path, an
  orthogonal mixing matrix and a sigmoid-dB octave ``parallelGEQ`` in the
  feedback path, 30 dB alias decay undone by an ``iFFTAntiAlias`` output
  layer, trained against a target RIR with ``mss_loss`` (FFT sizes 256,
  512, 1024) + ``sparsity_loss``;
* ``accurate_geq``: the N=6 FDN with a ``parallelFDNAccurateGEQ``
  attenuation (not trainable) assigned a target RT profile: its IR, and
  the RT that the attenuation of delay line 0 realizes at the band
  centers, whose mean squared error from the target must stay below
  0.01 s^2;
* ``direct``: the ``fdn`` FDN in a ``Parallel`` with a clip-mapped direct
  gain;
* ``delay_scaled``: an N=4 FDN (delays 179..251, 30 dB alias decay) with
  a delay-scaled attenuation picked by ``--attenuation`` (``geq``,
  ``accurate_geq``, ``peq`` or ``shelving``), trained with ``mss_loss`` +
  0.2 ``sparsity_loss``; ``--scan`` trains each epoch through
  ``Trainer.fit_scan_epochs``.

    python -m flamo_tpu_torch.examples.e8_fdn [--device cpu] [--nfft N]
        [--scenario fdn|accurate_geq|direct|delay_scaled|all]
        [--attenuation geq|accurate_geq|peq|shelving] [--scan]

The target is a synthetic WGN reverb (t60 0.25 s) unless ``--rir`` names
a WAV.  ``--backend auto`` (the default) is 'pallas' on the card (the
loop solve through K2, the ``parallelGEQ``'s and the accurate GEQ's
cascades through K4) and 'xla' on the CPU (plain cascades, pivoted
elimination).  A 'pallas' model is checked against an 'xla' build from
the same seed, and the check raises when it fails, as does an error of a
kernel's build or launch: a trained scenario's first loss must lie within
5e-3 of the 'xla' build's; the accurate attenuation's |H| within 1e-4 of
the max of the 'xla' build's, else both within the example's float64
rule (:func:`check_accurate_routes`).  The trained scenarios write
ir_init_<scenario>.wav and ir_optim_<scenario>.wav (``delay_scaled`` its
magnitudes, fdn_magnitude.npz), ``accurate_geq`` ir_accurate_geq.wav and
filter_response.npz, into ``--train_dir``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.reverb import (parallelFDNAccurateGEQ,
                                              parallelFDNGEQ, parallelFDNPEQ,
                                              parallelFirstOrderShelving)
from flamo_tpu_torch.examples._common import (example_parser, pick_backend,
                                              setup)
from flamo_tpu_torch.functional import (WGN_reverb, _clip, find_onset,
                                        signal_gallery)
from flamo_tpu_torch.models.attenuated_fdn import _sigmoid_db_map
from flamo_tpu_torch.optimize import (Dataset, Trainer, load_dataset,
                                      mss_loss, sparsity_loss, stack_loader)
from flamo_tpu_torch.optimize.trainer import FUSED_PARITY
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import (load_audio, resolve_device, save_audio,
                                   set_seed)

DELAYS = (593, 743, 929, 1153, 1399, 1699)
ALIAS_DB = 30
MSS_NFFT = [256, 512, 1024]
# accurate_geq: the target RT60 (s) of each band of the octave accurate GEQ
TARGET_RT = (0.25, 0.5, 0.5, 0.65, 0.7, 0.75, 0.8, 0.75, 0.65, 0.5, 0.25)
RT_MSE_TOL = 0.01
# the accurate attenuation's |H| on 'pallas' against 'xla', of the max;
# past it, each route against a float64 evaluation of the same taps, the
# 'pallas' one within ACC_F64_FACTOR times the 'xla' one's distance
ACC_ROUTE_TOL, ACC_F64_FACTOR = 1e-4, 2.0
# delay_scaled: an N=4 FDN, its sparsity weight
DS_DELAYS = (179, 211, 233, 251)
DS_SPARSITY = 0.2
ATTENUATIONS = ("geq", "accurate_geq", "peq", "shelving")


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


def first_loss(model, target, sample_rate: int = 48000,
               sparsity: float = 1.0) -> torch.Tensor:
    """The training objective at the model's current weights on the
    impulse: mss_loss(256, 512, 1024) + ``sparsity`` sparsity_loss."""
    x = signal_gallery(1, model.nfft, 1, "impulse", device=target.device)
    est = model(x)
    return (mss_loss(nfft=MSS_NFFT, sample_rate=sample_rate)(est, target)
            + sparsity * sparsity_loss()(est, target, model))


def _pick_backend(args, build_fn, target, device, loss=None):
    """Resolve ``--backend`` into ``(model, backend)``.  'auto' is 'xla'
    on the CPU and 'pallas' on the card.  A 'pallas' model is built beside
    an 'xla' one from the same seed and kept only when its first loss
    (``loss(model, target, sample_rate)``, by default :func:`first_loss`)
    is within FUSED_PARITY of the 'xla' model's; otherwise this raises.
    An error of a kernel propagates."""
    loss = first_loss if loss is None else loss
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
            losses[be] = float(loss(models[be], target, args.samplerate))
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


# ---------------------------------------------------------------------------
# accurate_geq: the accurate attenuation's realized RT
# ---------------------------------------------------------------------------
def build_accurate_fdn(args, backend: str = "xla", device=None):
    """(Shell(FFT -> core -> iFFT), attenuation): core Series(Gain(6, 1),
    Recursion(parallelDelay, Series(orthogonal Matrix,
    parallelFDNAccurateGEQ assigned TARGET_RT)), Gain(1, 6)), no alias
    decay.  'pallas' solves the loop with K2 and evaluates the accurate
    GEQ's cascade with K4f."""
    nfft = args.nfft
    device = resolve_device(device)
    N = len(DELAYS)
    common = dict(nfft=nfft, device=device)
    ig = dsp.Gain(size=(N, 1), requires_grad=True, **common)
    og = dsp.Gain(size=(1, N), requires_grad=True, **common)
    dl = dsp.parallelDelay(size=(N,), max_len=int(max(DELAYS)), isint=True,
                           **common)
    dl.assign_value(dl.sample2s(torch.tensor(DELAYS, dtype=torch.float32)))
    mix = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                     requires_grad=True, **common)
    atten = parallelFDNAccurateGEQ(
        octave_interval=1, fs=args.samplerate, delays=DELAYS,
        cascade_backend="pallas" if backend == "pallas" else "xla", **common)
    atten.assign_value(torch.tensor(TARGET_RT))
    fb = system.Series(OrderedDict(
        {"mixing_matrix": mix, "attenuation": atten}))
    loop = system.Recursion(fF=dl, fB=fb, solve_method=(
        "pallas" if backend == "pallas" else "ge"))
    core = system.Series(OrderedDict({
        "input_gain": ig, "feedback_loop": loop, "output_gain": og}))
    model = system.Shell(core=core, input_layer=dsp.FFT(nfft),
                         output_layer=dsp.iFFT(nfft))
    return model, atten


def attenuation_magnitude(atten) -> torch.Tensor:
    """|H| (M, N) of the attenuation alone, through a Shell's frequency
    response (one response of the module)."""
    shell = system.Shell(core=atten, input_layer=dsp.FFT(atten.nfft),
                         output_layer=dsp.Transform(torch.abs))
    return torch.abs(shell.get_freq_response()[0])


def accurate_f64(atten) -> torch.Tensor:
    """|H| (M, ...) of a float64 evaluation of ``atten``'s own taps (the
    alias envelope folded in, the plain guarded cascade)."""
    be, ae = atten.sos_taps(None)
    return dsp._guarded_cascade(be.double(), ae.double(), atten.nfft,
                                "xla").abs()


def check_accurate_routes(H_pallas, H_xla, atten_xla) -> dict:
    """The accurate attenuation's |H| on 'pallas' against 'xla': within
    ACC_ROUTE_TOL of the max, else each route held to a float64
    evaluation of the same taps, 'pallas' within ACC_F64_FACTOR times
    'xla''s distance.  Raises when it fails; returns the distances."""
    gap = float(torch.max(torch.abs(H_pallas - H_xla))
                / torch.max(torch.abs(H_xla)))
    out = {"gap": gap, "f64": None}
    if gap < ACC_ROUTE_TOL:
        return out
    ref = accurate_f64(atten_xla)
    out["f64"] = {be: float(torch.max(torch.abs(H.double() - ref))
                            / torch.max(ref))
                  for be, H in (("xla", H_xla), ("pallas", H_pallas))}
    if not out["f64"]["pallas"] <= ACC_F64_FACTOR * out["f64"]["xla"]:
        raise RuntimeError(
            f"accurate GEQ: the routes' |H| are {gap:.3e} of the max apart "
            f"and pallas lies {out['f64']['pallas']:.3e} from the float64 "
            f"taps, more than {ACC_F64_FACTOR:g}x xla's "
            f"{out['f64']['xla']:.3e}")
    return out


def realized_rt(H0: torch.Tensor, delay: int, fs: int):
    """(band-center RT60s, RT60 at every bin) that a per-pass gain |H0|
    (M,) realizes on a delay line of ``delay`` samples."""
    mag = np.maximum(H0.cpu().numpy().astype(np.float64), 1e-12)
    with np.errstate(divide="ignore"):
        return -3 / fs / np.log10(mag ** (1.0 / delay))


def example_fdn_accurate_geq(args) -> dict:
    """The accurate GEQ's realized RT: render the FDN's IR, then the RT
    that the attenuation of delay line 0 realizes at the band centers
    (the shelving crossovers and the centers) against TARGET_RT; raises
    when their mean squared error reaches RT_MSE_TOL.  On 'pallas' the
    attenuation's |H| is first held to an 'xla' build's from the same
    seed (:func:`check_accurate_routes`)."""
    device = resolve_device(args.device)
    fs = args.samplerate
    backend = pick_backend(args.backend, device)
    set_seed(args.seed)
    model, atten = build_accurate_fdn(args, backend, device)
    H = attenuation_magnitude(atten)
    routes = None
    if backend == "pallas":
        set_seed(args.seed)
        _, atten_x = build_accurate_fdn(args, "xla", device)
        routes = check_accurate_routes(H, attenuation_magnitude(atten_x),
                                       atten_x)
        print(f"backend=pallas (K4 cascade, K2 solve; |H| against xla "
              f"{routes['gap']:.1e} of the max)")
    ir = _save_ir(model, os.path.join(args.train_dir, "ir_accurate_geq.wav"),
                  fs)
    centers = ([atten.shelving_crossover[0]] + list(atten.center_freq)
               + [atten.shelving_crossover[1]])
    rt = realized_rt(H[:, 0], DELAYS[0], fs)
    freqs = np.linspace(0, fs / 2, args.nfft // 2 + 1)
    idx = [int(np.argmin(np.abs(freqs - f))) for f in centers]
    rt_mse = float(np.mean((rt[idx] - np.asarray(TARGET_RT)) ** 2))
    np.savez(os.path.join(args.train_dir, "filter_response.npz"),
             freqs=freqs, simulated_rt=rt, centers=np.asarray(centers),
             target_rt=np.asarray(TARGET_RT))
    print("e8_fdn[accurate_geq] RT MSE at band centers:", rt_mse)
    if not rt_mse < RT_MSE_TOL:
        raise RuntimeError(f"accurate_geq: the RT MSE {rt_mse:.4g} is not "
                           f"below {RT_MSE_TOL}")
    return dict(rt_mse=rt_mse, routes=routes, ir=ir, H=H, backend=backend)


# ---------------------------------------------------------------------------
# delay_scaled: the delay-scaled attenuation families
# ---------------------------------------------------------------------------
def build_delay_scaled(args, attenuation: str, backend: str = "xla",
                       device=None) -> system.Shell:
    """Shell(FFT -> core -> iFFTAntiAlias) with core Series(Gain(4, 1),
    Recursion(Series(parallelDelay, attenuation), orthogonal Matrix),
    Gain(1, 4)), alias decay 30 dB; ``attenuation`` one of ATTENUATIONS
    (the trainable ones train).  'pallas' solves the loop with K2 and the
    accurate GEQ's cascade with K4f (the trainable families have no
    kernel route, as in the JAX package)."""
    nfft, fs = args.nfft, args.samplerate
    device = resolve_device(device)
    N = len(DS_DELAYS)
    common = dict(nfft=nfft, alias_decay_db=ALIAS_DB, device=device)
    ig = dsp.Gain(size=(N, 1), requires_grad=True, **common)
    og = dsp.Gain(size=(1, N), requires_grad=True, **common)
    dl = dsp.parallelDelay(size=(N,), max_len=max(DS_DELAYS), isint=True,
                           **common)
    dl.assign_value(dl.sample2s(torch.tensor(DS_DELAYS,
                                             dtype=torch.float32)))
    if attenuation == "geq":
        atten = parallelFDNGEQ(octave_interval=1, fs=fs, delays=DS_DELAYS,
                               requires_grad=True, **common)
    elif attenuation == "accurate_geq":
        atten = parallelFDNAccurateGEQ(
            octave_interval=1, fs=fs, delays=DS_DELAYS,
            cascade_backend="pallas" if backend == "pallas" else "xla",
            **common)
    elif attenuation == "peq":
        atten = parallelFDNPEQ(n_bands=6, delays=DS_DELAYS, fs=fs,
                               requires_grad=True, **common)
    elif attenuation == "shelving":
        atten = parallelFirstOrderShelving(fs=fs, delays=DS_DELAYS,
                                           requires_grad=True, **common)
    else:
        raise ValueError(f"attenuation must be one of {ATTENUATIONS}, got "
                         f"{attenuation!r}")
    fb = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                    requires_grad=True, **common)
    loop = system.Recursion(
        fF=system.Series(OrderedDict({"delays": dl, "attenuation": atten})),
        fB=fb, solve_method="pallas" if backend == "pallas" else "ge")
    core = system.Series(OrderedDict({
        "input_gain": ig, "feedback_loop": loop, "output_gain": og}))
    return system.Shell(core=core, input_layer=dsp.FFT(nfft),
                        output_layer=dsp.iFFTAntiAlias(
                            nfft=nfft, alias_decay_db=ALIAS_DB,
                            device=device))


def delay_scaled_trainer(args, model, target, **trainer_kw):
    """(Trainer, train loader, valid loader): mss_loss(256, 512, 1024) +
    DS_SPARSITY sparsity_loss on (impulse, target) expanded ``--num``
    times; ``trainer_kw`` go to the Trainer."""
    device = target.device
    ds = Dataset(input=signal_gallery(1, args.nfft, 1, "impulse",
                                      device=device),
                 target=target, expand=args.num, device=device)
    tl, vl = load_dataset(ds, batch_size=args.batch_size, split=args.split)
    trainer = Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=args.train_dir, **trainer_kw)
    trainer.register_criterion(
        mss_loss(nfft=MSS_NFFT, sample_rate=args.samplerate), 1)
    trainer.register_criterion(sparsity_loss(), DS_SPARSITY,
                               requires_model=True)
    return trainer, tl, vl


def example_delay_scaled(args) -> Trainer:
    """Train the N=4 FDN with the ``--attenuation`` family to the target
    RIR (``--scan``: Trainer.fit_scan_epochs over stacked batches; else
    Trainer.train) and write the target's and the trained model's
    magnitudes."""
    device = resolve_device(args.device)
    target = _target_rir(args, args.nfft, device)
    model, _ = _pick_backend(
        args, lambda be: build_delay_scaled(args, args.attenuation, be,
                                            device),
        target, device,
        loss=lambda m, t, sr: first_loss(m, t, sr, DS_SPARSITY))
    trainer, tl, vl = delay_scaled_trainer(args, model, target)
    if args.scan:
        bx, bt = stack_loader(tl)
        history = trainer.fit_scan_epochs(bx, bt, n_epochs=args.max_epochs)
        trainer.train_loss = [float(history[0]), float(history[-1])]
        print(f"fit_scan_epochs: loss {history[0]:.4f} -> "
              f"{history[-1]:.4f} over {len(history)} steps")
    else:
        trainer.train(tl, vl)
    with torch.no_grad():
        opt_H = trainer.net.get_freq_response()[0, :, 0]
    np.savez(os.path.join(args.train_dir, "fdn_magnitude.npz"),
             target=np.abs(np.fft.rfft(target[0, :, 0].cpu().numpy())),
             optimized=opt_H.abs().cpu().numpy())
    print("e8_fdn[delay_scaled] final loss:", trainer.train_loss[-1])
    if not np.isfinite(trainer.train_loss[-1]):
        raise RuntimeError("the final loss is not finite")
    return trainer


SCENARIOS = {"fdn": example_fdn, "accurate_geq": example_fdn_accurate_geq,
             "direct": example_fdn_direct,
             "delay_scaled": example_delay_scaled}


def main(args):
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    results = []
    for name in names:
        print(f"--- e8_fdn scenario: {name} ---")
        results.append(SCENARIOS[name](args))
    return results


def parser():
    ap = example_parser(nfft=8192, max_epochs=3, num=16, batch_size=2,
                        lr=1e-3)
    ap.add_argument("--rir", type=str, default=None,
                    help="path to a measured RIR wav (optional)")
    ap.add_argument("--scenario", type=str, default="all",
                    choices=["fdn", "accurate_geq", "direct",
                             "delay_scaled", "all"],
                    help="'all' runs the four")
    ap.add_argument("--attenuation", type=str, default="geq",
                    choices=list(ATTENUATIONS),
                    help="delay_scaled's attenuation family")
    ap.add_argument("--scan", action="store_true",
                    help="fdn, direct: Trainer.train(scan=True) (always on "
                         "the card); delay_scaled: each epoch through "
                         "Trainer.fit_scan_epochs")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="'pallas': the loop solve through K2, the GEQ and "
                         "accurate GEQ cascades through K4; 'xla': the plain "
                         "cascades and the pivoted elimination; 'auto': "
                         "'pallas' on the card, 'xla' on the CPU.  'pallas' "
                         "raises when its first loss is outside 5e-3 of an "
                         "'xla' build's (the accurate attenuation: its |H| "
                         "outside 1e-4 of the max)")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
