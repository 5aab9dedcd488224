"""Active acoustics (counterpart of ``examples/e8_active_acoustics.py``,
DAFx-24): the physical room (measured or synthetic WGN-reverb RIR
matrices), the virtual room (trainable FIR matrix U, WGN reverb tail R,
general gain G) and the feedback-loop shell F_MM, trained with the
eigenvalue objective mse_evs.

    python -m flamo_tpu_torch.examples.e8_active_acoustics [--device cpu]

The workflow: normalize_U -> GBI -> set_G(GBI + start gain) -> eigenvalues
and IR at init -> train mse_evs -> normalize_U -> eigenvalues, IR and GBI
after: the system IRs go to ir_init.wav and ir_optim.wav, the parameters
to .mat files in ``--train_dir``, and the eigenvalue magnitudes' median
over 20 Hz - 20 kHz is printed (the JAX example plots their distribution
and the IRs' spectrograms).
``--fast auto`` (the default) and ``fused`` train through ``aa_evs_fit``
(the Durand-Kerner roots are kernel K7 on the card) and keep its result
when its first loss agrees with mse_evs on the F_MM graph; a failed
check or a non-finite loss raises (``_common.fast_path``).  ``graph``
takes the Trainer.  Measured RIR matrices are read from ``--rir_dir``
(mic{i}_speaker{j}.wav), else synthetic rooms stand in.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flamo_tpu_torch.examples._common import (example_parser, fast_path,
                                              setup)
from flamo_tpu_torch.functional import db2mag, mag2db
from flamo_tpu_torch.models import ActiveAcoustics, aa_evs_fit
from flamo_tpu_torch.optimize import (DatasetColorless, Trainer,
                                      load_dataset, mse_evs)
from flamo_tpu_torch.utils import resolve_device, save_audio


def load_measured_rirs(rir_dir, n_S, n_M, n_L, n_A, rir_length):
    """The room dict from mic{i}_speaker{j}.wav files laid out like the
    reference's measured set: speakers 1..n_L drive mics 1..n_M; the last
    mic column stands in for the audience and the last speaker for the
    source."""
    from scipy.io import wavfile

    def wav(i, j):
        _, data = wavfile.read(
            os.path.join(rir_dir, f"mic{i}_speaker{j}.wav"))
        data = data.astype(np.float32)
        if data.ndim > 1:
            data = data[:, 0]
        return data[:rir_length]

    H_LM = np.stack([np.stack([wav(i + 1, j + 1) for j in range(n_L)], -1)
                     for i in range(n_M)], 1)
    return {"H_LM": H_LM, "H_SM": H_LM[:, :, -n_S:],
            "H_LA": H_LM[:, -n_A:, :], "H_SA": H_LM[:, -n_A:, -n_S:]}


def save_model_params(aa, train_dir, filename):
    """The AA parameters, as a .mat file."""
    from scipy.io import savemat

    def host(module):
        return module.param.detach().cpu().numpy().squeeze()

    param = {"FIR_matrix": host(aa.U), "WGN_reverb": host(aa.R),
             "G": host(aa.G), "H_LM": host(aa.H_LM), "H_LA": host(aa.H_LA),
             "H_SM": host(aa.H_SM), "H_SA": host(aa.H_SA)}
    savemat(os.path.join(train_dir, filename + ".mat"), param)
    return param


def save_ir(aa, path: str) -> None:
    ir = aa.system_simulation()[0].squeeze().cpu().numpy()
    save_audio(path, ir / max(np.abs(ir).max(), 1e-12), fs=aa.fs)


def evs_median(evs, fs: int, nfft: int) -> float:
    """Median eigenvalue magnitude over 20 Hz - 20 kHz."""
    lo = int(nfft / fs * 20)
    hi = int(nfft / fs * min(20000, fs // 2 - 1))
    return float(torch.median(torch.abs(evs[lo:hi])))


def mse_evs_ref(criterion, model, x, t):
    """mse_evs at step 0 on the module graph, no grad: the reference that
    the fast path's first loss is held to."""
    with torch.no_grad():
        return criterion(model(x), t, step=0, state=criterion.mask_indices)


def main(args):
    device = resolve_device(args.device)
    nfft = args.nfft
    M = nfft // 2 + 1
    n_S, n_A = 1, 1
    room_irs = None
    if args.rir_dir:
        room_irs = load_measured_rirs(args.rir_dir, n_S, args.mics,
                                      args.loudspeakers, n_A,
                                      args.rir_length)
    aa = ActiveAcoustics(n_S=n_S, n_M=args.mics, n_L=args.loudspeakers,
                         n_A=n_A, fs=args.samplerate, nfft=nfft,
                         FIR_order=args.fir_order, wgn_RT=args.wgn_rt,
                         alias_decay_db=args.alias_decay_db,
                         room_irs=room_irs, rir_length=args.rir_length,
                         room_t60=args.room_t60, solve_method=args.solve,
                         device=device)

    # performance at initialization
    aa.normalize_U()
    gbi_init = aa.get_current_GBI()
    aa.set_G(db2mag(mag2db(gbi_init) + args.start_gain_db))
    evs_init = aa.get_F_MM_eigenvalues()[0]
    save_ir(aa, os.path.join(args.train_dir, "ir_init.wav"))
    save_model_params(aa, args.train_dir, "AA_parameters_init")

    # train the eigenvalue objective
    ds = DatasetColorless(input_shape=(1, M, args.mics),
                          target_shape=(1, M, args.mics), expand=args.num,
                          device=device)
    train_loader, valid_loader = load_dataset(
        ds, batch_size=args.batch_size, split=args.split, shuffle=False)
    criterion = mse_evs(iter_num=len(train_loader), freq_points=M,
                        device=device)
    n_steps = args.max_epochs * len(train_loader)
    fast = None
    if args.fast != "graph":
        x0, t0 = next(iter(train_loader))
        graph_loss = float(mse_evs_ref(criterion, aa.F_MM, x0, t0))
        # consecutive steps read different bin partitions, so the last
        # loss is held to the example's own 5 % margin over the first
        fast = fast_path(args.fast, graph_loss, lambda: aa_evs_fit(
            aa, t0[0], n_steps=n_steps, lr=args.lr,
            iter_num=len(train_loader), masks=criterion.mask_indices),
            rise=1.05)
    if fast is not None:
        trained, losses = fast
        train_loss = [float(losses[0]), float(losses[-1])]
    else:
        trainer = Trainer(aa.F_MM, max_epochs=args.max_epochs, lr=args.lr,
                          patience_delta=args.patience_delta,
                          train_dir=args.train_dir)
        trainer.register_criterion(criterion, 1)
        trainer.train(train_loader, valid_loader)
        trained = trainer.net
        train_loss = trainer.train_loss
    print("active acoustics final MSE_evs:", train_loss[-1])
    if not np.isfinite(train_loss[-1]):
        raise RuntimeError("the final loss is not finite")
    if train_loss[-1] > train_loss[0] * 1.05:
        raise RuntimeError("the eigenvalue loss did not improve")

    # performance after optimization
    aa.adopt(trained)
    aa.normalize_U()
    evs_opt = aa.get_F_MM_eigenvalues()[0]
    save_ir(aa, os.path.join(args.train_dir, "ir_optim.wav"))
    gbi_opt = aa.get_current_GBI()
    print(f"GBI init = {float(mag2db(gbi_init)):.2f} dB, "
          f"GBI optimized = {float(mag2db(gbi_opt)):.2f} dB; median "
          f"|eigenvalue| 20 Hz - 20 kHz: init "
          f"{evs_median(evs_init, args.samplerate, nfft):.4f}, optimized "
          f"{evs_median(evs_opt, args.samplerate, nfft):.4f}")
    save_model_params(aa, args.train_dir, "AA_parameters_optim")
    if not (np.isfinite(float(mag2db(gbi_opt)))
            and bool(torch.isfinite(torch.abs(evs_opt)).all())
            and bool(torch.isfinite(torch.abs(evs_init)).all())):
        raise RuntimeError("the eigenvalues or the GBI are not finite")
    return train_loss


def parser():
    ap = example_parser(nfft=4096, max_epochs=2, num=8, batch_size=1,
                        lr=1e-3)
    ap.add_argument("--mics", type=int, default=2,
                    help="number of microphones (reference: 4)")
    ap.add_argument("--loudspeakers", type=int, default=3,
                    help="number of loudspeakers (reference: 13)")
    ap.add_argument("--fir_order", type=int, default=16,
                    help="virtual-room FIR order (reference: 100)")
    ap.add_argument("--wgn_rt", type=float, default=0.1,
                    help="virtual-room WGN reverb RT60 (reference: 1.0)")
    ap.add_argument("--room_t60", type=float, default=0.1,
                    help="synthetic physical-room RT60")
    ap.add_argument("--alias_decay_db", type=float, default=0.0,
                    help="time-alias decay (reference example: -20)")
    ap.add_argument("--start_gain_db", type=float, default=0.0,
                    help="dB offset from the GBI at training start")
    ap.add_argument("--fast", type=str, default="auto",
                    choices=["auto", "fused", "graph"],
                    help="eigenvalue-training path: 'auto' and 'fused' "
                         "train through aa_evs_fit (K7 on the card) behind "
                         "a first-loss parity check that raises when it "
                         "fails; 'graph' takes the Trainer")
    ap.add_argument("--rir_dir", type=str, default=None,
                    help="directory of measured mic{i}_speaker{j}.wav RIRs")
    ap.add_argument("--rir_length", type=int, default=None,
                    help="truncate RIRs to this many samples "
                         "(reference: 15000)")
    ap.add_argument("--solve", type=str, default="ge",
                    choices=["ge", "ge_nopivot", "ge_cached", "lu",
                             "pallas"],
                    help="closed-loop solve of system_simulation")
    return ap


if __name__ == "__main__":
    main(setup(parser().parse_args()))
