"""Graphic-EQ design helpers (counterpart of ``flamo_tpu/auxiliary/eq.py``).

:func:`geq` builds every band branch-free and takes a batch of gain
vectors at once (trailing dimensions), where the JAX package maps it over
channels with ``vmap``.  :func:`accurate_geq` designs on the host in
float64 (the prototype bank probed at 2^16 points, then a bounded linear
least squares for the command gains) and hands the gains to :func:`geq`
in the caller's dtype; it runs once per design, never in a training
step.
"""

from __future__ import annotations

import numpy as np
import torch

from flamo_tpu_torch.functional import db2mag, peak_filter, shelving_filter


def octave_bands(interval: int = 1, start_freq: float = 31.25,
                 end_freq: float = 16000.0):
    """Octave-band center frequencies."""
    central_freq = []
    c_freq = start_freq
    while c_freq < end_freq:
        central_freq.append(c_freq * np.power(2, 1 / interval))
        c_freq = central_freq[-1]
    return central_freq


def eq_freqs(interval: int = 1, start_freq: float = 31.25,
             end_freq: float = 16000.0, dtype: torch.dtype = torch.float32):
    """Center and shelving crossover frequencies, as CPU tensors."""
    center_freq = torch.tensor(
        octave_bands(interval=interval, start_freq=start_freq,
                     end_freq=end_freq), dtype=dtype)
    shelving_crossover = torch.tensor([
        float(center_freq[0]) / np.power(2, 1 / interval / 2),
        float(center_freq[-1]) * np.power(2, 1 / interval / 2),
    ], dtype=dtype)
    return center_freq, shelving_crossover


def geq(center_freq, shelving_freq, R, gain_db, fs: int = 48000,
        dtype: torch.dtype = torch.float32):
    """GEQ as an SOS cascade: DC gain, low shelf, peaks, high shelf.

    gain_db: (num_bands, *batch) with num_bands = len(center) +
    len(shelving) + 1.  Returns (b, a), each (3, num_bands, *batch), on
    gain_db's device.  ``R`` stays a host scalar, so a design from
    frequencies already on that device copies nothing from the host."""
    gain_db = torch.as_tensor(gain_db, dtype=dtype)
    dev = gain_db.device
    center_freq = torch.as_tensor(center_freq, dtype=dtype, device=dev)
    shelving_freq = torch.as_tensor(shelving_freq, dtype=dtype, device=dev)
    num_bands = center_freq.shape[0] + shelving_freq.shape[0] + 1
    if gain_db.shape[0] != num_bands:
        raise AssertionError(
            "The number of gains must be equal to the number of "
            "frequencies.")
    batch = gain_db.shape[1:]
    # band 0: pure gain
    g0 = db2mag(gain_db[0])
    zero = torch.zeros_like(g0)
    b0 = torch.stack([g0, zero, zero])[:, None]
    a0 = torch.stack([torch.ones_like(g0), zero, zero])[:, None]
    # band 1: low shelf; last band: high shelf
    b_ls, a_ls = shelving_filter(shelving_freq[0], db2mag(gain_db[1]),
                                 "low", fs=fs, dtype=dtype)
    b_hs, a_hs = shelving_filter(shelving_freq[1], db2mag(gain_db[-1]),
                                 "high", fs=fs, dtype=dtype)
    # middle bands: peaks, vectorized over center frequencies
    R = torch.as_tensor(R, dtype=dtype)
    Q = torch.sqrt(R) / (R - 1)
    cf = center_freq.reshape((-1,) + (1,) * len(batch))
    b_pk, a_pk = peak_filter(cf, db2mag(gain_db[2:-1]), Q, fs=fs,
                             dtype=dtype)  # (3, n_center, *batch)
    b = torch.cat([b0, b_ls[:, None], b_pk, b_hs[:, None]], dim=1)
    a = torch.cat([a0, a_ls[:, None], a_pk, a_hs[:, None]], dim=1)
    return b, a


def accurate_geq(target_gain, center_freq, shelving_crossover, fs: int = 48000,
                 dtype: torch.dtype = torch.float32):
    """Accurate GEQ design (Schlecht & Habets 2017): the command gains
    whose cascade best meets ``target_gain`` (len(center_freq) + 2 dB
    values) at 101 log-spaced control frequencies.

    A 10 dB prototype bank is probed at 2^16 rfft points, its dB
    magnitudes interpolated at the control frequencies give the
    interaction matrix, and ``scipy.optimize.lsq_linear`` solves the
    bounded fit (command gains within +-20 dB, the DC gain free): the
    problem is linear in the gains, so this is exact and deterministic.
    Host-side float64 throughout; returns (b, a), each (3,
    len(center_freq) + 3), CPU tensors in ``dtype``."""
    from scipy.optimize import lsq_linear

    target_gain = np.asarray(target_gain, dtype=np.float64)
    center_freq = np.asarray(center_freq, dtype=np.float64)
    shelving_crossover = np.asarray(shelving_crossover, dtype=np.float64)
    if len(target_gain) != len(center_freq) + 2:
        raise AssertionError(
            "The number of target gains must be equal to the number of "
            "center frequencies + 2.")
    nfft = 2 ** 16
    num_freq = len(center_freq) + len(shelving_crossover)
    R = 2.7
    num_control = 100
    control_freq = np.round(
        np.logspace(np.log10(1), np.log10(fs / 2.1), num_control + 1))
    target_freq = np.concatenate(([1.0], center_freq, [fs / 2.1]))
    target_interp = np.interp(control_freq, target_freq, target_gain)

    # the 10 dB prototype bank's normalized sections at the control freqs
    prototype_gain = 10.0
    proto_gains = np.full((num_freq + 1,), prototype_gain)
    b, a = geq(center_freq, shelving_crossover, R, proto_gains, fs,
               dtype=torch.float64)
    sos = np.vstack([b.numpy(), a.numpy()])  # (6, num_bands)
    sos = sos / sos[3:4, :]
    w = 2 * np.pi * np.arange(nfft // 2 + 1) / nfft
    z = np.exp(-1j * w)[:, None]
    B = sos[0] + sos[1] * z + sos[2] * z * z
    A = sos[3] + sos[4] * z + sos[5] * z * z
    H = B / (A + 1e-10)
    f = np.fft.rfftfreq(nfft, 1.0 / fs)
    mag_db = 20 * np.log10(np.abs(H))
    G = np.stack([np.interp(control_freq, f, mag_db[:, band])
                  for band in range(mag_db.shape[1])], axis=1)
    G = G / prototype_gain

    upper = np.array([np.inf] + [2 * prototype_gain] * num_freq)
    opt_gains = lsq_linear(G, target_interp, bounds=(-upper, upper)).x
    return geq(center_freq, shelving_crossover, R,
               torch.from_numpy(opt_gains), fs, dtype=dtype)
