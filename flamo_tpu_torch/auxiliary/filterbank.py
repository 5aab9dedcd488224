"""Fractional-octave Butterworth filterbank (counterpart of
``flamo_tpu/auxiliary/filterbank.py``).

The band filters are designed on the host with scipy (``butter``, second-
order sections) when the bank is made and when a setter changes it.
Both backends filter causally along time, ``(B, T, N) -> (B, T, N,
n_bands)``, and return the result on the bank's ``device`` (default: the
CUDA card): 'fft' (the default) zero-pads the signal by ``pad`` samples
past the filters' decay and multiplies its rfft by the bands' responses
sampled on that exact grid (``sosfreqz`` on the host) on that device;
'scipy' runs ``sosfilt`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from flamo_tpu_torch.utils import resolve_device

_NOM_FREQ_F1 = [16, 31.5, 63, 125, 250, 500, 1000, 2000, 4000, 8000, 16000,
                32000]
_NOM_FREQ_F3 = [16, 20, 25, 31.5, 40, 50, 63, 80, 100, 125, 160, 200, 250,
                315, 400, 500, 630, 800, 1000, 1250, 1600, 2000, 2500, 3150,
                4000, 5000, 6300, 8000, 10000, 12500, 16000, 20000, 25000,
                32000]


class FilterBank:
    """Octave (``fraction=1``) or third-octave (3) Butterworth bank of
    ``order`` over the nominal centers from ``fmin`` to ``fmax``."""

    def __init__(self, fraction: int = 3, order: int = 5, fmin: float = 20.0,
                 fmax: float = 18000.0, sample_rate: int = 48000,
                 nfft: int = None, backend: str = "fft", pad: int = None,
                 device=None):
        if fraction not in (1, 3):
            raise AssertionError(
                "At the moment only fractions 1 and 3 are supported")
        nom = _NOM_FREQ_F1 if fraction == 1 else _NOM_FREQ_F3
        index = [0, len(nom)]
        for i, f in enumerate(nom):
            if fmin > f:
                index[0] = i + (1 if fraction == 3 else 0)
                break
        for i, f in enumerate(nom):
            if f > fmax:
                index[1] = i
                break
        self._center_frequencies = nom[index[0]:index[1]]
        self._order = order
        self._sample_rate = sample_rate
        self._backend = backend
        self._nfft = nfft
        self.device = resolve_device(device)
        # 1 s of zeros covers the narrow low bands' decay below -60 dB
        self._pad = sample_rate if pad is None else int(pad)
        self._design()

    def _design(self):
        self._sos = self._get_octave_filters(
            self._center_frequencies, self._sample_rate, self._order)

    # -- setters: each designs the bank again ------------------------------
    def set_sample_rate(self, sample_rate):
        self._sample_rate = sample_rate
        self._design()

    def set_order(self, order):
        self._order = order
        self._design()

    def set_center_frequencies(self, center_freqs):
        cf = np.asarray(center_freqs)
        if np.any(cf < 0) or np.any(cf > self._sample_rate / 2):
            raise AssertionError(
                "Center Frequencies must be greater than 0 and smaller than "
                "fs/2. Exceptions: exactly 0 or fs/2 will give lowpass or "
                "highpass bands")
        self._center_frequencies = np.sort(cf).tolist()
        self._design()

    def get_center_frequencies(self):
        return self._center_frequencies

    # -- application -------------------------------------------------------
    def _band_responses(self, nfft_pad: int) -> np.ndarray:
        """(n_bands, nfft_pad // 2 + 1) complex128: the bands' responses
        at the bins k fs / nfft_pad of an ``nfft_pad``-point rfft."""
        from scipy.signal import sosfreqz

        worN = np.fft.rfftfreq(nfft_pad, d=1.0 / self._sample_rate)
        freqz = np.zeros((len(self._sos), worN.shape[0]), dtype=np.complex128)
        for i, sos in enumerate(self._sos):
            _, freqz[i] = sosfreqz(sos, worN=worN, fs=self._sample_rate)
        return freqz

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        """x (B, T, N) -> (B, T, N, n_bands): each band filtered causally
        along time."""
        x = torch.as_tensor(x)
        if self._backend == "scipy":
            from scipy.signal import sosfilt

            xn = x.detach().cpu().numpy()
            out = np.stack([sosfilt(np.asarray(sos), xn, axis=1)
                            for sos in self._sos], axis=-1)
            return torch.as_tensor(out, dtype=x.dtype, device=self.device)
        x = x.to(self.device)
        T = x.shape[1]
        Tp = T + self._pad
        freqz = torch.as_tensor(self._band_responses(Tp),
                                dtype=torch.complex64, device=self.device)
        X = torch.fft.rfft(x, n=Tp, dim=1)
        Y = torch.einsum("bfn,kf->bfnk", X, freqz)
        return torch.fft.irfft(Y, n=Tp, dim=1)[:, :T]

    def get_filterbank_impulse_response(self):
        """The bank's response to an impulse at 1 s in 20 s of signal,
        (1, 20 fs, 1, n_bands)."""
        impulse = torch.zeros((1, self._sample_rate * 20, 1),
                              device=self.device)
        impulse[0, self._sample_rate, 0] = 1.0
        return self.forward(impulse)

    @staticmethod
    def _get_octave_filters(center_freqs, fs, order):
        """Butterworth second-order sections of each band: a low pass
        below the next center for a center of 0, a high pass above the
        previous one for fs / 2, else a band pass over [fc / sqrt 2, fc
        sqrt 2]."""
        from scipy.signal import butter

        sos = []
        for i, center_freq in enumerate(center_freqs):
            if abs(center_freq) < 1e-6:
                f_cutoff = (1 / np.sqrt(2)) * center_freqs[i + 1]
                this_sos = butter(N=order, Wn=f_cutoff, fs=fs,
                                  btype="lowpass", analog=False,
                                  output="sos")
            elif abs(center_freq - fs / 2) < 1e-6:
                f_cutoff = np.sqrt(2) * center_freqs[i - 1]
                this_sos = butter(N=order, Wn=f_cutoff, fs=fs,
                                  btype="highpass", analog=False,
                                  output="sos")
            else:
                f_cutoff = center_freq * np.array([1 / np.sqrt(2),
                                                   np.sqrt(2)])
                this_sos = butter(N=order, Wn=f_cutoff, fs=fs,
                                  btype="bandpass", analog=False,
                                  output="sos")
            sos.append(this_sos)
        return sos
