"""Losses (counterpart of ``flamo_tpu/optimize/loss.py``): the FDN and
active-acoustics objectives, the multi-scale spectral family (``mss_loss``,
``mel_mss_loss``, ``AveragePower``) and the energy-decay losses
(``edr_loss``, ``edc_loss``).

The spectrograms are plain PyTorch, in the JAX package's conventions:
reflect padding and a strided frame gather (``unfold``, so gradients reach
the input), a periodic Hann window, and two frequency grids, the rfft grid
and nnAudio's linearly respaced one, evaluated as a frames x DFT-kernel
float32 matmul.  ``torch.stft`` would frame and window otherwise.  The
DFT kernels, windows and mel banks are built once per shape, dtype and
device, in float64 on the host.  The losses set no matmul precision: on
the card the caller keeps TF32 off, as the JAX package computes the
respaced product at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch

from flamo_tpu_torch.functional import eigvals
from flamo_tpu_torch.optimize.utils import generate_partitions
from flamo_tpu_torch.processor.dsp import HouseholderMatrix, _check
from flamo_tpu_torch.utils import next_key, resolve_device


# ----------------------------------------------------------------------
# spectrogram building blocks
# ----------------------------------------------------------------------
def _hann(win_length: int, dtype: torch.dtype = torch.float32,
          device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s)."""
    n = torch.arange(win_length, dtype=dtype, device=resolve_device(device))
    return 0.5 * (1 - torch.cos(2 * torch.pi * n / win_length))


def _hann_np(win_length: int, n_fft: int) -> np.ndarray:
    """The periodic Hann window in float64, zero-padded to ``n_fft`` and
    centred when shorter."""
    nw = np.arange(win_length, dtype=np.float64)
    win = 0.5 * (1 - np.cos(2 * np.pi * nw / win_length))
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    return win


@functools.lru_cache(maxsize=64)
def _stft_window(n_fft: int, win_length: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(_hann_np(win_length, n_fft), dtype=dtype,
                        device=device)


@functools.lru_cache(maxsize=64)
def _respaced_dft(n_fft: int, win_length: int, fmin: float, fmax: float,
                  sr: int, dtype: torch.dtype, device: torch.device):
    """The windowed DFT kernel (cos, sin), each (n_fft//2+1, n_fft), at
    nnAudio's ``freq_scale='linear'`` frequencies: ``fmin n_fft / sr + k
    (fmax - fmin) (n_fft / sr) / (n_fft//2+1)``, k = 0..n_fft//2."""
    win = _hann_np(win_length, n_fft)
    freq_bins = n_fft // 2 + 1
    start_bin = fmin * n_fft / sr
    scaling = (fmax - fmin) * (n_fft / sr) / freq_bins
    bins = start_bin + scaling * np.arange(freq_bins)
    ang = 2.0 * np.pi * bins[:, None] * np.arange(n_fft)[None, :] / n_fft
    return (torch.tensor(np.cos(ang) * win[None, :], dtype=dtype,
                         device=device),
            torch.tensor(np.sin(ang) * win[None, :], dtype=dtype,
                         device=device))


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` samples of reflection on both ends of the last axis, as
    numpy's and JAX's 'reflect'.  ``torch.nn.functional.pad`` reflects
    once, so it takes ``pad`` below the length; longer reflections repeat
    (numpy's rule) by a gather, which the card runs more slowly: its
    backward scatters with atomics."""
    T = x.shape[-1]
    if pad < T:
        return torch.nn.functional.pad(x, (pad, pad), mode="reflect")
    period = max(2 * (T - 1), 1)
    i = torch.arange(-pad, T + pad, device=x.device) % period
    return x[..., torch.where(i >= T, period - i, i)]


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None, center: bool = True,
                   fmin: Optional[float] = None, fmax: Optional[float] = None,
                   sr: Optional[int] = None) -> torch.Tensor:
    """|STFT| of (num_audio, T) -> (num_audio, n_fft//2+1, n_frames).

    Frames ``1 + (T' - n_fft) // hop_length`` of the reflect-padded signal
    (T' = T + n_fft with ``center``), each times the Hann window.  By
    default on the rfft grid; with ``fmin``/``fmax``/``sr`` at nnAudio's
    linearly respaced frequencies (:func:`_respaced_dft`), as two float32
    matmuls of the frames with the windowed DFT kernel."""
    if win_length is None:
        win_length = n_fft
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop_length)  # (B, n_frames, n_fft)
    if fmin is None:
        win = _stft_window(n_fft, win_length, x.dtype, x.device)
        spec = torch.fft.rfft(frames * win, dim=-1)
        return torch.abs(spec).transpose(1, 2)
    wcos, wsin = _respaced_dft(n_fft, win_length, float(fmin), float(fmax),
                               int(sr), x.dtype, x.device)
    ft = frames.transpose(1, 2)  # (B, n_fft, n_frames)
    re = torch.matmul(wcos, ft)
    im = torch.matmul(wsin, ft)
    return torch.sqrt(re * re + im * im)


def _hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney (librosa's default): linear below 1 kHz, log above
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def _mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: Optional[float], htk: bool,
                       norm: Optional[str]) -> np.ndarray:
    if fmax is None:
        fmax = sr / 2
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        left, center, right = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - left) / max(center - left, 1e-10)
        down = (right - fft_freqs) / max(right - center, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        fb *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return fb


@functools.lru_cache(maxsize=64)
def _mel_filterbank_cached(sr, n_fft, n_mels, fmin, fmax, htk, norm, dtype,
                           device):
    return torch.tensor(_mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax,
                                           htk, norm),
                        dtype=dtype, device=device)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney",
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Triangular mel filterbank (n_mels, n_fft//2+1): by default
    ``librosa.filters.mel``'s (Slaney mel scale, 'slaney' area
    normalization); ``htk=True, norm=None`` for the HTK variant.  Built
    once per arguments and device."""
    return _mel_filterbank_cached(sr, n_fft, n_mels, fmin, fmax, htk, norm,
                                  dtype, resolve_device(device))


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop_length: int,
                    n_mels: int, win_length: Optional[int] = None,
                    fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """Mel power spectrogram of (num_audio, T) -> (B, n_mels, n_frames):
    the rfft-grid power spectrogram through :func:`mel_filterbank`."""
    S = stft_magnitude(x, n_fft, hop_length, win_length) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, dtype=x.dtype,
                        device=x.device)
    return torch.matmul(fb, S)


def _norm(x: torch.Tensor, p) -> torch.Tensor:
    if p in ("fro", 2):
        return torch.sqrt(torch.sum(torch.abs(x) ** 2))
    if p == 1:
        return torch.sum(torch.abs(x))
    return torch.sum(torch.abs(x) ** p) ** (1.0 / p)


# ----------------------------------------------------------------------
# simple losses
# ----------------------------------------------------------------------
class sparsity_loss:
    """FDN mixing-matrix sparsity (arXiv:2402.11216):
    -(sum|A| - N sqrt N) / (N (sqrt N - 1)), with A the mapped feedback
    matrix of ``model.get_core()``: its ``feedback_loop.feedback``, else
    that Series' ``mixing_matrix``, else (an FDN beside a direct path,
    a ``Parallel``) ``branchA.feedback_loop.feedback.mixing_matrix``.  A
    ``HouseholderMatrix`` is scored as I - 2 u u^T, not as u."""

    name = "sparsity"

    def __call__(self, y_pred, y_true, model):
        core = model.get_core()
        try:
            mixing_matrix = core.feedback_loop.feedback
            A = mixing_matrix.map(mixing_matrix.param)
        except (AttributeError, KeyError):
            try:
                mixing_matrix = core.feedback_loop.feedback.mixing_matrix
                A = mixing_matrix.map(mixing_matrix.param)
            except (AttributeError, KeyError):
                mixing_matrix = (
                    core.branchA.feedback_loop.feedback.mixing_matrix)
                A = mixing_matrix.map(mixing_matrix.param)
        if isinstance(mixing_matrix, HouseholderMatrix):
            u = A
            A = torch.eye(u.shape[0], dtype=u.dtype,
                          device=u.device) - 2 * u @ u.T
        A = torch.real(A) if A.is_complex() else A
        N = A.shape[-1]
        if A.ndim == 3:
            return torch.mean(
                (torch.sum(torch.abs(A), dim=(-2, -1)) - N * math.sqrt(N))
                / (N * (1 - math.sqrt(N))))
        return -(torch.sum(torch.abs(A)) - N * math.sqrt(N)) \
            / (N * (math.sqrt(N) - 1))


class mse_loss:
    """MSE of the summed prediction channels against the target with its
    last axis squeezed when that axis is 1."""

    name = "MSE"

    def __init__(self, nfft: int | None = None, **kwargs):
        self.nfft = nfft

    def __call__(self, y_pred, y_true):
        y_pred_sum = torch.sum(y_pred, dim=-1)
        if y_true.shape[-1] == 1:
            y_true = torch.squeeze(y_true, dim=-1)
        return torch.mean((y_pred_sum - y_true) ** 2)


class masked_mse_loss:
    """MSE over random partitions of the bin axis.

    The partitions of cycle ``c = step // n_masks`` are a pure function of
    a base seed (drawn once from ``generator``) and c: a fresh
    ``torch.Generator`` seeded from both draws them, so every caller that
    names a step sees the same mask.  They are not JAX's masks (another
    PRNG).  The masks live on ``device`` (default the CUDA card, raising
    without one, as every entry point; ``device="cpu"`` to run there); the
    last cycle's are kept, so a training loop draws each cycle once."""

    name = "maskedMSE"
    stateful = True

    def __init__(self, nfft: int, n_samples: int, n_sets: int = 1,
                 regenerate_mask: bool = True, generator=None, device=None,
                 **kwargs):
        self.nfft = nfft
        self.n_samples = n_samples
        self.n_sets = n_sets
        self.regenerate_mask = regenerate_mask
        self.device = resolve_device(device)
        self._base_seed = int(torch.randint(
            0, 2**62, (1,), generator=next_key(generator)))
        self._cached = None
        self.mask_indices = self.masks_for_cycle(0)
        self.n_masks = self.mask_indices.shape[0]
        self._calls = 0
        self._cycle = 0

    def masks_for_cycle(self, cycle: int) -> torch.Tensor:
        """(n_masks, n_samples) bin indices of regeneration cycle
        ``cycle``."""
        cycle = int(cycle)
        if self._cached is None or self._cached[0] != cycle:
            seed = np.random.SeedSequence(
                [self._base_seed, cycle]).generate_state(1, np.uint64)[0]
            masks = generate_partitions(
                torch.arange(self.nfft // 2 + 1, device=self.device),
                self.n_samples, self.n_sets,
                generator=torch.Generator().manual_seed(int(seed)))
            self._cached = (cycle, masks)
        return self._cached[1]

    def pre_step(self):
        """Host-side hook before each step of a loop that does not pass
        ``step``: advances ``mask_indices`` to the next cycle when the
        masks of this one are used up."""
        self._calls += 1
        if self.regenerate_mask:
            cycle = (self._calls - 1) // self.n_masks
            if cycle != self._cycle:
                self._cycle = cycle
                self.mask_indices = self.masks_for_cycle(cycle)

    def __call__(self, y_pred, y_true, step=None, state=None):
        if step is None:
            masks = self.mask_indices if state is None else state
            mask = masks[0]
        elif self.regenerate_mask:
            step = int(step)
            mask = self.masks_for_cycle(step // self.n_masks)[
                step % self.n_masks]
        else:
            masks = self.mask_indices if state is None else state
            mask = masks[int(step) % masks.shape[0]]
        mask = mask.to(y_pred.device)
        return torch.mean((y_pred[:, mask] - y_true[:, mask]) ** 2)


class mse_evs:
    """Eigenvalue-magnitude MSE over cycling bin partitions: the
    active-acoustics training objective.  ``y_pred`` is the loop-matrix
    spectrum (B, M, N, N) (``ActiveAcoustics.F_MM`` on diag-embedded
    impulses), ``y_true`` the target magnitudes (B, M, N).  Step ``step``
    reads partition ``step % n_masks`` of ``ceil(freq_points / iter_num)``
    bins, so every bin is seen once per cycle; the eigenvalues come from
    :func:`flamo_tpu_torch.functional.eigvals` (``torch.linalg.eigvals``
    and its autograd).  The partitions are drawn from ``generator``
    (another PRNG than JAX's) and live on ``device`` (default the CUDA
    card, raising without one, as every entry point; ``device="cpu"`` to
    run there), so a step on that device copies none; ``mask_indices``
    may be replaced by the caller's."""

    name = "MSE_evs"
    stateful = True

    def __init__(self, iter_num: int, freq_points: int, generator=None,
                 device=None, **kwargs):
        self.iter_num = int(iter_num)
        self.freq_points = int(freq_points)
        self.device = resolve_device(device)
        n_samples = int(math.ceil(freq_points / iter_num))
        self.mask_indices = generate_partitions(
            torch.arange(self.freq_points, device=self.device), n_samples, 1,
            generator=generator)
        self.n_masks = self.mask_indices.shape[0]

    def __call__(self, y_pred, y_true, step=None, state=None):
        masks = self.mask_indices if state is None else state
        i = 0 if step is None else int(step) % masks.shape[0]
        idx = masks[i].to(y_pred.device)
        evs_pred = torch.abs(eigvals(y_pred[:, idx]))
        return torch.mean((evs_pred - y_true[:, idx]) ** 2)


# ----------------------------------------------------------------------
# multi-scale spectral losses
# ----------------------------------------------------------------------
class _mss_base:
    def __init__(self, nfft: List[int], overlap: float, sample_rate: int,
                 energy_norm: bool, name: str, apply_mask: bool,
                 threshold: float, p, log_term: bool, alpha: float,
                 noise_energy):
        self.nfft = list(nfft)
        self.overlap = overlap
        self.sample_rate = sample_rate
        self.energy_norm = energy_norm
        self.name = name
        self.apply_mask = apply_mask
        self.threshold = threshold
        self.p = p
        self.log_term = log_term
        self.alpha = alpha
        # None or 0 means "estimate from the target" (log10(0) would enter
        # the SNR mask otherwise)
        self.noise_energy = noise_energy if noise_energy else None

    def _prep(self, y_pred, y_true):
        if y_pred.ndim == 1:
            y_pred = y_pred[None, :, None]
            y_true = y_true[None, :, None]
        _check(y_pred.shape == y_true.shape and y_true.ndim == 3,
               "y_pred and y_true must have the same shape "
               "(n_batch, n_samples, n_channels)")
        n_channels = y_pred.shape[-1]
        batch = y_pred.shape[0]
        if self.energy_norm:
            y_pred = y_pred / torch.linalg.vector_norm(y_pred)
            y_true = y_true / torch.linalg.vector_norm(y_true)
        # (B, T, C) -> (B*C, T), channels fastest
        y_pred = y_pred.transpose(1, 2).reshape(-1, y_pred.shape[1])
        y_true = y_true.transpose(1, 2).reshape(-1, y_true.shape[1])
        return y_pred, y_true, batch, n_channels

    def _mask(self, Y_true_lin, hop_length, noise_energy=None):
        """SNR mask: ``(mask, count, noise_energy)``.  The noise energy is
        estimated from the first scale's target spectrogram (one frame,
        0.01 s from its end) and reused for the other scales, within one
        call, as in the JAX package."""
        if not self.apply_mask:
            return (torch.ones_like(Y_true_lin),
                    float(np.prod(Y_true_lin.shape)), noise_energy)
        if noise_energy is None:
            noise_energy = self.noise_energy
        if noise_energy is None:
            noise_energy = torch.mean(
                Y_true_lin[:, :, -int(0.01 * self.sample_rate / hop_length)]
                ** 2)
        noise_energy = torch.as_tensor(noise_energy, dtype=Y_true_lin.dtype,
                                       device=Y_true_lin.device)
        SNR = (10 * torch.log10(torch.maximum(Y_true_lin ** 2,
                                              noise_energy * 1.01)
                                - noise_energy)
               - 10 * torch.log10(noise_energy))
        mask = torch.where(SNR < self.threshold, 0.0, 1.0).to(
            Y_true_lin.dtype)
        return mask, torch.sum(mask), noise_energy


class mel_mss_loss(_mss_base):
    """Multi-scale spectral loss on the mel scale: at each FFT size the
    norm ``p`` of the masked mel-spectrogram difference over the mask's
    count (n_fft // 8 mels), plus ``alpha`` times that of the logs with
    ``log_term``."""

    def __init__(self, nfft: List[int] = (128, 256, 512, 1024, 2048, 4096),
                 overlap: float = 0.75, sample_rate: int = 48000,
                 energy_norm: bool = False, name: str = "MelMSS",
                 apply_mask: bool = False, threshold: float = 5,
                 p="fro", log_term: bool = False, alpha: float = 1.0,
                 noise_energy=None, **kwargs):
        super().__init__(nfft, overlap, sample_rate, energy_norm, name,
                         apply_mask, threshold, p, log_term, alpha,
                         noise_energy)

    def __call__(self, y_pred, y_true):
        y_pred, y_true, _, _ = self._prep(y_pred, y_true)
        loss = 0.0
        noise_energy = None
        for n_fft in self.nfft:
            hop = int(n_fft * (1 - self.overlap))
            kw = dict(sr=self.sample_rate, n_fft=n_fft, hop_length=hop,
                      n_mels=n_fft // 8, fmin=0,
                      fmax=self.sample_rate // 2)
            Yp = mel_spectrogram(y_pred, **kw)
            Yt = mel_spectrogram(y_true, **kw)
            mask, N, noise_energy = self._mask(Yt, hop, noise_energy)
            loss = loss + _norm((Yt - Yp) * mask, self.p) / N
            if self.log_term:
                loss = loss + self.alpha * _norm(
                    (torch.log(Yt) - torch.log(Yp)) * mask, self.p) / N
        return loss


class mss_loss(_mss_base):
    """Multi-scale spectral loss on the linear scale, in the form None
    (the norm ``p`` of the masked difference over the mask's count, plus
    ``alpha`` times that of the logs with ``log_term``), 'yamamoto' or
    'magenta'.  ``freq_grid`` 'nnaudio' (default) reads n_fft//2+1
    frequencies linearly respaced over [20 Hz, sr/2] (nnAudio's STFT, the
    reference's grid); 'rfft' the standard DFT grid."""

    def __init__(self, nfft: List[int] = (128, 256, 512, 1024, 2048, 4096),
                 overlap: float = 0.75, sample_rate: int = 48000,
                 energy_norm: bool = False, name: str = "MSS",
                 apply_mask: bool = False, threshold: float = 5,
                 p="fro", log_term: bool = False, alpha: float = 1.0,
                 form: Optional[str] = None, noise_energy=None,
                 freq_grid: str = "nnaudio", **kwargs):
        super().__init__(nfft, overlap, sample_rate, energy_norm, name,
                         apply_mask, threshold, p, log_term, alpha,
                         noise_energy)
        self.form = form
        self.freq_grid = freq_grid

    def __call__(self, y_pred, y_true):
        y_pred, y_true, _, _ = self._prep(y_pred, y_true)
        loss = 0.0
        grid = ({"fmin": 20.0, "fmax": self.sample_rate // 2,
                 "sr": self.sample_rate}
                if self.freq_grid == "nnaudio" else {})
        noise_energy = None
        for n_fft in self.nfft:
            hop = int(n_fft * (1 - self.overlap))
            Yp = stft_magnitude(y_pred, n_fft, hop, **grid)
            Yt = stft_magnitude(y_true, n_fft, hop, **grid)
            mask, N, noise_energy = self._mask(Yt, hop, noise_energy)
            eps = torch.finfo(Yp.dtype).tiny
            Yp_log = torch.log(Yp + eps)
            Yt_log = torch.log(Yt + eps)
            if self.form is None:
                loss = loss + _norm((Yt - Yp) * mask, self.p) / N
                if self.log_term:
                    loss = loss + self.alpha * _norm(
                        (Yt_log - Yp_log) * mask, self.p) / N
            elif self.form == "yamamoto":
                loss = loss + (
                    _norm((Yt - Yp) * mask, "fro") / _norm(Yt, "fro")
                    + self.alpha * _norm((Yt_log - Yp_log) * mask, 1)
                    / float(np.prod(Yt.shape)))
            elif self.form == "magenta":
                loss = loss + (
                    _norm((Yt - Yp) * mask, 1)
                    + self.alpha * torch.sum(torch.abs(Yt_log - Yp_log)
                                             * mask)
                ) / float(np.prod(Yt.shape))
        return loss


class AveragePower:
    """2-D Hann-smoothed STFT magnitude comparison (Dal Santo et al.,
    Asilomar '24): the 1024-point rfft-grid magnitudes (hop 256) under a
    64 x 64 Hann window at ``stride``, compared by
    ||S2w - S1w|| / ||S1w|| / ||S2w||."""

    def __init__(self, energy_norm: bool = False, name: str = "Average Power",
                 stride: tuple = (4, 4), **kwargs):
        self.name = name
        self.energy_norm = energy_norm
        self.stride = stride

    def __call__(self, y_pred, y_true):
        if y_pred.ndim == 1:
            y_pred = y_pred[None, :, None]
            y_true = y_true[None, :, None]
        _check(y_pred.shape == y_true.shape and y_true.ndim == 3,
               "y_pred and y_true must have the same shape "
               "(n_batch, n_samples, n_channels)")
        if self.energy_norm:
            y_pred = y_pred / torch.linalg.vector_norm(y_pred)
            y_true = y_true / torch.linalg.vector_norm(y_true)
        return self.average_power(y_pred, y_true)[0]

    def average_power(self, y_pred, y_true):
        S1 = stft_magnitude(y_pred.squeeze(-1), 1024, 256)
        S2 = stft_magnitude(y_true.squeeze(-1), 1024, 256)
        S1w, S2w = self._smooth(S1), self._smooth(S2)
        val = (_norm(S2w - S1w, "fro") / _norm(S1w, "fro")
               / _norm(S2w, "fro"))
        return val, S1w, S2w

    def _smooth(self, S):
        """The valid, strided correlation of S (B, F, T) with the 64 x 64
        window hann(64) hann(64)^T, as two 64-tap passes (the window is
        separable): the JAX package's 2-D convolution, whose 4096-term
        sums the CPU's conv2d rounds to ~3e-6 against ~1e-7."""
        win = _hann(64, S.dtype, S.device)
        x = torch.nn.functional.conv2d(S[:, None], win.reshape(1, 1, 64, 1),
                                       stride=(self.stride[0], 1))
        x = torch.nn.functional.conv2d(x, win.reshape(1, 1, 1, 64),
                                       stride=(1, self.stride[1]))
        return x.squeeze(1)


# ----------------------------------------------------------------------
# energy-decay losses
# ----------------------------------------------------------------------
def schroeder_backward_int(x: torch.Tensor, axis: int, energy_norm: bool):
    """Backward-integrated energy (Schroeder) along ``axis``, divided by
    its maximum with ``energy_norm``: ``(curve, norm)``."""
    out = torch.flip(x, dims=(axis,))
    out = torch.cumsum(out ** 2, dim=axis)
    out = torch.flip(out, dims=(axis,))
    if energy_norm:
        norm_vals = torch.amax(out, dim=axis, keepdim=True)
    else:
        norm_vals = torch.ones_like(out)
    return out / norm_vals, norm_vals


class edr_loss:
    """Energy Decay Relief loss on the mel scale (Mezza et al., DAFx-24):
    the L1 distance of the dB Schroeder integrals of 64-band mel
    spectrograms (20 ms windows, hop ``overlap``), over the target's."""

    def __init__(self, nfft: int = 1024, overlap: float = 0.5,
                 sample_rate: int = 48000, energy_norm: bool = False,
                 name: str = "EDR", **kwargs):
        self.nfft = nfft
        self.overlap = overlap
        self.sample_rate = sample_rate
        self.energy_norm = energy_norm
        self.win_length = int(0.020 * sample_rate)
        self.name = name

    def _mel(self, x):
        hop = int(self.win_length * (1 - self.overlap))
        n_fft = max(self.nfft, self.win_length)
        return mel_spectrogram(x, sr=self.sample_rate, n_fft=n_fft,
                               hop_length=hop, win_length=self.win_length,
                               n_mels=64, fmin=20,
                               fmax=self.sample_rate // 2)

    def __call__(self, y_pred, y_true):
        if y_pred.ndim == 1:
            y_pred = y_pred[None, :, None]
            y_true = y_true[None, :, None]
        _check(y_pred.shape == y_true.shape and y_true.ndim == 3,
               "y_pred and y_true must have the same shape "
               "(n_batch, n_samples, n_channels)")
        yp = y_pred.transpose(1, 2).reshape(-1, y_pred.shape[1])
        yt = y_true.transpose(1, 2).reshape(-1, y_true.shape[1])
        Ep = schroeder_backward_int(self._mel(yp), axis=-1,
                                    energy_norm=self.energy_norm)[0]
        Et = schroeder_backward_int(self._mel(yt), axis=-1,
                                    energy_norm=self.energy_norm)[0]
        eps = torch.finfo(Ep.dtype).tiny
        Yp_edr = 10 * torch.log10(Ep + eps)
        Yt_edr = 10 * torch.log10(Et + eps)
        bad = ~torch.isfinite(Yt_edr)
        fin_eps = torch.finfo(Yt_edr.dtype).eps
        Yt_edr = torch.where(bad, fin_eps, Yt_edr)
        Yp_edr = torch.where(bad, fin_eps, Yp_edr)
        return _norm(Yt_edr - Yp_edr, 1) / _norm(Yt_edr, 1)


class edc_loss:
    """Energy Decay Curve loss, broadband or per fractional-octave band:
    the MSE of the dB Schroeder integrals (the last 0.5 % of samples
    dropped), divided by the target's mean square with ``convergence``.
    The band bank is a 5th-order Butterworth bandpass per band in [63,
    16000] Hz, designed on the host with scipy once per signal length and
    device, and applied in the frequency domain."""

    def __init__(self, sample_rate: int = 48000, is_broadband: bool = False,
                 n_fractions: int = 1, energy_norm: bool = False,
                 convergence: bool = False, clip: bool = False,
                 name: str = "EDC", **kwargs):
        self.sample_rate = sample_rate
        self.is_broadband = is_broadband
        self.n_fractions = n_fractions
        self.energy_norm = energy_norm
        self.convergence = convergence
        self.clip = clip
        self.name = name
        self.discard_n = 0.5
        self._bank_cache = {}

    def _band_freqs(self):
        """Fractional-octave centre frequencies in [63, 16000] Hz."""
        f_low, f_high = 63.0, 16000.0
        n = self.n_fractions
        centers = []
        f = 1000.0
        while f / 2 ** (1 / (2 * n)) > f_low / 2 ** (1 / (2 * n)):
            f = f / 2 ** (1 / n)
            if f < f_low:
                break
            centers.append(f)
        centers = centers[::-1]
        f = 1000.0
        while f <= f_high:
            centers.append(f)
            f = f * 2 ** (1 / n)
        return np.unique(np.round(np.asarray(centers), 6))

    def _bank(self, T: int, device) -> torch.Tensor:
        """(n_bands, T) complex64 band responses on the rfft grid of
        2T - 1 points."""
        key = (T, str(device))
        if key in self._bank_cache:
            return self._bank_cache[key]
        from scipy.signal import butter, sosfreqz as scipy_sosfreqz

        nfft = 2 * T - 1
        responses = []
        for fc in self._band_freqs():
            lo = fc / 2 ** (1 / (2 * self.n_fractions))
            hi = fc * 2 ** (1 / (2 * self.n_fractions))
            hi = min(hi, self.sample_rate / 2 * 0.999)
            sos = butter(5, [lo, hi], btype="bandpass", output="sos",
                         fs=self.sample_rate)
            _, h = scipy_sosfreqz(sos, worN=nfft // 2 + 1)
            responses.append(h)
        bank = torch.tensor(np.stack(responses), dtype=torch.complex64,
                            device=device)
        self._bank_cache[key] = bank
        return bank

    def filterbank(self, x):
        """x (B, T, C) -> (B, T, C, n_bands), filtered in the frequency
        domain."""
        T = x.shape[1]
        bank = self._bank(T, x.device)
        X = torch.fft.rfft(x, n=2 * T - 1, dim=1)  # (B, F, C)
        Y = torch.einsum("bfc,kf->bfck", X, bank)
        return torch.fft.irfft(Y, n=2 * T - 1, dim=1)[:, :T]

    def discard_last_n_percent(self, x, n_percent):
        last_id = int(np.round((1 - n_percent / 100) * x.shape[1]))
        return x[:, 0:last_id]

    def get_edc(self, x):
        out = self.discard_last_n_percent(x, self.discard_n)
        if not self.is_broadband:
            out = self.filterbank(out)
        out = schroeder_backward_int(out, axis=1,
                                     energy_norm=self.energy_norm)[0]
        eps = torch.finfo(out.dtype).tiny
        return 10 * torch.log10(out + eps)

    def __call__(self, y_pred, y_true):
        if y_pred.ndim == 1:
            y_pred = y_pred[None, :, None]
            y_true = y_true[None, :, None]
        _check(y_pred.shape == y_true.shape and y_true.ndim == 3,
               "y_pred and y_true must have the same shape "
               "(n_batch, n_samples, n_channels)")
        yp_edc = self.get_edc(y_pred)
        yt_edc = self.get_edc(y_true)
        if self.clip:
            thresh = torch.amax(yt_edc, dim=1, keepdim=True) - 60
            clip_mask = yt_edc < thresh
            yp_edc = torch.where(clip_mask, -180.0, yp_edc)
            yt_edc = torch.where(clip_mask, -180.0, yt_edc)
        num = torch.mean((yp_edc - yt_edc) ** 2)
        den = torch.mean(yt_edc ** 2)
        return num / den if self.convergence else num
