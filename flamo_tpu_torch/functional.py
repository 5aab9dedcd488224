"""Functional helpers of the FDN, active-acoustics and e8_fdn paths
(counterpart of the matching subset of ``flamo_tpu/functional.py``): the
orthogonal, Hadamard and rotation maps, the signal gallery, filter design
and evaluation, the WGN reverb, the RIR onset, and the eigenvalue solvers
(char-poly + Durand-Kerner, whose root iteration is kernel K7 on the
card, and the Hessenberg + shifted-QR solver of ``ops.qr_eig``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from flamo_tpu_torch import utils
from flamo_tpu_torch.utils import complex_dtype_for, next_key, resolve_device

# the char-poly + Durand-Kerner solver (and kernel K7) takes N <= 8
EIG_DK_MAX_N = 8


def get_magnitude(x: torch.Tensor) -> torch.Tensor:
    """|x| (counterpart of ``flamo_tpu.functional.get_magnitude``)."""
    return torch.abs(x)


def skew_matrix(X: torch.Tensor) -> torch.Tensor:
    """Upper-triangular antisymmetrization."""
    A = torch.triu(X, 1)
    return A - A.transpose(-1, -2)


def expm(A: torch.Tensor, order: int = 10) -> torch.Tensor:
    """Matrix exponential by Taylor-10 after a 2^-5 scaling, then five
    squarings: the JAX package's algorithm, step for step, so both sides
    give the same float32 orthogonal matrix (``torch.linalg.matrix_exp``
    picks its own order and scaling).  Fifteen small matmuls; callers on
    the card keep TF32 off so they stay full float32."""
    n = A.shape[-1]
    s = 5
    As = A / (2.0 ** s)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    term = eye
    out = eye
    for k in range(1, order + 1):
        term = torch.matmul(term, As) / k
        out = out + term
    for _ in range(s):
        out = torch.matmul(out, out)
    return out


def expm_skew(X: torch.Tensor) -> torch.Tensor:
    """Orthogonal matrix exp(skew(X)): the ``orthogonal`` Matrix map."""
    return expm(skew_matrix(X))


def get_frequency_samples(num: int, dtype: torch.dtype = torch.float32,
                          device=None) -> torch.Tensor:
    """Unit-circle samples e^{j pi t}, t in [0, 1] (num points):
    :func:`flamo_tpu_torch.utils.get_frequency_samples` at radius 1."""
    return utils.get_frequency_samples(num, 1.0, dtype, device).to(
        complex_dtype_for(dtype))


def hadamard_matrix_jnp(N: int, dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """Normalized Hadamard matrix by Kronecker doubling, formed in float64
    on the host (the JAX package's name and construction)."""
    U = np.array([[1.0]])
    while U.shape[0] < N:
        U = np.kron(U, np.array([[1.0, 1.0], [1.0, -1.0]])) / np.sqrt(2.0)
    return torch.tensor(U, dtype=dtype, device=resolve_device(device))


class HadamardMatrix:
    """Matrix map that ignores its input and returns the N x N Hadamard
    matrix on the input's device."""

    def __init__(self, N: int, dtype: torch.dtype = torch.float32):
        self.N = N
        self.dtype = dtype

    def __call__(self, x):
        return hadamard_matrix_jnp(self.N, self.dtype, device=x.device)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), whose gradient is 1/2 at either
    boundary (``torch.clamp``'s is 1)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def rotation_matrix(theta, N: int, iters=None, min_angle: float = 0.0,
                    max_angle: float = math.pi / 4,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kronecker power of the 2 x 2 rotation by ``theta`` (clipped to
    [min_angle, max_angle]): ``iters`` squarings, by default
    ``log2(N) - 1``."""
    theta = _clip(torch.as_tensor(theta, dtype=dtype), min_angle, max_angle)
    c, s = torch.cos(theta), torch.sin(theta)
    X = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
    if iters is None:
        iters = int(math.log2(N)) - 1
    for _ in range(int(iters)):
        X = torch.kron(X, X)
    return X


class RotationMatrix:
    """Matrix map: scalar raw angle -> :func:`rotation_matrix`."""

    def __init__(self, N: int, iters=None, min_angle: float = 0.0,
                 max_angle: float = math.pi / 4,
                 dtype: torch.dtype = torch.float32):
        self.N, self.iters = N, iters
        self.min_angle, self.max_angle = min_angle, max_angle
        self.dtype = dtype

    def __call__(self, theta):
        return rotation_matrix(theta, self.N, self.iters, self.min_angle,
                               self.max_angle, self.dtype)


_SIGNAL_TYPES = {"impulse", "sine", "sweep", "wgn", "exp", "reference",
                 "noise", "velvet"}


def signal_gallery(batch_size: int, n_samples: int, n: int,
                   signal_type: str = "impulse", fs: int = 48000,
                   rate: float = 1.0, reference=None, generator=None,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Test signal of shape (batch_size, n_samples, n): 'impulse', 'sine'
    (``rate`` Hz; None: one period), 'sweep' (linear chirp 20 Hz to 20
    kHz), 'wgn'/'noise', 'exp' (decay ``rate``), 'velvet' (density
    ``rate``) or 'reference' (broadcast).  The random types draw on the
    CPU from ``generator`` (default the global stream; another PRNG than
    JAX's) and are then moved to ``device``."""
    if signal_type not in _SIGNAL_TYPES:
        raise ValueError(f"Signal type {signal_type} not recognized.")
    device = resolve_device(device)
    shape = (batch_size, n_samples, n)
    if signal_type == "impulse":
        x = torch.zeros(shape, dtype=dtype, device=device)
        x[:, 0, :] = 1.0
        return x
    if signal_type == "sine":
        if rate is not None:
            t = torch.linspace(0, n_samples / fs, n_samples, dtype=dtype,
                               device=device)
            s = torch.sin(2 * torch.pi * rate / fs * t)
        else:
            s = torch.sin(torch.linspace(0, 2 * torch.pi, n_samples,
                                         dtype=dtype, device=device))
        return s[None, :, None].expand(shape)
    if signal_type == "sweep":
        t = torch.linspace(0, n_samples / fs - 1 / fs, n_samples,
                           dtype=dtype, device=device)
        t1 = t[-1]
        f0, f1 = 20.0, 20000.0
        phase = 2 * torch.pi * (f0 * t + (f1 - f0) / (2 * t1) * t * t)
        return torch.cos(phase)[None, :, None].expand(shape)
    if signal_type in ("wgn", "noise"):
        return torch.randn(shape, generator=next_key(generator),
                           dtype=dtype).to(device)
    if signal_type == "exp":
        x = torch.exp(-rate * torch.arange(n_samples, dtype=dtype,
                                           device=device) / fs)
        return x[None, :, None].expand(shape)
    if signal_type == "velvet":
        generator = next_key(generator)
        seqs = [gen_velvet_noise(n_samples, fs, rate, generator=generator,
                                 dtype=dtype, device=device)
                for _ in range(batch_size * n)]
        x = torch.stack(seqs).reshape(batch_size, n, n_samples)
        return x.transpose(1, 2)
    ref = torch.as_tensor(reference, dtype=dtype, device=device)
    return ref.expand(shape)


def gen_velvet_noise(n_samples: int, fs: int, density: float,
                     generator=None, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """One velvet-noise sequence: a +-1 pulse at a jittered position in
    each period of fs / density samples, the first at sample 0."""
    generator = next_key(generator)
    Td = fs / density
    n_pulses = math.floor(n_samples / Td)
    grid = torch.arange(n_pulses, dtype=dtype) * Td
    jitter = torch.rand((n_pulses,), generator=generator, dtype=dtype)
    idx = torch.ceil(grid + jitter * (Td - 1)).to(torch.int64)
    if n_pulses:
        idx[0] = 0
    idx = torch.clamp(idx, 0, n_samples - 1)
    signs = 2 * torch.randint(0, 2, (n_pulses,), generator=generator) - 1
    seq = torch.zeros(n_samples, dtype=dtype)
    seq[idx] = signs.to(dtype)
    return seq.to(resolve_device(device))


def hertz2rad(hertz, fs: int):
    """f[Hz] -> omega[rad/sample]."""
    return torch.as_tensor(hertz) / fs * 2 * torch.pi


def rad2hertz(rad, fs: int):
    """omega[rad/sample] -> f[Hz]."""
    return torch.as_tensor(rad) * fs / (2 * torch.pi)


def db2mag(dB):
    return 10 ** (torch.as_tensor(dB) / 20)


def mag2db(mag):
    return 20 * torch.log10(torch.abs(torch.as_tensor(mag)))


# ----------------------------------------------------------------------
# polynomial / transfer-function evaluation
# ----------------------------------------------------------------------
def rfft_phasor(nfft: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """z^{-1} on the rfft grid: e^{-j 2 pi m / nfft}, shape (nfft//2+1,).
    The angle is formed in ``dtype`` as ``2 pi m / nfft``, in the JAX
    package's order."""
    m = torch.arange(nfft // 2 + 1, dtype=dtype,
                     device=resolve_device(device))
    w = 2.0 * torch.pi * m / nfft
    return torch.exp(-1j * w)


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return x.real.dtype if x.is_complex() else x.dtype


def poly_response(coeffs, nfft: int):
    """``rfft(pad(coeffs, nfft), axis=0)`` for low-order polynomials, by
    Horner on the rfft grid.  coeffs: (P, ...) tap axis first; returns
    (M, ...) complex with M = nfft//2+1."""
    coeffs = torch.as_tensor(coeffs)
    P = coeffs.shape[0]
    zinv = rfft_phasor(nfft, _real_dtype(coeffs), coeffs.device)
    zinv = zinv.reshape((-1,) + (1,) * (coeffs.ndim - 1))
    out = coeffs[P - 1].to(zinv.dtype)
    for k in range(P - 2, -1, -1):
        out = out * zinv + coeffs[k]
    return out


def _cascade_chain(b, a, nfft: int, zinv, after_section):
    """The Horner-and-multiply chains of the (P, K, ...) tap-major
    cascades b and a, ``after_section(prodB, prodA)`` applied to the pair
    after each section."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a)
    P, K = b.shape[0], b.shape[1]
    if zinv is None:
        zinv = rfft_phasor(nfft, _real_dtype(b), b.device)
    zinv = zinv.reshape((-1,) + (1,) * (b.ndim - 2))

    def polyval(c):  # (P, ...) -> (M, ...)
        out = c[P - 1].to(zinv.dtype)
        for j in range(P - 2, -1, -1):
            out = out * zinv + c[j]
        return out

    prodB, prodA = after_section(polyval(b[:, 0]), polyval(a[:, 0]))
    for k in range(1, K):
        prodB, prodA = after_section(prodB * polyval(b[:, k]),
                                     prodA * polyval(a[:, k]))
    return prodB, prodA


def cascade_prods(b, a, nfft: int, zinv=None):
    """``(prod_k polyval(b[:, k]), prod_k polyval(a[:, k]))`` on the rfft
    grid, one Horner-and-multiply chain per section, without the
    (M, K, ...) per-section responses.  b, a: (P, K, ...) tap-major SOS
    cascades.  ``zinv`` (M,) replaces the rfft phasor (a shifted bin
    grid)."""
    return _cascade_chain(b, a, nfft, zinv, lambda pb, pa: (pb, pa))


# |e| bound of _rescale_pair's exponent: 2^-e stays a normal number
_EXP_LIMIT = {torch.float32: 126, torch.float64: 1022}


def _rescale_pair(prodB, prodA):
    """Both products times one power of two, 2^-e with e the exponent
    (``torch.frexp``) of prodA's larger part, so that |prodA| lands in
    [0.5, 1.5); e is clamped so that 2^-e is a normal number.  In
    float32's normal range the scaling is exact, and so is every product
    and sum after it: the ratio keeps its bits.  An exactly zero prodA has
    e = 0 and stays zero.  The scale is a constant to autograd."""
    dtype = _real_dtype(prodA)
    lim = _EXP_LIMIT[dtype]
    with torch.no_grad():
        e = torch.frexp(torch.maximum(prodA.real.abs(),
                                      prodA.imag.abs())).exponent
        s = torch.ldexp(torch.ones_like(e, dtype=dtype),
                        -e.clamp(-lim, lim))
    return prodB * s, prodA * s


def cascade_prods_scaled(b, a, nfft: int, zinv=None):
    """:func:`cascade_prods`'s pair scaled after every section by one
    power of two chosen from prodA's exponent (:func:`_rescale_pair`):
    ``prodB / prodA`` is the same ratio, bit for bit wherever the
    unscaled products stay normal, and it stays finite where a long
    cascade's unscaled products underflow float32 (a 30-section
    1/3-octave GEQ near DC).  The plain versions of the cascade kernels
    and the 'xla' cascade route use it; they read only the ratio and
    whether prodA is 0."""
    return _cascade_chain(b, a, nfft, zinv, _rescale_pair)


def biquad2tf(b, a, nfft: int):
    """Cascade of biquads -> transfer function on the rfft grid.  b, a:
    (3,) or (3, n_sections); returns (nfft//2+1,)."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a)
    if b.ndim < 2:
        b = b[:, None]
    if a.ndim < 2:
        a = a[:, None]
    B = poly_response(b, nfft)
    A = poly_response(a, nfft)
    return torch.prod(B, dim=1) / torch.prod(A, dim=1)


# ----------------------------------------------------------------------
# filter design: every design is vectorized over the shape of its
# frequency argument and returns (b, a), each (3, *shape) (2 taps for the
# first-order proportional shelf)
# ----------------------------------------------------------------------
def _rbj_pass(fc, gain, fs: int, dtype: torch.dtype, high: bool):
    omegaC = hertz2rad(torch.as_tensor(fc, dtype=dtype), fs)
    alpha = torch.sin(omegaC) / 2 * torch.sqrt(torch.tensor(2.0, dtype=dtype))
    cosOC = torch.cos(omegaC)
    if high:
        b = torch.stack([(1 + cosOC) / 2, -(1 + cosOC), (1 + cosOC) / 2])
    else:
        b = torch.stack([(1 - cosOC) / 2, 1 - cosOC, (1 - cosOC) / 2])
    a = torch.stack([1 + alpha, -2 * cosOC, 1 - alpha])
    return 10 ** (torch.as_tensor(gain, dtype=dtype) / 20) * b, a


def lowpass_filter(fc=500.0, gain=0.0, fs: int = 48000,
                   dtype: torch.dtype = torch.float32):
    """RBJ lowpass at ``fc`` Hz, gain in dB."""
    return _rbj_pass(fc, gain, fs, dtype, high=False)


def highpass_filter(fc=10000.0, gain=0.0, fs: int = 48000,
                    dtype: torch.dtype = torch.float32):
    """RBJ highpass at ``fc`` Hz, gain in dB."""
    return _rbj_pass(fc, gain, fs, dtype, high=True)


def shelving_filter(fc, gain, type: str = "low", fs: int = 48000,
                    dtype: torch.dtype = torch.float32):
    """Second-order shelving filter, linear gain.  Returns (b, a), each
    (3, *broadcast(fc, gain).shape)."""
    fc = torch.as_tensor(fc, dtype=dtype)
    gain = torch.as_tensor(gain, dtype=dtype)
    omegaC = hertz2rad(fc, fs)
    t = torch.tan(omegaC / 2)
    t2 = t ** 2
    g2 = gain ** 0.5
    g4 = gain ** 0.25
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dtype))
    b = torch.stack(torch.broadcast_tensors(
        g2 * t2 + sqrt2 * t * g4 + 1,
        2 * g2 * t2 - 2,
        g2 * t2 - sqrt2 * t * g4 + 1,
    ))
    a = torch.stack(torch.broadcast_tensors(
        g2 + sqrt2 * t * g4 + t2,
        2 * t2 - 2 * g2,
        g2 - sqrt2 * t * g4 + t2,
    ))
    b = g2 * b
    if type == "high":
        b, a = a * gain, b
    return b, a


def peak_filter(fc, gain, Q, fs: int = 48000,
                dtype: torch.dtype = torch.float32):
    """Second-order peak filter, linear gain.  Returns (b, a), each
    (3, *broadcast(fc, gain, Q).shape)."""
    fc = torch.as_tensor(fc, dtype=dtype)
    gain = torch.as_tensor(gain, dtype=dtype)
    Q = torch.as_tensor(Q, dtype=dtype)
    omegaC = hertz2rad(fc, fs)
    t = torch.tan(omegaC / Q / 2)
    sg = torch.sqrt(gain)
    b = torch.stack(torch.broadcast_tensors(
        sg + gain * t, -2 * sg * torch.cos(omegaC), sg - gain * t))
    a = torch.stack(torch.broadcast_tensors(
        sg + t, -2 * sg * torch.cos(omegaC), sg - t))
    return b, a


def bandpass_filter(fc1, fc2, gain=0.0, fs: int = 48000,
                    dtype: torch.dtype = torch.float32):
    """RBJ bandpass between ``fc1`` and ``fc2`` Hz, gain in dB.  Returns
    (b, a), each (3, *fc1.shape)."""
    fc1 = torch.as_tensor(fc1, dtype=dtype)
    fc2 = torch.as_tensor(fc2, dtype=dtype)
    omegaC = (hertz2rad(fc1, fs) + hertz2rad(fc2, fs)) / 2
    BW = torch.log2(fc2 / fc1)
    two = torch.tensor(2.0, dtype=dtype)
    alpha = torch.sin(omegaC) * torch.sinh(
        torch.log(two) / two * BW * (omegaC / torch.sin(omegaC)))
    cosOC = torch.cos(omegaC)
    b = torch.stack([alpha, torch.zeros_like(alpha), -alpha])
    a = torch.stack([1 + alpha, -2 * cosOC, 1 - alpha])
    return 10 ** (torch.as_tensor(gain, dtype=dtype) / 20) * b, a


def prop_shelving_filter(fc, gain, type: str = "low", fs: int = 48000,
                         dtype: torch.dtype = torch.float32):
    """Jot's proportional first-order shelving filter, gain in dB."""
    fc = torch.as_tensor(fc, dtype=dtype)
    gain = torch.as_tensor(gain, dtype=dtype)
    t = torch.tan(torch.pi * fc / fs)
    k = 10 ** (gain / 20)
    if type == "low":
        b = torch.stack([t * torch.sqrt(k) + 1, t * torch.sqrt(k) - 1])
        a = torch.stack([t / torch.sqrt(k) + 1, t / torch.sqrt(k) - 1])
    elif type == "high":
        k = 1 / k
        b = torch.stack([(t * torch.sqrt(k) + 1) / k,
                         (t * torch.sqrt(k) - 1) / k])
        a = torch.stack([t / torch.sqrt(k) + 1, t / torch.sqrt(k) - 1])
    else:
        raise ValueError("type must be 'low' or 'high'")
    return b, a


def prop_peak_filter(fc, bw, gain, fs: int = 48000,
                     dtype: torch.dtype = torch.float32):
    """Jot's proportional presence (peak) filter, gain in dB."""
    fc = torch.as_tensor(fc, dtype=dtype)
    bw = torch.as_tensor(bw, dtype=dtype)
    gain = torch.as_tensor(gain, dtype=dtype)
    t = torch.tan(torch.pi * bw / fs)
    c = torch.cos(2 * torch.pi * fc / fs)
    sk = torch.sqrt(10 ** (gain / 20))
    b = torch.stack(torch.broadcast_tensors(1 + sk * t, -2 * c, 1 - sk * t))
    a = torch.stack(torch.broadcast_tensors(1 + t / sk, -2 * c, 1 - t / sk))
    return b, a


def svf_taps(f, R, mLP, mBP, mHP):
    """The biquad taps (b, a), each (3, *shape), of a state-variable
    filter of warped frequency f = tan(pi fc / fs), resonance R and
    mixing coefficients mLP, mBP, mHP."""
    b = torch.stack([f**2 * mLP + f * mBP + mHP,
                     2 * f**2 * mLP - 2 * mHP,
                     f**2 * mLP - f * mBP + mHP])
    a = torch.stack(torch.broadcast_tensors(
        f**2 + 2 * R * f + 1, 2 * f**2 - 2, f**2 - 2 * R * f + 1))
    return b, a


def svf_mix(filter_type, R, G):
    """(mLP, mBP, mHP) of a typed state-variable filter of resonance R
    and linear gain G."""
    ones, zeros = torch.ones_like(G), torch.zeros_like(G)
    if filter_type == "lowpass":
        return ones, zeros, zeros
    if filter_type == "highpass":
        return zeros, zeros, ones
    if filter_type == "bandpass":
        return zeros, ones, zeros
    if filter_type == "lowshelf":
        return ones, 2 * R * torch.sqrt(G), G
    if filter_type == "highshelf":
        return G, 2 * R * torch.sqrt(G), ones
    if filter_type in ("peaking", "notch"):
        return ones, 2 * R * torch.sqrt(G), ones
    raise ValueError(f"unknown filter_type {filter_type}")


def svf(fc, R, m=None, G=None, filter_type: str = None, fs: int = 48000,
        dtype: torch.dtype = torch.float32):
    """State-variable-filter coefficients at ``fc`` Hz: a typed filter
    (``filter_type``, linear gain ``G``) or, with ``filter_type=None``,
    the free mixing coefficients ``m`` (..., 3).  Returns (b, a), each
    (3, *fc.shape)."""
    fc = torch.as_tensor(fc, dtype=dtype)
    R = torch.as_tensor(R, dtype=dtype)
    f = torch.tan(torch.pi * fc / fs)
    G = torch.ones_like(f) if G is None else torch.as_tensor(G, dtype=dtype)
    if filter_type is None:
        m = torch.as_tensor(m, dtype=dtype)
        mix = (m[..., 0], m[..., 1], m[..., 2])
    else:
        mix = svf_mix(filter_type, R, G)
    return svf_taps(f, R, *mix)


def probe_sos(sos, control_freqs, nfft: int, fs: int,
              dtype: torch.dtype = torch.float32):
    """The magnitude of each of a bank of second-order sections at control
    frequencies.  sos: (6, n_bands) columns [b0 b1 b2 a0 a1 a2].  Returns
    (G, H, W): the gains in dB at the control frequencies (n_ctrl,
    n_bands), linearly interpolated on the rfft grid, the responses
    (M, n_bands) and their angular frequencies (M, n_bands).  The bands
    are interpolated together, one gather for all of them."""
    sos = torch.as_tensor(sos, dtype=dtype)
    control_freqs = torch.as_tensor(control_freqs, dtype=dtype,
                                    device=sos.device)
    sos = sos / sos[3:4, :]
    B = poly_response(sos[:3], nfft)  # (M, n_bands)
    A = poly_response(sos[3:], nfft)
    H = B / (A + 1e-10)
    f = torch.fft.rfftfreq(nfft, 1.0 / fs, dtype=dtype, device=sos.device)
    mag_db = 20 * torch.log10(torch.abs(H))
    G = utils.RegularGridInterpolator([f], mag_db)([control_freqs])
    W = (2 * torch.pi * f / fs)[:, None].expand(H.shape)
    return G, H, W


def sosfreqz(sos, nfft: int = 512):
    """Frequency response of cascaded second-order sections on the rfft
    grid.  sos: (n_sections, 6) rows [b0 b1 b2 a0 a1 a2]; returns
    (nfft//2+1,)."""
    sos = torch.as_tensor(sos)
    if sos.shape[-1] != 6:
        raise AssertionError("sos must have 6 columns")
    B = poly_response(sos[:, :3].T, nfft)  # (M, n_sections)
    A = poly_response(sos[:, 3:].T, nfft)
    return torch.prod(B, dim=-1) / torch.prod(A, dim=-1)


def find_onset(rir) -> int:
    """Onset sample of a 1-D RIR: the start of the 64-sample periodic-Hann
    window of largest local energy, hop 16, one sample window back."""
    rir = torch.as_tensor(rir)
    win_len = 64
    overlap = 0.75
    win = 0.5 * (1 - torch.cos(2 * torch.pi * torch.arange(
        win_len, dtype=rir.dtype, device=rir.device) / win_len))
    pad = int(win_len * overlap)
    x = torch.nn.functional.pad(rir, (pad, pad))
    hop = 1 - overlap
    n_wins = int(np.floor(x.shape[0] / (win_len * hop) - 1 / 2 / hop))
    hop_len = int(win_len * hop)
    frames = x.unfold(0, win_len, hop_len)[:n_wins - 2]
    local_energy = torch.sum(frames ** 2 * win[None, :], dim=1)
    n_win_discard = int((overlap / hop) - (1 / 2 / hop))
    local_energy = local_energy[n_win_discard:]
    return int(win_len * hop * (int(torch.argmax(local_energy)) - 1))


def WGN_reverb(matrix_size: tuple = (1, 1), t60: float = 1.0,
               samplerate: int = 48000, generator=None,
               dtype: torch.dtype = torch.float32, device=None):
    """Exponentially decaying white-noise IR matrix (n_samples,
    *matrix_size), n_samples = int(1.5 t60 samplerate), bandpassed 20 Hz
    to min(20 kHz, 0.95 Nyquist) and normalized per column.  The noise is
    drawn on the CPU from ``generator`` (another PRNG than JAX's: the
    same seed gives other rooms than ``flamo_tpu``'s) and then moved to
    ``device``."""
    generator = next_key(generator)
    device = resolve_device(device)
    n_samples = int(1.5 * t60 * samplerate)
    noise = torch.randn((n_samples, *matrix_size), generator=generator,
                        dtype=dtype).to(device)
    dr = t60 / math.log(1000.0)
    decay = torch.exp(-1 / dr * torch.linspace(0, t60, n_samples,
                                               dtype=dtype, device=device))
    IRs = noise * decay.reshape(-1, *([1] * len(matrix_size)))
    TFs = torch.fft.rfft(IRs, n=n_samples, dim=0)
    f_hi = min(20000.0, 0.95 * samplerate / 2)
    b, a = bandpass_filter(torch.tensor([20.0]), torch.tensor([f_hi]),
                           torch.tensor([1.0]), fs=samplerate, dtype=dtype)
    sos = torch.cat([b.reshape(1, 3), a.reshape(1, 3)], dim=1).to(device)
    bp_H = sosfreqz(sos=sos, nfft=n_samples).squeeze()
    bp_H = bp_H.reshape(-1, *([1] * len(matrix_size)))
    IRs = torch.fft.irfft(TFs * bp_H, n=n_samples, dim=0)
    return IRs / torch.linalg.vector_norm(IRs, ord=2, dim=0)


# ----------------------------------------------------------------------
# eigenvalues
# ----------------------------------------------------------------------
# the Hessenberg + shifted-QR solver of the JAX package's callback-less
# backends, beside torch.linalg.eigvals (which CUDA has for any N)
from flamo_tpu_torch.ops.qr_eig import (  # noqa: E402
    EIG_QR_MAX_N, eigvals_qr, eigvals_qr_grad)


def get_eigenvalues(x):
    """Eigenvalues of (..., N, N) matrices for analysis, without a
    gradient: ``torch.linalg.eigvals`` (the JAX package's host-callback
    LAPACK route).  The JAX package takes :func:`eigvals_qr` only on
    backends without host callbacks; CUDA has a general eig."""
    with torch.no_grad():
        return torch.linalg.eigvals(x)


def eigvals(A):
    """Differentiable eigenvalues of (..., N, N) matrices:
    ``torch.linalg.eigvals``, whose autograd is the closed-form VJP of the
    JAX package's ``eigvals_lapack`` (exact for simple spectra).  The
    order of the eigenvalues is LAPACK's: treat them as a set."""
    return torch.linalg.eigvals(A)


# the JAX package's name for its host-callback LAPACK route, which is
# eigvals here
eigvals_lapack = eigvals


def spectral_radius(A, iters: int = 64, tail: int = 8):
    """Differentiable spectral-radius estimate ``max |lambda|`` of
    (..., N, N) matrices by power iteration from a fixed complex start
    vector; the geometric mean of the last ``tail`` norm ratios averages
    out the oscillation of a dominant complex-conjugate pair."""
    n = A.shape[-1]
    rdt = A.real.dtype if A.is_complex() else A.dtype
    cd = complex_dtype_for(rdt)
    A = A.to(cd)
    k = torch.arange(1, n + 1, dtype=rdt, device=A.device)
    v = torch.complex(k, torch.sqrt(k))
    v = (v / torch.linalg.vector_norm(v)).expand(A.shape[:-1])
    ratios = []
    for _ in range(iters):
        w = torch.einsum("...ij,...j->...i", A, v)
        r = torch.linalg.vector_norm(w, dim=-1)
        v = w / (r[..., None] + 1e-30)
        ratios.append(r)
    tail = min(tail, iters)
    return torch.exp(torch.mean(torch.log(torch.stack(ratios[-tail:])
                                          + 1e-30), dim=0))


def charpoly(A):
    """Characteristic-polynomial coefficients of (..., N, N) matrices by
    the Faddeev-LeVerrier recursion: ``c`` (..., N) with
    ``p(z) = z^N + c[0] z^{N-1} + ... + c[N-1]``.  N small matmuls; on the
    card the caller keeps TF32 off, so they stay full precision."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    Mk = A
    c = -torch.diagonal(Mk, dim1=-2, dim2=-1).sum(-1)
    cs = [c]
    for k in range(2, N + 1):
        Mk = torch.matmul(A, Mk + c[..., None, None] * eye)
        c = -torch.diagonal(Mk, dim1=-2, dim2=-1).sum(-1) / k
        cs.append(c)
    return torch.stack(cs, dim=-1)


def _dk_start_angles(N: int, dtype: torch.dtype, device):
    """cos and sin of the start angles 2 pi (n + 0.354) / N, computed in
    float64 and rounded once to ``dtype`` (as the kernel does)."""
    ang = 2.0 * np.pi * (np.arange(N) + 0.354) / N
    return (torch.tensor(np.cos(ang), dtype=dtype, device=device),
            torch.tensor(np.sin(ang), dtype=dtype, device=device))


def _dk_iterate_rows(cr, ci, iters: int):
    """Durand-Kerner (Weierstrass) simultaneous root iteration on rows:
    real coefficient rows ``cr``/``ci`` (N, ...) of the monic
    ``z^N + c[0] z^{N-1} + ... + c[N-1]`` -> root rows ``(zr, zi)`` (N, ...).

    This is the plain version of kernel K7 and the iteration of the JAX
    package's ``_dk_iterate``: start on the circle of radius
    ``0.9 (1 + max_k |c_k|)`` at angles ``2 pi (n + 0.354) / N``, then
    ``iters`` simultaneous (Jacobi) updates
    ``z_n -= p(z_n) / prod_{j != n} (z_n - z_j)``, a slot frozen where
    ``|prod|^2 = 0``.  The arithmetic is explicit re/im pairs in the
    kernel's order of operations (monic Horner, the product in ascending
    j, ``(p conj(d)) / |d|^2``), so on the card the kernel, built without
    FMA contraction, repeats it to the last bit."""
    N = cr.shape[0]
    R = torch.sqrt(cr * cr + ci * ci).amax(dim=0)
    R = 0.9 * (1.0 + R)
    cos_a, sin_a = _dk_start_angles(N, cr.dtype, cr.device)
    shape = (N,) + (1,) * (cr.ndim - 1)
    zr = R[None] * cos_a.reshape(shape)
    zi = R[None] * sin_a.reshape(shape)
    eye = torch.eye(N, dtype=torch.bool, device=cr.device).reshape(
        (N, N) + (1,) * (cr.ndim - 1))
    one = torch.ones((), dtype=cr.dtype, device=cr.device)
    zero = torch.zeros((), dtype=cr.dtype, device=cr.device)
    for _ in range(iters):
        ar = torch.ones_like(zr)
        ai = torch.zeros_like(zi)
        for k in range(N):
            tr = ar * zr - ai * zi
            ti = ar * zi + ai * zr
            ar, ai = tr + cr[k], ti + ci[k]
        dr = torch.ones_like(zr)
        di = torch.zeros_like(zi)
        for j in range(N):
            # z_n - z_j, and exactly 1 in slot j (a factor of one)
            er = torch.where(eye[j], one, zr - zr[j])
            ei = torch.where(eye[j], zero, zi - zi[j])
            dr, di = dr * er - di * ei, dr * ei + di * er
        d2 = dr * dr + di * di
        ok = d2 > 0.0
        inv = 1.0 / torch.where(ok, d2, one)
        sr = (ar * dr + ai * di) * inv
        si = (ai * dr - ar * di) * inv
        zr = zr - torch.where(ok, sr, zero)
        zi = zi - torch.where(ok, si, zero)
    return zr, zi


def _dk_iterate(c, iters: int):
    """:func:`_dk_iterate_rows` for complex coefficients (..., N) ->
    complex roots (..., N)."""
    cr = torch.movedim(c.real, -1, 0)
    ci = torch.movedim(c.imag, -1, 0)
    zr, zi = _dk_iterate_rows(cr, ci, iters)
    return torch.complex(torch.movedim(zr, 0, -1), torch.movedim(zi, 0, -1))


def _poly_roots_pullback(z, z_bar):
    """JAX's implicit-function pullback at converged roots, in JAX's
    cotangent convention: ``c_bar_k = -sum_n w_n z_n^{N-1-k}`` with
    ``w_n = z_bar_n / p'(z_n)``, ``p'(z_n) = prod_{j != n} (z_n - z_j)``
    (0 where that product is 0).  z and z_bar (..., N) complex."""
    N = z.shape[-1]
    eye = torch.eye(N, dtype=z.dtype, device=z.device)
    diff = z[..., :, None] - z[..., None, :] + eye
    dp = torch.prod(diff, dim=-1)
    ok = torch.abs(dp) > 0.0
    w = torch.where(ok, z_bar / torch.where(ok, dp, torch.ones_like(dp)),
                    torch.zeros_like(dp))
    pw = torch.stack([z ** (N - 1 - k) for k in range(N)], dim=-1)
    return -torch.sum(w[..., :, None] * pw, dim=-2)


class _PolyRoots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, iters):
        if c.dtype == torch.complex64:
            from flamo_tpu_torch.ops.eig_kernels import dk_roots

            z = dk_roots(c, iters)
        else:
            z = _dk_iterate(c, iters)
        ctx.save_for_backward(z)
        return z

    @staticmethod
    def backward(ctx, z_bar):
        (z,) = ctx.saved_tensors
        # PyTorch's gradient of a complex tensor is the conjugate of JAX's
        # cotangent: conjugate in, apply JAX's pullback, conjugate out
        c_bar = _poly_roots_pullback(z, torch.conj_physical(z_bar))
        return torch.conj_physical(c_bar), None


def poly_roots(c, iters: int = 96):
    """All complex roots of the monic polynomial(s)
    ``z^N + c[..., 0] z^{N-1} + ... + c[..., N-1]`` by batched
    Durand-Kerner iteration; the root order is the iteration's, not
    LAPACK's.  The gradient is the implicit-function pullback at the
    converged roots (exact for simple roots).

    Dtype rule: complex64 runs kernel K7 (:func:`~flamo_tpu_torch.ops.
    eig_kernels.dk_roots`: the CUDA kernel for CUDA tensors, N <= 8, its
    plain version for CPU tensors); complex128 runs the plain iteration on
    any device, as the JAX package sends x64 to its scan: the kernel is
    float32."""
    return _PolyRoots.apply(c, iters)


def _poly_roots_rows_pullback(zr, zi, zr_bar, zi_bar):
    """The pullback of :func:`poly_roots_rows` on rows: with
    ``acc_k = -sum_n w_n z_n^{N-1-k}``, ``w_n = (zr_bar_n - i zi_bar_n) /
    p'(z_n)``, the real gradients are ``cr_bar = Re acc``,
    ``ci_bar = -Im acc``."""
    N = zr.shape[0]
    z = torch.complex(zr, zi)
    eye = torch.eye(N, dtype=z.dtype, device=z.device).reshape(
        (N, N) + (1,) * (z.ndim - 1))
    dp = torch.prod(z[:, None] - z[None, :] + eye, dim=1)
    ok = torch.abs(dp) > 0.0
    w = torch.complex(zr_bar, -zi_bar)
    w = torch.where(ok, w / torch.where(ok, dp, torch.ones_like(dp)),
                    torch.zeros_like(dp))
    crb, cib = [], []
    p = torch.ones_like(z)
    for _ in range(N):
        acc = -torch.sum(w * p, dim=0)
        crb.append(torch.real(acc))
        cib.append(-torch.imag(acc))
        p = p * z
    return torch.stack(crb[::-1]), torch.stack(cib[::-1])


class _PolyRootsRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cr, ci, iters):
        if cr.dtype == torch.float32:
            from flamo_tpu_torch.ops.eig_kernels import dk_roots_rows

            zr, zi = dk_roots_rows(cr, ci, iters)
        else:
            zr, zi = _dk_iterate_rows(cr, ci, iters)
        ctx.save_for_backward(zr, zi)
        return zr, zi

    @staticmethod
    def backward(ctx, zr_bar, zi_bar):
        zr, zi = ctx.saved_tensors
        if zr_bar is None:
            zr_bar = torch.zeros_like(zr)
        if zi_bar is None:
            zi_bar = torch.zeros_like(zi)
        crb, cib = _poly_roots_rows_pullback(zr, zi, zr_bar, zi_bar)
        return crb, cib, None


def poly_roots_rows(cr, ci, iters: int = 96):
    """Rows twin of :func:`poly_roots`: real coefficient rows ``cr``/``ci``
    (N, B), polynomials on the last axis, -> real root rows ``(zr, zi)``,
    each (N, B).  Same iteration, root order and pullback.

    Dtype rule: float32 runs kernel K7 (:func:`~flamo_tpu_torch.ops.
    eig_kernels.dk_roots_rows`: the CUDA kernel for CUDA tensors, N <= 8,
    its plain version for CPU tensors); float64 runs the plain iteration
    on any device."""
    return _PolyRootsRows.apply(cr, ci, iters)


def eigvals_dk(A, iters: int = 96):
    """Differentiable eigenvalues of small (..., N, N) matrices, N <= 8:
    the matrix is spectrum-centred and scaled (``B = (A - mu I) / s``),
    then :func:`charpoly` + :func:`poly_roots`.  The root order is the
    iteration's: compare sorted or through symmetric functions."""
    rdt = A.real.dtype if A.is_complex() else A.dtype
    cd = complex_dtype_for(rdt)
    A = A.to(cd)
    N = A.shape[-1]
    eye = torch.eye(N, dtype=cd, device=A.device)
    mu = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / N
    B = A - mu[..., None, None] * eye
    s = torch.clamp(torch.sqrt(torch.sum(torch.abs(B) ** 2, dim=(-2, -1))
                               / N), min=1e-30)
    B = B / s[..., None, None]
    z = poly_roots(charpoly(B), iters)
    return z * s[..., None].to(cd) + mu[..., None]
