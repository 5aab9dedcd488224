"""Functional helpers of the colorless- and attenuated-FDN paths
(counterpart of the matching subset of ``flamo_tpu/functional.py``)."""

from __future__ import annotations

import torch

from flamo_tpu_torch.utils import resolve_device


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


_SIGNAL_TYPES = {"impulse", "sine", "sweep", "wgn", "exp", "reference",
                 "noise", "velvet"}


def signal_gallery(batch_size: int, n_samples: int, n: int,
                   signal_type: str = "impulse", fs: int = 48000,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Test signal of shape (batch_size, n_samples, n).  Only the impulse
    is ported so far; the other types of the JAX gallery raise."""
    if signal_type not in _SIGNAL_TYPES:
        raise ValueError(f"Signal type {signal_type} not recognized.")
    if signal_type != "impulse":
        raise NotImplementedError(
            f"signal_gallery({signal_type!r}) is not ported yet; only "
            "'impulse' is.")
    x = torch.zeros((batch_size, n_samples, n), dtype=dtype,
                    device=resolve_device(device))
    x[:, 0, :] = 1.0
    return x


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


def cascade_prods(b, a, nfft: int, zinv=None):
    """``(prod_k polyval(b[:, k]), prod_k polyval(a[:, k]))`` on the rfft
    grid, one Horner-and-multiply chain per section, without the
    (M, K, ...) per-section responses.  b, a: (P, K, ...) tap-major SOS
    cascades.  ``zinv`` (M,) replaces the rfft phasor (a shifted bin
    grid)."""
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

    prodB = polyval(b[:, 0])
    prodA = polyval(a[:, 0])
    for k in range(1, K):
        prodB = prodB * polyval(b[:, k])
        prodA = prodA * polyval(a[:, k])
    return prodB, prodA


# ----------------------------------------------------------------------
# filter design
# ----------------------------------------------------------------------
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
