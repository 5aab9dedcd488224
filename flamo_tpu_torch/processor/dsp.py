"""DSP processor modules of the colorless-, attenuated- and scattering-FDN
paths and of the e8_fdn example (counterpart of the matching subset of
``flamo_tpu/processor/dsp.py``).

Spectra flow as complex ``(B, M, N, ...)`` with ``M = nfft//2+1`` rfft
bins; each module maps its raw ``param`` to a per-bin response and
contracts with an einsum, as in the JAX package.  Unlike there, modules
are mutable ``nn.Module``s: :meth:`DSP.assign_value` writes in place and
returns the module, and a module is trainable exactly when its ``param``
requires grad.

The eager construction checks raise ``AssertionError`` with the JAX
package's messages (explicitly, so they survive ``python -O``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from flamo_tpu_torch.auxiliary.eq import eq_freqs, geq
from flamo_tpu_torch.auxiliary.scattering import ScatteringMapping
from flamo_tpu_torch.core import Module
from flamo_tpu_torch.functional import (HadamardMatrix, RotationMatrix,
                                        cascade_prods, expm_skew,
                                        poly_response)
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.sos_kernels import _iir_guard_prods, sos_cascade
from flamo_tpu_torch.utils import (complex_dtype_for, next_key,
                                   resolve_device, to_complex)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _identity(x):
    return x


def _abs_db_map(x):
    return 20 * torch.log10(torch.abs(x))


def _softplus(x):
    return torch.nn.functional.softplus(x)


def _bins_prod_mod(b, m_int, nfft: int):
    """``(b * m_int) % nfft``, exact in int64 (both factors are reduced mod
    nfft first, so the product stays below nfft**2).  The ``response_at``
    phasors take their phase indices from it: integer indices mod nfft
    avoid the float32 large-angle loss of ``cos(2 pi b m / nfft)`` at
    b m ~ 1e8.  (The JAX package splits m into int32 hi/lo halves for the
    TPU; the indices are the same.)"""
    return (b.to(torch.int64) % nfft) * (m_int.to(torch.int64) % nfft) % nfft


# ============================= TRANSFORMS ================================


class Transform(Module):
    """Wraps an arbitrary callable as a module."""

    def __init__(self, transform: Callable = _identity,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform = transform
        self.dtype = dtype

    def forward(self, x):
        return self.transform(x)


class FFT(Transform):
    """rfft along the time axis (dim=1), zero-padded to ``nfft``."""

    def __init__(self, nfft: int = 2**11, norm: str = "backward",
                 dtype: torch.dtype = torch.float32):
        super().__init__(transform=_identity, dtype=dtype)
        self.nfft = nfft
        self.norm = norm

    def forward(self, x):
        return torch.fft.rfft(x, n=self.nfft, dim=1, norm=self.norm)


class iFFT(Transform):
    """irfft along the bin axis (dim=1)."""

    def __init__(self, nfft: int = 2**11, norm: str = "backward",
                 dtype: torch.dtype = torch.float32):
        super().__init__(transform=_identity, dtype=dtype)
        self.nfft = nfft
        self.norm = norm

    def forward(self, x):
        return torch.fft.irfft(x, n=self.nfft, dim=1, norm=self.norm)


def _alias_envelope(nfft: int, alias_decay_db: float, dtype: torch.dtype,
                    device=None) -> torch.Tensor:
    """gamma^{-n} envelope of length nfft."""
    device = resolve_device(device)
    gamma = 10 ** (-abs(alias_decay_db) / nfft / 20)
    n = torch.arange(0, -nfft, -1, dtype=dtype, device=device)
    return torch.tensor(gamma, dtype=dtype, device=device) ** n


class _AntiAliasTransform(Transform):
    """A transform with the alias envelope of :func:`_alias_envelope`,
    built once, on ``device`` (default: the CUDA card) in ``dtype``."""

    def __init__(self, nfft: int = 2**11, norm: str = "backward",
                 alias_decay_db: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(transform=_identity, dtype=dtype)
        self.nfft = nfft
        self.norm = norm
        self.alias_decay_db = float(alias_decay_db)
        self.register_buffer("env", _alias_envelope(
            nfft, self.alias_decay_db, dtype, device), persistent=False)


class FFTAntiAlias(_AntiAliasTransform):
    """rfft of the input times the alias envelope (the JAX package's
    FFTAntiAlias, envelope for envelope)."""

    def forward(self, x):
        return torch.fft.rfft(x * self.env[None, :, None], n=self.nfft,
                              dim=1, norm=self.norm)


class iFFTAntiAlias(_AntiAliasTransform):
    """irfft followed by the gamma^{-n} rising envelope, which undoes the
    alias decay of the modules' responses."""

    def forward(self, x):
        y = torch.fft.irfft(x, n=self.nfft, dim=1, norm=self.norm)
        return y * self.env[None, :, None]


# ============================= CORE ================================


class DSP(Module):
    """Processor base: raw ``param`` -> per-bin response.

    ``generator`` (a ``torch.Generator``, default the global stream of
    :func:`flamo_tpu_torch.utils.set_seed`) draws the initial parameters
    on the CPU; they are then moved to ``device``."""

    def __init__(self, size: tuple, nfft: int = 2**11,
                 map: Callable = _identity, requires_grad: bool = False,
                 alias_decay_db: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        super().__init__()
        _check(isinstance(size, tuple), "Size must be a tuple.")
        self.size = size
        self.nfft = int(nfft)
        self.map = map
        self.alias_decay_db = float(alias_decay_db)
        self.dtype = dtype
        init = self.init_param(next_key(generator))
        self.param = nn.Parameter(init.to(resolve_device(device)),
                                  requires_grad=bool(requires_grad))
        self.initialize_class()

    # -- construction hooks (overridden by subclasses) --------------------
    def init_param(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(self.size, generator=generator, dtype=self.dtype)

    def initialize_class(self):
        self.check_param_shape()
        self.get_io()

    def check_param_shape(self):
        pass

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = (self.size[-2] if len(self.size) >= 2
                                else self.size[-1])

    # -- static helpers ----------------------------------------------------
    @property
    def trainable(self) -> bool:
        return self.param.requires_grad

    @property
    def gamma(self) -> float:
        """gamma = 10^(-|alias_dB| / nfft / 20)."""
        return 10 ** (-abs(self.alias_decay_db) / self.nfft / 20)

    @property
    def cdtype(self) -> torch.dtype:
        return complex_dtype_for(self.dtype)

    @property
    def M(self) -> int:
        return self.nfft // 2 + 1

    def omega(self) -> torch.Tensor:
        """2 pi m / nfft on the rfft grid, shape (M,)."""
        return (2 * torch.pi * torch.arange(
            self.M, dtype=self.dtype, device=self.param.device) / self.nfft)

    def response_at(self, bins):
        """Frequency response at rfft bins ``bins`` only."""
        return self.response()[torch.as_tensor(bins,
                                               device=self.param.device)]

    # -- parameter update ----------------------------------------------------
    def assign_value(self, new_value, indx=None) -> "DSP":
        """Write new raw parameters in place and return the module."""
        new_value = torch.as_tensor(new_value, dtype=self.dtype,
                                    device=self.param.device)
        with torch.no_grad():
            if indx is None:
                _check(tuple(new_value.shape) == tuple(self.param.shape),
                       f"New values shape {tuple(new_value.shape)} is not "
                       f"compatible with the parameter shape "
                       f"{tuple(self.param.shape)}.")
                self.param.copy_(new_value)
            else:
                self.param[indx] = new_value
        return self

    def check_input_shape(self, x):
        if (self.M, self.input_channels) != (x.shape[1], x.shape[2]):
            raise ValueError(
                f"parameter shape = {self.size} not compatible with input "
                f"signal of shape = ({tuple(x.shape)}).")


# ============================= GAINS ================================


class Gain(DSP):
    """Frequency-flat MIMO matrix gain, param (N_out, N_in)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "gains must be 2D. For 1D (parallel) gains use parallelGain "
               "module.")

    def check_input_shape(self, x):
        if self.input_channels != x.shape[2]:
            raise ValueError(
                f"parameter shape = {self.size} not compatible with input "
                f"signal of shape = ({tuple(x.shape)}).")

    def response(self):
        return to_complex(self.map(self.param))

    def response_at(self, bins):
        return self.response()

    def matrix_response(self):
        return linop.FLAT, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("mn,bfn...->bfm...", self.response(), x)


class parallelGain(Gain):
    """Per-channel (diagonal) gain, param (N,)."""

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "gains must be 1D, for 2D gains use Gain module.")

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def matrix_response(self):
        return linop.DIAG, self.response()[None, :]

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("n,bfn...->bfn...", self.response(), x)


# ============================= MATRICES ================================


class Matrix(Gain):
    """Gain whose map comes from a matrix gallery: ``random``/``identity``
    (identity map), ``orthogonal`` (``expm_skew``), ``hadamard`` (the
    constant Hadamard matrix) or ``rotation`` (a Kronecker power of the
    2 x 2 rotation by the raw param's [0, 0] angle, ``iter`` squarings)."""

    def __init__(self, size=(1, 1), nfft=2**11, map=_identity,
                 matrix_type: str = "random", iter: int = 1,
                 requires_grad: bool = False, alias_decay_db: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        self.matrix_type = matrix_type
        self.iter = iter
        super().__init__(size=size, nfft=nfft, map=map,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def initialize_class(self):
        self.check_param_shape()
        self.get_io()
        self.matrix_gallery()

    def matrix_gallery(self):
        N = self.size[0]
        if self.matrix_type in ("random", "identity"):
            self.map = _identity
        elif self.matrix_type == "orthogonal":
            _check(N == self.size[1], "Matrix must be square to be orthogonal")
            self.map = expm_skew
        elif self.matrix_type == "hadamard":
            _check(N == self.size[1], "Matrix must be square to be Hadamard")
            _check(N % 2 == 0,
                   "Matrix must have even dimensions to be Hadamard")
            self.map = HadamardMatrix(N, dtype=self.dtype)
        elif self.matrix_type == "rotation":
            _check(N == self.size[1],
                   "Matrix must be square to be a rotation matrix")
            _check(N % 2 == 0, "Matrix must have even dimensions to be a "
                   "rotation matrix")
            self.map = _RotationMap(
                RotationMatrix(N, iters=self.iter, dtype=self.dtype))
        else:
            raise ValueError(f"unknown matrix_type {self.matrix_type}")


class _RotationMap:
    """Map adapter: full raw matrix -> rotation built from its [0, 0]
    angle."""

    def __init__(self, rot: RotationMatrix):
        self.rot = rot

    def __call__(self, x):
        return self.rot(x[0][0])


def _householder_map(x):
    return to_complex(x) / torch.linalg.vector_norm(x, dim=0, keepdim=True)


class HouseholderMatrix(Gain):
    """Orthogonal I - 2 u u^T from the unit vector u (N, 1) of its raw
    (N, 1) param; the forward applies it as two vector contractions and
    never forms the matrix."""

    def __init__(self, size=(1, 1), nfft=2**11, requires_grad=False,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None):
        _check(size[0] == size[1], "Matrix must be square")
        super().__init__(size=(size[0], 1), nfft=nfft, map=_householder_map,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def get_io(self):
        self.input_channels = self.size[0]
        self.output_channels = self.size[0]

    def check_input_shape(self, x):
        if self.size[0] != x.shape[2]:
            raise ValueError(
                f"parameter shape = {self.size} not compatible with input "
                f"signal of shape = ({tuple(x.shape)}).")

    def matrix_response(self):
        u = self.map(self.param)
        eye = torch.eye(self.size[0], dtype=u.dtype, device=u.device)
        return linop.FLAT, eye - 2 * (u @ u.T)

    def forward(self, x):
        self.check_input_shape(x)
        u = self.map(self.param)  # (N, 1) complex
        uTx = torch.einsum("mn,bfn...->bfm...", u.T, x)
        uuTx = torch.einsum("nm,bfm...->bfn...", u, uTx)
        return x - 2 * uuTx


# ============================= DELAYS ================================


class Delay(DSP):
    """MIMO delay matrix: response gamma^m e^{-j omega m}.

    The param is stored in seconds x ``unit`` (``s2sample``/``sample2s``),
    optionally rounded to whole samples (``isint``); a trainable delay
    goes through softplus."""

    def __init__(self, size=(1, 1), max_len=2000, isint=False, unit=100,
                 nfft=2**11, fs=48000, requires_grad=False,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None):
        self.fs = fs
        self.max_len = int(max_len)
        self.unit = unit
        self.isint = bool(isint)
        super().__init__(size=size, nfft=nfft,
                         map=_softplus if requires_grad else _identity,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def init_param(self, generator):
        if self.isint:
            delay_len = torch.randint(1, self.max_len, self.size,
                                      generator=generator).to(self.dtype)
        else:
            delay_len = torch.rand(self.size, generator=generator,
                                   dtype=self.dtype) * self.max_len
        self.order = int(self.max_len) + 1
        return self.sample2s(delay_len)

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "delay must be 2D, for 1D (parallel) delay use parallelDelay "
               "module.")

    def s2sample(self, delay):
        return torch.as_tensor(delay) * self.fs / self.unit

    def sample2s(self, delay):
        return torch.as_tensor(delay) / self.fs * self.unit

    def get_delays(self, param):
        m = self.s2sample(self.map(param))
        return torch.round(m) if self.isint else m

    def _gain_of(self, m):
        gam = torch.tensor(self.gamma, dtype=self.dtype, device=m.device)
        return gam ** m

    def response(self):
        m = self.get_delays(self.param)  # (N_out, N_in)
        phase = self.omega()[:, None, None] * m[None]
        return self._gain_of(m)[None] * torch.exp(-1j * phase)

    def response_at(self, bins):
        """Closed-form ``gamma^m e^{-j w m}`` at just ``bins``, for Delay's
        (N_out, N_in) and parallelDelay's (N,) delays alike.  The phase
        ``b m`` is reduced mod nfft with the integer part of m in exact
        integer arithmetic; the fractional part (nonzero only for
        trainable non-integer delays) is added in float32 and is the only
        path of the delay gradient (d phase / d m = 2 pi b / nfft, exact,
        since floor is piecewise constant)."""
        m = self.get_delays(self.param)
        b = torch.as_tensor(bins, device=m.device).to(torch.int64)
        mi = torch.floor(m).detach()
        frac = m - mi
        bb = b.reshape((-1,) + (1,) * m.ndim)
        idx = _bins_prod_mod(bb, mi, self.nfft)
        ph = (2 * torch.pi / self.nfft) * (
            idx.to(self.dtype) + bb.to(self.dtype) * frac)
        return self._gain_of(m)[None] * torch.exp(-1j * ph)

    def matrix_response(self):
        return linop.FULL, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("fmn,bfn...->bfm...", self.response(), x)


class parallelDelay(Delay):
    """Diagonal delays (N,): the FDN delay-line module."""

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "delays must be 1D, for 2D delays use Delay module.")

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def response(self):
        # omega * m in float32, in the JAX package's order: the phase
        # reaches ~6.4e3 rad at m = 2053, nfft = 96000
        m = self.get_delays(self.param)  # (N,)
        phase = self.omega()[:, None] * m[None, :]
        return self._gain_of(m)[None] * torch.exp(-1j * phase)

    def matrix_response(self):
        return linop.DIAG, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("fn,bfn...->bfn...", self.response(), x)


# ============================= FILTERS ================================


class Filter(DSP):
    """General FIR MIMO filter, param (taps, N_out, N_in): response =
    rfft(map(param) * gamma^t).  The probes are not ported yet."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 3D, for 2D (parallel) filters use "
               "ParallelFilter module.")

    def ir(self, param):
        return self.map(param)

    def response(self):
        """(M, N_out, N_in) complex frequency response."""
        ir = self.ir(self.param)
        t = torch.arange(ir.shape[0], dtype=self.dtype, device=ir.device)
        env = torch.tensor(self.gamma, dtype=self.dtype,
                           device=ir.device) ** t
        env = env.reshape((-1,) + (1,) * (ir.ndim - 1))
        return torch.fft.rfft(ir * env, n=self.nfft, dim=0)

    def response_at(self, bins):
        """``response()[bins]`` without the full-nfft rfft: the (L, ...) ir
        times the alias envelope, contracted against an exact-phase DFT
        basis at just those bins, two float32 (P, L) x (L, prod(size))
        matmuls (the caller keeps TF32 off on the card).  The phase
        indices are integers mod nfft (:func:`_bins_prod_mod`).  A
        subclass that redefines :meth:`response` (GEQ) takes the base
        gather instead, since the FIR contraction would not be its
        response."""
        if type(self).response is not Filter.response:
            return DSP.response_at(self, bins)
        b = torch.as_tensor(bins, device=self.param.device).to(torch.int64)
        ir = self.ir(self.param)
        if ir.shape[0] > self.nfft:  # rfft(n=nfft) truncates; match it
            ir = ir[:self.nfft]
        L = ir.shape[0]
        t = torch.arange(L, dtype=self.dtype, device=ir.device)
        env = torch.tensor(self.gamma, dtype=self.dtype, device=ir.device) ** t
        flat = (ir * env.reshape((-1,) + (1,) * (ir.ndim - 1))).reshape(L, -1)
        idx = _bins_prod_mod(b[:, None],
                             torch.arange(L, device=ir.device)[None, :],
                             self.nfft)
        ph = (2 * torch.pi / self.nfft) * idx.to(self.dtype)
        re = torch.matmul(torch.cos(ph), flat)
        im = torch.matmul(torch.sin(ph), flat)
        return torch.complex(re, -im).reshape((b.shape[0],) + ir.shape[1:])

    def matrix_response(self):
        return linop.FULL, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("fmn,bfn...->bfm...", self.response(), x)


class parallelFilter(Filter):
    """Diagonal FIR filter, param (taps, N): one FIR per channel (the
    active-acoustics rig's WGN reverb tail)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "Filter must be 1D, for 2D filters use Filter module.")

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def matrix_response(self):
        return linop.DIAG, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("fn,bfn...->bfn...", self.response(), x)


# -------------------- scattering feedback matrices -------------------------


class ScatteringMatrix(Filter):
    """Learnable paraunitary filter feedback matrix for FDNs: K+1
    orthogonal matrices (``expm_skew`` of the (K+1, N, N) param)
    interleaved with sparse parallel delays (Schlecht & Habets,
    'Scattering in FDNs').  The shifts and m_L/m_R of its
    :class:`ScatteringMapping` are drawn from ``generator`` at
    construction and stay fixed."""

    def __init__(self, size=(1, 1, 1), nfft=2**11, sparsity=3,
                 gain_per_sample=0.9999, pulse_size=1, m_L=None, m_R=None,
                 requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        _check(size[1] == size[2], "Matrix must be square")
        self.sparsity = sparsity
        self.gain_per_sample = float(gain_per_sample)
        self.pulse_size = pulse_size
        generator = next_key(generator)
        self.map_filter = ScatteringMapping(
            size[-1], n_stages=size[0] - 1, sparsity=sparsity,
            gain_per_sample=gain_per_sample, pulse_size=pulse_size,
            m_L=m_L, m_R=m_R, dtype=dtype, generator=generator)
        super().__init__(size=size, nfft=nfft, map=expm_skew,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def ir(self, param):
        return self.map_filter(self.map(param))


# -------------------- parametric IIR families ------------------------------


def _iir_eps_guard(B, A):
    """Guarded product-of-sections ratio from materialized (M, K, ...)
    per-section responses."""
    return _iir_guard_prods(torch.prod(B, dim=1), torch.prod(A, dim=1))


def _guarded_cascade(be, ae, nfft: int, backend: str = "xla"):
    """Guarded cascade response from envelope-applied (P, K, ...) taps.

    backend='xla': the Horner-product chain of ``cascade_prods`` in
    PyTorch; backend='pallas': the hand-written cascade kernel K4
    (:func:`flamo_tpu_torch.ops.sos_kernels.sos_cascade`; the names are
    the JAX package's).  Trailing channel dims fold into the kernel's
    channel axis."""
    if backend == "pallas":
        P, K = be.shape[:2]
        chans = be.shape[2:]
        H = sos_cascade(be.reshape(P, K, -1), ae.reshape(P, K, -1), nfft)
        return H.reshape((H.shape[0],) + tuple(chans))
    return _iir_guard_prods(*cascade_prods(be, ae, nfft))


def _check_cascade_backend(backend: str):
    if backend not in ("xla", "pallas"):
        raise ValueError(
            f"cascade_backend must be 'xla' or 'pallas', got {backend!r}")


class GEQ(Filter):
    """Graphic EQ (1 or 1/3 octave); params = command gains (K, N_out,
    N_in), K = n_bands + 3.  ``cascade_backend='pallas'`` evaluates the
    cascade with kernel K4."""

    def __init__(self, size=(1, 1), octave_interval=1, nfft=2**11, fs=48000,
                 map=_abs_db_map, requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None, cascade_backend: str = "xla"):
        _check_cascade_backend(cascade_backend)
        self.cascade_backend = cascade_backend
        self.octave_interval = octave_interval
        self.fs = fs
        center, shelving = eq_freqs(interval=octave_interval)
        self.center_freq = tuple(float(f) for f in center)
        self.shelving_crossover = tuple(float(f) for f in shelving)
        self.n_gains = len(self.center_freq) + 3
        super().__init__(size=(self.n_gains, *size), nfft=nfft, map=map,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)
        # the band frequencies on the parameter's device, so that the
        # design of a training step copies nothing from the host
        for name, freqs in (("center_freq_t", self.center_freq),
                            ("shelving_crossover_t", self.shelving_crossover)):
            self.register_buffer(name, torch.tensor(
                freqs, dtype=dtype, device=self.param.device),
                persistent=False)

    def init_param(self, generator):
        lo, hi = 10 ** (-6 / 20), 10 ** (6 / 20)
        return (torch.rand(self.size, generator=generator, dtype=self.dtype)
                * (hi - lo) + lo)

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 3D, for 2D (parallel) filters use ParallelGEQ "
               "module.")

    def _design(self, gain_db):
        """gain_db (K, ...) -> SOS (b, a), each (3, n_bands, ...)."""
        return geq(center_freq=self.center_freq_t,
                   shelving_freq=self.shelving_crossover_t, R=2.7,
                   gain_db=gain_db, fs=self.fs, dtype=self.dtype)

    def sos_taps(self, gain_db):
        """The design's (b, a) with the alias envelope gamma^[0, 1, 2]
        folded in: the taps the cascade is evaluated from."""
        b, a = self._design(gain_db)
        env = self.gamma ** torch.arange(3, dtype=self.dtype,
                                         device=b.device)
        env = env.reshape((3,) + (1,) * (b.ndim - 1))
        return b * env, a * env

    def get_poly_coeff(self, gain_db):
        """(H, B, A): the guarded response and the (M, K, ...) per-section
        numerator and denominator responses.  :meth:`response` needs H
        alone and does not compute B and A."""
        be, ae = self.sos_taps(gain_db)
        return (_guarded_cascade(be, ae, self.nfft, self.cascade_backend),
                poly_response(be, self.nfft), poly_response(ae, self.nfft))

    def response(self):
        be, ae = self.sos_taps(self.map(self.param))
        return _guarded_cascade(be, ae, self.nfft, self.cascade_backend)


class parallelGEQ(GEQ):
    """Diagonal GEQ, param (K, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "Filter must be 2D, for 3D filters use GEQ module.")

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def matrix_response(self):
        return linop.DIAG, self.response()

    def forward(self, x):
        self.check_input_shape(x)
        return torch.einsum("fn,bfn...->bfn...", self.response(), x)


class CachedResponse(Module):
    """Precomputed response of a FROZEN module: computed once at wrap
    time and kept as the real buffers ``H_re``/``H_im`` (the JAX
    package's leaf names), so a training step only contracts with it."""

    def __init__(self, module):
        super().__init__()
        _check(not getattr(module, "trainable", False),
               "CachedResponse is for frozen modules; a trainable module's "
               "response must be recomputed from its parameters every step.")
        with torch.no_grad():
            kind, H = module.matrix_response()
        self.kind = kind
        self.register_buffer("H_re", torch.real(H).contiguous())
        self.register_buffer("H_im", torch.imag(H).contiguous())
        self.nfft = module.nfft
        self.M = module.nfft // 2 + 1
        self.alias_decay_db = module.alias_decay_db
        self.dtype = module.dtype
        self.input_channels = module.input_channels
        self.output_channels = module.output_channels
        self.trainable = False

    @property
    def H(self) -> torch.Tensor:
        return torch.complex(self.H_re, self.H_im)

    def matrix_response(self):
        return self.kind, self.H

    def forward(self, x):
        return linop.apply(self.kind, self.H, x)
