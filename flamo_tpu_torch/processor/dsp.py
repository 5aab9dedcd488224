"""DSP processor modules (counterpart of ``flamo_tpu/processor/dsp.py``).

Spectra flow as complex ``(B, M, N, ...)`` with ``M = nfft//2+1`` rfft
bins; each module maps its raw ``param`` to a per-bin response and
contracts with an einsum, as in the JAX package.  Unlike there, modules
are mutable ``nn.Module``s: :meth:`DSP.assign_value` writes in place and
returns the module, and a module is trainable exactly when its ``param``
requires grad.

Hyper-conditioning: ``forward(x, ext_param)``, ``response(ext_param)`` and
``matrix_response(ext_param)`` use the raw parameters ``ext_param`` in
place of ``param`` (the containers of ``system`` route a dict of them by
key), so that a gradient reaches whatever computed them.

``probe(z)`` is a module's transfer matrix at one point ``z`` of the
z-plane, from its own ``param``, and ``probe_w(w)`` the same at
``z = 1/w``; :func:`torch.func.vmap` batches it over a grid of z.

The eager construction checks raise ``AssertionError`` with the JAX
package's messages (explicitly, so they survive ``python -O``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from flamo_tpu_torch.auxiliary.eq import accurate_geq, eq_freqs, geq
from flamo_tpu_torch.auxiliary.scattering import ScatteringMapping
from flamo_tpu_torch.core import Module
from flamo_tpu_torch.functional import (HadamardMatrix, RotationMatrix,
                                        _clip, bandpass_filter,
                                        cascade_prods_scaled, expm_skew,
                                        hadamard_matrix_jnp, highpass_filter,
                                        lowpass_filter,
                                        poly_response, rad2hertz, svf_mix,
                                        svf_taps)
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


def _contract(spec: str, H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A module's response (or map) contracted with its input in their
    common dtype, as ``jnp.einsum`` promotes mixed operands: under
    ``torch.set_default_dtype(torch.float64)`` (the examples' ``--dtype
    float64``, JAX's x64 mode) an input made without a dtype is float64
    and meets the modules' float32 responses."""
    dt = torch.promote_types(H.dtype, x.dtype)
    return torch.einsum(spec, H.to(dt), x.to(dt))


def _as_z(z, cdtype: torch.dtype, device) -> torch.Tensor:
    """A probe's point z as a complex tensor on the module's device."""
    if isinstance(z, torch.Tensor):
        return z.to(dtype=cdtype, device=device)
    return torch.tensor(z, dtype=cdtype, device=device)


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

    def forward(self, x, ext_param=None):
        return self.transform(x)

    def probe(self, z):
        """An identity transfer, for a Shell's layers: None."""
        return None

    def probe_w(self, w):
        return None


class FFT(Transform):
    """rfft along the time axis (dim=1), zero-padded to ``nfft``."""

    def __init__(self, nfft: int = 2**11, norm: str = "backward",
                 dtype: torch.dtype = torch.float32):
        super().__init__(transform=_identity, dtype=dtype)
        self.nfft = nfft
        self.norm = norm

    def forward(self, x, ext_param=None):
        return torch.fft.rfft(x, n=self.nfft, dim=1, norm=self.norm)


class iFFT(Transform):
    """irfft along the bin axis (dim=1)."""

    def __init__(self, nfft: int = 2**11, norm: str = "backward",
                 dtype: torch.dtype = torch.float32):
        super().__init__(transform=_identity, dtype=dtype)
        self.nfft = nfft
        self.norm = norm

    def forward(self, x, ext_param=None):
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

    def forward(self, x, ext_param=None):
        return torch.fft.rfft(x * self.env[None, :, None], n=self.nfft,
                              dim=1, norm=self.norm)


class iFFTAntiAlias(_AntiAliasTransform):
    """irfft followed by the gamma^{-n} rising envelope, which undoes the
    alias decay of the modules' responses."""

    def forward(self, x, ext_param=None):
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

    def response_at(self, bins, ext_param=None):
        """Frequency response at rfft bins ``bins`` only."""
        return self.response(ext_param)[torch.as_tensor(
            bins, device=self.param.device)]

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

    def _raw(self, ext_param):
        return self.param if ext_param is None else ext_param

    def _z_weights(self, z, P: int) -> torch.Tensor:
        """gamma^k z^-k for k < P, (P,) complex: the alias-scaled tap
        weights of a probe at z."""
        k = torch.arange(P, dtype=self.dtype, device=self.param.device)
        return ((self.gamma ** k).to(self.cdtype)
                * _as_z(z, self.cdtype, self.param.device) ** (-k))

    def probe(self, z):
        raise NotImplementedError(
            f"probe() not implemented for {type(self).__name__}")

    def probe_w(self, w):
        """The probe at z = 1/w."""
        return self.probe(1 / w)


class _Diagonal:
    """Mixin of the parallel (diagonal) modules: N channels in and out, a
    DIAG per-bin map, an elementwise forward and a diagonal probe."""

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def matrix_response(self, ext_param=None):
        return linop.DIAG, self.response(ext_param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("fn,bfn...->bfn...", self.response(ext_param), x)

    def probe(self, z):
        return torch.diag(super().probe(z))


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

    def response(self, ext_param=None):
        return to_complex(self.map(self._raw(ext_param)))

    def response_at(self, bins, ext_param=None):
        return self.response(ext_param)

    def matrix_response(self, ext_param=None):
        return linop.FLAT, self.response(ext_param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("mn,bfn...->bfm...", self.response(ext_param), x)

    def probe(self, z):
        return to_complex(self.map(self.param))


class parallelGain(Gain):
    """Per-channel (diagonal) gain, param (N,)."""

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "gains must be 1D, for 2D gains use Gain module.")

    def get_io(self):
        self.input_channels = self.size[-1]
        self.output_channels = self.size[-1]

    def matrix_response(self, ext_param=None):
        return linop.DIAG, self.response(ext_param)[None, :]

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("n,bfn...->bfn...", self.response(ext_param), x)

    def probe(self, z):
        return torch.diag(to_complex(self.map(self.param)))


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

    def _matrix(self, raw):
        u = self.map(raw)
        eye = torch.eye(self.size[0], dtype=u.dtype, device=u.device)
        return eye - 2 * (u @ u.T)

    def matrix_response(self, ext_param=None):
        return linop.FLAT, self._matrix(self._raw(ext_param))

    def probe(self, z):
        return self._matrix(self.param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        u = self.map(self._raw(ext_param))  # (N, 1) complex
        uTx = _contract("mn,bfn...->bfm...", u.T, x)
        uuTx = _contract("nm,bfm...->bfn...", u, uTx)
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

    def response(self, ext_param=None):
        m = self.get_delays(self._raw(ext_param))  # (N_out, N_in)
        phase = self.omega()[:, None, None] * m[None]
        return self._gain_of(m)[None] * torch.exp(-1j * phase)

    def response_at(self, bins, ext_param=None):
        """Closed-form ``gamma^m e^{-j w m}`` at just ``bins``, for Delay's
        (N_out, N_in) and parallelDelay's (N,) delays alike.  The phase
        ``b m`` is reduced mod nfft with the integer part of m in exact
        integer arithmetic; the fractional part (nonzero only for
        trainable non-integer delays) is added in float32 and is the only
        path of the delay gradient (d phase / d m = 2 pi b / nfft, exact,
        since floor is piecewise constant)."""
        m = self.get_delays(self._raw(ext_param))
        b = torch.as_tensor(bins, device=m.device).to(torch.int64)
        mi = torch.floor(m).detach()
        frac = m - mi
        bb = b.reshape((-1,) + (1,) * m.ndim)
        idx = _bins_prod_mod(bb, mi, self.nfft)
        ph = (2 * torch.pi / self.nfft) * (
            idx.to(self.dtype) + bb.to(self.dtype) * frac)
        return self._gain_of(m)[None] * torch.exp(-1j * ph)

    def matrix_response(self, ext_param=None):
        return linop.FULL, self.response(ext_param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("fmn,bfn...->bfm...", self.response(ext_param), x)

    def probe(self, z):
        m = self.get_delays(self.param)
        zinv = 1.0 / _as_z(z, self.cdtype, m.device)
        return self._gain_of(m).to(self.cdtype) * zinv ** m


class parallelDelay(_Diagonal, Delay):
    """Diagonal delays (N,): the FDN delay-line module."""

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "delays must be 1D, for 2D delays use Delay module.")

    def response(self, ext_param=None):
        # omega * m in float32, in the JAX package's order: the phase
        # reaches ~6.4e3 rad at m = 2053, nfft = 96000
        m = self.get_delays(self._raw(ext_param))  # (N,)
        phase = self.omega()[:, None] * m[None, :]
        return self._gain_of(m)[None] * torch.exp(-1j * phase)


class GainDelay(DSP):
    """Fused MIMO gain and delay, param (2, N_out, N_in): the gains
    (``map_gain``) and the delays in seconds x ``unit`` (``map_delay``,
    softplus for a trainable one), rounded to whole samples with
    ``isint``; the response g gamma^m e^{-j omega m}."""

    def __init__(self, size=(1, 1), max_len=2000, isint=False, unit=100,
                 nfft=2**11, fs=48000, map_gain=None, map_delay=None,
                 requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        self.fs = fs
        self.max_len = int(max_len)
        self.unit = unit
        self.isint = bool(isint)
        self.map_gain = map_gain if map_gain is not None else _identity
        if map_delay is not None:
            self.map_delay = map_delay
        else:
            self.map_delay = _softplus if requires_grad else _identity
        super().__init__(size=(2, *size), nfft=nfft,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def init_param(self, generator):
        shape = self.size[1:]
        if self.isint:
            d = torch.randint(1, self.max_len, shape,
                              generator=generator).to(self.dtype)
        else:
            d = torch.rand(shape, generator=generator,
                           dtype=self.dtype) * self.max_len
        self.order = int(self.max_len) + 1
        return torch.stack([torch.ones(shape, dtype=self.dtype),
                            self.sample2s(d)])

    def check_param_shape(self):
        _check(len(self.size) == 3 and self.size[0] == 2,
               "GainDelay parameters must have shape (2, N_out, N_in).")

    s2sample = Delay.s2sample
    sample2s = Delay.sample2s
    _gain_of = Delay._gain_of

    def _gain_delay(self, param):
        gain = to_complex(self.map_gain(param[0]))
        d = self.s2sample(self.map_delay(param[1]))
        return gain, (torch.round(d) if self.isint else d)

    def response(self, ext_param=None):
        gain, d = self._gain_delay(self._raw(ext_param))
        phase = self.omega().reshape((-1,) + (1,) * d.ndim) * d[None]
        return gain[None] * self._gain_of(d)[None] * torch.exp(-1j * phase)

    def matrix_response(self, ext_param=None):
        return linop.FULL, self.response(ext_param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("fmn,bfn...->bfm...", self.response(ext_param), x)

    def probe(self, z):
        gain, d = self._gain_delay(self.param)
        zinv = 1.0 / _as_z(z, self.cdtype, d.device)
        return gain * self._gain_of(d).to(self.cdtype) * zinv ** d


class parallelGainDelay(_Diagonal, GainDelay):
    """Diagonal gain and delay, param (2, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 2 and self.size[0] == 2,
               "parallelGainDelay parameters must have shape (2, N), for "
               "MIMO use GainDelay module.")


# ============================= FILTERS ================================


class Filter(DSP):
    """General FIR MIMO filter, param (taps, N_out, N_in): response =
    rfft(map(param) * gamma^t)."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 3D, for 2D (parallel) filters use "
               "ParallelFilter module.")

    def ir(self, param):
        return self.map(param)

    def response(self, ext_param=None):
        """(M, N_out, N_in) complex frequency response."""
        ir = self.ir(self._raw(ext_param))
        t = torch.arange(ir.shape[0], dtype=self.dtype, device=ir.device)
        env = torch.tensor(self.gamma, dtype=self.dtype,
                           device=ir.device) ** t
        env = env.reshape((-1,) + (1,) * (ir.ndim - 1))
        return torch.fft.rfft(ir * env, n=self.nfft, dim=0)

    def response_at(self, bins, ext_param=None):
        """``response()[bins]`` without the full-nfft rfft: the (L, ...) ir
        times the alias envelope, contracted against an exact-phase DFT
        basis at just those bins, two float32 (P, L) x (L, prod(size))
        matmuls (the caller keeps TF32 off on the card).  The phase
        indices are integers mod nfft (:func:`_bins_prod_mod`).  A
        subclass that redefines :meth:`response` (GEQ) takes the base
        gather instead, since the FIR contraction would not be its
        response."""
        if type(self).response is not Filter.response:
            return DSP.response_at(self, bins, ext_param)
        b = torch.as_tensor(bins, device=self.param.device).to(torch.int64)
        ir = self.ir(self._raw(ext_param))
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

    def matrix_response(self, ext_param=None):
        return linop.FULL, self.response(ext_param)

    def forward(self, x, ext_param=None):
        self.check_input_shape(x)
        return _contract("fmn,bfn...->bfm...", self.response(ext_param), x)

    def probe(self, z):
        """sum_k ir[k] gamma^k z^-k (a ScatteringMatrix's ir is its
        interleaved delays and matrices)."""
        coeff = self.ir(self.param)
        w = self._z_weights(z, coeff.shape[0])
        return torch.sum(to_complex(coeff)
                         * w.reshape((-1,) + (1,) * (coeff.ndim - 1)), dim=0)


class parallelFilter(_Diagonal, Filter):
    """Diagonal FIR filter, param (taps, N): one FIR per channel (the
    active-acoustics rig's WGN reverb tail)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "Filter must be 1D, for 2D filters use Filter module.")


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


class VelvetNoiseMatrix(ScatteringMatrix):
    """Non-learnable velvet-noise feedback matrix: Hadamard stages (the
    param, broadcast over the K+1 stages, identity map) interleaved with
    sparse scattering shifts of sparsity floor(1 / density)."""

    def __init__(self, size=(1, 1, 1), nfft=2**11, density=0.03,
                 gain_per_sample=0.9999, m_L=None, m_R=None,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None):
        _check(size[1] == size[2], "Matrix must be square")
        _check((size[1] & (size[1] - 1)) == 0,
               "At the moment the Matrix must have dimensions which are "
               "powers of 2")
        super().__init__(size=size, nfft=nfft,
                         sparsity=math.floor(1 / density),
                         gain_per_sample=gain_per_sample, pulse_size=1,
                         m_L=m_L, m_R=m_R, requires_grad=False,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)
        self.map = _identity
        H = hadamard_matrix_jnp(size[-1], dtype=dtype,
                                device=self.param.device)
        with torch.no_grad():
            self.param.copy_(H[None].expand(size))


# -------------------- parametric IIR families ------------------------------


def _iir_eps_guard(B, A):
    """Guarded product-of-sections ratio from materialized (M, K, ...)
    per-section responses."""
    return _iir_guard_prods(torch.prod(B, dim=1), torch.prod(A, dim=1))


def _guarded_cascade(be, ae, nfft: int, backend: str = "xla"):
    """Guarded cascade response from envelope-applied (P, K, ...) taps.

    backend='xla': the Horner-product chain of ``cascade_prods_scaled``
    (the products kept in range by powers of two) in PyTorch;
    backend='pallas': the hand-written cascade kernel K4
    (:func:`flamo_tpu_torch.ops.sos_kernels.sos_cascade`; the names are
    the JAX package's).  Trailing channel dims fold into the kernel's
    channel axis."""
    if backend == "pallas":
        P, K = be.shape[:2]
        chans = be.shape[2:]
        H = sos_cascade(be.reshape(P, K, -1), ae.reshape(P, K, -1), nfft)
        return H.reshape((H.shape[0],) + tuple(chans))
    return _iir_guard_prods(*cascade_prods_scaled(be, ae, nfft))


def _check_cascade_backend(backend: str):
    if backend not in ("xla", "pallas"):
        raise ValueError(
            f"cascade_backend must be 'xla' or 'pallas', got {backend!r}")


class _CascadeFilter(Filter):
    """A Filter whose response is a guarded cascade of second-order
    sections designed from its mapped parameters: ``_design(mapped)``
    gives the (3, K, ...) tap-major (b, a), the alias envelope
    gamma^[0, 1, 2] is folded into them, and the cascade is evaluated by
    ``cascade_backend``: 'xla', the Horner-product chain in PyTorch, or
    'pallas', the hand-written kernel K4 (the names are the JAX
    package's).  A family without the constructor argument takes the
    attribute, set on the module."""

    cascade_backend = "xla"

    def _design(self, mapped):
        raise NotImplementedError

    def sos_taps(self, mapped):
        """The design's (b, a) with the alias envelope folded in: the taps
        the cascade is evaluated from."""
        b, a = self._design(mapped)
        env = self.gamma ** torch.arange(3, dtype=self.dtype,
                                         device=b.device)
        env = env.reshape((3,) + (1,) * (b.ndim - 1))
        return b * env, a * env

    def get_poly_coeff(self, mapped=None):
        """(H, B, A): the guarded response and the (M, K, ...) per-section
        numerator and denominator responses, of ``mapped`` or else of the
        module's own mapped parameters.  :meth:`response` needs H alone and
        does not compute B and A."""
        if mapped is None:
            mapped = self.map(self.param)
        be, ae = self.sos_taps(mapped)
        return (_guarded_cascade(be, ae, self.nfft, self.cascade_backend),
                poly_response(be, self.nfft), poly_response(ae, self.nfft))

    def response(self, ext_param=None):
        be, ae = self.sos_taps(self.map(self._raw(ext_param)))
        return _guarded_cascade(be, ae, self.nfft, self.cascade_backend)

    def _probe_sections(self, z):
        """(B(z), A(z)), each (K, ...): the sections at z."""
        b, a = self._design(self.map(self.param))
        w = self._z_weights(z, 3).reshape((3,) + (1,) * (b.ndim - 1))
        return (torch.sum(to_complex(b) * w, dim=0),
                torch.sum(to_complex(a) * w, dim=0))

    def probe(self, z):
        Bz, Az = self._probe_sections(z)
        return torch.prod(Bz / Az, dim=0)


class GEQ(_CascadeFilter):
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


class parallelGEQ(_Diagonal, GEQ):
    """Diagonal GEQ, param (K, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "Filter must be 2D, for 3D filters use GEQ module.")


class Biquad(_CascadeFilter):
    """Cascaded RBJ biquads (lowpass, highpass or bandpass), raw param
    (K, P, N_out, N_in) with P = 2 (fc, g) or 3 (fc1, fc2, g): the map
    clips fc (omega / pi) to [0, 1] and the gain 20 log10|g| to +-60 dB.
    ``cascade_backend='pallas'`` evaluates the cascade with kernel K4."""

    def __init__(self, size=(1, 1), n_sections=1, filter_type="lowpass",
                 nfft=2**11, fs=48000, requires_grad=False,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None, cascade_backend: str = "xla"):
        _check(filter_type in ("lowpass", "highpass", "bandpass"),
               "Invalid filter type")
        _check_cascade_backend(cascade_backend)
        self.cascade_backend = cascade_backend
        self.n_sections = n_sections
        self.filter_type = filter_type
        self.fs = fs
        P = 3 if filter_type == "bandpass" else 2
        super().__init__(size=(n_sections, P, *size), nfft=nfft,
                         map=self._map_clamp, requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def check_param_shape(self):
        _check(len(self.size) == 4,
               "Parameter size must be 4D, for 3D (parallel) biquads use "
               "parallelBiquad module.")

    def init_param(self, generator):
        """fc ~ U(0, 0.5), a bandpass's fc2 ~ U(max fc, 1), g ~ U(-1, 1)."""
        p = torch.zeros(self.size, dtype=self.dtype)
        shape = p[:, 0].shape
        fc = torch.rand(shape, generator=generator, dtype=self.dtype) * 0.5
        p[:, 0] = fc
        if self.filter_type == "bandpass":
            lo = float(fc.max())
            p[:, 1] = (torch.rand(shape, generator=generator,
                                  dtype=self.dtype) * (1.0 - lo) + lo)
        p[:, -1] = torch.rand(shape, generator=generator,
                              dtype=self.dtype) * 2.0 - 1.0
        return p

    def _map_clamp(self, x):
        """Stability map; ``_clip`` keeps the JAX package's gradient of 1/2
        at a bound."""
        gain = _clip(20 * torch.log10(torch.abs(x[:, -1])), -60.0, 60.0)
        if self.filter_type == "bandpass":
            eps = torch.finfo(self.dtype).eps
            return torch.stack([_clip(x[:, 0], eps, 1 - eps),
                                _clip(x[:, 1], eps, 1 - eps), gain], dim=1)
        return torch.stack([_clip(x[:, 0], 0.0, 1.0), gain], dim=1)

    def _design(self, mapped):
        def hz(i):
            return rad2hertz(mapped[:, i] * torch.pi, self.fs)

        if self.filter_type == "bandpass":
            return bandpass_filter(fc1=hz(0), fc2=hz(1), gain=mapped[:, 2],
                                   fs=self.fs, dtype=self.dtype)
        design = (lowpass_filter if self.filter_type == "lowpass"
                  else highpass_filter)
        return design(fc=hz(0), gain=mapped[:, 1], fs=self.fs,
                      dtype=self.dtype)

    def probe(self, z):
        Bz, Az = self._probe_sections(z)
        return torch.prod(Bz, dim=0) / torch.prod(Az, dim=0)


class parallelBiquad(_Diagonal, Biquad):
    """Diagonal biquad cascade, param (K, P, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Parameter size must be 3D, for 3D space use Biquad module.")


class SOSFilter(_CascadeFilter):
    """Direct second-order sections, param (K, 6, N_out, N_in) rows
    [b0, b1, b2, a0, a1, a2]; not trainable, identity at initialization.
    With ``normalize_a0`` the map divides each section by its a0 (guarded
    at machine epsilon)."""

    def __init__(self, size=(1, 1), n_sections=1, nfft=2**11, fs=48000,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 normalize_a0=True, generator=None, device=None):
        self.n_sections = n_sections
        self.fs = fs
        self.normalize_a0 = bool(normalize_a0)
        super().__init__(size=(n_sections, 6, *size), nfft=nfft,
                         map=self._map_a0, requires_grad=False,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def check_param_shape(self):
        _check(len(self.size) == 4,
               "Parameter size must be 4D, expected (K, 6, N_out, N_in).")
        _check(self.size[1] == 6,
               "Second dimension must be 6: [b0,b1,b2,a0,a1,a2].")

    def init_param(self, generator):
        p = torch.zeros(self.size, dtype=self.dtype)
        p[:, 0] = 1.0
        p[:, 3] = 1.0
        return p

    def _map_a0(self, x):
        if not self.normalize_a0:
            return x
        a0 = x[:, 3]
        eps = torch.finfo(x.dtype).eps
        a0_safe = torch.where(torch.abs(a0) > eps, a0,
                              torch.full_like(a0, eps))
        y = x / a0_safe[:, None]
        return torch.cat([y[:, :3], torch.ones_like(y[:, 3:4]), y[:, 4:]],
                         dim=1)

    def _design(self, mapped):
        """The taps moved from (K, 3, ...) to (3, K, ...)."""
        return (torch.movedim(mapped[:, 0:3], 1, 0),
                torch.movedim(mapped[:, 3:6], 1, 0))


class parallelSOSFilter(_Diagonal, SOSFilter):
    """Diagonal SOS, param (K, 6, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Parameter size must be 3D, expected (K, 6, N).")
        _check(self.size[1] == 6,
               "Second dimension must be 6: [b0,b1,b2,a0,a1,a2].")


class SVF(_CascadeFilter):
    """Serially cascaded state-variable filters, raw param (5, K, N_out,
    N_in), stable by construction: f = tan(pi sigmoid(x) / 2), R =
    softplus(x) / ln 2, and the mixing coefficients of ``filter_type``
    with G = 10^-softplus(x), or with ``filter_type=None`` the raw ones
    plus the bias [1, 2, 1].  The map returns the 5-tuple (f, R, mLP,
    mBP, mHP)."""

    _FILTER_TYPES = ("lowpass", "highpass", "bandpass", "lowshelf",
                     "highshelf", "peaking", "notch", None)

    def __init__(self, size=(1, 1), n_sections=1, filter_type=None,
                 nfft=2**11, fs=48000, requires_grad=False,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None):
        _check(filter_type in self._FILTER_TYPES, "Invalid filter type")
        self.fs = fs
        self.n_sections = n_sections
        self.filter_type = filter_type
        super().__init__(size=(5, n_sections, *size), nfft=nfft,
                         map=self.map_param2svf, requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)

    def check_param_shape(self):
        _check(len(self.size) == 4,
               "Filter parameter space must be 4D, for 3D (parallel) filters "
               "use parallelSVF module.")

    def param2freq(self, p):
        return torch.tan(torch.pi * torch.sigmoid(p) * 0.5)

    def param2R(self, p):
        return _softplus(p) / torch.log(torch.tensor(2.0, dtype=self.dtype))

    def param2mix(self, p, R=None):
        if self.filter_type is None:
            bias = torch.ones_like(p)
            bias[1] = 2.0
            return p + bias
        return torch.stack(svf_mix(self.filter_type, R,
                                   10 ** (-_softplus(p[0]))))

    def map_param2svf(self, param):
        """Raw params -> (f, R, mLP, mBP, mHP); a peaking filter's R is
        1 / r and its mixing takes r."""
        f = self.param2freq(param[0])
        r = self.param2R(param[1])
        R = 1 / r if self.filter_type == "peaking" else r
        m = self.param2mix(param[2:], r)
        return f, R, m[0], m[1], m[2]

    def _design(self, mapped):
        return svf_taps(*mapped)


class parallelSVF(_Diagonal, SVF):
    """Diagonal SVF, param (5, K, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter parameter space must be 3D, for 4D filters use SVF "
               "module.")


class PEQ(_CascadeFilter):
    """Parametric EQ, a low shelf, peaks and a high shelf: raw (n_bands,
    3, N_out, N_in) as (f, R, G), the band frequencies a sigmoid about a
    log-spaced bias; designs 'biquad' (RBJ, G = 10^(G/40)) or 'svf'.
    ``cascade_backend='pallas'`` evaluates the cascade with kernel K4."""

    def __init__(self, size=(1, 1), n_bands=10, f_min=20.0, f_max=20000.0,
                 design="biquad", fs=48000, nfft=2**11, map=_identity,
                 requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None, cascade_backend: str = "xla"):
        _check(design in ("biquad", "svf"), "design must be biquad or svf")
        _check_cascade_backend(cascade_backend)
        self.cascade_backend = cascade_backend
        self.n_bands = n_bands
        self.design = design
        self.fs = fs
        self.f_min = float(f_min)
        self.f_max = float(f_max)
        # the bias frequencies in float64 on the host
        k = np.arange(1, n_bands + 1, dtype=np.float64)
        self.center_freq_bias = tuple(
            float(v) for v in f_min * (f_max / f_min)
            ** ((k - 1) / (n_bands - 1)))
        super().__init__(size=(n_bands, 3, *size), nfft=nfft, map=map,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)
        self.register_buffer("center_freq_bias_t", torch.tensor(
            self.center_freq_bias, dtype=dtype, device=self.param.device),
            persistent=False)

    def init_param(self, generator):
        return torch.rand(self.size, generator=generator, dtype=self.dtype)

    def check_param_shape(self):
        _check(len(self.size) == 4,
               "Filter must be 3D, for 2D (parallel) filters use ParallelPEQ "
               "module.")

    def map_eq(self, param):
        """(f, R, G) stacked, (3, n_bands, ...): the frequency a sigmoid
        about the band's bias, clipped to [f_min, f_max] (biquad) or
        warped by tan (svf)."""
        R = param[:, 1]
        G = param[:, 2]
        bias = self.center_freq_bias_t
        extra = (1,) * (param.ndim - 2)
        if self.design == "biquad":
            bias_w = bias.reshape((-1,) + extra) / self.fs * 2 * torch.pi
            min_f = 2 * math.pi * self.f_min / self.fs
            max_f = 2 * math.pi * self.f_max / self.fs
            f = _clip(torch.sigmoid(param[:, 0]) + bias_w, min_f, max_f)
        else:
            w = 2 * bias / self.fs
            bias_w = torch.log(w / (1 - w)).reshape((-1,) + extra)
            f = torch.tan(torch.pi * torch.sigmoid(param[:, 0] + bias_w)
                          * 0.5)
        return torch.stack([f, R, G])

    def compute_biquad_coeff(self, f, R, G, type="peaking"):
        """(a, b), each (..., 3): one band of the design."""
        if self.design == "svf":
            G = 10 ** (G / 20)
            kind = "peaking" if type == "peaking" else (
                "highshelf" if type == "lowshelf" else "lowshelf")
            # a PEQ's shelves weight the opposite SVF output by G
            b, a = svf_taps(f, R, *svf_mix(kind, R, G))
            return torch.movedim(a, 0, -1), torch.movedim(b, 0, -1)
        G = 10 ** (G / 40)
        cosf, sinf = torch.cos(f), torch.sin(f)
        if type == "peaking":
            alpha = sinf / (2 * R)
            b = torch.stack([1 + alpha * G, -2 * cosf, 1 - alpha * G], dim=-1)
            a = torch.stack([1 + alpha / G, -2 * cosf, 1 - alpha / G], dim=-1)
            return a, b
        alpha = sinf * torch.sqrt((G**2 + 1) * (1 / R - 1) + 2 * G)
        s = 1.0 if type == "lowshelf" else -1.0
        b = torch.stack([
            G * ((G + 1) - s * (G - 1) * cosf + alpha),
            s * 2 * G * ((G - 1) - s * (G + 1) * cosf),
            G * ((G + 1) - s * (G - 1) * cosf - alpha)], dim=-1)
        a = torch.stack([
            (G + 1) + s * (G - 1) * cosf + alpha,
            -s * 2 * ((G - 1) + s * (G + 1) * cosf),
            (G + 1) + s * (G - 1) * cosf - alpha], dim=-1)
        return a, b

    def _band_sos(self, mapped):
        """mapped (3, n_bands, ...) -> (a, b), each (n_bands, 3, ...):
        lowshelf, peaks, highshelf."""
        f, R, G = mapped[0], mapped[1], mapped[2]
        a_ls, b_ls = self.compute_biquad_coeff(f[0], R[0], G[0], "lowshelf")
        a_hs, b_hs = self.compute_biquad_coeff(f[-1], R[-1], G[-1],
                                               "highshelf")
        a_pk, b_pk = self.compute_biquad_coeff(f[1:-1], R[1:-1], G[1:-1],
                                               "peaking")
        a = torch.cat([a_ls[None], a_pk, a_hs[None]], dim=0)
        b = torch.cat([b_ls[None], b_pk, b_hs[None]], dim=0)
        return torch.movedim(a, -1, 1), torch.movedim(b, -1, 1)

    def _design(self, param):
        a, b = self._band_sos(self.map_eq(param))
        return torch.movedim(b, 1, 0), torch.movedim(a, 1, 0)


class parallelPEQ(_Diagonal, PEQ):
    """Diagonal PEQ, param (n_bands, 3, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 2D in the parallel configuration, for 3D "
               "filters use PEQ module.")


class AccurateGEQ(_CascadeFilter):
    """Non-learnable GEQ whose command gains come from the accurate design
    (:func:`~flamo_tpu_torch.auxiliary.eq.accurate_geq`, Schlecht & Habets
    DAFx-17) of its target gains ``map(param)`` in dB, param (K, N_out,
    N_in), K = n_bands + 2.

    The design runs on the host at construction and in
    :meth:`assign_value`, never in ``forward``: its (3, K + 1, ...) taps
    are the buffers ``sos_b``/``sos_a`` on the module's device (the JAX
    package's leaves), and a response is one cascade of them (K4 with
    ``cascade_backend='pallas'``)."""

    def __init__(self, size=(1, 1), octave_interval=1, nfft=2**11, fs=48000,
                 map=_abs_db_map, alias_decay_db=0.0, start_freq=31.25,
                 end_freq=16000.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None, cascade_backend: str = "xla"):
        _check_cascade_backend(cascade_backend)
        self.cascade_backend = cascade_backend
        self.octave_interval = octave_interval
        self.fs = fs
        self.start_freq = float(start_freq)
        self.end_freq = float(end_freq)
        center, shelving = eq_freqs(interval=octave_interval,
                                    start_freq=start_freq, end_freq=end_freq)
        self.center_freq = tuple(float(f) for f in center)
        self.shelving_crossover = tuple(float(f) for f in shelving)
        self.n_gains = len(self.center_freq) + 2
        super().__init__(size=(self.n_gains, *size), nfft=nfft, map=map,
                         requires_grad=False, alias_decay_db=alias_decay_db,
                         dtype=dtype, generator=generator, device=device)
        for name in ("sos_b", "sos_a"):
            self.register_buffer(name, torch.zeros(
                self._sos_shape(), dtype=dtype, device=self.param.device))
        self._design_cache()

    def _sos_shape(self) -> tuple:
        """The designed taps' shape: (3, K + 1, ...), a cascade of K + 1
        sections for each channel of the target gains."""
        return (3, self.n_gains + 1) + tuple(self.size[1:])

    def init_param(self, generator):
        lo, hi = 10 ** (-6 / 20), 10 ** (6 / 20)
        return (torch.rand(self.size, generator=generator, dtype=self.dtype)
                * (hi - lo) + lo)

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 3D, for 2D (parallel) filters use ParallelGEQ "
               "module.")

    def _design_cache(self):
        """The accurate design of every channel's dB targets, on the host,
        written into ``sos_b``/``sos_a`` in place."""
        with torch.no_grad():
            target = self.map(self.param).cpu().numpy()  # (K, ...)
        flat = target.reshape(target.shape[0], -1)
        bs, as_ = zip(*(accurate_geq(
            target_gain=flat[:, i], center_freq=self.center_freq,
            shelving_crossover=self.shelving_crossover, fs=self.fs,
            dtype=self.dtype) for i in range(flat.shape[1])))
        with torch.no_grad():
            for buf, taps in ((self.sos_b, bs), (self.sos_a, as_)):
                buf.copy_(torch.stack(taps, dim=-1).reshape(buf.shape))

    def assign_value(self, new_value, indx=None) -> "AccurateGEQ":
        """Write new target gains in place, design them, and return the
        module."""
        super().assign_value(new_value, indx)
        self._design_cache()
        return self

    def _design(self, mapped):
        """The cached design; the mapped parameters are not read."""
        return self.sos_b, self.sos_a


class parallelAccurateGEQ(_Diagonal, AccurateGEQ):
    """Diagonal accurate GEQ, param (K, N)."""

    def check_param_shape(self):
        _check(len(self.size) == 2,
               "Filter must be 2D, for 3D filters use GEQ module.")


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

    def matrix_response(self, ext_param=None):
        return self.kind, self.H

    def forward(self, x, ext_param=None):
        return linop.apply(self.kind, self.H, x)
