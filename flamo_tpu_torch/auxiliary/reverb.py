"""FDN reverb factories and delay-scaled attenuation filters (counterpart
of ``flamo_tpu/auxiliary/reverb.py``).

:class:`HomogeneousFDN` builds the canonical FDN, Shell(FFT ->
Series(input Gain, Recursion(Series(parallelDelay, parallelGain through
:class:`map_gamma`), orthogonal Matrix), output Gain) -> iFFTAntiAlias),
from a :class:`~flamo_tpu_torch.auxiliary.config.HomogeneousFDNConfig`;
``solve_method='pallas'`` solves its loop with kernel K2.  Its edits
(:meth:`~HomogeneousFDN.set_raw_parameters`,
:meth:`~HomogeneousFDN.normalize_energy`) write the modules' parameters in
place, where the JAX package rebuilds the model.

The attenuation filters map reverberation times (seconds) to a decay in
dB per pass of each delay line: the accurate GEQ (designed on the host,
not trainable; ``cascade_backend='pallas'`` evaluates it with K4f), the
trainable GEQ and PEQ (the plain cascade, as in the JAX package) and a
first-order shelf.

:func:`coprime_delay_lengths` draws primes from a numpy sieve of its own.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.eq import accurate_geq
from flamo_tpu_torch.functional import _clip, poly_response
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.processor.dsp import _check, _identity
from flamo_tpu_torch.utils import next_key


def rt2slope(rt60, fs: int):
    """RT60 seconds -> energy decay slope in dB a sample."""
    return -60 / (torch.as_tensor(rt60) * fs)


def rt2absorption(rt60, fs: int, delays_len):
    """RT60 -> dB of decay a pass of each delay line, (len(rt60), N)."""
    slope = torch.atleast_1d(rt2slope(rt60, fs))
    d = torch.as_tensor(delays_len).to(dtype=slope.dtype, device=slope.device)
    return torch.einsum("i,j->ij", slope, d)


def _delays_like(delays: tuple, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(delays, dtype=x.dtype, device=x.device)


def _delay_tuple(delays) -> tuple:
    return tuple(int(d) for d in np.asarray(delays).reshape(-1))


class map_gamma:
    """Homogeneous attenuation: gamma^d_i from the first raw value, gamma =
    sigmoid(x[0]) (g_max - g_min) + g_min in [0.99, 1] (compressed) or
    x[0] itself."""

    g_min, g_max = 0.99, 1.0

    def __init__(self, delays, is_compressed: bool = True):
        self.delays = _delay_tuple(delays)
        self.is_compressed = is_compressed

    def __call__(self, x):
        d = _delays_like(self.delays, x)
        if self.is_compressed:
            return (torch.sigmoid(x[0]) * (self.g_max - self.g_min)
                    + self.g_min) ** d
        return x[0] ** d


class inverse_map_gamma:
    """The inverse of :class:`map_gamma`: the raw value of gains y (per
    delay line when ``delays`` are given)."""

    g_min, g_max = 0.99, 1.0

    def __init__(self, delays=None, is_compressed: bool = True):
        self.delays = None if delays is None else _delay_tuple(delays)
        self.is_compressed = is_compressed

    def __call__(self, y):
        y = torch.as_tensor(y)
        if self.delays is not None:
            y = y ** (1 / _delays_like(self.delays, y))
        if self.is_compressed:
            sig = (y - self.g_min) / (self.g_max - self.g_min)
            return torch.log(sig / (1 - sig))
        return y


class _RTScaledMap:
    """RT60 seconds (K,) -> dB a pass of each delay line (K, N)."""

    def __init__(self, delays, fs: int):
        self.delays = _delay_tuple(delays)
        self.fs = fs

    def __call__(self, x):
        return rt2slope(x, self.fs)[..., None] * _delays_like(self.delays,
                                                              x)[None, :]


class map_gfdn_gamma(_RTScaledMap):
    """The grouped FDN's map: n_groups stacked RT60 vectors (G K,) -> dB a
    pass of each delay line (G K, N)."""

    def __init__(self, delays, n_groups: int, fs: int):
        super().__init__(delays, fs)
        self.n_groups = n_groups


def _primes_below(n: int) -> np.ndarray:
    """The primes p < n (a sieve of Eratosthenes)."""
    if n < 3:
        return np.zeros(0, dtype=np.int64)
    sieve = np.ones(n, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.flatnonzero(sieve)


def _next_prime(n: int) -> int:
    """The least prime greater than n."""
    m = max(int(n) + 1, 2)
    while True:
        if all(m % p for p in _primes_below(int(m ** 0.5) + 1)):
            return m
        m += 1


def coprime_delay_lengths(N: int, delay_range_ms, sample_rate: int,
                          rng: Optional[np.random.Generator] = None):
    """N coprime (prime) delay-line lengths for a range in ms: N - 1 of
    the primes in [lo, hi) samples in ``rng``'s random order, then the
    least prime above hi (a list of ints).  The same ``rng`` state gives
    the JAX package's list."""
    rng = rng or np.random.default_rng()
    lo, hi = (np.round(np.asarray(delay_range_ms) * sample_rate / 1000)
              .astype(int))
    primes = _primes_below(int(hi))
    primes = primes[primes >= lo].astype(np.int32)
    rand_primes = primes[rng.permutation(len(primes))]
    return np.r_[rand_primes[:N - 1],
                 _next_prime(int(hi))].astype(np.int32).tolist()


class HomogeneousFDN:
    """Feedback delay network with homogeneous attenuation, built from a
    :class:`~flamo_tpu_torch.auxiliary.config.HomogeneousFDNConfig` on its
    device: ``model`` is Shell(FFT -> Series(input_gain,
    Recursion(Series(delays, attenuation), orthogonal mixing matrix),
    output_gain) -> iFFTAntiAlias).  Its weights are drawn from
    ``generator`` (default the global stream)."""

    def __init__(self, config_dict, generator=None):
        self.config_dict = config_dict
        self.N = config_dict.N
        self.delays = config_dict.delays
        self.generator = next_key(generator)
        self.fdn = self.get_fdn_instance()
        self.set_model()

    def set_model(self, input_layer=None, output_layer=None):
        cfg = self.config_dict
        if input_layer is None:
            input_layer = dsp.FFT(cfg.nfft, dtype=cfg.dtype)
        if output_layer is None:
            output_layer = dsp.iFFTAntiAlias(
                nfft=cfg.nfft, alias_decay_db=cfg.alias_decay_db,
                dtype=cfg.dtype, device=cfg.device)
        self.model = self.get_shell(input_layer, output_layer)

    def get_fdn_instance(self):
        cfg = self.config_dict
        common = dict(nfft=cfg.nfft, alias_decay_db=cfg.alias_decay_db,
                      dtype=cfg.dtype, generator=self.generator,
                      device=cfg.device)
        input_gain = dsp.Gain(size=(self.N, 1),
                              requires_grad=cfg.input_gain_grad, **common)
        output_gain = dsp.Gain(size=(1, self.N),
                               requires_grad=cfg.output_gain_grad, **common)
        delays = dsp.parallelDelay(
            size=(self.N,), max_len=int(max(self.delays)),
            isint=cfg.is_delay_int, requires_grad=cfg.delays_grad, **common)
        delays.assign_value(delays.sample2s(
            torch.tensor(self.delays, dtype=cfg.dtype)))
        mixing_matrix = dsp.Matrix(
            size=(self.N, self.N), matrix_type="orthogonal",
            requires_grad=cfg.mixing_matrix_grad, **common)
        attenuation = dsp.parallelGain(
            size=(self.N,), map=map_gamma(self.delays),
            requires_grad=cfg.attenuation_grad, **common)
        attenuation.assign_value(6 * torch.ones((self.N,), dtype=cfg.dtype))
        feedforward = system.Series(
            OrderedDict({"delays": delays, "attenuation": attenuation}))
        feedback_loop = system.Recursion(fF=feedforward, fB=mixing_matrix,
                                         solve_method=cfg.solve_method)
        return system.Series(OrderedDict({
            "input_gain": input_gain,
            "feedback_loop": feedback_loop,
            "output_gain": output_gain,
        }))

    def get_shell(self, input_layer, output_layer):
        return system.Shell(core=self.fdn, input_layer=input_layer,
                            output_layer=output_layer)

    def get_delay_lines(self):
        """Coprime delay lengths for the configured range (unseeded)."""
        return coprime_delay_lengths(self.N, self.config_dict.delay_range_ms,
                                     self.config_dict.sample_rate)

    def _modules(self) -> dict:
        core = self.model.get_core()
        loop = core.feedback_loop
        return {"A": loop.feedback,
                "attenuation": loop.feedforward.attenuation,
                "B": core.input_gain, "C": core.output_gain,
                "m": loop.feedforward.delays}

    def get_raw_parameters(self) -> dict:
        """The raw parameters as numpy arrays: A (mixing), attenuation, B
        (input gains), C (output gains), m (delays)."""
        return {k: m.param.detach().cpu().numpy()
                for k, m in self._modules().items()}

    def set_raw_parameters(self, param: dict):
        """Write raw parameters from a dict of :meth:`get_raw_parameters`'s
        keys, in place (the attenuation and delays squeezed)."""
        modules = self._modules()
        for key, value in param.items():
            v = torch.as_tensor(value)
            modules[key].assign_value(v.squeeze() if key in
                                      ("attenuation", "m") else v)

    def normalize_energy(self, target_energy=1):
        """Scale the input and output gains in place so that the mean
        energy of the frequency response is ``target_energy``; raises when
        it misses by more than 1e-4 relative."""
        core = self.model.get_core()
        H = self.model.get_freq_response(identity=False)
        energy_H = torch.mean(torch.abs(H) ** 2)
        scale = (energy_H / target_energy) ** (1 / 4)
        for gain in (core.input_gain, core.output_gain):
            gain.assign_value(gain.param.detach() / scale)
        H = self.model.get_freq_response(identity=False)
        energy_H = float(torch.mean(torch.abs(H) ** 2))
        _check(abs(energy_H - target_energy) / target_energy < 1e-4,
               "Energy normalization failed")

    def rt2gain(self, rt60):
        gdB = rt2absorption(rt60, self.config_dict.sample_rate,
                            self.delays).squeeze()
        return 10 ** (gdB / 20)


# ---------------------------------------------------------------------------
# delay-scaled attenuation filters
# ---------------------------------------------------------------------------
class _DelayChannels:
    """Mixin: one channel a delay line, the parameter a 1-D vector."""

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "The parameter should contain only the command gains")

    def get_io(self):
        self.input_channels = len(self.delays)
        self.output_channels = len(self.delays)


class parallelFDNAccurateGEQ(_DelayChannels, dsp.parallelAccurateGEQ):
    """The accurate GEQ as a delay-scaled attenuation: param the (K,)
    RT60s in seconds of its bands, mapped to dB a pass of each delay
    line; the (3, K + 1, N) taps are designed on the host at construction
    and in ``assign_value``.  Not trainable; ``cascade_backend='pallas'``
    evaluates the cascade with K4f."""

    def __init__(self, octave_interval=1, nfft=2**11, fs=48000, delays=None,
                 alias_decay_db=0.0, start_freq=31.25, end_freq=16000.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None, cascade_backend: str = "xla"):
        _check(delays is not None, "Delays must be provided")
        self.delays = _delay_tuple(delays)
        super().__init__(size=(), octave_interval=octave_interval, nfft=nfft,
                         fs=fs, map=self._rt_map(fs),
                         alias_decay_db=alias_decay_db,
                         start_freq=start_freq, end_freq=end_freq,
                         dtype=dtype, generator=generator, device=device,
                         cascade_backend=cascade_backend)

    def _rt_map(self, fs):
        return _RTScaledMap(self.delays, fs)

    def init_param(self, generator):
        # U(db2mag(-6), db2mag(6)) seconds, as the JAX package
        lo, hi = 10 ** (-6 / 20), 10 ** (6 / 20)
        return (torch.rand(self.size, generator=generator, dtype=self.dtype)
                * (hi - lo) + lo)

    def _sos_shape(self) -> tuple:
        return (3, self.n_gains + 1, len(self.delays))


class parallelGFDNAccurateGEQ(parallelFDNAccurateGEQ):
    """The grouped (multi-slope) accurate GEQ: param n_groups stacked
    (K,) RT60 vectors; each delay line's cascade is the n_groups designs
    one after another, (3, n_groups (K + 1), N)."""

    def __init__(self, octave_interval=1, n_groups=2, nfft=2**11, fs=48000,
                 delays=None, alias_decay_db=0.0, start_freq=31.25,
                 end_freq=16000.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None, cascade_backend: str = "xla"):
        self.n_groups = n_groups
        super().__init__(octave_interval=octave_interval, nfft=nfft, fs=fs,
                         delays=delays, alias_decay_db=alias_decay_db,
                         start_freq=start_freq, end_freq=end_freq,
                         dtype=dtype, generator=generator, device=device,
                         cascade_backend=cascade_backend)

    def _rt_map(self, fs):
        return map_gfdn_gamma(self.delays, self.n_groups, fs)

    def init_param(self, generator):
        self.size = (self.n_groups * self.n_gains,)
        return super().init_param(generator)

    def _sos_shape(self) -> tuple:
        return (3, self.n_groups * (self.n_gains + 1), len(self.delays))

    def _design_cache(self):
        """Each group's accurate design of each delay line's dB targets,
        the groups' sections concatenated, written into ``sos_b``/``sos_a``
        in place."""
        with torch.no_grad():
            target = self.map(self.param).cpu().numpy()  # (G K, N)
        K = self.n_gains
        designs = [[accurate_geq(
            target_gain=target[g * K:(g + 1) * K, i],
            center_freq=self.center_freq,
            shelving_crossover=self.shelving_crossover, fs=self.fs,
            dtype=self.dtype) for g in range(self.n_groups)]
            for i in range(target.shape[1])]
        with torch.no_grad():
            for j, buf in enumerate((self.sos_b, self.sos_a)):
                buf.copy_(torch.stack([
                    torch.cat([d[j] for d in per_line], dim=1)
                    for per_line in designs], dim=-1))


class parallelFDNGEQ(_DelayChannels, dsp.parallelGEQ):
    """A trainable GEQ as a delay-scaled attenuation: param the (K,)
    RT60s in seconds of its command gains, each delay line's GEQ designed
    from rt2slope(param) d_i dB; the plain cascade (no K4 route, as in
    the JAX package)."""

    def __init__(self, octave_interval=1, nfft=2**11, fs=48000, delays=None,
                 requires_grad=False, alias_decay_db=0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        _check(delays is not None, "Delays must be provided")
        self.delays = _delay_tuple(delays)
        super().__init__(size=(), octave_interval=octave_interval, nfft=nfft,
                         fs=fs, map=_identity, requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)
        self.register_buffer("delays_t", torch.tensor(
            self.delays, dtype=dtype, device=self.param.device),
            persistent=False)

    def init_param(self, generator):
        return (torch.rand(self.size, generator=generator, dtype=self.dtype)
                * 2.0 + 1.0)

    def _design(self, rt):
        """(K,) RT60s -> the delay lines' GEQs, each (3, bands, N)."""
        gains = rt2slope(rt, self.fs)[:, None] * self.delays_t[None, :]
        return super()._design(gains)


class parallelFDNPEQ(dsp._Diagonal, dsp._CascadeFilter):
    """A trainable PEQ as a delay-scaled attenuation, raw param (n_bands
    (+ 1 with ``is_twostage``), 3, N or 1 with ``is_proportional``) as
    (f, R, G) through the JAX package's sigmoid maps, designs 'biquad' or
    'svf'; band 0 a high shelf, band n_bands - 1 a low shelf (the
    reference's order), peaks between, and with ``is_twostage`` a global
    high shelf after them.  ``is_proportional`` scales one filter's gains
    by each delay length.  The plain cascade (no K4 route, as in the JAX
    package)."""

    def __init__(self, n_bands=10, f_min=20.0, f_max=20000.0, delays=None,
                 design="biquad", is_twostage=False, is_proportional=False,
                 nfft=2**11, fs=48000, map=_identity, requires_grad=False,
                 alias_decay_db=0.0, dtype: torch.dtype = torch.float32,
                 generator=None, device=None):
        _check(delays is not None, "Delays must be provided")
        _check(design in ("biquad", "svf"), "design must be biquad or svf")
        self.delays = _delay_tuple(delays)
        self.is_twostage = bool(is_twostage)
        self.is_proportional = bool(is_proportional)
        self.n_bands = n_bands
        self.design = design
        self.fs = fs
        self.f_min = float(f_min)
        self.f_max = float(f_max)
        k = np.arange(1, n_bands + 1, dtype=np.float64)
        self.center_freq_bias = tuple(
            float(v) for v in f_min * (f_max / f_min)
            ** ((k - 1) / (n_bands - 1)))
        n_rows = n_bands + 1 if is_twostage else n_bands
        n_cols = 1 if is_proportional else len(self.delays)
        super().__init__(size=(n_rows, 3, n_cols), nfft=nfft, map=map,
                         requires_grad=requires_grad,
                         alias_decay_db=alias_decay_db, dtype=dtype,
                         generator=generator, device=device)
        for name, vals in (("center_freq_bias_t", self.center_freq_bias),
                           ("delays_t", self.delays)):
            self.register_buffer(name, torch.tensor(
                vals, dtype=dtype, device=self.param.device),
                persistent=False)

    def init_param(self, generator):
        return torch.rand(self.size, generator=generator, dtype=self.dtype)

    def check_param_shape(self):
        _check(len(self.size) == 3,
               "Filter must be 2D in the parallel configuration, for 3D "
               "filters use PEQ module.")

    get_io = _DelayChannels.get_io

    def map_eq(self, param, is_twostage: bool = False):
        """(f, R, G) stacked, (3, ...): the design's band maps (a band's
        R does not read its raw value in the 'biquad' design, as in the
        reference), or the two-stage shelf's."""
        if is_twostage:
            f = torch.sigmoid(param[0]) / self.n_bands + torch.pi / 3
            R = 0.1 + torch.sigmoid(torch.zeros_like(param[1])) * 0.9
            G = -1e-6 + torch.sigmoid(param[2] - 0.5) * (-30.0)
            return torch.stack([f, R, G])
        bias_f = self.center_freq_bias_t
        if self.design == "biquad":
            bias = bias_f / self.fs * 2 * torch.pi
            min_f = 2 * torch.pi * self.f_min / self.fs
            max_f = 2 * torch.pi * self.f_max / self.fs
            spread = 2 ** torch.linspace(self.n_bands, 0, self.n_bands,
                                         dtype=self.dtype,
                                         device=param.device)[:, None]
            f = _clip(torch.sigmoid(param[:, 0] - 0.5) / spread
                      + bias[:, None], min_f, max_f)
            half = torch.sigmoid(torch.zeros_like(param[:, 1]))
            R = torch.cat([0.1 + half[:1] * 0.9, 0.1 + half[1:-1] * 3,
                           0.1 + half[-1:] * 0.9])
            G = -1e-6 + torch.sigmoid(param[:, 2] - 0.5) * (-5.0)
        else:
            w = 2 * bias_f / self.fs
            bias = torch.log(w / (1 - w))[:, None]
            f = torch.tan(torch.pi * torch.sigmoid(param[:, 0] + bias) * 0.5)
            ln2 = torch.log(torch.tensor(2.0, dtype=self.dtype))
            R = torch.nn.functional.softplus(param[:, 1]) / ln2
            G = 10 ** (-torch.nn.functional.softplus(param[:, 2] - 0.5)
                       / ln2) - 10
        return torch.stack([f, R, G])

    def compute_biquad_coeff(self, f, R, G, type="peaking"):
        """(a, b), each (..., 3): the PEQ's coefficient math."""
        return dsp.PEQ.compute_biquad_coeff(self, f, R, G, type)

    def _design(self, param):
        """(b, a), each (3, rows, N), before the alias envelope."""
        d = self.delays_t
        nb = self.n_bands
        f, R, G = self.map_eq(param[:-1] if self.is_twostage else param)
        if self.is_proportional:
            f = f[:, 0:1].expand(nb, len(self.delays))
            R = R[:, 0:1].expand(nb, len(self.delays))
            G = G[:, 0:1] * d[None, :]

        def R_shelf(r):
            return r if self.design == "biquad" else r + np.sqrt(0.5)

        bands = [self.compute_biquad_coeff(f[0], R_shelf(R[0]), G[0],
                                           "highshelf"),
                 self.compute_biquad_coeff(f[1:nb - 1], R[1:nb - 1],
                                           G[1:nb - 1], "peaking"),
                 self.compute_biquad_coeff(f[nb - 1], R_shelf(R[nb - 1]),
                                           G[nb - 1], "lowshelf")]
        if self.is_twostage:
            f2, R2, G2 = self.map_eq(param[-1], is_twostage=True)
            if self.is_proportional:
                f2 = f2[0].expand(len(self.delays))
                R2 = R2[0].expand(len(self.delays))
                G2 = G2[0] * d
            bands.append(self.compute_biquad_coeff(f2, R_shelf(R2), G2,
                                                   "highshelf"))
        rows_a = [a if a.ndim == 3 else a[None] for a, _ in bands]
        rows_b = [b if b.ndim == 3 else b[None] for _, b in bands]
        # (rows, N, 3) -> (3, rows, N)
        return (torch.cat(rows_b).permute(2, 0, 1),
                torch.cat(rows_a).permute(2, 0, 1))


class parallelFirstOrderShelving(dsp.parallelFilter):
    """A first-order shelf per delay line from the RT60 at DC (param[0],
    seconds) and ``rt_nyquist``, crossover param[1] (radians, clipped to
    [0, pi]): B / A of two taps, no guard."""

    def __init__(self, nfft=2**11, fs=48000, rt_nyquist=0.2, delays=None,
                 alias_decay_db=0.0, requires_grad=False,
                 dtype: torch.dtype = torch.float32, generator=None,
                 device=None):
        _check(delays is not None, "Delays must be provided")
        self.delays = _delay_tuple(delays)
        self.rt_nyquist = float(rt_nyquist)
        self.fs = fs
        super().__init__(size=(2,), nfft=nfft, map=_identity,
                         alias_decay_db=alias_decay_db,
                         requires_grad=requires_grad, dtype=dtype,
                         generator=generator, device=device)
        self.register_buffer("delays_t", torch.tensor(
            self.delays, dtype=dtype, device=self.param.device),
            persistent=False)

    def check_param_shape(self):
        _check(len(self.size) == 1,
               "Filter must be 1D, for 2D filters use Filter module.")

    get_io = _DelayChannels.get_io

    def map_param(self, param):
        """(rt_DC, omega_c) -> the first-order (b, a) of each delay line,
        each (2, N)."""
        d = self.delays_t
        gain_DC = rt2slope(param[0], self.fs) * d
        gain_Nyq = rt2slope(torch.tensor(self.rt_nyquist, dtype=self.dtype,
                                         device=d.device), self.fs) * d
        t = torch.tan(_clip(param[1], 0.0, torch.pi) / 2)
        sk = torch.sqrt(10 ** (gain_DC / 20) / 10 ** (gain_Nyq / 20))
        a = torch.stack([t / sk + 1, t / sk - 1])
        b = torch.stack([t * sk + 1, t * sk - 1])
        return b * 10 ** (gain_Nyq / 20), a

    def _envelope_coeffs(self, param):
        b, a = self.map_param(param)
        env = (self.gamma ** torch.arange(2, dtype=self.dtype,
                                          device=b.device)).reshape(2, 1)
        return b * env, a * env

    def get_poly_coeff(self, param):
        b2, a2 = self._envelope_coeffs(param)
        B = poly_response(b2, self.nfft)
        A = poly_response(a2, self.nfft)
        return B / A, B, A

    def response(self, ext_param=None):
        return self.get_poly_coeff(self.map(self._raw(ext_param)))[0]

    def probe(self, z):
        """diag of the shelves at z."""
        b, a = self.map_param(self.map(self.param))
        w = self._z_weights(z, 2)[:, None]
        return torch.diag(torch.sum(b.to(self.cdtype) * w, dim=0)
                          / torch.sum(a.to(self.cdtype) * w, dim=0))
