"""The e8_fdn slice's losses and signals against flamo_tpu on the CPU:
``stft_magnitude`` on both grids, ``mss_loss`` over every form, grid,
mask and log term (value and input gradient), ``mel_mss_loss``,
``edr_loss``, ``edc_loss``, ``AveragePower``, ``sparsity_loss`` on four
feedback topologies (fault F2), ``signal_gallery`` and ``find_onset``.
Inputs are seeded numpy arrays fed to both packages.  JAX's losses run
jitted, a family of configurations in one jit; the rest runs eagerly."""

from __future__ import annotations

import itertools
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu import functional as jfun
from flamo_tpu.optimize import loss as jloss
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch import functional as tfun
from flamo_tpu_torch.optimize import loss as tloss
from flamo_tpu_torch.processor import dsp, system

CPU = dict(device="cpu")
T = 2048  # samples of the loss inputs
SCALES = [64, 128, 256]  # the MSS FFT sizes at this length


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _rirs(seed: int, batch: int = 2, channels: int = 1, length: int = T):
    """Two decaying noise signals (B, T, C) over a noise floor, so that
    the SNR mask cuts some bins and keeps others."""
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(length) / (300.0 * length / T))[None, :, None]
    shape = (batch, length, channels)
    pred = rng.normal(size=shape) * env + 1e-3 * rng.normal(size=shape)
    true = rng.normal(size=shape) * env + 1e-3 * rng.normal(size=shape)
    return pred.astype(np.float32), true.astype(np.float32)


def _value_and_grad(ours, pred, true):
    """The port's value and gradient of pred."""
    p = torch.tensor(pred, requires_grad=True)
    v = ours(p, torch.tensor(true))
    v.backward()
    return float(v), p.grad.numpy()


class JaxRefs:
    """JAX's value and gradient of pred for each loss of ``fns`` (a dict)
    on one input pair, in float32 and in float64 (under a scoped x64),
    each precision through one jit of the whole family on its first use.
    Eager JAX compiles each of its operations at each new shape, dtype
    and configuration, which took most of this file's time."""

    def __init__(self, fns: dict, pred, true):
        self.fns, self.pred, self.true = fns, pred, true
        self._cache = {}

    def _run(self, dtype):
        run = jax.jit(lambda q, t: [jax.value_and_grad(fn)(q, t)
                                    for fn in self.fns.values()])
        out = run(jnp.asarray(self.pred.astype(dtype)),
                  jnp.asarray(self.true.astype(dtype)))
        return {k: (float(v), np.asarray(g))
                for k, (v, g) in zip(self.fns, out)}

    def get(self, key, dtype=np.float32):
        if dtype not in self._cache:
            if dtype == np.float64:
                with jax.enable_x64(True):
                    self._cache[dtype] = self._run(dtype)
            else:
                self._cache[dtype] = self._run(dtype)
        return self._cache[dtype][key]


def _check_loss(ours, refs: JaxRefs, key, tol: float = 1e-5):
    """Value and input gradient of a loss against JAX's, relative ``tol``.

    Both are held in float32 where they agree to ``tol``.  Else they are
    held in float64 (JAX under a scoped x64), where the two
    implementations agree to ~1e-13, and the port's float32 value and
    gradient must lie within ``tol`` of the float64 ones or no further
    from them than 1.5x JAX's own float32 results: a gradient through
    log|Y| or sqrt(re^2 + im^2) scales with 1/|Y|, so it carries the
    rounding of near-zero STFT bins (the respaced grid's matmul and the
    rfft round differently in the two packages), and a norm ratio the
    rounding of its sums."""
    v, g = _value_and_grad(ours, refs.pred, refs.true)
    jv, jg = refs.get(key)
    assert np.isfinite(v)
    if abs(v - jv) / abs(jv) < tol and _rel(g, jg) < tol:
        return
    with jax.enable_x64(True):
        v64, g64 = _value_and_grad(ours, refs.pred.astype(np.float64),
                                   refs.true.astype(np.float64))
    jv64, jg64 = refs.get(key, np.float64)
    assert abs(v64 - jv64) / abs(jv64) < tol and _rel(g64, jg64) < tol
    assert abs(v - v64) / abs(v64) < max(tol,
                                         1.5 * abs(jv - jv64) / abs(jv64))
    assert _rel(g, g64) < max(tol, 1.5 * _rel(jg, jg64))


@pytest.mark.parametrize("grid", ["rfft", "nnaudio"])
@pytest.mark.parametrize("n_fft,win,length", [(256, None, T),
                                              (1024, 960, T),
                                              (1024, None, 300)])
def test_stft_magnitude_matches_jax(grid, n_fft, win, length):
    """Both grids (the respaced one as a frames x DFT-kernel product), a
    window shorter than n_fft zero-padded in the middle, and a signal
    shorter than the padding (reflected repeatedly, as numpy's pad)."""
    x = _rirs(0, length=length)[0][..., 0]
    kw = dict(fmin=20.0, fmax=24000, sr=48000) if grid == "nnaudio" else {}
    got = tloss.stft_magnitude(torch.tensor(x), n_fft, n_fft // 4,
                               win_length=win, **kw)
    ref = jloss.stft_magnitude(jnp.asarray(x), n_fft, n_fft // 4,
                               win_length=win, **kw)
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) < 1e-5


MSS_CASES = list(itertools.product([None, "yamamoto", "magenta"],
                                   ["nnaudio", "rfft"], [False, True],
                                   [False, True]))


def _mss_kw(form, grid, apply_mask, log_term):
    return dict(nfft=SCALES, form=form, freq_grid=grid,
                apply_mask=apply_mask, log_term=log_term, threshold=5)


@pytest.fixture(scope="module")
def mss_refs():
    return JaxRefs({case: jloss.mss_loss(**_mss_kw(*case))
                    for case in MSS_CASES}, *_rirs(1))


@pytest.mark.parametrize("form,grid,apply_mask,log_term", MSS_CASES)
def test_mss_loss_matches_jax(mss_refs, form, grid, apply_mask, log_term):
    """mss_loss's value and input gradient at every form x grid x SNR mask
    x log term (:func:`_check_loss`)."""
    case = (form, grid, apply_mask, log_term)
    _check_loss(tloss.mss_loss(**_mss_kw(*case)), mss_refs, case)


def test_mss_loss_channels_and_energy_norm_match_jax():
    """Several channels (flattened channels-fastest) with energy_norm, a
    given noise energy, and the 1-D input form."""
    pred, true = _rirs(2, batch=1, channels=2)
    kw = dict(nfft=SCALES, energy_norm=True, apply_mask=True,
              noise_energy=1e-6)
    _check_loss(tloss.mss_loss(**kw),
                JaxRefs({0: jloss.mss_loss(**kw)}, pred, true), 0)
    one = tloss.mss_loss(nfft=SCALES)(torch.tensor(pred[0, :, 0]),
                                      torch.tensor(true[0, :, 0]))
    ref = jloss.mss_loss(nfft=SCALES)(pred[0, :, 0], true[0, :, 0])
    assert abs(float(one) - float(ref)) / float(ref) < 1e-5
    with pytest.raises(AssertionError, match="same shape"):
        tloss.mss_loss()(torch.tensor(pred), torch.tensor(true[..., :1]))


LOSS_CASES = {
    "mel_mss": lambda m: m.mel_mss_loss(nfft=SCALES),
    "mel_mss_masked_log": lambda m: m.mel_mss_loss(
        nfft=SCALES, apply_mask=True, log_term=True, threshold=-60),
    "edr": lambda m: m.edr_loss(),
    "edc_broadband": lambda m: m.edc_loss(is_broadband=True, clip=True),
    "edc_octave": lambda m: m.edc_loss(convergence=True),
    "average_power": lambda m: m.AveragePower(stride=(8, 8)),
}


@pytest.fixture(scope="module")
def other_refs():
    """Two families: AveragePower's 64 x 64 window needs 64 frames of hop
    256, the others run at T."""
    def family(names, length):
        return JaxRefs({n: LOSS_CASES[n](jloss) for n in names},
                       *_rirs(3, batch=1, length=length))

    short = family([n for n in LOSS_CASES if n != "average_power"], T)
    return {**dict.fromkeys(LOSS_CASES, short),
            "average_power": family(["average_power"], 16384)}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_other_losses_match_jax(other_refs, name):
    """mel_mss_loss, edr_loss, edc_loss and AveragePower: value and input
    gradient against JAX's (:func:`_check_loss`)."""
    _check_loss(LOSS_CASES[name](tloss), other_refs[name], name)


def test_filterbanks_and_schroeder_match_jax():
    for htk, norm in ((False, "slaney"), (True, None)):
        got = tloss.mel_filterbank(48000, 512, 40, htk=htk, norm=norm, **CPU)
        ref = jloss.mel_filterbank(48000, 512, 40, htk=htk, norm=norm)
        assert _rel(got.numpy(), ref) < 1e-6
    x, _ = _rirs(4)
    for energy_norm in (False, True):
        got = tloss.schroeder_backward_int(torch.tensor(x), 1, energy_norm)
        ref = jloss.schroeder_backward_int(jnp.asarray(x), 1, energy_norm)
        assert _rel(got[0].numpy(), ref[0]) < 1e-5
    assert _rel(tloss._hann(64, **CPU).numpy(), jloss._hann(64)) < 1e-7


# ---------------------------------------------------------------------------
# sparsity_loss on four feedback topologies (fault F2)
# ---------------------------------------------------------------------------
NFFT_SP, N_SP = 64, 4


def _fdn(pkg, feedback, direct=False):
    """Shell of Series(input gain, Recursion(delays, feedback), output
    gain), beside a direct gain in a Parallel with ``direct``."""
    d, s = pkg
    kw = dict(device="cpu") if d is dsp else {}
    dl = d.parallelDelay(size=(N_SP,), max_len=20, nfft=NFFT_SP, isint=True,
                         **kw)
    loop = s.Recursion(dl, feedback)
    core = s.Series(OrderedDict({
        "input_gain": d.Gain(size=(N_SP, 1), nfft=NFFT_SP, **kw),
        "feedback_loop": loop,
        "output_gain": d.Gain(size=(1, N_SP), nfft=NFFT_SP, **kw)}))
    if direct:
        core = s.Parallel(core, d.Gain(size=(1, 1), nfft=NFFT_SP, **kw))
    return s.Shell(core=core)


def _feedbacks(topology):
    """The (JAX, port) feedback paths with the same raw params."""
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(N_SP, N_SP)).astype(np.float32)
    if topology == "householder":
        j = jdsp.HouseholderMatrix(size=(N_SP, N_SP), nfft=NFFT_SP,
                                   requires_grad=True)
        t = dsp.HouseholderMatrix(size=(N_SP, N_SP), nfft=NFFT_SP,
                                  requires_grad=True, **CPU)
        t.assign_value(np.asarray(j.param))
        return j, t
    j = jdsp.Matrix(size=(N_SP, N_SP), nfft=NFFT_SP,
                    matrix_type="orthogonal", requires_grad=True)
    j = j.assign_value(jnp.asarray(raw))
    t = dsp.Matrix(size=(N_SP, N_SP), nfft=NFFT_SP, matrix_type="orthogonal",
                   requires_grad=True, **CPU)
    t.assign_value(raw)
    if topology == "plain":
        return j, t
    g = rng.uniform(0.5, 0.9, N_SP).astype(np.float32)
    jg = jdsp.parallelGain(size=(N_SP,), nfft=NFFT_SP).assign_value(
        jnp.asarray(g))
    tg = dsp.parallelGain(size=(N_SP,), nfft=NFFT_SP, **CPU)
    tg.assign_value(g)
    return (jsystem.Series(OrderedDict({"mixing_matrix": j,
                                        "attenuation": jg})),
            system.Series(OrderedDict({"mixing_matrix": t,
                                       "attenuation": tg})))


@pytest.mark.parametrize("topology", ["plain", "series", "direct",
                                      "householder"])
def test_sparsity_loss_topologies_match_jax(topology):
    """The feedback matrix itself, the Series(mixing_matrix, attenuation)
    feedback, that FDN in a Parallel beside a direct path (the e8_fdn
    'direct' scenario) and a HouseholderMatrix feedback, scored as
    I - 2 u u^T: value and gradient of the matrix's raw param."""
    jfb, tfb = _feedbacks("series" if topology == "direct" else topology)
    direct = topology == "direct"
    jm = _fdn((jdsp, jsystem), jfb, direct)
    tm = _fdn((dsp, system), tfb, direct)
    v = tloss.sparsity_loss()(None, None, tm)
    v.backward()
    mix = tfb if topology in ("plain", "householder") else tfb.mixing_matrix
    if topology == "householder":
        u = np.asarray(jfb.param)[:, 0] / np.linalg.norm(jfb.param)
        A = np.eye(N_SP) - 2 * np.outer(u, u)
        want = -(np.abs(A).sum() - N_SP ** 1.5) / (N_SP * (N_SP ** .5 - 1))
        assert abs(float(v) - want) < 1e-6
    jv = jloss.sparsity_loss()(None, None, jm)
    assert abs(float(v) - float(jv)) < 1e-6

    def jax_sp(p):
        if topology in ("plain", "householder"):
            fb = jfb.assign_value(p)
        else:
            fb = jsystem.Series(OrderedDict({
                "mixing_matrix": jfb.mixing_matrix.assign_value(p),
                "attenuation": jfb.attenuation}))
        return jloss.sparsity_loss()(None, None, _fdn((jdsp, jsystem), fb,
                                                      direct))

    jparam = (jfb if topology in ("plain", "householder")
              else jfb.mixing_matrix).param
    assert _rel(mix.param.grad.numpy(), jax.grad(jax_sp)(jparam)) < 1e-5


# ---------------------------------------------------------------------------
# signals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("signal_type,rate", [
    ("impulse", 1.0), ("sine", 440.0), ("sine", None), ("sweep", 1.0),
    ("exp", 2000.0), ("reference", 1.0)])
def test_signal_gallery_matches_jax(signal_type, rate):
    ref_sig = np.linspace(-1, 1, 512, dtype=np.float32)[:, None]
    kw = dict(signal_type=signal_type, fs=48000, rate=rate,
              reference=ref_sig)
    got = tfun.signal_gallery(2, 512, 3, **kw, **CPU)
    ref = jfun.signal_gallery(2, 512, 3, **kw)
    assert got.shape == ref.shape == (2, 512, 3)
    # the sweep's float32 phase reaches 2 pi (20 t + 19980 t^2 / (2 t1))
    # ~ 670 rad at 512 samples, where torch's and JAX's linspace round t
    # one ulp apart: a few ulps of that phase
    atol = 8 * np.finfo(np.float32).eps * 670 if signal_type == "sweep" \
        else 2e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("signal_type", ["wgn", "noise", "velvet"])
def test_signal_gallery_random_types_shape_and_seed(signal_type):
    """The random types: shape, reproducible from a generator's seed,
    other draws from another seed; velvet noise is +-1 pulses, one in
    each period of fs / rate samples, the first at sample 0."""
    def draw(seed):
        return tfun.signal_gallery(
            2, 4800, 3, signal_type=signal_type, rate=1000.0,
            generator=torch.Generator().manual_seed(seed), **CPU)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (2, 4800, 3) and torch.equal(a, b)
    assert not torch.equal(a, c)
    if signal_type == "velvet":
        nz = a != 0
        assert torch.all(torch.abs(a[nz]) == 1)
        assert torch.all(nz.sum(dim=1) == 4800 // 48)
        assert torch.all(a[:, 0] != 0)


def test_find_onset_and_frequency_samples_match_jax():
    rng = np.random.default_rng(6)
    for delay in (0, 137, 1500):
        rir = np.zeros(4000, np.float32)
        rir[delay:] = (rng.normal(size=4000 - delay)
                       * np.exp(-np.arange(4000 - delay) / 400.0))
        rir += 1e-4 * rng.normal(size=4000).astype(np.float32)
        got = tfun.find_onset(torch.tensor(rir))
        assert got == jfun.find_onset(jnp.asarray(rir))
    got = tfun.get_frequency_samples(9, **CPU)
    assert _rel(got.numpy(), jfun.get_frequency_samples(9)) < 1e-6
