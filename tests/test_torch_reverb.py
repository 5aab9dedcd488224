"""The reverb domain against flamo_tpu on the CPU: ``auxiliary/reverb.py``
(the RT maps, ``coprime_delay_lengths``, ``HomogeneousFDN``; its
attenuation families are held in ``test_torch_reverb_filters.py``, the
accurate ones in ``test_torch_accurate_geq.py``),
``auxiliary/config.py``, ``auxiliary/filterbank.py`` and the e8_fdn
``accurate_geq`` and ``delay_scaled`` scenarios.  The same weights go
into both packages (``load_jax_params`` carries a JAX model's leaves).

Tolerances: the maps 1e-6 (``map_gamma``'s power multiplies an ulp of its
base by the delay length); the FDN's |H|, forward and IR 1e-5 of the max
on 'ge' and on 'pallas' (K2's plain version against JAX's interpreted
``pallas_fdn_solve``); the filterbank 1e-5; the delay_scaled model's
losses over 3 Adam steps in lockstep 1e-5."""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu import optimize as jopt
from flamo_tpu.auxiliary import config as jcfg
from flamo_tpu.auxiliary import filterbank as jfb
from flamo_tpu.auxiliary import reverb as jrev
from flamo_tpu.optimize import loss as jloss
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsys
from flamo_tpu_torch.auxiliary import config as tcfg
from flamo_tpu_torch.auxiliary import filterbank as tfb
from flamo_tpu_torch.auxiliary import reverb as trev
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.examples import e8_fdn
from flamo_tpu_torch.examples._common import setup
from flamo_tpu_torch.optimize import Trainer, mss_loss, sparsity_loss

NFFT = 512
M = NFFT // 2 + 1
CPU = dict(device="cpu")
MAP_TOL = 1e-6
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
DELAYS4 = (179, 211, 233, 251)


def _rel(got, ref) -> float:
    """max |got - ref| / max |ref| over the entries where ref is finite,
    where got must be finite too."""
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all()
    got, ref = got[fin], ref[fin]
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) or 1.0))


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


# ---------------------------------------------------------------------------
# the maps and the delay lengths
# ---------------------------------------------------------------------------
def test_rt_maps_match_jax():
    rng = np.random.default_rng(0)
    rt = rng.uniform(0.2, 3.0, 7).astype(np.float32)
    d = np.array([593, 743, 929, 1153])
    assert _rel(trev.rt2slope(_t(rt), 48000), jrev.rt2slope(rt, 48000)) \
        < MAP_TOL
    got = trev.rt2absorption(_t(rt), 48000, d)
    assert got.shape == (7, 4) and got.dtype == torch.float32
    assert _rel(got, jrev.rt2absorption(rt, 48000, d)) < MAP_TOL
    assert _rel(trev.rt2absorption(0.5, 48000, d),
                jrev.rt2absorption(0.5, 48000, d)) < MAP_TOL
    x = rng.normal(size=4).astype(np.float32)
    for delays in (d, np.array([1, 2, 3, 5])):
        for comp in (True, False):
            xx = x if comp else np.abs(x) * 0.01 + 0.99
            # gamma^d_i: the sigmoids of the two packages may lie an ulp
            # apart, which the power multiplies by d_i
            assert _rel(trev.map_gamma(delays, comp)(_t(xx)),
                        jrev.map_gamma(delays, comp)(jnp.asarray(xx))) \
                < MAP_TOL * max(1, delays.max() / 16)
    g = np.float32([0.9935, 0.9962, 0.9978, 0.9991])
    for delays in (None, d):
        for comp in (True, False):
            yy = g if delays is None else (g ** d).astype(np.float32)
            assert _rel(trev.inverse_map_gamma(delays, comp)(_t(yy)),
                        jrev.inverse_map_gamma(delays, comp)(yy)) < MAP_TOL
    # map_gamma then its inverse: the raw value's first entry back
    g = trev.map_gamma(d)(_t(x))
    np.testing.assert_allclose(trev.inverse_map_gamma(d)(g).numpy(),
                               np.full(4, x[0]), rtol=1e-3, atol=1e-3)
    rt2 = rng.uniform(0.3, 2.0, 10).astype(np.float32)
    for ours, theirs in ((trev._RTScaledMap(d, 48000),
                          jrev._RTScaledMap(tuple(d), 48000)),
                         (trev.map_gfdn_gamma(d, 2, 48000),
                          jrev.map_gfdn_gamma(d, 2, 48000))):
        assert _rel(ours(_t(rt2)), theirs(jnp.asarray(rt2))) < MAP_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coprime_delay_lengths_equal_jax(seed):
    for N, rng_ms, fs in ((6, [20.0, 50.0], 48000), (4, [5.0, 9.0], 44100),
                          (8, [1.0, 3.0], 16000)):
        got = trev.coprime_delay_lengths(
            N, rng_ms, fs, rng=np.random.default_rng(seed))
        want = jrev.coprime_delay_lengths(
            N, rng_ms, fs, rng=np.random.default_rng(seed))
        assert got == want and all(isinstance(v, int) for v in got)
    assert trev._next_prime(2411) == 2417 and trev._next_prime(1) == 2


def test_config_defaults_and_errors():
    ours = tcfg.HomogeneousFDNConfig(**CPU)
    theirs = jcfg.HomogeneousFDNConfig()
    fields = {f.name for f in dataclasses.fields(ours)}
    assert fields == set(type(theirs).model_fields)
    for name in fields - {"device", "dtype", "delays"}:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device == torch.device("cpu")
    assert ours.dtype == torch.float32 and theirs.dtype == "float32"
    # the delays drawn in range, N - 1 primes and the prime above it
    lo, hi = 960, 2400
    assert len(ours.delays) == ours.N == 6
    assert all(lo <= v < hi for v in ours.delays[:-1])
    assert ours.delays[-1] == trev._next_prime(hi)
    assert tcfg.HomogeneousFDNConfig(dtype="float64",
                                     **CPU).dtype == torch.float64
    assert tcfg.HomogeneousFDNConfig(dtype=np.float32,
                                     **CPU).dtype == torch.float32
    cfg = tcfg.HomogeneousFDNConfig(N=3, delays=[3, 5, 7], **CPU)
    assert cfg.delays == [3, 5, 7]
    with pytest.raises(ValueError, match="must match N"):
        tcfg.HomogeneousFDNConfig(N=3, delays=[3, 5], **CPU)
    with pytest.raises(ValueError, match="must match N"):
        jcfg.HomogeneousFDNConfig(N=3, delays=[3, 5])
    with pytest.raises(TypeError, match="unexpected keyword"):
        tcfg.HomogeneousFDNConfig(n_lines=3, **CPU)
    with pytest.raises(ValueError, match="Extra inputs"):
        jcfg.HomogeneousFDNConfig(n_lines=3)
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcfg.HomogeneousFDNConfig()


# ---------------------------------------------------------------------------
# HomogeneousFDN
# ---------------------------------------------------------------------------
def _impulse():
    x = np.zeros((1, NFFT, 1), np.float32)
    x[0, 0, 0] = 1.0
    return x


@jax.jit
def _fdn_refs(model):
    """JAX's frequency response, forward on the impulse and IR of an FDN
    model, in one jit (a model of the same structure reuses it)."""
    return (model.get_freq_response(identity=False), model(_impulse()),
            model.get_time_response())


def _check_fdn(fj_model, ft_model):
    Hj, yj, irj = _fdn_refs(fj_model)
    Ht = ft_model.get_freq_response(identity=False)
    assert Ht.shape == Hj.shape == (1, M, 1)
    assert _rel(torch.abs(Ht), jnp.abs(Hj)) < VAL_TOL
    with torch.no_grad():
        assert _rel(ft_model(_t(_impulse())), yj) < VAL_TOL
    assert _rel(ft_model.get_time_response(), irj) < VAL_TOL
    return np.asarray(Hj)


@pytest.mark.parametrize("method", ["ge", "pallas"])
def test_homogeneous_fdn_matches_jax(method):
    """The FDN from JAX's weights on 'ge' and 'pallas' (K2's plain version
    against JAX's interpreted pallas_fdn_solve): |H|, the forward on the
    impulse (through iFFTAntiAlias) and the IR; normalize_energy, in
    place, against JAX's response scaled as it scales it; the raw
    parameters, and a round trip of edited ones through both packages'
    set_raw_parameters; rt2gain."""
    kw = dict(N=4, nfft=NFFT, delays=[89, 97, 107, 113], alias_decay_db=20,
              solve_method=method)
    flamo_tpu.set_seed(0)
    fj = jrev.HomogeneousFDN(jcfg.HomogeneousFDNConfig(**kw))
    ft = trev.HomogeneousFDN(tcfg.HomogeneousFDNConfig(**kw, **CPU))
    assert set(jax_named_tensors(ft)) == set(_jax_params(fj.model))
    load_jax_params(ft, _jax_params(fj.model))
    assert ft.model.core.feedback_loop.solve_method == method
    Hj = _check_fdn(fj.model, ft.model)
    rj = fj.get_raw_parameters()
    assert set(rj) == set(ft.get_raw_parameters()) == {
        "A", "attenuation", "B", "C", "m"}
    for k, v in ft.get_raw_parameters().items():
        np.testing.assert_array_equal(v, rj[k])
    # normalize_energy: both gains divided by (E|H|^2)^(1/4)
    gains = ft.model.core.input_gain.param
    ptr = gains.data_ptr()
    ft.normalize_energy()
    assert gains.data_ptr() == ptr
    scale = float(np.mean(np.abs(Hj) ** 2)) ** 0.25
    for k in ("B", "C"):
        assert _rel(ft.get_raw_parameters()[k], rj[k] / scale) < VAL_TOL
    H = ft.model.get_freq_response()
    assert abs(float(torch.mean(torch.abs(H) ** 2)) - 1) < 1e-4
    with pytest.raises(AssertionError, match="Energy normalization"):
        ft.normalize_energy(target_energy=float("inf"))
    # edited raw parameters through both packages
    edit = dict(rj, attenuation=np.full_like(rj["attenuation"], 4.0)[None],
                B=rj["B"] * 0.5)
    fj.set_raw_parameters(edit)
    ft.set_raw_parameters(edit)
    for k, v in ft.get_raw_parameters().items():
        np.testing.assert_array_equal(v, np.squeeze(edit[k]) if k in (
            "attenuation", "m") else edit[k])
    _check_fdn(fj.model, ft.model)
    assert _rel(ft.rt2gain(1.2), fj.rt2gain(1.2)) < MAP_TOL


# ---------------------------------------------------------------------------
# the filterbank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["fft", "scipy"])
def test_filterbank_matches_jax(backend):
    kw = dict(fraction=3, order=4, fmin=100.0, fmax=4000.0,
              sample_rate=16000, backend=backend, pad=4000)
    tb, jb = tfb.FilterBank(**kw, **CPU), jfb.FilterBank(**kw)
    assert tb.get_center_frequencies() == jb.get_center_frequencies()
    x = np.random.default_rng(2).normal(size=(2, 3000, 2)).astype(np.float32)
    y = tb(_t(x))
    assert y.shape == (2, 3000, 2, len(tb.get_center_frequencies()))
    assert _rel(y, jb(jnp.asarray(x))) < VAL_TOL
    # the setters design the bank again, as JAX's
    for name, value in (("set_order", 3), ("set_sample_rate", 12000),
                        ("set_center_frequencies", [500, 125, 250])):
        getattr(tb, name)(value)
        getattr(jb, name)(value)
        for a, b in zip(tb._sos, jb._sos):
            np.testing.assert_array_equal(a, b)
    assert tb.get_center_frequencies() == [125, 250, 500]
    with pytest.raises(AssertionError, match="fs/2"):
        tb.set_center_frequencies([100, 7000])
    with pytest.raises(AssertionError, match="fractions 1 and 3"):
        tfb.FilterBank(fraction=2, **CPU)


def test_filterbank_impulse_response_matches_jax():
    kw = dict(fraction=1, order=3, fmin=60.0, fmax=500.0, sample_rate=2000)
    tb, jb = tfb.FilterBank(**kw, **CPU), jfb.FilterBank(**kw)
    got = tb.get_filterbank_impulse_response()
    want = jb.get_filterbank_impulse_response()
    assert got.shape == want.shape == (1, 40000, 1, 6)
    assert _rel(got, want) < VAL_TOL


# ---------------------------------------------------------------------------
# the e8_fdn scenarios
# ---------------------------------------------------------------------------
ARGS = types.SimpleNamespace(nfft=NFFT, samplerate=48000, rir=None)


def _jax_delay_scaled(attenuation: str):
    """JAX's delay_scaled model, as examples/e8_fdn.py builds it."""
    N, alias = 4, 30.0
    common = dict(nfft=NFFT, alias_decay_db=alias)
    ig = jdsp.Gain(size=(N, 1), requires_grad=True, **common)
    og = jdsp.Gain(size=(1, N), requires_grad=True, **common)
    dl = jdsp.parallelDelay(size=(N,), max_len=max(DELAYS4), isint=True,
                            **common)
    dl = dl.assign_value(dl.sample2s(jnp.asarray(DELAYS4, jnp.float32)))
    atten = {
        "geq": lambda: jrev.parallelFDNGEQ(octave_interval=1, fs=48000,
                                           delays=jnp.asarray(DELAYS4),
                                           requires_grad=True, **common),
        "accurate_geq": lambda: jrev.parallelFDNAccurateGEQ(
            octave_interval=1, fs=48000, delays=jnp.asarray(DELAYS4),
            **common),
        "peq": lambda: jrev.parallelFDNPEQ(
            n_bands=6, delays=jnp.asarray(DELAYS4), fs=48000,
            requires_grad=True, **common),
        "shelving": lambda: jrev.parallelFirstOrderShelving(
            fs=48000, delays=jnp.asarray(DELAYS4), requires_grad=True,
            **common),
    }[attenuation]()
    fb = jdsp.Matrix(size=(N, N), matrix_type="orthogonal",
                     requires_grad=True, **common)
    from collections import OrderedDict

    loop = jsys.Recursion(fF=jsys.Series(OrderedDict(
        {"delays": dl, "attenuation": atten})), fB=fb)
    core = jsys.Series(OrderedDict({
        "input_gain": ig, "feedback_loop": loop, "output_gain": og}))
    return jsys.Shell(core=core, input_layer=jdsp.FFT(NFFT),
                      output_layer=jdsp.iFFTAntiAlias(nfft=NFFT,
                                                      alias_decay_db=alias))


@pytest.mark.parametrize("attenuation", ["peq"])
def test_delay_scaled_lockstep_with_jax(attenuation):
    """Three Adam steps of each package's Trainer.fit_scan on (impulse,
    WGN target) from the same weights, mss_loss + 0.2 sparsity_loss: the
    losses at 1e-5."""
    flamo_tpu.set_seed(5)
    mj = _jax_delay_scaled(attenuation)
    mt = e8_fdn.build_delay_scaled(ARGS, attenuation, "xla", device="cpu")
    load_jax_params(mt, _jax_params(mj))
    rng = np.random.default_rng(6)
    target = (rng.normal(size=(1, NFFT, 1))
              * np.exp(-np.arange(NFFT) / 200.0)[None, :, None]).astype(
        np.float32)
    x = np.zeros((1, NFFT, 1), np.float32)
    x[0, 0, 0] = 1.0
    trj = jopt.Trainer(mj, lr=1e-3, log=False)
    trj.register_criterion(jloss.mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    trj.register_criterion(jloss.sparsity_loss(), 0.2, requires_model=True)
    hj = np.asarray(trj.fit_scan(jnp.asarray(x), jnp.asarray(target),
                                 n_steps=3, steps_per_call=3))
    trt = Trainer(mt, lr=1e-3, log=False)
    trt.register_criterion(mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    trt.register_criterion(sparsity_loss(), e8_fdn.DS_SPARSITY,
                           requires_model=True)
    ht = trt.fit_scan(_t(x), _t(target), n_steps=3, steps_per_call=3)
    np.testing.assert_allclose(ht, hj, rtol=1e-5)
    assert np.isfinite(ht).all()


def test_e8_fdn_new_scenarios_on_cpu(tmp_path, capsys):
    """accurate_geq through the 'pallas' route's plain versions (the
    routes' check and the RT gate) and delay_scaled with each attenuation
    through fit_scan_epochs; their files written."""
    args = setup(e8_fdn.parser().parse_args([
        "--device", "cpu", "--nfft", "2048", "--num", "4", "--max_epochs",
        "1", "--backend", "pallas", "--scan", "--scenario", "accurate_geq",
        "--train_dir", str(tmp_path)]))
    (acc,) = e8_fdn.main(args)
    assert acc["rt_mse"] < e8_fdn.RT_MSE_TOL and acc["backend"] == "pallas"
    assert acc["routes"]["gap"] < e8_fdn.ACC_ROUTE_TOL
    with np.load(tmp_path / "filter_response.npz") as f:
        assert f["simulated_rt"].shape == (1025,)
    assert (tmp_path / "ir_accurate_geq.wav").exists()
    args.scenario = "delay_scaled"
    for attenuation in e8_fdn.ATTENUATIONS:
        args.attenuation = attenuation
        (tr,) = e8_fdn.main(args)
        assert np.isfinite(tr.train_loss).all()
    out = capsys.readouterr().out
    assert out.count("fit_scan_epochs: loss") == 4
    with np.load(tmp_path / "fdn_magnitude.npz") as f:
        assert f["optimized"].shape == f["target"].shape == (1025,)
