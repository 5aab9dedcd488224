"""The probes and ``ext_param`` against flamo_tpu on the CPU.

* ``probe``/``probe_w`` of every module that the port holds and
  ``tests/test_probe_all.py`` lists (the accurate GEQ, the velvet-noise
  matrix and the reverb attenuation family are not ported yet), against
  JAX's probe and against the port's own forward; the containers'
  probes (Series, Recursion and its characteristic matrix, Parallel
  summed and concatenated, Shell with its layers), also batched with
  ``torch.func.vmap``.
* ``ext_param`` through Series, Recursion, Parallel and Shell in both key
  forms (nested dicts of exact keys, dotted ``'key.sub'`` keys): values,
  ``matrix_response`` and the gradients in the external parameters.

The weights go from JAX into the port through ``convert``.  Tolerances:
a probe against JAX's 1e-5 of the max (cascades of sections 1e-4: XLA
contracts the Horner sums into FMAs; the 12-section octave GEQ, which is
ill-conditioned near DC in float32, 5e-3, the JAX package's bound for its
two GEQ backends in tests/test_ops.py); against the port's forward 5e-3,
and probe_w against probe 5e-3, tests/test_probe_all.py's own; the
ext_param values 1e-5 and gradients 1e-4 of the max."""

from __future__ import annotations

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.convert import load_jax_params, load_jax_scattering
from flamo_tpu_torch.processor import dsp, system

NFFT = 512
M = NFFT // 2 + 1
CPU = dict(device="cpu")
PROBE_TOL = 1e-5
CASCADE_TOL = 1e-4
GEQ_TOL = 5e-3
FWD_TOL = 5e-3
VAL_TOL = 1e-5
GRAD_TOL = 1e-4

MODULES = {
    "Gain": ("Gain", dict(size=(2, 3))),
    "parallelGain": ("parallelGain", dict(size=(3,))),
    "Matrix_random": ("Matrix", dict(size=(3, 3), matrix_type="random")),
    "Matrix_orthogonal": ("Matrix", dict(size=(3, 3),
                                         matrix_type="orthogonal")),
    "Matrix_hadamard": ("Matrix", dict(size=(4, 4), matrix_type="hadamard")),
    "Matrix_rotation": ("Matrix", dict(size=(4, 4), matrix_type="rotation")),
    "HouseholderMatrix": ("HouseholderMatrix", dict(size=(3, 3))),
    "Filter": ("Filter", dict(size=(7, 2, 3))),
    "Filter_alias": ("Filter", dict(size=(7, 2, 3), alias_decay_db=20.0)),
    "parallelFilter": ("parallelFilter", dict(size=(7, 3))),
    "ScatteringMatrix": ("ScatteringMatrix", dict(size=(2, 4, 4),
                                                  sparsity=2)),
    "Biquad": ("Biquad", dict(size=(2, 3), n_sections=2,
                              filter_type="lowpass", fs=48000)),
    "parallelBiquad": ("parallelBiquad", dict(size=(3,), n_sections=2,
                                              filter_type="bandpass",
                                              fs=48000)),
    "SOSFilter": ("SOSFilter", dict(size=(2, 3), n_sections=2, fs=48000)),
    "parallelSOSFilter": ("parallelSOSFilter", dict(size=(3,), n_sections=2,
                                                    fs=48000)),
    "SVF": ("SVF", dict(size=(2, 3), n_sections=2, filter_type="peaking",
                        fs=48000)),
    "parallelSVF": ("parallelSVF", dict(size=(3,), n_sections=1,
                                        filter_type="lowshelf", fs=48000)),
    "GEQ": ("GEQ", dict(size=(2, 3), octave_interval=1, fs=48000)),
    "parallelGEQ": ("parallelGEQ", dict(size=(3,), octave_interval=1,
                                        fs=48000)),
    "PEQ_biquad": ("PEQ", dict(size=(2, 3), n_bands=4, design="biquad",
                               fs=48000)),
    "PEQ_svf": ("PEQ", dict(size=(2, 3), n_bands=4, design="svf",
                            fs=48000)),
    "parallelPEQ": ("parallelPEQ", dict(size=(3,), n_bands=4, fs=48000)),
    "Delay": ("Delay", dict(size=(2, 3), max_len=32, isint=True)),
    "Delay_frac": ("Delay", dict(size=(2, 3), max_len=32, isint=False)),
    "parallelDelay": ("parallelDelay", dict(size=(3,), max_len=32,
                                            isint=True)),
    "parallelDelay_alias": ("parallelDelay", dict(size=(3,), max_len=32,
                                                  isint=True,
                                                  alias_decay_db=20.0)),
    "GainDelay": ("GainDelay", dict(size=(2, 3), max_len=16, isint=True)),
    "parallelGainDelay": ("parallelGainDelay", dict(size=(3,), max_len=16,
                                                    isint=True)),
}
CASCADES = ("Biquad", "parallelBiquad", "SOSFilter", "parallelSOSFilter",
            "SVF", "parallelSVF", "GEQ", "parallelGEQ", "PEQ_biquad",
            "PEQ_svf", "parallelPEQ")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]}


def _module_pair(name):
    cls, kw = MODULES[name]
    kw = dict(kw, nfft=NFFT)
    flamo_tpu.set_seed(77)
    jm = getattr(jdsp, cls)(**kw)
    tm = getattr(dsp, cls)(**kw, **CPU)
    tm.assign_value(np.asarray(jm.param))
    if cls == "ScatteringMatrix":
        mf = jm.map_filter
        load_jax_scattering(tm, mf.shifts, mf.m_L, mf.m_R)
    return jm, tm


def _bins(name):
    # a fractional z^-m at the exact Nyquist bin sits on the branch cut
    # (tests/test_probe_all.py): probe the bin below it
    return [1, M // 3, M - 2 if name == "Delay_frac" else M - 1]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_probe_matches_jax_and_forward(name):
    """The module's probe and probe_w at three bins against JAX's and its
    own forward, from a Python complex z and batched by vmap."""
    jm, tm = _module_pair(name)
    ks = _bins(name)
    zs = np.exp(1j * 2 * np.pi * np.asarray(ks) / NFFT).astype(np.complex64)
    jH = np.asarray(jax.jit(jax.vmap(jm.probe))(jnp.asarray(zs)))
    jHw = np.asarray(jax.jit(jax.vmap(jm.probe_w))(1 / jnp.asarray(zs)))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(1, M, tm.input_channels))
         + 1j * rng.normal(size=(1, M, tm.input_channels))).astype(
        np.complex64)
    with torch.no_grad():
        y = tm(torch.tensor(x)).numpy()
        scale = float(np.abs(y).max()) + 1e-6
        tol = (GEQ_TOL if "GEQ" in name else
               CASCADE_TOL if name in CASCADES else PROBE_TOL)
        for i, (k, z) in enumerate(zip(ks, zs)):
            Hp = tm.probe(torch.tensor(z)).numpy()
            assert np.isfinite(Hp).all(), (name, k)
            assert _rel(Hp, jH[i]) < tol, (name, k)
            rel = float(np.abs(Hp @ x[0, k] - y[0, k]).max()) / scale
            assert rel < FWD_TOL, (name, k, rel)
            Hw = tm.probe_w(1 / torch.tensor(z)).numpy()
            assert _rel(Hw, Hp) < FWD_TOL, (name, k)
            assert _rel(Hw, jHw[i]) < tol, (name, k)
        # a Python complex z, and torch.func.vmap over the three
        Hc = tm.probe(complex(zs[0])).numpy()
        assert _rel(Hc, jH[0]) < tol
        Hv = torch.func.vmap(tm.probe)(torch.tensor(zs)).numpy()
        assert _rel(Hv, jH) < tol


def test_convert_carries_the_filter_zoo():
    """load_jax_params carries every family's raw param into the port: a
    Shell (FFT in, |.| out) around a Series of a Biquad, an SOS filter,
    an SVF, a PEQ and a GainDelay, built in both packages from different
    seeds, gives JAX's output once loaded."""
    def build(d, sys_, **kw):
        return sys_.Shell(core=sys_.Series(OrderedDict({
            "bq": d.Biquad(size=(2, 1), n_sections=2, filter_type="bandpass",
                           nfft=NFFT, **kw),
            "sos": d.parallelSOSFilter(size=(2,), n_sections=2, nfft=NFFT,
                                       **kw),
            "svf": d.SVF(size=(2, 2), n_sections=2, nfft=NFFT, **kw),
            "peq": d.parallelPEQ(size=(2,), n_bands=3, nfft=NFFT, **kw),
            "gd": d.GainDelay(size=(1, 2), max_len=8, nfft=NFFT, **kw)})),
            input_layer=d.FFT(NFFT), output_layer=d.Transform(
                jnp.abs if d is jdsp else torch.abs))

    flamo_tpu.set_seed(3)
    js = build(jdsp, jsystem)
    ts = build(dsp, system, **CPU)
    params = _jax_params(js)
    assert len(params) == 5
    load_jax_params(ts, params)
    x = np.random.default_rng(0).normal(size=(1, NFFT, 1)).astype(
        np.float32)
    with torch.no_grad():
        y = ts(torch.tensor(x)).numpy()
    assert _rel(y, jax.jit(js)(jnp.asarray(x))) < CASCADE_TOL


def test_transforms_probe_to_none():
    for t in (dsp.Transform(), dsp.FFT(NFFT), dsp.iFFT(NFFT)):
        assert t.probe(1j) is None and t.probe_w(1j) is None
    with pytest.raises(NotImplementedError, match="probe"):
        dsp.DSP(size=(2,), nfft=NFFT, **CPU).probe(1j)


# ---------------------------------------------------------------------------
# the containers
# ---------------------------------------------------------------------------
def _fdn(sys_, d, seed: int = 5, par: bool = False, sum_output=True):
    """e10's FDN (input gain, Recursion of delays and a 0.8 attenuation
    against an orthogonal feedback, output gain) in ``sys_``/``d`` (the
    JAX or the port's modules); with ``par`` the output stage is a
    Parallel of two gains."""
    kw = {} if d is jdsp else CPU
    flamo_tpu.set_seed(seed)
    dl = d.parallelDelay(size=(3,), max_len=120, nfft=NFFT, isint=True, **kw)
    att = d.parallelBiquad(size=(3,), n_sections=2, filter_type="lowpass",
                           nfft=NFFT, **kw)
    loop = sys_.Recursion(
        fF=sys_.Series(OrderedDict({"d": dl, "a": att})),
        fB=d.Matrix(size=(3, 3), nfft=NFFT, matrix_type="orthogonal", **kw))
    if par:
        out = sys_.Parallel(d.Gain(size=(1, 3), nfft=NFFT, **kw),
                            d.Gain(size=(1, 3), nfft=NFFT, **kw),
                            sum_output=sum_output)
    else:
        out = d.Gain(size=(1, 3), nfft=NFFT, **kw)
    core = sys_.Series(OrderedDict({
        "i": d.Gain(size=(3, 1), nfft=NFFT, **kw), "loop": loop,
        "out": out}))
    return sys_.Shell(core=core, input_layer=d.Gain(size=(1, 1), nfft=NFFT,
                                                    **kw),
                      output_layer=d.Gain(size=(1, 1 if sum_output else 2),
                                          nfft=NFFT, **kw))


def _shell_pair(**kw):
    js = _fdn(jsystem, jdsp, **kw)
    ts = load_jax_params(_fdn(system, dsp, **kw), _jax_params(js))
    return js, ts


ZS = np.exp(1j * 2 * np.pi * np.array([1, 37, 100, M - 1]) / NFFT).astype(
    np.complex64)


@pytest.mark.parametrize("par,sum_output", [(False, True), (True, True),
                                            (True, False)])
def test_container_probes_match_jax(par, sum_output):
    """Shell.probe with and without its layers, the core's Series.probe
    and probe_w, the loop's probe, probe_w, probe_recursion and
    probe_recursion_w, and a Parallel output stage summed or
    concatenated, at four points of the unit circle, each also batched
    with torch.func.vmap; the Shell's probe agrees with its forward."""
    js, ts = _shell_pair(par=par, sum_output=sum_output)
    jloop, tloop = js.core.loop, ts.core.loop
    calls = {
        "shell": (lambda m, z: m.probe(z), js, ts),
        "shell_io": (lambda m, z: m.probe(z, include_shell_io=True), js, ts),
        "core": (lambda m, z: m.probe(z), js.core, ts.core),
        "core_w": (lambda m, z: m.probe_w(1 / z), js.core, ts.core),
        "loop": (lambda m, z: m.probe(z), jloop, tloop),
        "loop_w": (lambda m, z: m.probe_w(1 / z), jloop, tloop),
        "recursion": (lambda m, z: m.probe_recursion(z), jloop, tloop),
        "recursion_w": (lambda m, z: m.probe_recursion_w(1 / z), jloop,
                        tloop),
        "out": (lambda m, z: m.probe(z), js.core.out, ts.core.out),
    }
    with torch.no_grad():
        for name, (f, jm, tm) in calls.items():
            jH = np.asarray(jax.jit(jax.vmap(lambda z: f(jm, z)))(
                jnp.asarray(ZS)))
            for i, z in enumerate(ZS):
                assert _rel(f(tm, torch.tensor(z)).numpy(), jH[i]) \
                    < CASCADE_TOL, (name, i)
            Hv = torch.func.vmap(lambda z: f(tm, z))(torch.tensor(ZS))
            assert _rel(Hv.numpy(), jH) < CASCADE_TOL, name
        X = torch.ones((1, M, 1), dtype=torch.complex64)
        y = ts.core(X)[0]
        for k in (1, 37, 100, M - 1):
            z = torch.tensor(np.exp(1j * 2 * np.pi * k / NFFT),
                             dtype=torch.complex64)
            assert _rel(ts.core.probe(z)[:, 0].numpy(), y[k].numpy()) \
                < FWD_TOL


# ---------------------------------------------------------------------------
# ext_param
# ---------------------------------------------------------------------------
def _ext_payloads(rng):
    """Raw parameters for the input gain, the loop's lowpass, the loop's
    feedback matrix and the output stage's branch B, in both key forms."""
    raw = {
        "i": rng.normal(size=(3, 1)).astype(np.float32),
        "a": np.stack([rng.uniform(0.1, 0.4, (2, 3)),
                       rng.uniform(0.5, 1.5, (2, 3))], axis=1)
        .astype(np.float32),
        "fb": rng.normal(size=(3, 3)).astype(np.float32),
        "b": rng.normal(size=(1, 3)).astype(np.float32),
    }

    def nested(v):
        return {"i": v["i"], "loop": {"feedforward": {"a": v["a"]},
                                      "feedback": v["fb"]},
                "out": {"branchB": v["b"]}}

    def dotted(v):
        return {"i": v["i"], "loop.feedforward.a": v["a"],
                "loop.feedback": v["fb"], "out.branchB": v["b"]}

    return raw, {"nested": nested, "dotted": dotted}


@pytest.mark.parametrize("form", ["nested", "dotted"])
@pytest.mark.parametrize("solve", ["ge", "pallas"])
def test_ext_param_matches_jax(form, solve):
    """Shell(x, ext_param) and the core's matrix_response(ext_param)
    against JAX's, and the gradients in every external parameter; the
    model's own parameters get none.  Under 'pallas' the port's loop takes
    the FDN split (K2's plain version here) with the external feedback,
    against JAX's 'ge'."""
    js, ts = _shell_pair(par=True)
    ts.core.loop.solve_method = solve
    raw, forms = _ext_payloads(np.random.default_rng(9))
    make = forms[form]
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, M, 1))
         + 1j * rng.normal(size=(2, M, 1))).astype(np.complex64)

    def jloss(v):
        y = js(jnp.asarray(x), ext_param=make(v))
        return jnp.sum(jnp.abs(y) ** 2), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    tv = {k: torch.tensor(v, requires_grad=True) for k, v in raw.items()}
    y = ts(torch.tensor(x), ext_param=make(tv))
    assert _rel(y.detach().numpy(), jy) < VAL_TOL
    torch.sum(torch.abs(y) ** 2).backward()
    for k in raw:
        assert _rel(tv[k].grad.numpy(), jg[k]) < GRAD_TOL, k
    assert all(p.grad is None for p in ts.parameters())

    # the external values change the result, and matrix_response follows
    y0 = ts(torch.tensor(x)).detach().numpy()
    assert _rel(y0, y.detach().numpy()) > 1e-2
    ext = make({k: torch.tensor(v) for k, v in raw.items()})
    kind, H = ts.core.matrix_response(ext)
    jH = jax.jit(lambda v: js.core.matrix_response(make(v))[1])(raw)
    assert kind == "full" and _rel(H.detach().numpy(), jH) < VAL_TOL


def test_ext_for_key_forms():
    """A child's part of ext_param: its exact key wins over dotted keys,
    dotted keys become a dict without the prefix, anything else is None."""
    f = system._ext_for
    assert f({"a": 1, "a.b": 2}, "a") == 1
    assert f({"a.b": 2, "a.c.d": 3, "ab": 4}, "a") == {"b": 2, "c.d": 3}
    assert f({"b": 1}, "a") is None and f(None, "a") is None
    assert f(torch.ones(2), "a") is None
    assert system._branch_ext({"feedback": 5}, "feedback") == 5
