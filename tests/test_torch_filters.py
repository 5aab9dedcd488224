"""The filter zoo against flamo_tpu on the CPU: the coefficient designs,
``RegularGridInterpolator`` and ``probe_sos``, and the Biquad, SOS, SVF,
PEQ and GainDelay families' responses and gradients on both cascade
routes.  The same raw parameters go into both packages (numpy).

Tolerances are the JAX package's own for these paths: values 1e-5 of the
max and gradients 1e-4 of the max, on 'xla' against 'xla' and on the
'pallas' route (K4's plain version here) against JAX's Pallas kernel in
interpret mode (``TILE`` 256), as ``tests/test_ops.py`` holds JAX's two
routes.  The designs' taps agree to 1e-5 of the max.  Two places are
ill-conditioned in float32, and each is also held in float64, where the
packages agree to 1e-9:

* an evaluated cascade of resonant sections (biquad2tf, probe_sos):
  XLA contracts the Horner steps into FMAs and PyTorch does not, which
  puts them up to 2e-5 apart: 1e-4 (the gradient bound);
* the PEQ's 'svf' design, whose 20 Hz shelf has a double pole within
  f = tan(pi 20 / 48000) = 1.3e-3 of z = 1 (a = [1 + 2 R f + f^2, ...]),
  so that one rounding step of a tap moves the response near DC by ~1e-3
  of its max, and a softplus-mapped delay of ~340 samples, one rounding
  step of which (3e-5 samples) turns the phase at Nyquist by 1e-4 rad:
  2e-3, the bound of the JAX package's PEQ 'svf' parity test
  (tests/test_parity.py)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu import functional as jf
from flamo_tpu import utils as ju
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch import functional as tf
from flamo_tpu_torch import utils as tu
from flamo_tpu_torch.processor import dsp

NFFT = 256
M = NFFT // 2 + 1
CPU = dict(device="cpu")
VAL_TOL = 1e-5
GRAD_TOL = 1e-4
CASCADE_TOL = 1e-4
ILL_TOL = 2e-3
F64_TOL = 1e-9


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the families: response and gradient on both routes
# ---------------------------------------------------------------------------
def _sos_params(rng, shape):
    """Well-conditioned direct SOS rows (K, 6, ...): poles of radius
    <= 0.6, a0 away from 1."""
    r = rng.uniform(0.2, 0.6, shape)
    th = rng.uniform(0, np.pi, shape)
    a0 = rng.uniform(0.5, 2.0, shape)
    a = np.stack([a0, -2 * r * np.cos(th) * a0, r * r * a0], axis=1)
    b = rng.normal(size=(shape[0], 3) + shape[1:])
    return np.concatenate([b, a], axis=1).astype(np.float32)


FAMILIES = {
    # name: (class, kwargs, route attribute or None (constructor))
    "Biquad_highpass": ("Biquad", dict(size=(2, 1), n_sections=2,
                                       filter_type="highpass",
                                       alias_decay_db=30)),
    "Biquad_lowpass": ("Biquad", dict(size=(1, 2), n_sections=3,
                                      filter_type="lowpass")),
    "Biquad_bandpass": ("Biquad", dict(size=(2, 2), n_sections=2,
                                       filter_type="bandpass")),
    "parallelBiquad": ("parallelBiquad", dict(size=(2,), n_sections=2,
                                              filter_type="highpass",
                                              alias_decay_db=30)),
    "SOSFilter": ("SOSFilter", dict(size=(2, 1), n_sections=3)),
    "parallelSOSFilter": ("parallelSOSFilter", dict(size=(2,),
                                                    n_sections=2)),
    "SVF_free": ("SVF", dict(size=(2, 1), n_sections=4, filter_type=None)),
    "SVF_peaking": ("SVF", dict(size=(1, 2), n_sections=2,
                                filter_type="peaking", alias_decay_db=20)),
    "SVF_lowshelf": ("SVF", dict(size=(1, 1), n_sections=2,
                                 filter_type="lowshelf")),
    "parallelSVF": ("parallelSVF", dict(size=(2,), n_sections=3,
                                        filter_type=None)),
    "PEQ_biquad": ("PEQ", dict(size=(2, 1), n_bands=4, design="biquad")),
    "PEQ_svf": ("PEQ", dict(size=(2, 1), n_bands=4, design="svf",
                            alias_decay_db=20)),
    "parallelPEQ_biquad": ("parallelPEQ", dict(size=(2,), n_bands=4,
                                               design="biquad")),
    "parallelPEQ_svf": ("parallelPEQ", dict(size=(2,), n_bands=3,
                                            design="svf")),
    # frozen: identity maps, so that the delays are the raw param x
    # fs / unit in both packages (its gradient is taken all the same)
    "GainDelay": ("GainDelay", dict(size=(2, 3), max_len=16, isint=False,
                                    alias_decay_db=10)),
    "GainDelay_int": ("GainDelay", dict(size=(2, 1), max_len=16,
                                        isint=True)),
    "GainDelay_softplus": ("GainDelay", dict(size=(2, 2), max_len=16,
                                             isint=False,
                                             requires_grad=True)),
    "parallelGainDelay": ("parallelGainDelay", dict(size=(3,), max_len=16,
                                                    isint=False)),
}
ILL_CONDITIONED = ("PEQ_svf", "parallelPEQ_svf", "GainDelay_softplus")
# the families that hold a cascade, on K4's route; the SOS and SVF
# families take the route as an attribute, the others as an argument
CASCADES = ["Biquad_highpass", "SOSFilter", "SVF_free", "parallelPEQ_svf"]


def _pair(name, backend: str = "xla", seed: int = 5, f64: bool = False):
    """The JAX module of ``name`` (its weights from ``seed``) and the port's
    holding the same raw param, both on ``backend``; with ``f64`` both in
    float64 (call under ``jax.enable_x64``)."""
    cls, kw = FAMILIES[name]
    kw = dict(kw, nfft=NFFT)
    trainable = cls in ("Biquad", "parallelBiquad", "SVF", "parallelSVF",
                        "PEQ", "parallelPEQ") or kw.get("requires_grad")
    if trainable:
        kw["requires_grad"] = True
    jkw, tkw = dict(kw), dict(kw, **CPU)
    if f64:
        jkw["dtype"], tkw["dtype"] = jnp.float64, torch.float64
    by_arg = cls.startswith(("Biquad", "parallelBiquad", "PEQ",
                             "parallelPEQ"))
    if by_arg:
        jkw["cascade_backend"] = tkw["cascade_backend"] = backend
    flamo_tpu.set_seed(seed)
    jm = getattr(jdsp, cls)(**jkw)
    if cls.endswith("SOSFilter"):
        jm = jm.assign_value(jnp.asarray(_sos_params(
            np.random.default_rng(seed), jm.param.shape[:1]
            + jm.param.shape[2:])))
    tm = getattr(dsp, cls)(**tkw)
    tm.assign_value(np.asarray(jm.param))
    if not trainable:
        tm.param.requires_grad_(True)
    if not by_arg and backend != "xla":
        jm.cascade_backend = backend
        tm.cascade_backend = backend
    return jm, tm


def _jax_refs(jm, r, x=None):
    """JAX's response, gradient of sum |H| r in the raw param, forward on
    ``x`` and matrix_response, through one jit (eager JAX compiles each
    operation anew)."""
    def f(p):
        m = jm.assign_value(p)
        H = m.response()
        aux = (H, m(x), m.matrix_response()[1]) if x is not None else (H,)
        return jnp.sum(jnp.abs(H) * r), aux

    (_, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jm.param)
    return g, aux


def _loss_pair(jm, tm, seed: int = 7, x=None):
    """Sum |H| r with random weights r on each package's response; the
    port's gradient lands in ``tm.param.grad``.  Returns (H, JAX's
    gradient, JAX's (H[, y, H_matrix]))."""
    r = np.random.default_rng(seed).uniform(
        0.5, 1.5, tuple(tm.response().shape))
    if tm.dtype == torch.float32:
        r = r.astype(np.float32)
    H = tm.response()
    torch.sum(torch.abs(H) * _t(r)).backward()
    jg, aux = _jax_refs(jm, r, x)
    return H, jg, aux


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax_xla(name):
    """Response, forward on a random spectrum, matrix_response and the
    gradient of sum |H| r in the raw param, on the 'xla' route."""
    jm, tm = _pair(name)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(1, M, tm.input_channels))
         + 1j * rng.normal(size=(1, M, tm.input_channels))).astype(
        np.complex64)
    H, jg, (jH, jy, jHm) = _loss_pair(jm, tm, x=jnp.asarray(x))
    val_tol, grad_tol = ((ILL_TOL, ILL_TOL) if name in ILL_CONDITIONED
                         else (VAL_TOL, GRAD_TOL))
    assert tuple(H.shape) == jH.shape
    assert _rel(H.detach().numpy(), jH) < val_tol, name
    assert _rel(tm.param.grad.numpy(), jg) < grad_tol, name
    y = tm(_t(x)).detach().numpy()
    assert _rel(y, jy) < val_tol
    kind, Hm = tm.matrix_response()
    diag = type(jm).matrix_response is jdsp._mr_diag
    assert kind == ("diag" if diag else "full")
    assert _rel(Hm.detach().numpy(), jHm) < val_tol


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """JAX's Pallas kernels through the interpreter, TILE = 256."""
    import flamo_tpu.ops.pallas_solve as ps
    from jax.experimental import pallas as pl

    monkeypatch.setattr(ps.pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(ps, "TILE", 256)
    return ps


@pytest.mark.parametrize("name", CASCADES)
def test_family_matches_jax_pallas(name, pallas_interpret):
    """The 'pallas' route: the port's K4 wrapper (its plain version on the
    CPU) against JAX's K4 interpreted, response and tap gradient, and
    against the port's own 'xla' route."""
    jm, tm = _pair(name, "pallas")
    H, jg, (jH,) = _loss_pair(jm, tm)
    val_tol, grad_tol = ((ILL_TOL, ILL_TOL) if name in ILL_CONDITIONED
                         else (VAL_TOL, GRAD_TOL))
    assert _rel(H.detach().numpy(), jH) < val_tol, name
    assert _rel(tm.param.grad.numpy(), jg) < grad_tol, name
    _, tx = _pair(name, "xla")
    assert _rel(H.detach().numpy(), tx.response().detach().numpy()) < VAL_TOL


def test_pallas_route_goes_through_k4_and_raises_on_float64(monkeypatch):
    """On the 'pallas' route a family's response is the K4 wrapper's, the
    channel dims folded into its channel axis; a float64 family raises
    through the wrapper's check and never falls back; an unknown route
    raises at construction."""
    from flamo_tpu_torch.ops import sos_kernels as sk

    seen = []
    fwd = sk.sos_cascade_fwd_kernel

    def spy(b, a, nfft, bin_offset=None):
        seen.append(tuple(b.shape))
        return fwd(b, a, nfft, bin_offset)

    monkeypatch.setattr(sk, "sos_cascade_fwd_kernel", spy)
    pe = dsp.PEQ(size=(2, 3), n_bands=4, nfft=NFFT, cascade_backend="pallas",
                 **CPU)
    assert tuple(pe.response().shape) == (M, 2, 3)
    sv = dsp.SVF(size=(2, 1), n_sections=3, nfft=NFFT, **CPU)
    sv.cascade_backend = "pallas"
    sv.response()
    assert seen == [(3, 4, 6), (3, 3, 2)]
    bq = dsp.Biquad(size=(1, 1), nfft=NFFT, cascade_backend="pallas",
                    dtype=torch.float64, **CPU)
    with pytest.raises(TypeError, match="float32"):
        bq.response()
    with pytest.raises(ValueError, match="cascade_backend"):
        dsp.Biquad(nfft=NFFT, cascade_backend="cuda", **CPU)


# ---------------------------------------------------------------------------
# the coefficient designs
# ---------------------------------------------------------------------------
def _design_args(rng):
    fc = rng.uniform(100, 20000, (3, 2)).astype(np.float32)
    return dict(
        lowpass=((fc, rng.uniform(-6, 6, (3, 2)).astype(np.float32)), {}),
        highpass=((fc, rng.uniform(-6, 6, (3, 2)).astype(np.float32)), {}),
        prop_shelving_low=((fc, rng.uniform(-9, 9, (3, 2))
                            .astype(np.float32)), dict(type="low")),
        prop_shelving_high=((fc, rng.uniform(-9, 9, (3, 2))
                             .astype(np.float32)), dict(type="high")),
        prop_peak=((fc, (fc / 3).astype(np.float32),
                    rng.uniform(-9, 9, (3, 2)).astype(np.float32)), {}),
        svf_free=((fc, rng.uniform(0.2, 1.2, (3, 2)).astype(np.float32)),
                  dict(m=rng.uniform(-1, 1, (3, 2, 3)).astype(np.float32),
                       filter_type=None)),
        svf_lowshelf=((fc, rng.uniform(0.2, 1.2, (3, 2)).astype(np.float32)),
                      dict(G=rng.uniform(0.3, 2, (3, 2)).astype(np.float32),
                           filter_type="lowshelf")),
        svf_peaking=((fc, rng.uniform(0.2, 1.2, (3, 2)).astype(np.float32)),
                     dict(G=rng.uniform(0.3, 2, (3, 2)).astype(np.float32),
                          filter_type="peaking")),
        svf_highpass=((fc, rng.uniform(0.2, 1.2, (3, 2)).astype(np.float32)),
                      dict(filter_type="highpass")),
    )


_DESIGNS = {"lowpass": "lowpass_filter", "highpass": "highpass_filter",
            "prop_shelving_low": "prop_shelving_filter",
            "prop_shelving_high": "prop_shelving_filter",
            "prop_peak": "prop_peak_filter", "svf_free": "svf",
            "svf_lowshelf": "svf", "svf_peaking": "svf", "svf_highpass": "svf"}


@pytest.mark.parametrize("case", sorted(_DESIGNS))
def test_designs_match_jax(case):
    """Each design's (b, a) and their cascade's biquad2tf response."""
    args, kw = _design_args(np.random.default_rng(0))[case]
    name = _DESIGNS[case]
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    b, a = getattr(tf, name)(*map(_t, args), fs=48000, **tkw)
    jb, ja = getattr(jf, name)(*map(jnp.asarray, args), fs=48000, **kw)
    assert tuple(b.shape) == jb.shape and tuple(a.shape) == ja.shape
    assert _rel(b.numpy(), jb) < VAL_TOL and _rel(a.numpy(), ja) < VAL_TOL
    if b.shape[0] == 3:  # biquad2tf on JAX's taps, one section and three
        jb, ja = np.asarray(jb), np.asarray(ja)
        for sl, tol in ((np.s_[:, 0, 0], VAL_TOL),
                        (np.s_[:, :, 0], CASCADE_TOL)):
            H = tf.biquad2tf(_t(jb[sl]), _t(ja[sl]), NFFT)
            assert _rel(H.numpy(), jf.biquad2tf(jb[sl], ja[sl],
                                                NFFT)) < tol


# ---------------------------------------------------------------------------
# RegularGridInterpolator and probe_sos
# ---------------------------------------------------------------------------
def test_regular_grid_interpolator_matches_jax():
    """Values and the gradient in the values on a 1-D and a 2-D grid, at
    points between nodes, on nodes (the both-zero case) and outside the
    grid; a 1-D grid with trailing value columns interpolates each column
    as its own 1-D grid would."""
    rng = np.random.default_rng(1)
    p1 = np.linspace(0, 1, 11).astype(np.float32)
    p2 = np.linspace(-2, 2, 7).astype(np.float32)
    v = rng.normal(size=(11, 7)).astype(np.float32)
    x1 = np.array([0.0, 0.05, 0.1, 0.33, 1.0, 1.2, -0.1], np.float32)
    x2 = np.array([-2.0, 0.1, 0.0, 1.9, 2.0, 3.0, -2.5], np.float32)
    w = rng.normal(size=7).astype(np.float32)

    def ours(values, pts):
        return tu.RegularGridInterpolator([_t(q) for q in pts], values)(
            [_t(x) for x in (x1, x2)[:len(pts)]])

    def theirs(values, pts):
        return ju.RegularGridInterpolator([jnp.asarray(q) for q in pts],
                                          values)(
            [jnp.asarray(x) for x in (x1, x2)[:len(pts)]])

    for values, pts in ((v[:, 0], (p1,)), (v, (p1, p2))):
        vt = _t(values).requires_grad_(True)
        y = ours(vt, pts)
        jy = theirs(jnp.asarray(values), pts)
        assert _rel(y.detach().numpy(), jy) < VAL_TOL
        torch.sum(y * _t(w)).backward()
        jg = jax.grad(lambda q: jnp.sum(theirs(q, pts) * w))(
            jnp.asarray(values))
        assert np.all(np.isfinite(vt.grad.numpy()))
        assert _rel(vt.grad.numpy(), jg) < VAL_TOL
    cols = tu.RegularGridInterpolator([_t(p1)], _t(v))([_t(x1)])
    for j in range(v.shape[1]):
        assert _rel(cols[:, j].numpy(), theirs(jnp.asarray(v[:, j]),
                                               (p1,))) < VAL_TOL


def test_probe_sos_matches_jax():
    """G (dB at the control frequencies, interpolated per band in one
    gather), H and W against JAX's vmap over bands."""
    rng = np.random.default_rng(2)
    b, a = jf.peak_filter(jnp.asarray([100.0, 1000.0, 8000.0]),
                          jnp.asarray([2.0, 0.5, 3.0]),
                          jnp.asarray([1.0, 2.0, 0.7]))
    sos = np.concatenate([np.asarray(b), np.asarray(a)], axis=0) \
        * rng.uniform(0.5, 2.0, (1, 3)).astype(np.float32)
    ctrl = np.array([31.25, 125.0, 1000.0, 8000.0, 16000.0], np.float32)
    G, H, W = tf.probe_sos(_t(sos), _t(ctrl), NFFT, 48000)
    jG, jH, jW = jax.jit(jf.probe_sos, static_argnums=(2, 3))(
        sos, ctrl, NFFT, 48000)
    assert tuple(G.shape) == jG.shape == (5, 3)
    assert _rel(H.numpy(), jH) < CASCADE_TOL and _rel(W.numpy(), jW) < VAL_TOL
    assert np.max(np.abs(G.numpy() - np.asarray(jG))) < 1e-3  # dB
    with jax.enable_x64(True):
        G, H, _ = tf.probe_sos(_t(sos.astype(np.float64)), _t(ctrl), NFFT,
                               48000, dtype=torch.float64)
        jG, jH, _ = jax.jit(partial(jf.probe_sos, dtype=jnp.float64),
                            static_argnums=(2, 3))(
            sos.astype(np.float64), ctrl, NFFT, 48000)
        assert _rel(H.numpy(), jH) < F64_TOL
        assert np.max(np.abs(G.numpy() - np.asarray(jG))) < F64_TOL


@pytest.mark.parametrize("name", ILL_CONDITIONED)
def test_ill_conditioned_families_match_jax_in_float64(name):
    """The families whose float32 results are held to ILL_TOL agree with
    JAX's to F64_TOL in float64, response and gradient."""
    with jax.enable_x64(True):
        jm, tm = _pair(name, f64=True)
        H, jg, (jH,) = _loss_pair(jm, tm)
        assert H.dtype == torch.complex128 and jH.dtype == jnp.complex128
        assert _rel(H.detach().numpy(), jH) < F64_TOL, name
        assert _rel(tm.param.grad.numpy(), jg) < F64_TOL, name



@pytest.mark.parametrize("boundary", ["fc_low", "fc_high", "gain"])
def test_biquad_clip_boundary_gradient_is_half(boundary):
    """A raw fc exactly at 0 or 1, or a gain at exactly +60 dB, sits on
    the map's clip bound, where jnp.clip's gradient is 1/2: the port's
    (``_clip``) must give JAX's, not torch.clamp's 1."""
    flamo_tpu.set_seed(11)
    jm = jdsp.Biquad(size=(1, 1), n_sections=1, filter_type="lowpass",
                     nfft=NFFT, requires_grad=True)
    p = np.array(jm.param)
    if boundary == "fc_low":
        p[0, 0] = 0.0
    elif boundary == "fc_high":
        p[0, 0] = 1.0
    else:
        p[0, 1] = 1000.0  # 20 log10(1000) = 60 dB
    jm = jm.assign_value(jnp.asarray(p))
    tm = dsp.Biquad(size=(1, 1), n_sections=1, filter_type="lowpass",
                    nfft=NFFT, requires_grad=True, **CPU).assign_value(p)
    i = 1 if boundary == "gain" else 0
    mapped = tm.map(tm.param)
    torch.sum(mapped[:, i]).backward()
    jg = jax.grad(lambda q: jnp.sum(jm.map(q)[:, i]))(jm.param)
    g = tm.param.grad.numpy()
    if boundary == "gain":
        np.testing.assert_allclose(g[0, 1], np.asarray(jg)[0, 1], rtol=1e-6)
        np.testing.assert_allclose(g[0, 1] * 1000 * np.log(10) / 20, 0.5,
                                   rtol=1e-5)
    else:
        assert g[0, 0] == np.asarray(jg)[0, 0] == 0.5
    # and through the response, against JAX's jitted one: fc = 1 is a tie
    # there too (at fc = 0 the lowpass is zero at every bin, where |H| has
    # no gradient; a gain's dB comes from log10, whose last bit the jitted
    # XLA kernel rounds otherwise than eager JAX, so the tie moves)
    if boundary == "fc_high":
        tm.param.grad = None
        _, jg2, _ = _loss_pair(jm, tm)
        assert _rel(tm.param.grad.numpy(), jg2) < GRAD_TOL


def test_construction_checks_and_init():
    """The families' shape checks carry JAX's messages; the initial
    parameters follow JAX's rules (a bandpass's fc2 >= max fc1, SOS
    identity rows, GainDelay unit gains)."""
    with pytest.raises(AssertionError, match="Invalid filter type"):
        dsp.Biquad(filter_type="notch", nfft=NFFT, **CPU)
    with pytest.raises(AssertionError, match="Invalid filter type"):
        dsp.SVF(filter_type="allpass", nfft=NFFT, **CPU)
    with pytest.raises(AssertionError, match="expected \\(K, 6, N\\)"):
        dsp.parallelSOSFilter(size=(2, 3), nfft=NFFT, **CPU)
    with pytest.raises(AssertionError, match="shape \\(2, N_out, N_in\\)"):
        dsp.GainDelay(size=(2,), nfft=NFFT, **CPU)
    bp = dsp.Biquad(size=(2, 2), n_sections=3, filter_type="bandpass",
                    nfft=NFFT, generator=torch.Generator().manual_seed(0),
                    **CPU)
    p = bp.param.detach()
    assert bool((p[:, 1] >= p[:, 0].max()).all()) and bool(
        (p[:, 0] < 0.5).all())
    sos = dsp.SOSFilter(size=(1, 2), n_sections=2, nfft=NFFT, **CPU)
    assert torch.allclose(sos.response(), torch.ones((M, 1, 2),
                                                     dtype=torch.complex64))
    gd = dsp.GainDelay(size=(2, 3), nfft=NFFT, isint=True, **CPU)
    assert bool((gd.param[0] == 1).all()) and gd.order == 2001
    pe = dsp.PEQ(n_bands=5, nfft=NFFT, **CPU)
    np.testing.assert_allclose(pe.center_freq_bias,
                               jdsp.PEQ(n_bands=5, nfft=NFFT)
                               .center_freq_bias, rtol=0)
