"""The trainable delay-scaled attenuation families of
``auxiliary/reverb.py`` against flamo_tpu on the CPU: ``parallelFDNGEQ``,
``parallelFDNPEQ`` (both designs, two-stage, proportional) and
``parallelFirstOrderShelving``, from the same raw parameters (RT60s in
seconds); the accurate ``parallelFDNAccurateGEQ``/``parallelGFDNAccurateGEQ``
are held in ``test_torch_accurate_geq.py``.

Tolerances: responses and probes 1e-5, gradients 1e-4 of the max, except
a cascade of 12 or more sections (the octave GEQ, the accurate GEQ), held
at the JAX package's GEQ bounds, 5e-3 and 1e-3: in float32 such a
cascade is ill-conditioned near DC, and XLA's fused Horner steps round
there otherwise than PyTorch's; and the PEQ, whose ~20 Hz shelf is
ill-conditioned in float32 too, held to the JAX package's PEQ bound 2e-3
and to 1e-9 in float64.  The accurate taps are held to JAX's float64
design (x64 on) at 1e-6 (``test_torch_accurate_geq.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu.auxiliary import reverb as jrev
from flamo_tpu_torch.auxiliary import reverb as trev
from test_torch_reverb import (CPU, DELAYS4, NFFT, M, VAL_TOL, GRAD_TOL,
                               _rel, _t)

GEQ_VAL_TOL, GEQ_GRAD_TOL = 5e-3, 1e-3
# the bound of the JAX package's PEQ parity test (tests/test_parity.py)
ILL_TOL = 2e-3
F64_TOL = 1e-9


# ---------------------------------------------------------------------------
# the delay-scaled attenuation families
# ---------------------------------------------------------------------------
# (design, is_twostage, is_proportional)
PEQ_CASES = [("biquad", False, False), ("biquad", True, False),
             ("svf", False, True)]


def _atten_pair(name, case=None, dtype=torch.float32):
    """(JAX module, the port's module with its param) in ``dtype``."""
    flamo_tpu.set_seed(3)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    common = dict(nfft=NFFT, fs=48000, delays=DELAYS4, alias_decay_db=30.0)
    if name == "geq":
        kw = dict(octave_interval=1, requires_grad=True, **common)
        jm, tm = jrev.parallelFDNGEQ, trev.parallelFDNGEQ
    elif name == "shelving":
        kw = dict(requires_grad=True, **common)
        jm, tm = (jrev.parallelFirstOrderShelving,
                  trev.parallelFirstOrderShelving)
    else:
        design, two, prop = case
        kw = dict(n_bands=6, design=design, is_twostage=two,
                  is_proportional=prop, requires_grad=True, **common)
        jm, tm = jrev.parallelFDNPEQ, trev.parallelFDNPEQ
    jm, tm = jm(dtype=jdtype, **kw), tm(dtype=dtype, **kw, **CPU)
    if name == "shelving":  # a DC RT60 and a crossover in range
        jm = jm.assign_value(jnp.asarray([0.9, 1.1], jdtype))
    tm.assign_value(np.asarray(jm.param))
    return jm, tm


def _jax_grad_and_refs(jm, r, z):
    """JAX's gradient of sum |H| r, H, the matrix response and the probe
    at z, in one jit."""
    def f(p):
        m = jm.assign_value(p)
        H = m.response()
        return jnp.sum(jnp.abs(H) * r), (H, m.matrix_response()[1],
                                         m.probe(z))

    (_, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jm.param)
    return (np.asarray(g), *(np.asarray(a) for a in aux))


def _port_grad(tm, r):
    H = tm.response()
    torch.sum(torch.abs(H) * _t(r)).backward()
    return H.detach(), tm.param.grad


@pytest.mark.parametrize("name,case", [("geq", None), ("shelving", None)]
                         + [("peq", c) for c in PEQ_CASES])
def test_trainable_attenuations_match_jax(name, case):
    """Response, matrix response (diagonal), gradient of sum |H| r in the
    raw param, probe at a point of the unit circle, forward.  The PEQ's
    band 0 is a shelf at ~20 Hz, whose double zero and pole near z = 1 are
    ill-conditioned in float32: both packages lie ~7e-4 of the max from a
    float64 evaluation of the same taps there, so the PEQ is held to
    ILL_TOL here and to 1e-9 in float64
    (test_peq_attenuation_in_float64)."""
    jm, tm = _atten_pair(name, case)
    assert tm.input_channels == tm.output_channels == 4
    r = np.random.default_rng(1).uniform(0.5, 1.5, (M, 4)).astype(np.float32)
    z = np.exp(1j * 0.37)
    jg, jH, jHm, jP = _jax_grad_and_refs(jm, r, z)
    H, g = _port_grad(tm, r)
    val_tol, grad_tol = {"geq": (GEQ_VAL_TOL, GEQ_GRAD_TOL),
                         "peq": (ILL_TOL, ILL_TOL)}.get(
                             name, (VAL_TOL, GRAD_TOL))
    assert H.shape == jH.shape == (M, 4)
    assert bool(torch.isfinite(H).all())
    assert _rel(H, jH) < val_tol
    assert _rel(g, jg) < grad_tol
    kind, Hm = tm.matrix_response()
    assert kind == "diag" and torch.equal(Hm.detach(), H)
    P = tm.probe(torch.tensor(z))
    assert P.shape == (4, 4) and _rel(P.detach(), jP) < val_tol
    x = torch.randn((2, M, 4), dtype=torch.complex64)
    assert torch.allclose(tm(x), H[None] * x)


def test_proportional_twostage_peq_stays_finite():
    """The proportional two-stage PEQ's global shelf takes -30 dB times
    each delay length (thousands of dB): its numerator underflows to 0 and
    its denominator's unscaled products overflow, so JAX returns NaN at
    the longer lines' bins, where the port's products, rescaled after
    every section, give the ratio 0 (ROADMAP queue 3, F5); elsewhere the
    two agree."""
    jm, tm = _atten_pair("peq", ("biquad", True, True))
    jH = np.asarray(jax.jit(lambda m: m.response())(jm))
    with torch.no_grad():
        H = tm.response()
    assert np.isnan(jH).any() and bool(torch.isfinite(H).all())
    assert _rel(H, jH) < ILL_TOL


@pytest.mark.parametrize("case", PEQ_CASES[2:])
def test_peq_attenuation_in_float64(case):
    """The PEQ attenuation in float64 (x64 on in JAX): response and
    gradient to F64_TOL of the max."""
    r = np.random.default_rng(1).uniform(0.5, 1.5, (M, 4))
    with jax.enable_x64(True):
        jm, tm = _atten_pair("peq", case, dtype=torch.float64)
        jg, jH, _, _ = _jax_grad_and_refs(jm, r, np.exp(1j * 0.37))
    H, g = _port_grad(tm, r)
    assert H.dtype == torch.complex128
    assert _rel(H, jH) < F64_TOL and _rel(g, jg) < F64_TOL


def test_attenuation_errors_and_io():
    for cls in (trev.parallelFDNGEQ, trev.parallelFDNAccurateGEQ,
                trev.parallelFDNPEQ, trev.parallelFirstOrderShelving):
        with pytest.raises(AssertionError, match="Delays must be provided"):
            cls(**CPU)
    with pytest.raises(AssertionError, match="biquad or svf"):
        trev.parallelFDNPEQ(delays=DELAYS4, design="rbj", **CPU)
    with pytest.raises(ValueError, match="cascade_backend"):
        trev.parallelFDNAccurateGEQ(delays=DELAYS4, cascade_backend="cuda",
                                    **CPU)
    m = trev.parallelFDNPEQ(delays=DELAYS4, is_proportional=True,
                            is_twostage=True, **CPU)
    assert m.param.shape == (11, 3, 1) and m.output_channels == 4
