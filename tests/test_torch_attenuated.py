"""The port's attenuated FDN and its GEQ held against flamo_tpu's, on the
CPU.

Both models are built at nfft=512 with delays (89, 97, 107) from
``flamo_tpu.set_seed(13)``; the JAX model's weights are carried into the
port with ``load_jax_params``.  The JAX side runs its graph path
(solve_method='ge', cascade_backend='xla'); the port each of its routes,
with the kernels' plain versions standing in for the CUDA kernels (K2
and K4 for solve_method='pallas' + cascade_backend='pallas', K5 for the
fused step).  PyTorch's gradients of the real parameters equal JAX's
cotangents directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
import flamo_tpu.models as jm
from flamo_tpu.models import attenuated_fdn as jatt
from flamo_tpu_torch.auxiliary.eq import eq_freqs, geq
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.models import (attenuated_loss,
                                    attenuated_loss_fused_step,
                                    attenuated_train_step,
                                    build_attenuated_fdn,
                                    build_colorless_sfdn)
from flamo_tpu_torch.processor import dsp, system

NFFT = 512
M = NFFT // 2 + 1
DELAYS = (89, 97, 107)
TRAINABLE = (".core.modules[0].param",
             ".core.modules[1].feedback.modules[0].param",
             ".core.modules[1].feedback.modules[1].param",
             ".core.modules[2].param")


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _pair(seed: int = 13, **kw):
    """(JAX model on its graph path, port model with the JAX weights and
    the routes ``kw``)."""
    cache = kw.pop("cache_delays", False)
    flamo_tpu.set_seed(seed)
    mj = jm.build_attenuated_fdn(nfft=NFFT, delays=DELAYS,
                                 cache_delays=cache)
    mt = build_attenuated_fdn(nfft=NFFT, delays=DELAYS, cache_delays=cache,
                              device="cpu", **kw)
    return mj, load_jax_params(mt, _jax_params(mj))


def _io_jax():
    return (jnp.zeros((1, NFFT, 1)).at[:, 0, :].set(1.0),
            jnp.ones((1, M, 1)))


def _io_torch():
    x = torch.zeros((1, NFFT, 1))
    x[:, 0, :] = 1.0
    return x, torch.ones((1, M, 1))


def _jax_loss_and_grads(mj):
    loss, g = jax.jit(jax.value_and_grad(jatt.attenuated_loss))(
        mj, *_io_jax())
    return float(loss), _jax_params(g)


def _port_loss_and_grads(mt, loss_fn):
    mt.zero_grad(set_to_none=True)
    loss = loss_fn(mt, *_io_torch())
    loss.backward()
    named = jax_named_tensors(mt)
    return float(loss.detach()), {k: named[k].grad.numpy() for k in TRAINABLE}


@pytest.fixture(scope="module")
def jax_reference():
    flamo_tpu.set_seed(13)
    mj = jm.build_attenuated_fdn(nfft=NFFT, delays=DELAYS)
    return _jax_loss_and_grads(mj)


# ---------------------------------------------------------------------------
# the GEQ
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interval", [1, 3])
def test_eq_freqs_and_geq_match_jax(interval):
    from flamo_tpu.auxiliary.eq import eq_freqs as jeq_freqs, geq as jgeq

    cj, sj = jeq_freqs(interval=interval)
    ct, st = eq_freqs(interval=interval)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    rng = np.random.default_rng(interval)
    gains = rng.uniform(-12, 6, size=(len(cj) + 3, 4)).astype(np.float32)
    bt, at = geq(ct, st, 2.7, torch.tensor(gains))
    assert bt.shape == at.shape == (3, len(cj) + 3, 4)
    # the port takes the batch, JAX one vector a call: vmap over channels
    bj, aj = jax.jit(jax.vmap(lambda g: jgeq(cj, sj, 2.7, g), in_axes=1,
                              out_axes=-1))(jnp.asarray(gains))
    assert _rel(bt.numpy(), np.asarray(bj)) < 1e-6
    assert _rel(at.numpy(), np.asarray(aj)) < 1e-6


@pytest.fixture(scope="module")
def geq_reference():
    """A seeded JAX parallelGEQ's command gains, response and the gradient
    of sum |H|^2 in the gains."""
    from flamo_tpu.processor import dsp as jdsp

    flamo_tpu.set_seed(9)
    gj = jdsp.parallelGEQ(size=(3,), octave_interval=1, nfft=NFFT,
                          fs=48000, requires_grad=True)

    def loss_j(p):
        H = gj.assign_value(p).response()
        return jnp.sum(jnp.abs(H) ** 2), H

    (_, Hj), grad_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        gj.param)
    return np.array(gj.param), np.asarray(Hj), np.asarray(grad_j)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_parallel_geq_response_matches_jax(geq_reference, backend):
    """parallelGEQ's response and the gradient of sum |H|^2 in its command
    gains, both port backends ('pallas': K4's plain version here) against
    the JAX package's 'xla' backend.  The same float32 operations on both
    sides, but near DC the 12-section cascade is ill-conditioned: the
    last-bit differences of the band design (tan, log) and of the complex
    products reach 5e-4 of a bin's value at bin 1, even from identical
    taps and phasors.  So the bounds are the JAX package's own for its
    two GEQ backends (test_ops.py's test_geq_pallas_cascade_backend):
    5e-3 of the max on the values, 1e-3 on the gradients."""
    param, Hj, grad_j = geq_reference
    gt = dsp.parallelGEQ(size=(3,), octave_interval=1, nfft=NFFT, fs=48000,
                         requires_grad=True, cascade_backend=backend,
                         device="cpu")
    gt.assign_value(param)
    Ht = gt.response()
    assert Ht.shape == (M, 3)
    assert _rel(Ht.detach().numpy(), Hj) < 5e-3
    kind, Hm = gt.matrix_response()
    assert kind == "diag" and Hm.shape == (M, 3)
    torch.sum(torch.abs(Ht) ** 2).backward()
    assert _rel(gt.param.grad.numpy(), grad_j) < 1e-3


def test_geq_poly_coeff_sections_match_the_cascade():
    """get_poly_coeff's per-section responses give the cascade response
    through _iir_eps_guard, and a full GEQ applies it per bin."""
    g = torch.Generator().manual_seed(3)
    geq_full = dsp.GEQ(size=(2, 2), nfft=64, generator=g, device="cpu")
    H, B, A = geq_full.get_poly_coeff(geq_full.map(geq_full.param))
    assert B.shape == A.shape == (33, 12, 2, 2)
    assert _rel(dsp._iir_eps_guard(B, A).numpy(), H.numpy()) < 1e-5
    assert geq_full.matrix_response()[0] == "full"
    x = torch.randn((1, 33, 2), dtype=torch.complex64, generator=g)
    y = geq_full(x)
    assert _rel(y.numpy(), torch.einsum("fmn,bfn->bfm", H, x).numpy()) \
        < 1e-6


def test_filter_fir_response_matches_jax():
    """The FIR Filter that GEQ builds on: rfft of the enveloped taps."""
    from flamo_tpu.processor import dsp as jdsp

    taps = np.random.default_rng(6).normal(size=(5, 2, 3)).astype(np.float32)
    fj = jdsp.Filter(size=(5, 2, 3), nfft=64, alias_decay_db=20.0)
    fj = fj.assign_value(jnp.asarray(taps))
    ft = dsp.Filter(size=(5, 2, 3), nfft=64, alias_decay_db=20.0,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    ft.assign_value(taps)
    assert ft.matrix_response()[0] == "full"
    assert _rel(ft.response().numpy(), np.asarray(fj.response())) < 1e-6
    x = np.random.default_rng(7).normal(size=(1, 33, 3)).astype(np.complex64)
    assert _rel(ft(torch.tensor(x)).numpy(), np.asarray(fj(jnp.asarray(x)))) \
        < 1e-6


def test_geq_construction_errors_match_jax():
    from flamo_tpu.processor import dsp as jdsp

    g = torch.Generator().manual_seed(0)
    with pytest.raises(AssertionError) as ej:
        jdsp.parallelGEQ(size=(3, 3), nfft=64)
    with pytest.raises(AssertionError) as et:
        dsp.parallelGEQ(size=(3, 3), nfft=64, generator=g, device="cpu")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        jdsp.parallelGEQ(size=(3,), nfft=64, cascade_backend="cuda")
    with pytest.raises(ValueError) as et:
        dsp.parallelGEQ(size=(3,), nfft=64, cascade_backend="cuda",
                        generator=g, device="cpu")
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("routes", [
    dict(),
    dict(solve_method="pallas", cascade_backend="pallas"),
], ids=["ge-xla", "pallas-pallas"])
def test_graph_loss_and_grads_match_jax(jax_reference, routes):
    """The graph path against the JAX graph path: the 'ge'/'xla' route
    runs the same float32 operations (1e-5 on the loss, 1e-4 of the max
    on the gradients); the K2 + K4 route (plain versions here) folds the
    GEQ into the loop diagonal and takes K4's tap sums, so it is held to
    the JAX package's fused-vs-graph bounds (1e-4, 5e-3)."""
    lj, gj = jax_reference
    _, mt = _pair(**routes)
    lt, gt = _port_loss_and_grads(mt, attenuated_loss)
    loss_tol, grad_tol = (1e-5, 1e-4) if not routes else (1e-4, 5e-3)
    assert abs(lt - lj) / lj < loss_tol
    for k in TRAINABLE:
        assert _rel(gt[k], gj[k]) < grad_tol, k


@pytest.mark.parametrize("pivot", [False, True])
def test_fused_step_matches_jax_graph(jax_reference, pivot):
    """The fused step (K5's plain version) against the JAX graph loss, to
    the JAX package's own fused-vs-graph tolerances (1e-4 on the loss,
    5e-3 of the max on the gradients, test_ops.py's
    test_attenuated_fused_step_loss_matches)."""
    lj, gj = jax_reference
    _, mt = _pair(cache_delays=True)
    lt, gt = _port_loss_and_grads(
        mt, lambda m, x, t: attenuated_loss_fused_step(m, x, t, pivot=pivot))
    assert abs(lt - lj) / lj < 1e-4
    for k in TRAINABLE:
        assert _rel(gt[k], gj[k]) < 5e-3, k


def test_train_step_lockstep_with_jax_adam():
    """Five Adam steps at lr 1e-4: the port's fused step (plain K5)
    against the JAX graph-path train step.  Loss history to 1e-4
    relative; parameters to 1e-5 of their max (an Adam step moves a
    parameter by at most ~lr, so a 5e-3 relative gradient error moves it
    by far less than float32's resolution of the weights)."""
    mj, mt = _pair(cache_delays=True)
    step_j, opt_j = jatt.attenuated_train_step(mj, lr=1e-4,
                                               fused_step=False)
    step_j = jax.jit(step_j)
    x, t = _io_jax()
    hist_j = []
    for _ in range(5):
        mj, opt_j, loss = step_j(mj, opt_j, x, t)
        hist_j.append(float(loss))
    step_t, _ = attenuated_train_step(mt, lr=1e-4, fused_step=True)
    xt, tt = _io_torch()
    hist_t = [float(step_t(xt, tt)) for _ in range(5)]
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    assert hist_t[-1] < hist_t[0]
    pj = _jax_params(mj)
    named = jax_named_tensors(mt)
    assert sorted(named) == sorted(pj)
    for k in pj:
        assert _rel(named[k].detach().numpy(), pj[k]) < 1e-5, k


def test_recursion_pallas_folds_the_geq_into_k2(monkeypatch):
    """solve_method='pallas' hands K2 the diagonal D Gam (delays times
    the GEQ response) and the mixing matrix; 'ge' assembles the full
    loop I - diag(D Gam) U per bin."""
    _, mt = _pair(solve_method="pallas")
    loop = mt.core.feedback_loop
    D = loop.feedforward.matrix_response()[1]
    Gam = loop.feedback.attenuation.response()
    U = loop.feedback.mixing_matrix.matrix_response()[1]
    seen = {}

    def spy_k2(Dk, Uk, B):
        seen["k2"] = (Dk, Uk)
        return torch.zeros_like(B)

    def spy_ge(A, B, method="ge"):
        seen["ge"] = A
        return torch.zeros_like(B)

    x = torch.ones((1, M, 3), dtype=torch.complex64)
    monkeypatch.setattr(system, "fdn_solve", spy_k2)
    monkeypatch.setattr(system, "closed_loop_solve", spy_ge)
    with torch.no_grad():
        loop(x)
        assert "ge" not in seen
        loop.solve_method = "ge"
        loop(x)
    Dk, Uk = seen["k2"]
    assert _rel(Dk.numpy(), (D * Gam).detach().numpy()) < 1e-6
    assert _rel(Uk.numpy(), U.detach().numpy()) < 1e-6
    A_ref = (torch.eye(3, dtype=torch.complex64)
             - (D * Gam)[:, :, None] * U[None].to(torch.complex64))
    assert seen["ge"].shape == (1, M, 3, 3)
    assert _rel(seen["ge"][0].numpy(), A_ref.detach().numpy()) < 1e-6


def test_load_jax_params_reaches_series_geq_and_cache():
    """The JAX key paths of the attenuated FDN (a Series inside
    Recursion.feedback, the GEQ's (K, N) gains, the cached delay
    response) all land in the port."""
    for cache in (False, True):
        flamo_tpu.set_seed(1)
        pj = _jax_params(jm.build_attenuated_fdn(nfft=NFFT, delays=DELAYS,
                                                 cache_delays=cache))
        mt = build_attenuated_fdn(nfft=NFFT, delays=DELAYS,
                                  cache_delays=cache, device="cpu")
        named = jax_named_tensors(mt)
        assert sorted(named) == sorted(pj)
        assert named[TRAINABLE[2]].shape == (12, 3)
        if cache:
            assert ".core.modules[1].feedforward.H_re" in named
        load_jax_params(mt, pj)
        for k, v in jax_named_tensors(mt).items():
            np.testing.assert_array_equal(v.detach().numpy(), pj[k])


@pytest.mark.parametrize("solve_method", ["pallas", "ge"])
def test_recursion_evaluates_the_feedback_once(monkeypatch, solve_method):
    """One loop solve evaluates the GEQ (and the mixing matrix's expm)
    once, and a non-Series feedback that the FDN split declines (the
    scattering matrix, solved by K6 under 'pallas') once too: PyTorch
    runs eagerly, so a response computed for a branch that is not taken
    is paid for, not discarded as under jit."""
    _, mt = _pair(solve_method=solve_method)
    sfdn = build_colorless_sfdn(nfft=NFFT, delays=(31, 37, 41), n_stages=2,
                                solve_method=solve_method, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    calls = {"geq": 0, "matrix": 0, "scattering": 0}
    geq_response = dsp.parallelGEQ.response
    matrix_response = dsp.Matrix.matrix_response
    scattering_response = dsp.ScatteringMatrix.response

    def count_geq(self, *ext_param):
        calls["geq"] += 1
        return geq_response(self, *ext_param)

    def count_matrix(self):
        calls["matrix"] += 1
        return matrix_response(self)

    def count_scattering(self, *ext_param):
        calls["scattering"] += 1
        return scattering_response(self, *ext_param)

    monkeypatch.setattr(dsp.parallelGEQ, "response", count_geq)
    monkeypatch.setattr(dsp.Matrix, "matrix_response", count_matrix)
    monkeypatch.setattr(dsp.ScatteringMatrix, "response", count_scattering)
    with torch.no_grad():
        mt(_io_torch()[0])
        sfdn(_io_torch()[0])
    assert calls == {"geq": 1, "matrix": 1, "scattering": 1}
