"""K3f, K3b and K5 past 16 channels, on the CPU: the public functions
(``fdn_tf`` and ``fdn_sos_tf_mse``, whose wrappers take the plain versions
for CPU tensors at every N) at N = 20, 32 and 64 against a JAX oracle
built from ``flamo_tpu.ops.solve.gauss_solve_loop`` on the assembled loop
matrix, with ``flamo_tpu.functional.cascade_prods`` and
``flamo_tpu.processor.dsp._iir_guard_prods`` for the attenuation, values
and gradients; K5's ``bin_offset`` by self-consistency; the colorless
and attenuated FDNs at 32 and 64 channels against JAX's, with the
weights carried by ``load_jax_params``; the wrappers' dispatch on the
card (the unrolled libraries up to 16 channels, the looped one above,
the looped kernels' limits named before a library loads), the fused
colorless paths, the attenuated Trainer's gate and the sharded
attenuated loss reaching the looped kernels, pinned with the device test
patched; the shared-memory rules; and chip_smoke.py's phases 4m and 5m
at a small nfft, the wrappers counting their calls as launches.

JAX's Pallas kernels are not the oracle: interpreted, they take minutes
a call above N = 8 (tests/test_torch_n_gt16.py).  The kernel-level
systems are well conditioned: U orthogonal (0.6 U for K5), |D| = 0.9,
SOS taps with poles of radius 0.2-0.6 and numerators near the
denominators.

Tolerances: values and losses 1e-5 of the max (float32 rounding of two
eliminations in another order); gradients 1e-4 of the max (a second,
transposed solve and sums over bins); a torch complex gradient is the
conjugate of JAX's cotangent.  The models' fused routes are held to
JAX's graph routes at the same bounds, except where a GEQ's float32
conditioning near DC parts the routes (the attenuated FDN: the JAX
package's fused-vs-graph bounds, as tests/test_torch_attenuated.py).

The file runs on one torch thread: float64-free as it is, its small
eliminations lose most of their time to intra-op threads waiting on busy
cores beside the other test workers.

tests/test_torch_cuda.py holds the looped CUDA kernels to these plain
versions on the card.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import flamo_tpu
import flamo_tpu.models as jm
from flamo_tpu.functional import cascade_prods
from flamo_tpu.models import attenuated_fdn as jatt
from flamo_tpu.ops.solve import gauss_solve_loop
from flamo_tpu.processor.dsp import _iir_guard_prods
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.models import (attenuated_loss_fused_step,
                                    attenuated_train_step,
                                    build_attenuated_fdn,
                                    build_colorless_fdn,
                                    colorless_freq_response_fused,
                                    colorless_loss_fused_tf,
                                    colorless_train_step)
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.optimize import Trainer, mse_loss
from flamo_tpu_torch.parallel.fused import bins_sharded_attenuated_loss
from flamo_tpu_torch.processor import dsp, system

M = 33
NFFT_K = 2 * (M - 1)  # K5's grid: M bins
NS = (20, 32, 64)
K, P = 12, 3
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
MODEL_NFFT = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _taps(rng, K: int, N: int):
    """Well-conditioned (P, K, N) SOS taps: poles of radius 0.2-0.6,
    numerators within 0.02 of the denominators."""
    r = rng.uniform(0.2, 0.6, (K, N))
    th = rng.uniform(0, np.pi, (K, N))
    a = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    b = a + 0.02 * rng.normal(size=(P, K, N))
    return b.astype(np.float32), a.astype(np.float32)


def _operands(N: int, seed: int = 0, K_: int = K) -> dict:
    rng = np.random.default_rng(seed + N)
    U, _ = np.linalg.qr(rng.normal(size=(N, N)))
    bt, at = _taps(rng, K_, N)
    return dict(
        D=(0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N)))).astype(
            np.complex64),
        U=U.astype(np.float32), U6=(0.6 * U).astype(np.float32),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        W=_cplx(rng, (M,)), X=_cplx(rng, (M,)),
        t=rng.uniform(size=M).astype(np.float32), bt=bt, at=at)


def _leaves(o: dict, names):
    return [torch.tensor(o[k]).requires_grad_() for k in names]


def _jax_loop(D, U):
    return jnp.eye(D.shape[1], dtype=D.dtype) - D[:, :, None] * U.astype(
        D.dtype)


@jax.jit
def _jax_tf(D, U, b, c, W):
    def f(D, U, b, c):
        y = gauss_solve_loop(_jax_loop(D, U), D * b.astype(D.dtype))
        tf = y @ c.astype(y.dtype)
        return jnp.real(jnp.sum(W * tf)), tf

    (_, tf), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                    has_aux=True)(D, U, b, c)
    return tf, g


@jax.jit
def _jax_sos_tf_mse(D, bt, at, U, b, c, X, t):
    def f(D, bt, at, U, b, c):
        gam = _iir_guard_prods(*cascade_prods(bt, at, NFFT_K))
        y = gauss_solve_loop(_jax_loop(D * gam, U), D * b.astype(D.dtype))
        tf = y @ c.astype(y.dtype)
        return jnp.mean((jnp.abs(tf * X) - t) ** 2)

    return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4, 5))(
        D, bt, at, U, b, c)


# ---------------------------------------------------------------------------
# the kernels' functions against the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", NS)
def test_fdn_tf_matches_jax_gauss_solve_loop(N):
    """K3f's function and, through its VJP, K3b's: tf and the gradients of
    Re <W, tf> in D, U, b and c."""
    o = _operands(N)
    D, U, b, c = _leaves(o, "DUbc")
    tf = fk.fdn_tf(D, U, b, c)
    torch.real(torch.sum(torch.tensor(o["W"]) * tf)).backward()
    tfj, (gD, gU, gb, gc) = _jax_tf(*(jnp.asarray(o[k]) for k in "DUbcW"))
    assert _rel(tf.detach(), tfj) < VAL_TOL
    assert _rel(D.grad, np.conj(gD)) < GRAD_TOL
    for got, want in ((U.grad, gU), (b.grad, gb), (c.grad, gc)):
        assert _rel(got, want) < GRAD_TOL


def _check_k5_against_jax(o, pivot: bool, with_dbar: bool,
                          fuse_taps: bool = True):
    D, bt, at, U, b, c = _leaves({**o, "U": o["U6"]},
                                 ("D", "bt", "at", "U", "b", "c"))
    X, t = torch.tensor(o["X"]), torch.tensor(o["t"])
    loss = sk.fdn_sos_tf_mse(D, bt, at, U, b, c, X, t, NFFT_K,
                             with_dbar=with_dbar, pivot=pivot,
                             fuse_taps=fuse_taps)
    loss.backward()
    lj, grads = _jax_sos_tf_mse(*(jnp.asarray(o[k]) for k in (
        "D", "bt", "at", "U6", "b", "c", "X", "t")))
    assert abs(float(loss.detach()) - float(lj)) < VAL_TOL * abs(float(lj))
    if with_dbar:
        assert _rel(D.grad, np.conj(grads[0])) < GRAD_TOL
    else:
        assert D.grad is None
    for got, want in zip((bt.grad, at.grad, U.grad, b.grad, c.grad),
                         grads[1:]):
        assert _rel(got, want) < GRAD_TOL


@pytest.mark.parametrize("with_dbar", [True, False], ids=["dbar", "nodbar"])
@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("N", NS)
def test_fdn_sos_tf_mse_matches_jax_oracle(N, pivot, with_dbar):
    """K5's function at K = 12 sections of P = 3 taps, fused tap sums: the
    loss and its gradients in D (with_dbar), the taps, U, b and c."""
    _check_k5_against_jax(_operands(N, seed=3), pivot, with_dbar)


@pytest.mark.parametrize("N,K_,fuse_taps", [(32, K, False), (64, 30, True)],
                         ids=["k4b-taps-N32", "third-octave-N64"])
def test_fdn_sos_tf_mse_matches_jax_oracle_taps(N, K_, fuse_taps):
    """K5's function with the tap sums from K4b's (fuse_taps=False), and at
    64 channels of a 1/3-octave GEQ's K = 30 sections (the looped kernel's
    shared-memory extreme)."""
    _check_k5_against_jax(_operands(N, seed=5, K_=K_), False, False,
                          fuse_taps)


def test_fdn_sos_tf_mse_bin_offset_is_consistent():
    """Rows j at bin_offset s are rows j + s of the grid at offset 0: the
    loss and the gradients of the two blocks [0, s) and [s, M), each
    weighted by its share of the bins, sum to the whole grid's, and the
    second block's D_bar rows are the whole grid's rows s.. (scaled by
    (M - s) / M, the mean's weight)."""
    N, s = 20, 13
    o = {k: torch.tensor(v) for k, v in _operands(N, seed=9).items()}
    rows = {k: o[k] for k in ("D", "X", "t")}

    def run(lo, hi, offset):
        return sk.fdn_sos_tf_mse_kernel(
            rows["D"][lo:hi], o["bt"], o["at"], o["U6"], o["b"], o["c"],
            rows["X"][lo:hi], rows["t"][lo:hi], NFFT_K, with_dbar=True,
            bin_offset=offset)

    whole = run(0, M, None)
    first, second = run(0, s, None), run(s, M, s)
    w1, w2 = s / M, (M - s) / M
    assert abs(float(w1 * first[0] + w2 * second[0] - whole[0])) < (
        VAL_TOL * float(whole[0]))
    for i in range(2, 7):
        assert _rel(w1 * first[i] + w2 * second[i], whole[i]) < GRAD_TOL
    assert _rel(w2 * second[1], whole[1][s:]) < VAL_TOL


# ---------------------------------------------------------------------------
# the models against JAX's, weights carried by load_jax_params
# ---------------------------------------------------------------------------
def _delays(N: int) -> tuple:
    """N distinct primes from 101 (a few ms at 48 kHz)."""
    out, n = [], 101
    while len(out) < N:
        if all(n % p for p in range(2, int(n ** 0.5) + 1)):
            out.append(n)
        n += 2
    return tuple(out)


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


# JAX's graph route: 'ge' is its loop route above 32 channels; at 32 its
# unrolled 'ge' takes ~80 s to jit, so 'lu' (jnp.linalg.solve)
JAX_ROUTE = {32: "lu", 64: "ge"}


def _model_pair(kind: str, N: int):
    """(JAX model on its graph route, port model with its weights, the JAX
    (inputs, targets), the port's)."""
    flamo_tpu.set_seed(N)
    if kind == "colorless":
        mj = jm.build_colorless_fdn(nfft=MODEL_NFFT, delays=_delays(N),
                                    solve_method=JAX_ROUTE[N])
        mt = build_colorless_fdn(nfft=MODEL_NFFT, delays=_delays(N),
                                 device="cpu")
        T = MODEL_NFFT // 2 + 1
    else:
        mj = jm.build_attenuated_fdn(nfft=MODEL_NFFT, delays=_delays(N),
                                     solve_method=JAX_ROUTE[N])
        mt = build_attenuated_fdn(nfft=MODEL_NFFT, delays=_delays(N),
                                  device="cpu")
        T = MODEL_NFFT
    Mm = MODEL_NFFT // 2 + 1
    xt = torch.zeros((1, T, 1))
    xt[:, 0, :] = 1.0
    io_t = (xt, torch.ones((1, Mm, 1)))
    io_j = (jnp.zeros((1, T, 1)).at[:, 0, :].set(1.0), jnp.ones((1, Mm, 1)))
    return mj, load_jax_params(mt, _jax_params(mj)), io_j, io_t


# The GEQ command gains' gradient passes through the octave GEQ's band
# design and its cascade near DC, which float32 conditions badly: JAX's
# graph route and the port's own graph route part there by 6.8e-4 of the
# max at 32 channels (2.0e-4 at 64), the fused step by 4.4e-3 (3.7e-4),
# in float32 on the CPU at nfft 256; it is held to the JAX package's
# fused-vs-graph bound for the GEQ (5e-3, tests/test_torch_attenuated.py),
# every other gradient to GRAD_TOL.  Adam's first step moves each
# parameter by about lr whatever its gradient's size, so a GEQ gain whose
# gradient differs in sign moves 2 lr apart and the attenuated histories
# part by up to 2e-5: they are held to 1e-4, as
# tests/test_torch_attenuated.py's lockstep
GEQ_GAINS, GEQ_GRAD_TOL = ".core.modules[1].feedback.modules[1].param", 5e-3
HISTORY_TOL = {"colorless": VAL_TOL, "attenuated": 1e-4}


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("kind", ["colorless", "attenuated"])
def test_fused_model_lockstep_with_jax(kind, N):
    """The fused route at N channels (colorless: the fused-tf loss, K3f and
    K3b; attenuated: the fused step, K5) against JAX's graph route on the
    same weights: the first loss (VAL_TOL) and gradients (GRAD_TOL, the
    GEQ gains GEQ_GRAD_TOL), then three Adam steps in lockstep (losses
    HISTORY_TOL)."""
    mj, mt, io_j, io_t = _model_pair(kind, N)
    loss_j = jm.colorless_loss if kind == "colorless" else jatt.attenuated_loss
    fused = (colorless_loss_fused_tf if kind == "colorless"
             else attenuated_loss_fused_step)
    lj, gj = jax.jit(jax.value_and_grad(loss_j))(mj, *io_j)
    gj = _jax_params(gj)
    mt.zero_grad(set_to_none=True)
    lt = fused(mt, *io_t)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) < VAL_TOL * float(lj)
    named = jax_named_tensors(mt)
    trainable = [k for k, v in named.items() if v.requires_grad]
    assert len(trainable) == (3 if kind == "colorless" else 4)
    for k in trainable:
        tol = GEQ_GRAD_TOL if k == GEQ_GAINS else GRAD_TOL
        assert _rel(named[k].grad.numpy(), gj[k]) < tol, k
    if kind == "colorless":
        step_j, opt_j = jm.colorless_train_step(mj)
        step_t, _ = colorless_train_step(mt, fused_tf=True)
    else:
        step_j, opt_j = jatt.attenuated_train_step(mj)
        step_t, _ = attenuated_train_step(mt, fused_step=True)
    step_j = jax.jit(step_j)
    hist_j = []
    for _ in range(3):
        mj, opt_j, loss = step_j(mj, opt_j, *io_j)
        hist_j.append(float(loss))
    hist_t = [float(step_t(*io_t)) for _ in range(3)]
    np.testing.assert_allclose(hist_t, hist_j, rtol=HISTORY_TOL[kind])


# ---------------------------------------------------------------------------
# the card's dispatch, pinned with the device test patched
# ---------------------------------------------------------------------------
@pytest.fixture()
def on_card(monkeypatch):
    """The wrappers' device test patched to say CUDA, and cuda_build.load
    recording what it is asked for instead of loading it."""
    loads = []

    def no_load(n, lib="fdn_kernels"):
        loads.append((lib, n))
        raise RuntimeError("no library here")

    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_build, "load", no_load)
    return loads


def _tensors(N: int, K_: int = K) -> dict:
    return {k: torch.tensor(v) for k, v in _operands(N, K_=K_).items()}


@pytest.mark.parametrize("N", [16, 17, 64, 101])
def test_tf_and_k5_dispatch_unrolled_to_16_looped_above(on_card, N):
    """On the card K3f, K3b and K5 load the unrolled library of N channels
    (fdn_kernels, sos_kernels) up to 16 and the one looped library above."""
    o = _tensors(N)
    D, U, b, c, W, X, t = (o[k] for k in "DUbcWXt")
    calls = {"fdn_kernels": [lambda: fk.fdn_tf_fwd_kernel(D, U, b, c),
                             lambda: fk.fdn_tf_bwd_kernel(D, U, b, c, D, W)],
             "sos_kernels": [lambda: sk.fdn_sos_tf_mse_kernel(
                 D, o["bt"], o["at"], U, b, c, X, t, NFFT_K)]}
    for lib, runs in calls.items():
        for run in runs:
            with pytest.raises(RuntimeError, match="no library"):
                run()
            assert on_card[-1] == ((lib, N) if N <= fk.MAX_N
                                   else ("fdn_loop", 1))
    assert len(on_card) == 3


def test_tf_and_k5_limits_named_before_loading(on_card):
    """Past its limit each looped wrapper raises, naming N (and K5's K, P
    and fuse_taps) and the limit, before it loads the library; at the
    limit it goes on to load."""
    for kind in ("fdn_tf_fwd", "fdn_tf_bwd"):
        top = fk.LOOP_MAX_N[kind]
        for N in (top + 1, top):
            D = torch.zeros((2, N), dtype=torch.complex64)
            U, v = torch.zeros((N, N)), torch.zeros(N)
            call = (lambda: fk.fdn_tf_fwd_kernel(D, U, v, v)) if (
                kind == "fdn_tf_fwd") else (
                lambda: fk.fdn_tf_bwd_kernel(D, U, v, v, D, D[:, 0]))
            n_loads = len(on_card)
            if N > top:
                label = fk.LOOP_LABELS[kind]
                with pytest.raises(ValueError, match=(
                        rf"N = {N} channels; the looped kernel {label} "
                        rf"\({kind}\) takes 1\.\.{top} on the card")):
                    call()
                assert len(on_card) == n_loads
            else:
                with pytest.raises(RuntimeError, match="no library"):
                    call()
                assert on_card[-1] == ("fdn_loop", 1)
    for K_, P_, fuse in ((12, 3, True), (30, 3, True), (12, 3, False)):
        top = sk.loop_tf_mse_max_n(K_, P_, fuse)
        for N in (top + 1, top):
            D = torch.zeros((2, N), dtype=torch.complex64)
            taps = torch.zeros((P_, K_, N))
            v = torch.zeros(N)
            n_loads = len(on_card)
            call = lambda: sk.fdn_sos_tf_mse_kernel(  # noqa: E731
                D, taps, taps, torch.zeros((N, N)), v, v, D[:, 0],
                torch.zeros(2), 2, fuse_taps=fuse)
            if N > top:
                with pytest.raises(ValueError, match=(
                        rf"N = {N} channels, K = {K_} sections of P = {P_} "
                        rf"taps, fuse_taps={fuse}: the looped kernel K5 "
                        rf"\(fdn_sos_tf_mse\) takes 1\.\.{top} .*227 KB")):
                    call()
                assert len(on_card) == n_loads
            else:
                with pytest.raises(RuntimeError, match="no library"):
                    call()
                assert on_card[-1] == ("fdn_loop", 1)


@pytest.fixture()
def looped_on_card(monkeypatch):
    """The wrappers' device test patched to say CUDA and the looped K3f,
    K3b and K5 wrappers replaced by their plain versions, each call
    counted under the kernel's launch key: the paths run on the CPU along
    the card's dispatch."""
    counts = {}
    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sk, "_on_cuda", lambda *t: True)

    def spy(mod, attr, plain, key):
        def run(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return plain(*args, **kwargs)
        monkeypatch.setattr(mod, attr, run)

    spy(fk, "fdn_tf_fwd_loop_kernel", fk.fdn_tf_fwd_plain, "fdn_tf_fwd_loop")
    spy(fk, "fdn_tf_bwd_loop_kernel", fk.fdn_tf_bwd_plain, "fdn_tf_bwd_loop")
    spy(sk, "fdn_sos_tf_mse_loop_kernel", sk.fdn_sos_tf_mse_plain,
        "fdn_sos_tf_mse_loop")
    return counts


def test_colorless_fused_paths_reach_the_looped_kernels(looped_on_card):
    """Fault 1: at 32 channels on the card the fused response, the
    fused-tf loss and its step go through K3f and K3b looped (they raised
    before), and give the CPU's results."""
    g = torch.Generator().manual_seed(0)
    model = build_colorless_fdn(nfft=MODEL_NFFT, delays=_delays(32),
                                device="cpu", generator=g)
    with torch.no_grad():
        H = colorless_freq_response_fused(model)
        H_graph = model.get_freq_response()
    assert _rel(H, H_graph) < VAL_TOL
    assert looped_on_card == {"fdn_tf_fwd_loop": 1}
    x, t = cs.colorless_pair(model)
    step, _ = colorless_train_step(model, fused_tf=True)
    hist = [float(step(x, t)) for _ in range(2)]
    assert np.isfinite(hist).all()
    assert looped_on_card == {"fdn_tf_fwd_loop": 3, "fdn_tf_bwd_loop": 2}
    colorless_loss_fused_tf(model, x, t).backward()
    assert looped_on_card["fdn_tf_bwd_loop"] == 3


def _att_abs_model(N: int):
    m = build_attenuated_fdn(nfft=MODEL_NFFT, delays=_delays(N),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    return system.Shell(core=m.core, input_layer=m.input_layer,
                        output_layer=dsp.Transform(torch.abs))


def test_attenuated_trainer_gate_takes_the_fused_step(looped_on_card):
    """Fault 2: at 32 channels on the card the Trainer's gate takes
    attenuated_fused_step, K5 looped once, and each fit_scan step runs it
    once (the gate let the kernel's error propagate before)."""
    model = _att_abs_model(32)
    x, t = cs.time_impulse_pair(MODEL_NFFT, "cpu")
    tr = Trainer(model, max_epochs=1, lr=1e-4, log=False, fused="force")
    tr.register_criterion(mse_loss(nfft=MODEL_NFFT), 1)
    tr._maybe_gate_fused(x, t)
    assert tr.fused_path == "attenuated_fused_step"
    assert looped_on_card == {"fdn_sos_tf_mse_loop": 1}
    hist = tr.fit_scan(x, t, n_steps=2, steps_per_call=2)
    assert np.isfinite(hist).all()
    assert looped_on_card == {"fdn_sos_tf_mse_loop": 3}


def _stub_mesh(size: int, rank: int):
    """The one axis 'bins' of ``size`` ranks as this rank sees it (what
    shard_block reads of a DeviceMesh)."""
    return SimpleNamespace(mesh_dim_names=("bins",), size=lambda dim: size,
                           get_local_rank=lambda axis: rank)


@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_attenuated_loss_reaches_the_looped_kernel(looped_on_card,
                                                           ranks):
    """Fault 3: at 20 channels on the card each rank's share of the
    attenuated loss runs K5 looped on its block of bins (at its global
    bin_offset), and the shares sum to the unsharded fused step's loss."""
    model = _att_abs_model(20)
    x, t = cs.time_impulse_pair(MODEL_NFFT, "cpu")
    whole = attenuated_loss_fused_step(model, x, t)
    X = torch.fft.rfft(x[0, :, 0], n=MODEL_NFFT)
    shares = [bins_sharded_attenuated_loss(model, X, t[0, :, 0],
                                           _stub_mesh(ranks, r))
              for r in range(ranks)]
    total = float(sum(s.detach() for s in shares))
    assert abs(total - float(whole.detach())) < VAL_TOL * float(whole)
    assert looped_on_card == {"fdn_sos_tf_mse_loop": 1 + ranks}


# ---------------------------------------------------------------------------
# the shared-memory rules
# ---------------------------------------------------------------------------
def test_tf_and_k5_loop_smem_rules():
    """K3f's block as K2's plus b and c, K3b's as K1's; K5's with its
    staged taps and six vectors a warp, and with fused taps its 2 P K N
    tap sums a warp: at N = 64, K = 30, P = 3 one warp in 162820 bytes;
    the largest N of each, and where one warp no longer fits."""
    assert fk.LOOP_MAX_N["fdn_tf_fwd"] == 137
    assert fk.LOOP_MAX_N["fdn_tf_bwd"] == fk.LOOP_MAX_N["fdn_tf_mse"] == 119
    for N, w in ((17, 1), (64, 4), (119, 1)):
        assert fk.loop_smem_bytes("fdn_tf_bwd", N, w) == (
            fk.loop_smem_bytes("fdn_tf_mse", N, w))
        assert fk.loop_smem_bytes("fdn_tf_fwd", N, w) == (
            fk.loop_smem_bytes("fdn_solve", N, w) + 8 * N)
    assert fk.loop_smem_bytes("fdn_tf_fwd", 32, 2) == (
        4 * (32 * 33 + 64) + 2 * 8 * (32 * 33 + 3 * 32))
    assert [fk.loop_warps(k, 64) for k in ("fdn_tf_fwd", "fdn_tf_bwd")] == [
        6, 4]
    S = 65
    third = (4 * (64 * S + 128 + 2 * 3 * 30 * 64)
             + 8 * (64 * S + 6 * 64 + 32) + 4 * (64 * 64 + 129
                                                 + 2 * 3 * 30 * 64))
    assert sk.loop_tf_mse_smem_bytes(64, 30, 3, True, 1) == third == 162820
    assert sk.loop_tf_mse_smem_bytes(64, 30, 3, False, 1) == (
        third - 4 * 2 * 3 * 30 * 64)
    assert sk.loop_tf_mse_warps(64, 30, 3, True) == 1
    assert sk.loop_tf_mse_warps(64, 12, 3, True) == 2
    assert sk.loop_tf_mse_warps(32, 12, 3, True) == fk.LOOP_MAX_WARPS
    assert sk.loop_tf_mse_max_n(12, 3, True) == 101
    assert sk.loop_tf_mse_max_n(30, 3, True) == 82
    for K_, P_, fuse in ((1, 1, False), (12, 3, True), (64, 8, True)):
        top = sk.loop_tf_mse_max_n(K_, P_, fuse)
        assert sk.loop_tf_mse_smem_bytes(top, K_, P_, fuse, 1) <= fk.LOOP_SMEM
        assert sk.loop_tf_mse_smem_bytes(top + 1, K_, P_, fuse,
                                         1) > fk.LOOP_SMEM
        sk.check_loop_tf_mse(top, K_, P_, fuse)


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 4m and 5m at a small nfft
# ---------------------------------------------------------------------------
@pytest.fixture()
def counted_tf_sos(monkeypatch):
    """K3f's, K3b's and K5's wrappers counting a call above 16 channels as
    a launch of the looped kernel, as the kernels count on the card."""
    def spy(mod, attr, name):
        fn = getattr(mod, attr)

        def run(*args, **kwargs):
            if args[0].shape[-1] > fk.MAX_N:
                mod.LAUNCHES[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, attr, run)

    spy(fk, "fdn_tf_fwd_kernel", "fdn_tf_fwd_loop")
    spy(fk, "fdn_tf_bwd_kernel", "fdn_tf_bwd_loop")
    spy(sk, "fdn_sos_tf_mse_kernel", "fdn_sos_tf_mse_loop")


def test_phase_5m_kernel_checks_on_cpu(capsys):
    errs, tied = cs.tfsos_kernel_checks(20, M=40, device="cpu", offset=17)
    assert set(errs) == {"fdn_tf_fwd_loop", "fdn_tf_bwd_loop",
                         "fdn_sos_tf_mse_loop"}
    assert all(v == 0.0 for v in errs.values())  # plain against plain
    assert tied == 40
    gaps = cs.tfsos_versus_unrolled(M=40, device="cpu")
    assert len(gaps) == 2 + len(cs.K5_VARIANTS)
    assert all(v == 0.0 for v in gaps.values())
    text = capsys.readouterr().out
    for name in ("K3f looped N=20 tied lower y", "K3b looped N=20 pivoting",
                 "K5 looped N=20 bin_offset=17", "fuse_taps=False"):
        assert name in text, name


def test_phase_4m_paths_and_report_on_cpu(counted_tf_sos, capsys):
    paths = cs.tfsos_paths(nfft=MODEL_NFFT, device="cpu")
    S, T = cs.LOOP_STEPS, cs.TFSOS_TRAINER_STEPS
    assert [r["counts"] for r in paths["colorless"]] == [
        {"fdn_tf_fwd_loop": 1 + S, "fdn_tf_bwd_loop": S}] * 2
    assert [r["counts"] for r in paths["attenuated"]] == [
        {"fdn_sos_tf_mse_loop": S + 1 + T}] * 2
    assert paths["third"]["counts"] == {"fdn_sos_tf_mse_loop": 1}
    assert paths["third"]["warps"] == 1
    launches = cs.tfsos_report(paths)
    assert launches == {
        "fdn_tf_fwd_loop@N32": 1 + S, "fdn_tf_bwd_loop@N32": S,
        "fdn_tf_fwd_loop@N64": 1 + S, "fdn_tf_bwd_loop@N64": S,
        "fdn_sos_tf_mse_loop@N32": S + 1 + T,
        "fdn_sos_tf_mse_loop@N64": S + 1 + T + 1}
    text = capsys.readouterr().out
    for name in ("colorless FDN N=32", "colorless FDN N=64",
                 "attenuated FDN N=32", "attenuated FDN N=64",
                 "attenuated_fused_step", "1/3-octave GEQ (K=30) N=64",
                 "launches in phase 4m"):
        assert name in text, name
