"""The e8_fdn slice's composition and matrix modules against flamo_tpu on
the CPU: the anti-alias transforms at 30 dB, ``Parallel`` (summed and
concatenated, its ``matrix_response`` inside a ``Recursion``), the
functional structure edits of ``Series`` and ``Shell``, the
``HouseholderMatrix`` and the Hadamard and rotation galleries, and the
'ge_mat' solve.  The same parameters go into both packages (numpy), and
complex gradients are held as ``x.grad`` against ``conj(jax.grad)``."""

from __future__ import annotations

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.ops import solve as jsolve
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.ops import solve as tsolve
from flamo_tpu_torch.processor import dsp, system

NFFT = 64
M = NFFT // 2 + 1
CPU = dict(device="cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _port(jmod, cls, **kw):
    """``cls(**kw)`` on the CPU holding the JAX module's raw param."""
    mod = cls(**kw, **CPU)
    mod.assign_value(np.asarray(jmod.param))
    return mod


def _spectrum(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("cls", ["FFTAntiAlias", "iFFTAntiAlias"])
def test_anti_alias_transforms_match_jax_at_30db(cls):
    """Each transform against JAX's at 30 dB (the envelope scales the
    tail by up to 10^(30/20)), and FFT -> iFFTAntiAlias undoes the alias
    decay of a response evaluated at gamma^n."""
    rng = np.random.default_rng(0)
    if cls == "FFTAntiAlias":
        x = rng.normal(size=(2, NFFT, 3)).astype(np.float32)
    else:
        x = _spectrum(rng, 2, M, 3)
    ours = getattr(dsp, cls)(nfft=NFFT, alias_decay_db=30, **CPU)
    theirs = getattr(jdsp, cls)(nfft=NFFT, alias_decay_db=30)
    got = ours(torch.tensor(x)).numpy()
    assert _rel(got, theirs(jnp.asarray(x))) < 1e-6

    # a decaying IR h, transformed at gamma^n, comes back as h
    h = rng.normal(size=(1, NFFT, 1)).astype(np.float32)
    gamma = 10 ** (-30 / NFFT / 20)
    damped = torch.tensor(h * gamma ** np.arange(NFFT)[None, :, None],
                          dtype=torch.float32)
    back = dsp.iFFTAntiAlias(nfft=NFFT, alias_decay_db=30, **CPU)(
        dsp.FFT(NFFT)(damped))
    assert _rel(back.numpy(), h) < 1e-5


def _gain_pair(rng, size, scale: float = 1.0, alias_decay_db: float = 0.0):
    kw = dict(size=size, nfft=NFFT, requires_grad=True,
              alias_decay_db=alias_decay_db)
    j = jdsp.Gain(**kw).assign_value(
        jnp.asarray(scale * rng.normal(size=size), jnp.float32))
    return j, _port(j, dsp.Gain, **kw)


@pytest.mark.parametrize("sum_output", [True, False])
def test_parallel_matches_jax(sum_output):
    """Parallel of two gains (tests/test_system.py's case) summed and
    concatenated: forward, matrix_response, the branch-A input gradient;
    the attribute and IO errors carry JAX's messages."""
    rng = np.random.default_rng(1)
    (ja, ta), (jb, tb) = _gain_pair(rng, (3, 2)), _gain_pair(rng, (3, 2))
    jp = jsystem.Parallel(ja, jb, sum_output=sum_output)
    tp = system.Parallel(ta, tb, sum_output=sum_output)
    assert tp.output_channels == jp.output_channels == (3 if sum_output
                                                        else 6)
    x = _spectrum(rng, 1, M, 2)
    y = tp(torch.tensor(x))
    assert _rel(y.detach().numpy(), jp(jnp.asarray(x))) < 1e-6
    kind, H = tp.matrix_response()
    jkind, jH = jp.matrix_response()
    assert kind == jkind
    assert _rel(H.detach().numpy(), jH) < 1e-6

    # gradient of |y|^2 w.r.t. branch A's raw gain
    torch.sum(torch.abs(y) ** 2).backward()
    jg = jax.grad(lambda p: jnp.sum(jnp.abs(
        jsystem.Parallel(ja.assign_value(p), jb, sum_output=sum_output)(
            jnp.asarray(x))) ** 2))(ja.param)
    assert _rel(ta.param.grad.numpy(), jg) < 1e-5

    with pytest.raises(AssertionError, match="must be the same"):
        system.Parallel(ta, dsp.Gain(size=(3, 4), nfft=NFFT, **CPU),
                        sum_output=sum_output)
    if sum_output:
        with pytest.raises(AssertionError, match="if their output is being"):
            system.Parallel(ta, dsp.Gain(size=(4, 2), nfft=NFFT, **CPU))
    with pytest.raises(AssertionError, match="Branch A has nfft"):
        system.Parallel(ta, dsp.Gain(size=(3, 2), nfft=2 * NFFT, **CPU))
    with pytest.warns(UserWarning, match="Branch A has been converted"):
        system.Parallel(OrderedDict({"g": ta}), tb)


def test_parallel_in_a_recursion_loop_matches_jax():
    """A Parallel feedback (diagonal delays beside a flat gain) composes
    through matrix_response inside a Recursion: forward and gradients."""
    rng = np.random.default_rng(2)
    N = 3
    jd = jdsp.parallelDelay(size=(N,), max_len=20, nfft=NFFT, isint=True,
                            alias_decay_db=6)
    jd = jd.assign_value(jd.sample2s(jnp.asarray([5.0, 7.0, 11.0])))
    td = _port(jd, dsp.parallelDelay, size=(N,), max_len=20, nfft=NFFT,
               isint=True, alias_decay_db=6)
    jg, tg = _gain_pair(rng, (N, N), scale=0.2, alias_decay_db=6)
    jpg = jdsp.parallelGain(size=(N,), nfft=NFFT, alias_decay_db=6)
    jpg = jpg.assign_value(jnp.asarray([0.3, -0.2, 0.1], jnp.float32))
    tpg = _port(jpg, dsp.parallelGain, size=(N,), nfft=NFFT,
                alias_decay_db=6)
    jloop = jsystem.Recursion(jd, jsystem.Parallel(jg, jpg))
    tloop = system.Recursion(td, system.Parallel(tg, tpg))
    x = _spectrum(rng, 1, M, N)
    y = tloop(torch.tensor(x))
    assert _rel(y.detach().numpy(), jax.jit(jloop)(jnp.asarray(x))) < 1e-5
    torch.sum(torch.abs(y) ** 2).backward()
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jnp.abs(jsystem.Recursion(
        jd, jsystem.Parallel(jg.assign_value(p), jpg))(jnp.asarray(x)))
        ** 2)))(jg.param)
    assert _rel(tg.param.grad.numpy(), jgrad) < 1e-4
    kind, H = tloop.matrix_response()
    jH = jax.jit(lambda: jloop.matrix_response()[1])()
    assert kind == "full" and _rel(H.detach().numpy(), jH) < 1e-5


def test_series_edits_and_shell_setters_return_new_objects():
    """prepend/append/insert and set_inputLayer/set_outputLayer/set_core
    return new containers and leave the original as it was, with JAX's
    keys and IO."""
    g = [dsp.Gain(size=s, nfft=NFFT, **CPU) for s in ((2, 2), (3, 2),
                                                       (2, 5))]
    s = system.Series(OrderedDict({"a": g[0]}))
    s2 = s.append(g[1])
    assert len(s) == 1 and s.keys == ("a",) and len(s2) == 2
    s3 = s2.prepend(OrderedDict({"first": g[2]}))
    assert s3.keys == ("first", "a", "2")  # an integer key is renumbered
    assert (s3.input_channels, s3.output_channels) == (5, 3)
    s4 = s3.insert(-1, dsp.Gain(size=(2, 2), nfft=NFFT, **CPU))
    assert len(s4) == 4 and len(s3) == 3 and s4[3] is g[1]
    with pytest.raises(IndexError):
        s.insert(3, g[1])
    # the JAX package's keys for the same edits
    js = jsystem.Series(OrderedDict({"a": jdsp.Gain(size=(2, 2),
                                                    nfft=NFFT)}))
    js3 = js.append(jdsp.Gain(size=(3, 2), nfft=NFFT)).prepend(
        OrderedDict({"first": jdsp.Gain(size=(2, 5), nfft=NFFT)}))
    assert js3.keys == s3.keys

    core = system.Series(OrderedDict({"g": g[0]}))
    shell = system.Shell(core=core, input_layer=dsp.FFT(NFFT),
                         output_layer=dsp.iFFT(NFFT))
    abs_layer = dsp.Transform(torch.abs)
    swapped = shell.set_outputLayer(abs_layer)
    assert isinstance(shell.get_outputLayer(), dsp.iFFT)
    assert swapped.get_outputLayer() is abs_layer
    assert swapped.get_core() is core and swapped is not shell
    fed = shell.set_inputLayer(dsp.Transform())
    assert isinstance(shell.get_inputLayer(), dsp.FFT)
    assert isinstance(fed.get_inputLayer(), dsp.Transform)
    other = system.Series(OrderedDict({"h": g[1]}))
    recored = shell.set_core(other)
    assert shell.get_core() is core and recored.get_core() is other
    x = torch.zeros((1, NFFT, 2))
    x[:, 0] = 1.0
    assert torch.equal(swapped(x), torch.abs(core(dsp.FFT(NFFT)(x))))


def test_householder_matches_jax():
    """HouseholderMatrix: forward by two vector contractions, its flat
    matrix_response I - 2 u u^T, orthogonal, and the gradient of u."""
    rng = np.random.default_rng(3)
    jh = jdsp.HouseholderMatrix(size=(4, 4), nfft=NFFT, requires_grad=True)
    th = _port(jh, dsp.HouseholderMatrix, size=(4, 4), nfft=NFFT,
               requires_grad=True)
    assert (th.input_channels, th.output_channels) == (4, 4)
    x = _spectrum(rng, 2, M, 4)
    y = th(torch.tensor(x))
    assert _rel(y.detach().numpy(), jh(jnp.asarray(x))) < 1e-6
    kind, H = th.matrix_response()
    jkind, jH = jdsp.HouseholderMatrix.matrix_response(jh)
    assert kind == jkind == "flat"
    assert _rel(H.detach().numpy(), jH) < 1e-6
    Hr = torch.real(H).detach()
    assert torch.allclose(Hr @ Hr.T, torch.eye(4), atol=1e-6)
    torch.sum(torch.abs(y) ** 2 * torch.arange(4)).backward()
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.abs(jh.assign_value(p)(
        jnp.asarray(x))) ** 2 * jnp.arange(4))))(jh.param)
    assert _rel(th.param.grad.numpy(), jg) < 1e-5
    with pytest.raises(ValueError, match="not compatible"):
        th(torch.zeros((1, M, 3), dtype=torch.complex64))


@pytest.mark.parametrize("matrix_type,N", [("hadamard", 4), ("hadamard", 8),
                                           ("rotation", 4)])
def test_matrix_galleries_match_jax(matrix_type, N):
    """The Hadamard and rotation galleries map the same raw param to the
    same orthogonal matrix as JAX's; the rotation angle's gradient too,
    with the angle inside and at the clip boundary (jnp.clip's 1/2)."""
    rng = np.random.default_rng(4)
    jm = jdsp.Matrix(size=(N, N), nfft=NFFT, matrix_type=matrix_type,
                     requires_grad=True)
    tm = _port(jm, dsp.Matrix, size=(N, N), nfft=NFFT,
               matrix_type=matrix_type, requires_grad=True)
    A = tm.map(tm.param)
    assert _rel(A.detach().numpy(), jm.map(jm.param)) < 1e-6
    assert torch.allclose(A @ A.T, torch.eye(A.shape[0]), atol=1e-6)
    if matrix_type == "rotation":
        for angle in (0.3, np.pi / 4):
            p = np.asarray(rng.normal(size=(N, N)), np.float32)
            p[0, 0] = angle
            tm.assign_value(p)
            tm.param.grad = None
            torch.sum(tm.map(tm.param) * torch.arange(N * N).reshape(N, N)
                      ).backward()
            jg = jax.grad(lambda q: jnp.sum(jm.map(q) * jnp.arange(
                N * N).reshape(N, N)))(jnp.asarray(p))
            assert _rel(tm.param.grad.numpy(), jg) < 1e-6
    with pytest.raises(AssertionError, match="even dimensions"):
        dsp.Matrix(size=(3, 3), nfft=NFFT, matrix_type=matrix_type, **CPU)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_ge_mat_matches_ge_and_jax(rhs):
    """closed_loop_solve(method='ge_mat') against 'ge' and against JAX's
    gauss_solve_mat: values and gradients (autograd through the
    elimination)."""
    rng = np.random.default_rng(5)
    A = (np.eye(4) + 0.3 * (rng.normal(size=(7, 4, 4))
                            + 1j * rng.normal(size=(7, 4, 4)))).astype(
        np.complex64)
    B = _spectrum(rng, 7, 4) if rhs == "vector" else _spectrum(rng, 7, 4, 2)
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    Y = tsolve.closed_loop_solve(At, Bt, method="ge_mat")
    ref = tsolve.closed_loop_solve(torch.tensor(A), torch.tensor(B),
                                   method="ge")
    assert _rel(Y.detach().numpy(), ref.numpy()) < 1e-5
    assert _rel(Y.detach().numpy(),
                jax.jit(jsolve.gauss_solve_mat)(A, B)) < 1e-6
    w = np.arange(Y.numel()).reshape(Y.shape)
    torch.sum(torch.abs(Y) ** 2 * torch.tensor(w)).backward()
    gA, gB = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.abs(
        jsolve.gauss_solve_mat(a, b)) ** 2 * w), argnums=(0, 1)))(
        jnp.asarray(A), jnp.asarray(B))
    assert _rel(At.grad.numpy(), np.conj(gA)) < 1e-5
    assert _rel(Bt.grad.numpy(), np.conj(gB)) < 1e-5


def test_load_jax_params_carries_parallel_householder_and_galleries():
    """convert.load_jax_params on a JAX Shell whose core is a Parallel of
    a HouseholderMatrix and a Hadamard Matrix beside a rotation Matrix:
    the port's key paths are JAX's (``.core.branchA...``) and, after
    loading, both packages give the same response."""
    import jax.tree_util as jtu

    from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params

    def shell(d, s, **kw):
        a = s.Series(OrderedDict({
            "h": d.HouseholderMatrix(size=(4, 4), nfft=NFFT, **kw),
            "had": d.Matrix(size=(4, 4), nfft=NFFT, matrix_type="hadamard",
                            **kw)}))
        b = d.Matrix(size=(4, 4), nfft=NFFT, matrix_type="rotation", **kw)
        return s.Shell(core=s.Parallel(a, b), input_layer=d.FFT(NFFT))

    mj = shell(jdsp, jsystem)
    mt = shell(dsp, system, **CPU)
    params = {jtu.keystr(p): np.asarray(v)
              for p, v in jtu.tree_leaves_with_path(mj)}
    assert set(jax_named_tensors(mt)) == set(params)
    load_jax_params(mt, params)
    x = np.random.default_rng(6).normal(size=(1, NFFT, 4)).astype(
        np.float32)
    got = mt(torch.tensor(x)).detach().numpy()
    assert _rel(got, mj(jnp.asarray(x))) < 1e-6


@pytest.mark.parametrize("entry", ["FFTAntiAlias", "iFFTAntiAlias",
                                   "HouseholderMatrix", "signal_gallery",
                                   "mel_filterbank", "hadamard_matrix_jnp"])
def test_new_entry_points_default_to_the_card(entry):
    """Without device=, each new entry point runs on the CUDA card and,
    with none, raises instead of falling back to the CPU."""
    from flamo_tpu_torch import functional
    from flamo_tpu_torch.optimize import loss

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid")
    calls = {
        "FFTAntiAlias": lambda: dsp.FFTAntiAlias(nfft=NFFT),
        "iFFTAntiAlias": lambda: dsp.iFFTAntiAlias(nfft=NFFT),
        "HouseholderMatrix": lambda: dsp.HouseholderMatrix(size=(4, 4)),
        "signal_gallery": lambda: functional.signal_gallery(1, 8, 1, "sine"),
        "mel_filterbank": lambda: loss.mel_filterbank(48000, 64, 8),
        "hadamard_matrix_jnp": lambda: functional.hadamard_matrix_jnp(4),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()

