"""K1, K2 and K6 past 16 channels, on the CPU: the public functions
(``fdn_solve``, ``dense_solve``, ``fdn_tf_mse``, whose wrappers take the
plain versions for CPU tensors at every N) at N = 20, 32 and 64 against
the JAX package's ``gauss_solve_loop`` on the assembled loop matrices,
values and gradients; the wrappers' dispatch on the card (the unrolled
library up to 16 channels, the looped one above, for K3f, K3b and K5
too, the looped kernels' limits named before a library loads), pinned
with the device test patched; the looped kernels' shared-memory rule.
tests/test_torch_tf_sos_gt16.py holds K3f, K3b and K5 past 16 channels.

JAX's Pallas kernels are not the oracle here: interpreted, they take
minutes a call above N = 8, and JAX's unrolled ``gauss_solve`` ~80 s to
jit at N = 32, where ``gauss_solve_loop`` (JAX's own route above N = 32)
jits in about a second.  The systems are well conditioned: U orthogonal,
|D| = 0.9 (the loop matrix's singular values in [0.1, 1.9]); K6's A is I
plus a normal matrix of norm ~0.5.

Tolerances: values 1e-5 of the max (float32 rounding of two pivoted
eliminations in another order); gradients 1e-4 of the max (a second,
transposed solve, and K1's sums over bins); a complex gradient is the
conjugate of JAX's cotangent.

tests/test_torch_cuda.py holds the looped CUDA kernels to these plain
versions on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.ops.solve import gauss_solve_loop as jax_gauss_solve_loop
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import sos_kernels as sk

M = 33
NS = (20, 32, 64)
VAL_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _fdn_operands(N: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed + N)
    U, _ = np.linalg.qr(rng.normal(size=(N, N)))
    return dict(
        D=(0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N)))).astype(
            np.complex64),
        U=U.astype(np.float32), B=_cplx(rng, (M, N)), W=_cplx(rng, (M, N)),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        X=_cplx(rng, (M,)), t=rng.uniform(size=M).astype(np.float32))


def _jax_loop(D, U):
    N = D.shape[1]
    return jnp.eye(N, dtype=D.dtype) - D[:, :, None] * U.astype(D.dtype)


@jax.jit
def _jax_fdn_solve(D, U, B, W):
    def f(D, U, B):
        return jnp.real(jnp.sum(W * jax_gauss_solve_loop(_jax_loop(D, U), B)))

    y = jax_gauss_solve_loop(_jax_loop(D, U), B)
    return y, jax.grad(f, argnums=(0, 1, 2))(D, U, B)


@jax.jit
def _jax_dense_solve(A, B, W):
    def f(A, B):
        return jnp.real(jnp.sum(W * jax_gauss_solve_loop(A, B)))

    return jax_gauss_solve_loop(A, B), jax.grad(f, argnums=(0, 1))(A, B)


@jax.jit
def _jax_tf_mse(D, U, b, c, X, t):
    def f(D, U, b, c):
        y = jax_gauss_solve_loop(_jax_loop(D, U), D * b.astype(D.dtype))
        tf = y @ c.astype(y.dtype)
        return jnp.mean((jnp.abs(tf * X) - t) ** 2)

    return jax.value_and_grad(f, argnums=(0, 1, 2, 3))(D, U, b, c)


def _leaves(o: dict, names: str):
    return [torch.tensor(o[k]).requires_grad_() for k in names]


@pytest.mark.parametrize("N", NS)
def test_fdn_solve_matches_jax_gauss_solve_loop(N):
    """K2's function, forward and (through its VJP) transposed: y and the
    gradients of Re <W, y> in D, U and B."""
    o = _fdn_operands(N)
    D, U, B = _leaves(o, "DUB")
    y = fk.fdn_solve(D, U, B)
    torch.real(torch.sum(torch.tensor(o["W"]) * y)).backward()
    yj, (gD, gU, gB) = _jax_fdn_solve(*(jnp.asarray(o[k]) for k in "DUBW"))
    assert _rel(y.detach(), yj) < VAL_TOL
    assert _rel(D.grad, np.conj(gD)) < GRAD_TOL
    assert _rel(U.grad, gU) < GRAD_TOL
    assert _rel(B.grad, np.conj(gB)) < GRAD_TOL


@pytest.mark.parametrize("N", NS)
def test_dense_solve_matches_jax_gauss_solve_loop(N):
    """K6's function on dense systems, forward and (its VJP) on A^T: y and
    the gradients of Re <W, y> in A and B."""
    rng = np.random.default_rng(100 + N)
    A = (np.eye(N) + _cplx(rng, (M, N, N)) / (4 * np.sqrt(N))).astype(
        np.complex64)
    B, W = _cplx(rng, (M, N)), _cplx(rng, (M, N))
    At = torch.tensor(A).requires_grad_()
    Bt = torch.tensor(B).requires_grad_()
    y = fk.dense_solve(At, Bt)
    torch.real(torch.sum(torch.tensor(W) * y)).backward()
    yj, (gA, gB) = _jax_dense_solve(jnp.asarray(A), jnp.asarray(B),
                                    jnp.asarray(W))
    assert _rel(y.detach(), yj) < VAL_TOL
    assert _rel(At.grad, np.conj(gA)) < GRAD_TOL
    assert _rel(Bt.grad, np.conj(gB)) < GRAD_TOL


@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("N", NS)
def test_fdn_tf_mse_matches_jax_gauss_solve_loop(N, pivot):
    """K1's function, pivoted and on the forward factors: the loss and its
    gradients in D, U, b and c; with_dbar=False leaves D without one."""
    o = _fdn_operands(N, seed=7)
    D, U, b, c = _leaves(o, "DUbc")
    X, t = torch.tensor(o["X"]), torch.tensor(o["t"])
    loss = fk.fdn_tf_mse(D, U, b, c, X, t, with_dbar=True, pivot=pivot)
    loss.backward()
    lj, (gD, gU, gb, gc) = _jax_tf_mse(*(jnp.asarray(o[k])
                                         for k in "DUbcXt"))
    assert abs(float(loss.detach()) - float(lj)) < VAL_TOL * abs(float(lj))
    assert _rel(D.grad, np.conj(gD)) < GRAD_TOL
    for got, want in ((U.grad, gU), (b.grad, gb), (c.grad, gc)):
        assert _rel(got, want) < GRAD_TOL
    D2, U2, b2, c2 = _leaves(o, "DUbc")
    fk.fdn_tf_mse(D2, U2, b2, c2, X, t, with_dbar=False,
                  pivot=pivot).backward()
    assert D2.grad is None
    assert torch.equal(U2.grad, U.grad)


def test_cpu_wrappers_take_any_n():
    """On the CPU every wrapper runs its plain version above 16 channels,
    K3f, K3b and K5 too, and the looped wrappers equal them."""
    N = 20
    fk.reset_launch_counts()
    o = {k: torch.tensor(v) for k, v in _fdn_operands(N).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    for tr in (False, True):
        y = fk.fdn_solve_kernel(D, U, B, tr)
        assert torch.equal(y, fk.fdn_solve_plain(D, U, B, tr))
        assert torch.equal(y, fk.fdn_solve_loop_kernel(D, U, B, tr))
    A = fk._loop_matrix(D, U)
    assert torch.equal(fk.dense_solve_kernel(A, B),
                       fk.dense_solve_loop_kernel(A, B))
    for out, ref in zip(fk.fdn_tf_mse_kernel(D, U, b, c, X, t),
                        fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t)):
        assert torch.equal(out, ref)
    tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    assert torch.equal(y, fk.fdn_solve_plain(D, U, D * b))
    fk.fdn_tf_bwd_kernel(D, U, b, c, y, tf)
    bt = torch.full((3, 2, N), 0.1)
    sk.fdn_sos_tf_mse_kernel(D, bt, bt + 1.0, U, b, c, X, t, 2 * (M - 1))
    assert not any(fk.LAUNCHES.values())


def test_loop_smem_rule_and_limits():
    """The looped kernels' shared memory (fdn_loop.cu's smem_bytes): a
    block of W warps, each with its system (N rows of stride N | 1) and
    vectors, K1's sums, and U (and b, c) once; W as many warps as fit 227
    KB, at most 8; the largest N of one warp: 137 (K2), 169 (K6), 119
    (K1), 137 (K3f) and 119 (K3b)."""
    assert fk.LOOP_MAX_N == {"fdn_solve": 137, "dense_solve": 169,
                             "fdn_tf_mse": 119, "fdn_tf_fwd": 137,
                             "fdn_tf_bwd": 119}
    assert fk.loop_smem_bytes("fdn_solve", 64, 1) == (
        4 * 64 * 65 + 8 * (64 * 65 + 3 * 64))
    assert fk.loop_smem_bytes("dense_solve", 17, 2) == 2 * 8 * (17 * 17
                                                                + 2 * 17)
    assert fk.loop_smem_bytes("fdn_tf_mse", 32, 1) == (
        4 * (32 * 33 + 64) + 8 * (32 * 33 + 4 * 32) + 4 * (32 * 32 + 65))
    assert [fk.loop_warps(k, 64) for k in fk.LOOP_KINDS] == [6, 6, 4, 6, 4]
    for kind, top in fk.LOOP_MAX_N.items():
        assert fk.loop_warps(kind, 17) == fk.LOOP_MAX_WARPS
        assert fk.loop_smem_bytes(kind, top, 1) <= fk.LOOP_SMEM
        assert fk.loop_smem_bytes(kind, top + 1, 1) > fk.LOOP_SMEM
        assert fk.loop_warps(kind, top + 1) == 0
        fk.check_loop_n(kind, top)
        with pytest.raises(ValueError, match=rf"N = {top + 1} channels; the "
                           rf"looped kernel K\d[fb]? \({kind}\) takes "
                           rf"1\.\.{top} on the card.*227 KB"):
            fk.check_loop_n(kind, top + 1)


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


@pytest.mark.parametrize("N", [16, 17, 64, 119])
def test_dispatch_unrolled_to_16_looped_above(on_card, N):
    """On the card K1, K2 (both ways), K6, K3f, K3b and K5 load the
    unrolled library of N channels up to 16 and the one looped library
    above; past its limit at these taps (K = 2 sections of P = 3: 115
    channels) K5 raises, naming it, before loading anything."""
    o = {k: torch.tensor(v) for k, v in _fdn_operands(N).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    want = ("fdn_kernels", N) if N <= fk.MAX_N else ("fdn_loop", 1)
    calls = [lambda: fk.fdn_solve_kernel(D, U, B),
             lambda: fk.fdn_solve_kernel(D, U, B, True),
             lambda: fk.dense_solve_kernel(fk._loop_matrix(D, U), B, True),
             lambda: fk.fdn_tf_mse_kernel(D, U, b, c, X, t, False, False),
             lambda: fk.fdn_tf_fwd_kernel(D, U, b, c),
             lambda: fk.fdn_tf_bwd_kernel(D, U, b, c, B, X)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no library"):
            call()
    assert on_card == [want] * len(calls)
    bt = torch.full((3, 2, N), 0.1)
    top = sk.loop_tf_mse_max_n(2, 3, True)
    assert top == 115
    if N <= top:
        with pytest.raises(RuntimeError, match="no library"):
            sk.fdn_sos_tf_mse_kernel(D, bt, bt, U, b, c, X, t, 64)
        assert on_card[-1] == (("sos_kernels", N) if N <= fk.MAX_N
                               else ("fdn_loop", 1))
    else:
        with pytest.raises(ValueError, match=rf"N = {N} channels, K = 2 "
                           rf"sections of P = 3 taps.*takes 1\.\.{top}"):
            sk.fdn_sos_tf_mse_kernel(D, bt, bt, U, b, c, X, t, 64)
    assert len(on_card) == len(calls) + (N <= top)


def test_looped_wrappers_name_their_limit_before_loading(on_card):
    """Above its limit a looped wrapper raises, naming it, before it loads
    the library; at it, it goes on to load."""
    for kind, top in fk.LOOP_MAX_N.items():
        for N in (top + 1, top):
            D = torch.zeros((2, N), dtype=torch.complex64)
            U = torch.zeros((N, N))
            v = torch.zeros(N)
            call = {"fdn_solve": lambda: fk.fdn_solve_loop_kernel(D, U, D),
                    "dense_solve": lambda: fk.dense_solve_loop_kernel(
                        torch.zeros((2, N, N), dtype=torch.complex64), D),
                    "fdn_tf_mse": lambda: fk.fdn_tf_mse_loop_kernel(
                        D, U, v, v, D[:, 0], torch.zeros(2)),
                    "fdn_tf_fwd": lambda: fk.fdn_tf_fwd_loop_kernel(
                        D, U, v, v),
                    "fdn_tf_bwd": lambda: fk.fdn_tf_bwd_loop_kernel(
                        D, U, v, v, D, D[:, 0])}[kind]
            n_loads = len(on_card)
            if N > top:
                with pytest.raises(ValueError, match=f"takes 1..{top}"):
                    call()
                assert len(on_card) == n_loads
            else:
                with pytest.raises(RuntimeError, match="no library"):
                    call()
                assert on_card[-1] == ("fdn_loop", 1)
