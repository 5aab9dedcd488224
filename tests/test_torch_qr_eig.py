"""The port's Hessenberg + shifted-QR eigensolver (``ops.qr_eig``) and its
pivoted solve for any N (``ops.solve.gauss_solve_loop``), held against
flamo_tpu on the CPU.

Eigenvalues are compared as sets (``chip_smoke.match_sets``: greedy
nearest match, over the largest magnitude), against the JAX package's ``eigvals_qr`` and against LAPACK
(``torch.linalg.eigvals``) as a second oracle, to the JAX tests' 1e-4
(tests/test_functional.py:445-487).  The gradient of a sorted-magnitude
MSE through ``eigvals_qr_grad`` is held to JAX's ``eigvals_lapack`` VJP:
the loss to 1e-4, the gradient to 5e-3 of its max (:622-645).  A complex
gradient in PyTorch is the conjugate of JAX's cotangent.  The N = 64,
128 and 192 cases are marked slow, as in the JAX package: eagerly, every
Givens rotation of every sweep is a handful of PyTorch calls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu import functional as JF
from flamo_tpu.ops import qr_eig as jqr
from flamo_tpu.ops.solve import gauss_solve_loop as jax_gauss_solve_loop
from chip_smoke import match_sets
from flamo_tpu_torch import functional as F
from flamo_tpu_torch.ops import qr_eig
from flamo_tpu_torch.ops.solve import gauss_solve, gauss_solve_loop

SET_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-4, 5e-3


def _random(rng, shape, complex_: bool):
    if complex_:
        return (rng.normal(size=shape)
                + 1j * rng.normal(size=shape)).astype(np.complex64)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("complex_", [True, False], ids=["complex", "real"])
@pytest.mark.parametrize("N", [13, 16])
def test_eigvals_qr_matches_jax_and_lapack(N, complex_):
    A = _random(np.random.default_rng(7 + N), (6, N, N), complex_)
    z = qr_eig.eigvals_qr(torch.from_numpy(A)).numpy()
    assert z.shape == (6, N) and z.dtype == np.complex64
    zj = np.asarray(jax.jit(JF.eigvals_qr)(jnp.asarray(A)))
    assert match_sets(z, zj) < SET_TOL
    assert match_sets(z, torch.linalg.eigvals(torch.from_numpy(A)).numpy()) \
        < SET_TOL


def test_eigvals_qr_clustered_spectrum():
    """Eigenvalues 1e-3 apart, as tests/test_functional.py:465-481."""
    rng = np.random.default_rng(8)
    N = 12
    d = np.concatenate([np.full(N // 2, 1.0), np.full(N - N // 2, 1.0 + 1e-3)])
    Q = np.linalg.qr(rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N)))[0]
    A = (Q @ np.diag(d) @ Q.conj().T).astype(np.complex64)[None]
    z = qr_eig.eigvals_qr(torch.from_numpy(A)).numpy()
    assert match_sets(z, np.linalg.eigvals(A)) < SET_TOL


def test_eigvals_qr_circulant_needs_the_exceptional_shift():
    """A circulant permutation block, where the Wilkinson shift sits
    between two eigenvalues (tests/test_functional.py:483-486)."""
    P = np.eye(10, dtype=np.complex64)[list(range(1, 10)) + [0]][None]
    z = qr_eig.eigvals_qr(torch.from_numpy(P)).numpy()
    assert match_sets(z, np.linalg.eigvals(P)) < SET_TOL


def test_eigvals_qr_batch_shapes_and_n1():
    rng = np.random.default_rng(3)
    A = torch.from_numpy(_random(rng, (2, 3, 5, 5), True))
    z = qr_eig.eigvals_qr(A)
    assert z.shape == (2, 3, 5)
    assert match_sets(z.numpy(), torch.linalg.eigvals(A).numpy()) < SET_TOL
    one = torch.tensor([[[2.5 - 1j]]], dtype=torch.complex64)
    assert torch.equal(qr_eig.eigvals_qr(one), one[..., 0])
    assert qr_eig.eigvals_qr(A.real.double()).dtype == torch.complex128


def test_hessenberg_dyn_matches_static_and_jax():
    """tests/test_functional.py:589-603: the masked reduction is the same
    math as the windowed one; both match JAX's and leave nothing below
    the first subdiagonal."""
    A = _random(np.random.default_rng(5), (3, 12, 12), True)
    Hs = qr_eig._hessenberg(torch.from_numpy(A)).numpy()
    Hd = qr_eig._hessenberg_dyn(torch.from_numpy(A)).numpy()
    scale = np.abs(Hs).max()
    assert np.abs(Hs - Hd).max() < 1e-5 * scale
    Hj = np.asarray(jax.jit(jqr._hessenberg)(jnp.asarray(A)))
    assert np.abs(Hs - Hj).max() < 1e-5 * scale
    tri = np.tril(np.ones((12, 12)), -2).astype(bool)
    assert np.abs(Hd[:, tri]).max() < 1e-5 * scale


def test_wilkinson_shift_matches_jax():
    blk = _random(np.random.default_rng(4), (8, 2, 2), True)
    got = qr_eig._wilkinson_shift(torch.from_numpy(blk)).numpy()
    want = np.asarray(jax.jit(jqr._wilkinson_shift)(jnp.asarray(blk)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _sorted_mse(eig, A, t):
    m = torch.sort(torch.abs(eig(A)), dim=-1).values
    return torch.mean((m - t) ** 2)


def _jax_sorted_mse(eig, A, t):
    m = jnp.sort(jnp.abs(eig(A)), axis=-1)
    return jnp.mean((m - t) ** 2)


@pytest.mark.parametrize("complex_", [True, False], ids=["complex", "real"])
def test_eigvals_qr_grad_matches_jax_lapack_vjp(complex_):
    """tests/test_functional.py:622-660 at N = 16 (complex) and 12 (real,
    whose gradient stays real)."""
    rng = np.random.default_rng(21)
    N = 16 if complex_ else 12
    A = _random(rng, (4, N, N), complex_)
    t = rng.uniform(size=(4, N)).astype(np.float32)
    At = torch.from_numpy(A).requires_grad_()
    loss = _sorted_mse(qr_eig.eigvals_qr_grad, At, torch.from_numpy(t))
    loss.backward()
    assert At.grad.dtype == At.dtype
    lj, gj = jax.value_and_grad(
        lambda X: _jax_sorted_mse(JF.eigvals_lapack, X, jnp.asarray(t)))(
        jnp.asarray(A))
    assert abs(float(loss.detach()) - float(lj)) / abs(float(lj)) < LOSS_TOL
    want = np.conj(np.asarray(gj))  # PyTorch's gradient: JAX's, conjugated
    got = At.grad.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < GRAD_TOL
    # and torch.linalg.eigvals' own autograd, the port's LAPACK route
    Al = torch.from_numpy(A).requires_grad_()
    _sorted_mse(torch.linalg.eigvals, Al, torch.from_numpy(t)).backward()
    assert np.abs(got - Al.grad.numpy()).max() / np.abs(want).max() \
        < GRAD_TOL


def test_right_eigvecs_are_eigenvectors():
    rng = np.random.default_rng(2)
    A = torch.from_numpy(_random(rng, (3, 9, 9), True))
    lam = qr_eig.eigvals_qr(A)
    V = qr_eig._right_eigvecs(A, lam)
    resid = A @ V - V * lam[:, None, :]
    assert float(resid.abs().max()) < 1e-4 * float(A.abs().max())


@pytest.mark.parametrize("vector", [True, False], ids=["vector", "matrix"])
def test_gauss_solve_loop_matches_jax(vector):
    """N = 40 (the JAX package's rolled variant): values and the VJP of
    <w, Y> in both operands, against JAX's ``gauss_solve_loop``."""
    rng = np.random.default_rng(40)
    N = 40
    A = _random(rng, (5, N, N), True) + 4 * np.eye(N, dtype=np.complex64)
    B = _random(rng, (5, N) if vector else (5, N, 3), True)
    W = _random(rng, B.shape, True)
    At = torch.from_numpy(A).requires_grad_()
    Bt = torch.from_numpy(B).requires_grad_()
    Y = gauss_solve_loop(At, Bt)
    torch.real(torch.sum(torch.from_numpy(W) * Y)).backward()

    def f(A, B):
        return jnp.real(jnp.sum(jnp.asarray(W) * jax_gauss_solve_loop(A, B)))

    Yj = np.asarray(jax.jit(jax_gauss_solve_loop)(jnp.asarray(A),
                                                  jnp.asarray(B)))
    gA, gB = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(A),
                                                  jnp.asarray(B))
    for got, want in ((Y.detach().numpy(), Yj),
                      (At.grad.numpy(), np.conj(np.asarray(gA))),
                      (Bt.grad.numpy(), np.conj(np.asarray(gB)))):
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # one elimination: the unrolled solve, pivoted, gives the same bits
    assert torch.equal(Y, gauss_solve(At, Bt))


def test_functional_exports_and_lapack_route():
    assert F.eigvals_qr is qr_eig.eigvals_qr
    assert F.eigvals_qr_grad is qr_eig.eigvals_qr_grad
    assert F.EIG_QR_MAX_N == JF.EIG_QR_MAX_N == 128
    A = torch.from_numpy(_random(np.random.default_rng(1), (2, 10, 10), True))
    # get_eigenvalues and eigvals stay torch.linalg.eigvals
    assert torch.equal(F.get_eigenvalues(A), torch.linalg.eigvals(A))
    assert torch.equal(F.eigvals(A), torch.linalg.eigvals(A))


@pytest.mark.slow
def test_eigvals_qr_n64_values_and_grad():
    rng = np.random.default_rng(17)
    A = _random(rng, (2, 64, 64), True)
    z = qr_eig.eigvals_qr(torch.from_numpy(A)).numpy()
    assert match_sets(z, np.linalg.eigvals(A)) < SET_TOL
    t = torch.from_numpy(rng.uniform(size=(2, 64)).astype(np.float32))
    At = torch.from_numpy(A).requires_grad_()
    _sorted_mse(qr_eig.eigvals_qr_grad, At, t).backward()
    Al = torch.from_numpy(A).requires_grad_()
    _sorted_mse(torch.linalg.eigvals, Al, t).backward()
    assert float((At.grad - Al.grad).abs().max() / Al.grad.abs().max()) \
        < GRAD_TOL


@pytest.mark.slow
@pytest.mark.parametrize("N, tol", [(128, 2e-4), (192, 5e-4)])
def test_eigvals_qr_large_n(N, tol):
    """Above ``_HESS_STATIC_MAX_N``, through the masked Hessenberg
    reduction (tests/test_functional.py:529-620 bounds)."""
    rng = np.random.default_rng(N)
    A = (_random(rng, (1, N, N), True) / np.sqrt(N)).astype(np.complex64)
    z = qr_eig.eigvals_qr(torch.from_numpy(A)).numpy()
    assert match_sets(z, np.linalg.eigvals(A)) < tol
