"""K6, the dense per-bin solve, on the CPU: the port's plain version
(``dense_solve_plain``, which the CUDA kernel is held to on the card)
against the JAX package's ``pallas_gauss_solve``, values and VJP, at the
row counts around the kernel's blocks (1, 31, 33) and the masked step's
2000, N = 3 and 6, and on tied-pivot systems, where both must take the
first maximal row.

The Pallas kernel runs through the interpreter (TILE = 256, as
``tests/test_ops.py`` runs it), eagerly: inside a jit its N = 6 unrolled
elimination takes minutes to compile, and eagerly a call of 2000 rows at
N = 6 takes longer still, so that case is held to ``gauss_solve``, the
JAX package's plain elimination that ``tests/test_ops.py`` holds the
Pallas kernel's gradients to.  Tolerances are ``tests/test_ops.py``'s:
1e-4 absolute on values, 1e-3 of the max on gradients.  On the exact
tied-pivot systems (unit multipliers, see ``chip_smoke.tied_pivot_systems``)
the two agree bit for bit: another pivot rule rounds their rhs another
way.
"""

from __future__ import annotations

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.ops.solve import gauss_solve
from flamo_tpu_torch.ops import fdn_kernels as fk

REPO = Path(__file__).resolve().parents[1]
VAL_TOL, GRAD_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def ps():
    """flamo_tpu's Pallas kernels through the interpreter, TILE = 256."""
    import flamo_tpu.ops.pallas_solve as pallas_solve
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_solve.pl, "pallas_call",
                   partial(pl.pallas_call, interpret=True))
        mp.setattr(pallas_solve, "TILE", 256)
        yield pallas_solve


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _system(seed: int, rows: int, N: int):
    """Well-conditioned systems: I plus a normal complex matrix of norm
    ~0.5, and a normal rhs."""
    rng = np.random.default_rng(seed)
    A = np.eye(N) + ((rng.normal(size=(rows, N, N))
                      + 1j * rng.normal(size=(rows, N, N)))
                     / (4 * np.sqrt(N)))
    B = rng.normal(size=(rows, N)) + 1j * rng.normal(size=(rows, N))
    return A.astype(np.complex64), B.astype(np.complex64)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_value_and_vjp(solve, A, B, y_bar):
    """JAX's y and its VJP (A_bar, B_bar) for the cotangent y_bar, eagerly."""
    y, vjp = jax.vjp(solve, jnp.asarray(A), jnp.asarray(B))
    return (np.asarray(y),) + tuple(np.asarray(g)
                                    for g in vjp(jnp.asarray(y_bar)))


def _port_value_and_vjp(A, B, y_bar):
    """The port's y and its gradients for the same cotangent: PyTorch's
    complex gradients are the conjugates of JAX's cotangents, so the
    incoming gradient is conj(y_bar) and the results are conjugated."""
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    y = fk.dense_solve(At, Bt)
    y.backward(torch.tensor(np.conj(y_bar)))
    return (y.detach().numpy(), np.conj(At.grad.numpy()),
            np.conj(Bt.grad.numpy()))


def _check(got, ref):
    assert float(np.abs(got[0] - ref[0]).max()) < VAL_TOL
    for g, r in zip(got[1:], ref[1:]):
        assert _rel(g, r) < GRAD_TOL


@pytest.mark.parametrize("N,rows", [(3, 1), (3, 31), (3, 33), (3, 2000),
                                    (6, 1), (6, 31), (6, 33), (6, 2000)])
def test_dense_solve_matches_jax(ps, N, rows):
    A, B = _system(10 * N + rows, rows, N)
    y_bar = _system(rows, rows, N)[1]
    solve = gauss_solve if (N, rows) == (6, 2000) else ps.pallas_gauss_solve
    _check(_port_value_and_vjp(A, B, y_bar),
           _jax_value_and_vjp(solve, A, B, y_bar))


@pytest.mark.parametrize("N", [3, 6])
def test_dense_solve_tied_pivots_match_jax(ps, smoke, N):
    """Tied pivot columns: the port and JAX agree at the same bounds, and
    on the exact systems bit for bit, values and VJP, both ways (the
    transposed solve is the VJP's)."""
    A, B, exact = smoke.tied_pivot_systems(np.random.default_rng(N), 40, N)
    A, B = A.astype(np.complex64), B.astype(np.complex64)
    y_bar = (B / np.abs(B).max()).astype(np.complex64)
    got = _port_value_and_vjp(A, B, y_bar)
    ref = _jax_value_and_vjp(ps.pallas_gauss_solve, A, B, y_bar)
    for g, r in zip(got, ref):
        assert _rel(g, r) < VAL_TOL
    for g, r in zip((got[0], got[2]), (ref[0], ref[2])):
        assert np.array_equal(g[exact], r[exact])


@pytest.mark.parametrize("N", [1, 2, 3, 6, 16])
def test_tied_pivot_systems_tie(smoke, N):
    """Every exact tied-pivot system ties in |a| among the nonzero
    candidates of its first column, one way or the other, and the plain
    version solves them to float32 rounding of the float64 solve (1e-6 of
    the max)."""
    A, B, exact = smoke.tied_pivot_systems(np.random.default_rng(0), 30, N)
    assert exact.sum() >= 15
    for a in A[exact]:
        if N > 1:
            col = np.abs(a[:, 0]) if np.abs(a[:, 0]).min() > 0 else np.abs(
                a[0, :])
            assert np.ptp(col[col > 0]) == 0
    y = fk.dense_solve_plain(torch.tensor(A.astype(np.complex64)),
                             torch.tensor(B.astype(np.complex64)))
    ref = np.linalg.solve(A.astype(np.complex64).astype(np.complex128),
                          B.astype(np.complex64)[..., None].astype(
                              np.complex128))[..., 0]
    scale = np.abs(ref[exact]).max()
    assert np.abs(y.numpy()[exact] - ref[exact]).max() <= 1e-6 * scale
