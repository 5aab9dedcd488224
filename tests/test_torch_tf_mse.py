"""K1, the colorless FDN's fused step, on the CPU: the port's plain version
(``fdn_tf_mse_plain``, which the CUDA kernel is held to on the card)
against the JAX package's ``pallas_fdn_tf_mse`` through the Pallas
interpreter, in all four (pivot, with_dbar) variants, at bin counts that
are no multiple of the kernel's 128-bin blocks: 1, 63, 65 and 4097.  The
loss to 1e-5, the D/U/b/c cotangents to 2e-3 of the max, as
``tests/test_torch_kernels.py`` holds them.  Beside them, the bounds that
chip_smoke.py computes for K1 and K6 stay the work of the function.
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

from flamo_tpu_torch.ops import fdn_kernels as fk

REPO = Path(__file__).resolve().parents[1]
VAL_TOL, GRAD_TOL = 1e-5, 2e-3


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


def _operands(seed: int, M: int, N: int = 3):
    rng = np.random.default_rng(seed)
    return dict(
        D=(0.8 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))))
        .astype(np.complex64),
        U=np.linalg.qr(rng.normal(size=(N, N)))[0].astype(np.float32),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        X=(rng.normal(size=M) + 1j * rng.normal(size=M)).astype(np.complex64),
        t=rng.uniform(size=M).astype(np.float32),
    )


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("M", [1, 63, 65, 4097])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("with_dbar", [True, False])
def test_fdn_tf_mse_ragged_matches_pallas(ps, M, pivot, with_dbar):
    o = _operands(M + 2 * pivot + with_dbar, M)
    X, t = jnp.asarray(o["X"]), jnp.asarray(o["t"])

    def loss_j(D, U, b, c):
        return ps.pallas_fdn_tf_mse(D, U, b, c, X, t, with_dbar=with_dbar,
                                    pivot=pivot)

    lj, gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(o[n]) for n in "DUbc"))
    D, U, b, c = (torch.tensor(o[n], requires_grad=True) for n in "DUbc")
    lt = fk.fdn_tf_mse(D, U, b, c, torch.tensor(o["X"]),
                       torch.tensor(o["t"]), with_dbar=with_dbar, pivot=pivot)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) / abs(float(lj)) < VAL_TOL
    for x, g in zip((U, b, c), gj[1:]):
        assert _rel(x.grad.numpy(), g) < GRAD_TOL
    if with_dbar:
        assert _rel(np.conj(D.grad.resolve_conj().numpy()), gj[0]) < GRAD_TOL
    else:
        assert D.grad is None


@pytest.mark.parametrize("name,M,kw,want", [
    ("fdn_tf_mse", 48001, dict(pivot=False, with_dbar=False), 0.001127),
    ("dense_solve", 48001, {}, 0.005502),
    ("dense_solve", 2000, {}, 0.000229),
])
def test_bounds_are_the_same_work(smoke, name, M, kw, want):
    """The yardsticks of the redesigned kernels do not move: the
    function's work, whatever implements it."""
    ms, _ = smoke.bound(name, M, 6, **kw)
    assert round(ms, 6) == want
