"""Three names of the JAX package's surface, on the CPU:
``Trainer(profile_dir=...)`` (a ``torch.profiler`` trace of epoch 1, the
counterpart of the JAX Trainer's ``jax.profiler`` trace), and the aliases
``functional.eigvals_lapack`` (the port's ``eigvals``) and
``auxiliary.scattering.shift_matrix`` (``shift_matrix_static``), each
held against the JAX name: the eigenvalues as sets at the JAX tests'
1e-4 (tests/test_functional.py), the shifted matrices exactly."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import match_sets
from flamo_tpu import functional as JF
from flamo_tpu.auxiliary import scattering as jsc
from flamo_tpu_torch import functional as F
from flamo_tpu_torch.auxiliary import scattering as tsc
from flamo_tpu_torch.models import build_colorless_fdn
from flamo_tpu_torch.optimize import Trainer, mse_loss

NFFT = 256
DELAYS = (23, 29, 31)


def _batches(n: int, seed: int):
    rng = np.random.default_rng(seed)
    M = NFFT // 2 + 1
    x = torch.zeros((1, M, 1))
    x[0, 0, 0] = 1.0
    return [(x, torch.tensor(1.0 + 0.1 * rng.normal(size=(1, M, 1)),
                             dtype=torch.float32)) for _ in range(n)]


def _train(profile_dir):
    model = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu",
                                generator=torch.Generator().manual_seed(4))
    tr = Trainer(model, max_epochs=2, lr=1e-3, log=False, fused="off",
                 profile_dir=profile_dir)
    tr.register_criterion(mse_loss(), 1)
    tr.train(_batches(3, 0), _batches(1, 1))
    return tr


def test_trainer_profile_dir_traces_epoch_1(tmp_path):
    """A two-epoch run with profile_dir writes epoch 1's trace there (the
    training steps' operations in it) and trains to the same losses, bit
    for bit, as the same run without it."""
    out = tmp_path / "profile"
    traced = _train(str(out))
    plain = _train(None)
    assert traced.profile_dir == str(out) and plain.profile_dir is None
    assert traced.train_loss == plain.train_loss
    assert traced.valid_loss == plain.valid_loss
    assert len(traced.train_loss) == 2
    trace = json.loads((out / "trace_epoch1.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("Optimizer.step" in n for n in names)
    assert [p.name for p in out.iterdir()] == ["trace_epoch1.json"]


def test_eigvals_lapack_is_eigvals_and_matches_jax():
    assert F.eigvals_lapack is F.eigvals
    rng = np.random.default_rng(2)
    A = (rng.normal(size=(3, 7, 7))
         + 1j * rng.normal(size=(3, 7, 7))).astype(np.complex64)
    got = F.eigvals_lapack(torch.tensor(A)).numpy()
    assert match_sets(got, np.asarray(JF.eigvals_lapack(jnp.asarray(A)))) \
        < 1e-4


def test_shift_matrix_is_shift_matrix_static_and_matches_jax():
    assert tsc.shift_matrix is tsc.shift_matrix_static
    X = np.random.default_rng(3).normal(size=(4, 4, 5)).astype(np.float32)
    shift = [0, 3, 1, 2]
    for direction in ("left", "right"):
        got = tsc.shift_matrix(torch.tensor(X), shift, direction).numpy()
        want = np.asarray(jsc.shift_matrix(jnp.asarray(X), shift, direction))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
