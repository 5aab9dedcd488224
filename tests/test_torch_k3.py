"""K3f and K3b (the FDN transfer function and its VJP) after their
redesign for the H100, on the CPU: what of them the CPU can check.

* The plain versions (``fdn_tf_fwd_plain``, ``fdn_tf_bwd_plain``, which
  the CUDA kernels are held to on the card) against the JAX package's
  ``pallas_fdn_tf`` forward and VJP in interpret mode (TILE = 256, as
  ``tests/test_ops.py`` runs it), eagerly, on random systems, systems that
  pivot at every step and tied pivots (``chip_smoke.k3_systems``): tf and
  y to 1e-5 of the max, the JAX kernel test's bound on values, and the
  cotangents to 1e-5 of the max, tighter than its 2e-3 (the gaps
  measured on these cases: at most 7.3e-7 on values and 1.4e-6 on
  cotangents), and y on the exact tied systems bit for bit: another
  pivot rule rounds their right-hand side D b another way.
* Five Adam steps of the port's ``colorless_train_step(fused_tf=True)``
  (the plain K3f and K3b) in lockstep with JAX's fused-tf step, whose
  K3 runs in interpret mode.
* ``chip_smoke.kernel_work`` and ``bound`` of K3f and K3b, unchanged by
  the redesign, and phase 3's fused-tf step and fused-response helpers
  at a small nfft.
* ``sparsity_loss`` against the JAX package's where the feedback's own
  map raises ``KeyError`` and its ``mixing_matrix`` maps.

tests/test_torch_cuda.py holds the CUDA kernels to these plain versions
and to the previous kernels on the card.
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

import flamo_tpu
import flamo_tpu.models as jm
from flamo_tpu.optimize.loss import sparsity_loss as jax_sparsity_loss
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.models import (build_colorless_fdn, colorless_loss,
                                    colorless_train_step)
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.optimize import sparsity_loss

REPO = Path(__file__).resolve().parents[1]
VAL_TOL, GRAD_TOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("N,M,label", [
    (3, 1, "random"), (3, 63, "pivoting"), (3, 65, "tied lower"),
    (3, 65, "tied upper"), (3, 4097, "random"), (6, 65, "pivoting"),
])
def test_fdn_tf_plain_matches_pallas(ps, smoke, N, M, label):
    """fdn_tf_fwd_plain and fdn_tf_bwd_plain against pallas_fdn_tf's
    forward and VJP kernels, on the forward system for K3f and the
    transposed one for K3b (k3_systems with transpose False and True):
    tf and y 1e-5 of the max, D_bar, U_bar, b_bar, c_bar 1e-5 of the max,
    and the exact tied systems' y bit for bit.  'tied lower' ties the
    forward elimination at every step, 'tied upper' the transposed one
    (N = 3, and one case at N = 6: each JAX call interprets the unrolled
    eliminations, eagerly, ~1 s at N = 3 and 6-12 s at N = 6 on one CPU
    core)."""
    for transpose in (False, True):
        system = smoke.k3_systems(np.random.default_rng(10 * N + M),
                                  M, N, transpose)[label]
        D, U, b, c, tf_bar = smoke.k3_tensors(system, "cpu")
        exact = system[5]
        tf, y = fk.fdn_tf_fwd_plain(D, U, b, c)
        tfj, res = ps._fdn_tf_fwd(*(jnp.asarray(x.numpy())
                                    for x in (D, U, b, c)))
        yj = np.asarray(res[4] + 1j * res[5]).T[:M]
        if not transpose:
            assert _rel(tf.numpy(), np.asarray(tfj)) < VAL_TOL
            assert _rel(y.numpy(), yj) < VAL_TOL
            assert np.array_equal(y.numpy()[exact], yj[exact])
            assert exact.all() == label.startswith("tied")
            continue
        got = fk.fdn_tf_bwd_plain(D, U, b, c, y, tf_bar)
        ref = ps._fdn_tf_bwd(res, jnp.asarray(tf_bar.numpy()))
        for g, r in zip(got, ref):
            assert _rel(g.numpy(), np.asarray(r)) < GRAD_TOL
        if label == "pivoting":
            A = fk._loop_matrix(D, U, transpose)
            assert smoke.pivot_vote_share(A) == (1.0, 1.0)


def test_k3_systems_gains_keep_the_exact_products_exact(smoke):
    """On the exact tied systems b and c are real, of magnitudes 1 and
    2^27 times a whole number plus 0.25, so D b (D powers of i) is exact
    in complex64; elsewhere b and c are normal.  Every label of
    k2_systems is there, with k2_systems' D and U."""
    for transpose in (False, True):
        systems = smoke.k3_systems(np.random.default_rng(5), 96, 6,
                                   transpose)
        assert set(systems) == set(smoke.k2_systems(
            np.random.default_rng(5), 96, 6, transpose))
        for label, (D, U, b, c, tf_bar, exact) in systems.items():
            assert D.shape == (96, 6) and U.shape == (6, 6)
            assert b.shape == c.shape == (6,) and tf_bar.shape == (96,)
            if not exact.all():
                continue
            for g in (b, c):
                m = np.abs(g) / np.where(np.abs(g) > 8, 2.0 ** 27, 1.0)
                assert np.all(np.isin(m % 1, (0.25,))) and np.all(m < 8)
            Dt, _, bt, _, _ = smoke.k3_tensors(
                (D, U, b, c, tf_bar, exact), "cpu")
            assert np.array_equal((Dt * bt).numpy(),
                                  (D * b).astype(np.complex64))


def test_fused_tf_train_step_lockstep_with_jax():
    """Five Adam steps at lr 1e-2 of colorless_train_step(fused_tf=True):
    the port's (plain K3f and K3b) against JAX's (its K3 in interpret
    mode, TILE = 256), at nfft = 256 with the JAX model's weights: loss
    history to 1e-4 relative, parameters to 1e-4 of their max."""
    import flamo_tpu.ops.pallas_solve as pallas_solve
    from jax.experimental import pallas as pl

    nfft, delays = 256, (89, 97, 107, 113)
    M = nfft // 2 + 1
    flamo_tpu.set_seed(12)
    mj = jm.build_colorless_fdn(nfft=nfft, delays=delays)
    params = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_leaves_with_path(mj)}
    mt = load_jax_params(build_colorless_fdn(nfft=nfft, delays=delays,
                                             device="cpu"), params)
    x = jnp.zeros((1, M, 1)).at[:, 0, :].set(1.0)
    t = jnp.ones((1, M, 1))
    hist_j = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_solve.pl, "pallas_call",
                   partial(pl.pallas_call, interpret=True))
        mp.setattr(pallas_solve, "TILE", 256)
        step, opt = jm.colorless_train_step(mj, lr=1e-2, fused_tf=True)
        step = jax.jit(step)
        for _ in range(5):
            mj, opt, loss = step(mj, opt, x, t)
            hist_j.append(float(loss))
    step_t, _ = colorless_train_step(mt, lr=1e-2, fused_tf=True)
    xt = torch.zeros((1, M, 1))
    xt[:, 0, :] = 1.0
    fk.reset_launch_counts()
    hist_t = [float(step_t(xt, torch.ones((1, M, 1)))) for _ in range(5)]
    assert sum(fk.LAUNCHES.values()) == 0  # the CPU runs the plain versions
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    assert hist_t[-1] < hist_t[0]
    named = jax_named_tensors(mt)
    for k, v in jax.tree_util.tree_leaves_with_path(mj):
        k = jax.tree_util.keystr(k)
        ref = np.asarray(v)
        assert (np.abs(named[k].detach().numpy() - ref).max()
                <= 1e-4 * max(np.abs(ref).max(), 1e-9)), k


def test_k3_bounds_unchanged(smoke):
    """chip_smoke.kernel_work's bytes and operations of K3f and K3b, and
    the bounds from them at the main path's shape (0.001490 ms and
    0.002200 ms, both by bytes), are those of the kernels before the
    redesign: the work the functions need did not change."""
    assert smoke.kernel_work("fdn_tf_fwd", 48001, 6) == (4992296, 51361070)
    assert smoke.kernel_work("fdn_tf_bwd", 48001, 6) == (7370040, 70417467)
    for name, ms in (("fdn_tf_fwd", 0.001490), ("fdn_tf_bwd", 0.002200)):
        got, by = smoke.bound(name, 48001, 6)
        assert (round(got, 6), by) == (ms, "bytes")


def test_previous_libraries_bind_their_own_entry_points(smoke,
                                                       monkeypatch):
    """chip_smoke.Previous sets the argument types of each control's own C
    entry points and of no other's: K1, K2 and K6 for fdn_kernels_prev,
    those and K3f and K3b for fdn_tf_prev, K4's for sos_kernels_prev,
    K9's for aa_kernels_prev (a stand-in library takes the attributes)."""
    class Lib:
        """Makes each entry point it is asked for, as ctypes does."""

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    class Proc:
        returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(smoke.ctypes, "CDLL", lambda path: Lib())
    keys = (("fdn", 6), ("tf", 3), ("tf", 6), ("sos", 6), ("aa", 4))
    prev = smoke.Previous({k: Proc() for k in keys})
    fdn = {"fdn_tf_mse_launch", "fdn_dense_solve_launch", "fdn_solve_launch"}
    want = {"fdn": fdn,
            "tf": fdn | {"fdn_tf_fwd_launch", "fdn_tf_bwd_launch"},
            "sos": {"sos_cascade_fwd_launch", "sos_cascade_bwd_launch"},
            "aa": {"aa_taps_grid", "aa_taps_tf_mse_launch"}}
    for key, n in keys:
        assert set(vars(prev.libs[key, n])) == want[key], (key, n)
    assert prev.lib is prev.libs["fdn", 6]


def test_phase3_fused_tf_helpers_run_on_the_cpu(smoke):
    """Phase 3's helpers at nfft = 512 on the CPU: fused_tf_steps takes
    Adam steps whose loss falls from the graph loss, fused_evals returns
    the last of its responses, equal to get_freq_response (1e-5 of the
    max), and neither launches a kernel."""
    model = build_colorless_fdn(nfft=512, delays=(89, 97, 107, 113),
                                device="cpu",
                                generator=torch.Generator().manual_seed(4))
    x, t = smoke.colorless_pair(model)
    assert x.shape == t.shape == (1, 257, 1) and float(x.sum()) == 1.0
    with torch.no_grad():
        H = model.get_freq_response()
        l0 = float(colorless_loss(model, x, t))
    fk.reset_launch_counts()
    H_fused = smoke.fused_evals(model)(2)
    assert H_fused.shape == H.shape == (1, 257, 1)
    assert _rel(H_fused.numpy(), H.numpy()) < 1e-5
    losses = smoke.fused_tf_steps(model)(3)
    assert len(losses) == 3 and abs(float(losses[0]) - l0) < 1e-4 * l0
    assert float(losses[-1]) < float(losses[0])
    assert sum(fk.LAUNCHES.values()) == 0


class _Map:
    """A module stand-in whose map scales its parameter (any array type),
    or raises KeyError, as a mapping keyed by name might."""

    def __init__(self, param, raises: bool = False):
        self.param = param
        self.raises = raises

    def map(self, p):
        if self.raises:
            raise KeyError("map")
        return 0.5 * p


class _Model:
    """A model whose core's feedback_loop.feedback raises KeyError from its
    own map and keeps the mixing matrix as ``mixing_matrix``."""

    def __init__(self, param):
        feedback = _Map(param, raises=True)
        feedback.mixing_matrix = _Map(param)
        loop = type("Loop", (), {"feedback": feedback})()
        self.core = type("Core", (), {"feedback_loop": loop})()

    def get_core(self):
        return self.core


@pytest.mark.parametrize("shape", [(6, 6), (3, 4, 4)])
def test_sparsity_loss_falls_back_on_key_error_as_jax(shape):
    """Where feedback.map raises KeyError, sparsity_loss scores
    feedback.mixing_matrix, as the JAX package's does (1e-6 relative; a
    (3, 4, 4) stack takes the mean branch)."""
    p = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = float(sparsity_loss()(None, None, _Model(torch.tensor(p))))
    ref = float(jax_sparsity_loss()(None, None, _Model(jnp.asarray(p))))
    assert abs(got - ref) <= 1e-6 * abs(ref)
