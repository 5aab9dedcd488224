"""The port's FDN kernels K1, K2 and K3 and its solve layer, held against
flamo_tpu.

On the CPU each kernel wrapper runs its plain PyTorch version, which is
compared with the JAX Pallas kernel in interpret mode (TILE patched to
256, as tests/test_ops.py does) on the same seeded numpy inputs, to the
JAX kernel tests' tolerances: 1e-5 relative on values, 2e-3 of the max on
gradients.  PyTorch's gradient of a complex tensor is the conjugate of
JAX's cotangent, so complex gradients are compared with conj(jax.grad).

tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu_torch
from flamo_tpu_torch.core import masked_optimizer, trainable_mask
from flamo_tpu_torch.functional import expm_skew
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops.solve import closed_loop_solve
from flamo_tpu_torch.processor import dsp, system

REPO = Path(__file__).resolve().parents[1]
VAL_TOL = 1e-5
GRAD_TOL = 2e-3


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The JAX Pallas kernels through the interpreter, TILE = 256."""
    import flamo_tpu.ops.pallas_solve as ps
    from jax.experimental import pallas as pl

    orig_call = pl.pallas_call
    monkeypatch.setattr(ps.pl, "pallas_call",
                        partial(orig_call, interpret=True))
    monkeypatch.setattr(ps, "TILE", 256)
    return ps


def _operands(seed: int, M: int = 300, N: int = 3, radius: float = 0.8):
    rng = np.random.default_rng(seed)
    return dict(
        D=(radius * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))))
        .astype(np.complex64),
        U=np.linalg.qr(rng.normal(size=(N, N)))[0].astype(np.float32),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        B=(rng.normal(size=(M, N)) + 1j * rng.normal(size=(M, N)))
        .astype(np.complex64),
        X=(rng.normal(size=M) + 1j * rng.normal(size=M)).astype(np.complex64),
        t=rng.uniform(size=M).astype(np.float32),
    )


def _leaves(ops, names, device="cpu"):
    return [torch.tensor(ops[n], device=device, requires_grad=True)
            for n in names]


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _grad_np(x):
    return x.grad.detach().resolve_conj().cpu().numpy()


# ---------------------------------------------------------------------------
# kernel-level parity on the CPU: plain versions vs Pallas interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("with_dbar", [True, False])
def test_fdn_tf_mse_matches_pallas(pallas_interpret, pivot, with_dbar):
    ps = pallas_interpret
    o = _operands(41)
    X, t = jnp.asarray(o["X"]), jnp.asarray(o["t"])

    def loss_j(D, U, b, c):
        return ps.pallas_fdn_tf_mse(D, U, b, c, X, t, with_dbar=with_dbar,
                                    pivot=pivot)

    lj, gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(o[n]) for n in "DUbc"))
    D, U, b, c = _leaves(o, "DUbc")
    lt = fk.fdn_tf_mse(D, U, b, c, torch.tensor(o["X"]), torch.tensor(o["t"]),
                       with_dbar=with_dbar, pivot=pivot)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) / abs(float(lj)) < VAL_TOL
    for x, g in zip((U, b, c), gj[1:]):
        assert _rel(_grad_np(x), g) < GRAD_TOL
    if with_dbar:
        assert _rel(_grad_np(D), np.conj(np.asarray(gj[0]))) < GRAD_TOL
    else:
        # JAX returns zeros for the frozen D; the port returns no gradient
        assert bool(jnp.all(gj[0] == 0))
        assert D.grad is None


def test_fdn_solve_matches_pallas(pallas_interpret):
    ps = pallas_interpret
    o = _operands(12)

    def loss_j(D, U, B):
        return jnp.sum(jnp.abs(ps.pallas_fdn_solve(D, U, B)) ** 2)

    args = [jnp.asarray(o[n]) for n in "DUB"]
    yj = ps.pallas_fdn_solve(*args)
    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(*args)
    D, U, B = _leaves(o, "DUB")
    y = fk.fdn_solve(D, U, B)
    assert _rel(y.detach().numpy(), yj) < VAL_TOL
    torch.sum(torch.abs(y) ** 2).backward()
    assert _rel(_grad_np(D), np.conj(np.asarray(gj[0]))) < GRAD_TOL
    assert _rel(_grad_np(U), gj[1]) < GRAD_TOL
    assert _rel(_grad_np(B), np.conj(np.asarray(gj[2]))) < GRAD_TOL


def test_fdn_tf_matches_pallas(pallas_interpret):
    ps = pallas_interpret
    o = _operands(30, radius=0.85)

    def loss_j(D, U, b, c):
        return jnp.sum(jnp.abs(ps.pallas_fdn_tf(D, U, b, c)) ** 2)

    args = [jnp.asarray(o[n]) for n in "DUbc"]
    tfj = ps.pallas_fdn_tf(*args)
    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(*args)
    D, U, b, c = _leaves(o, "DUbc")
    tf = fk.fdn_tf(D, U, b, c)
    assert tf.shape == (300,)
    assert _rel(tf.detach().numpy(), tfj) < VAL_TOL
    torch.sum(torch.abs(tf) ** 2).backward()
    assert _rel(_grad_np(D), np.conj(np.asarray(gj[0]))) < GRAD_TOL
    for x, g in zip((U, b, c), gj[1:]):
        assert _rel(_grad_np(x), g) < GRAD_TOL


def test_fdn_solve_transposed_plain_solves_transpose():
    """K2's transposed plain version solves (I - diag(D) U)^T y = B."""
    o = _operands(5, M=64, N=5)
    D, U, B = (torch.tensor(o[n]) for n in "DUB")
    A = (torch.eye(5, dtype=torch.complex64)[None]
         - D[:, :, None] * U[None].to(torch.complex64))
    y = fk.fdn_solve_plain(D, U, B, transpose=True)
    ref = torch.linalg.solve(A.transpose(-1, -2), B[..., None])[..., 0]
    assert float((y - ref).abs().max() / ref.abs().max()) < VAL_TOL


def test_fdn_tf_mse_zero_magnitude_bins_are_safe():
    """Bins with X = t = 0 (|tf X| = 0) take the safe divide: finite
    gradients, and exactly zero loss and D cotangent there."""
    o = _operands(3, M=40, N=3)
    o["X"][::4] = 0
    o["t"][::4] = 0
    D, U, b, c, X, t = (torch.tensor(o[n]) for n in "DUbcXt")
    loss, D_bar, U_bar, b_bar, c_bar = fk.fdn_tf_mse_plain(
        D, U, b, c, X, t, with_dbar=True, pivot=False)
    for g in (loss, D_bar, U_bar, b_bar, c_bar):
        assert bool(torch.isfinite(torch.view_as_real(g) if g.is_complex()
                                   else g).all())
    assert bool((D_bar[::4] == 0).all())


def test_fdn_kernels_reject_bad_operands():
    o = _operands(1, M=8, N=3)
    D, U, b, c = (torch.tensor(o[n]) for n in "DUbc")
    with pytest.raises(TypeError, match="U must be"):
        fk.fdn_tf_fwd_kernel(D, U.double(), b, c)
    with pytest.raises(ValueError, match="channels"):
        fk.fdn_solve_kernel(torch.zeros((8, 0), dtype=torch.complex64),
                            torch.zeros((0, 0)),
                            torch.zeros((8, 0), dtype=torch.complex64))
    # past 16 channels the CPU takes the plain version; on the card the
    # looped kernel takes up to its shared-memory limit, named
    N = fk.LOOP_MAX_N["fdn_solve"] + 1
    with pytest.raises(ValueError, match=f"N = {N} channels"):
        fk.check_loop_n("fdn_solve", N)


# ---------------------------------------------------------------------------
# the solve layer, the functional core and the optimizer vs flamo_tpu
# ---------------------------------------------------------------------------
def _random_system(M, N, seed):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(M, N, N))
         + 1j * rng.normal(size=(M, N, N))).astype(np.complex64)
    A += (3.0 * np.eye(N)).astype(np.complex64)
    B = (rng.normal(size=(M, N))
         + 1j * rng.normal(size=(M, N))).astype(np.complex64)
    return A, B


@pytest.mark.parametrize("method", ["ge", "ge_nopivot", "ge_cached", "lu"])
def test_closed_loop_solve_matches_jax(method):
    from flamo_tpu.ops.solve import closed_loop_solve as jax_solve

    A, B = _random_system(64, 4, seed=len(method))

    def loss_j(A, B):
        return jnp.sum(jnp.abs(jax_solve(A, B, method=method)) ** 2)

    yj = jax_solve(jnp.asarray(A), jnp.asarray(B), method=method)
    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    At, Bt = (torch.tensor(a, requires_grad=True) for a in (A, B))
    y = closed_loop_solve(At, Bt, method=method)
    assert _rel(y.detach().numpy(), yj) < VAL_TOL
    torch.sum(torch.abs(y) ** 2).backward()
    assert _rel(_grad_np(At), np.conj(np.asarray(gj[0]))) < 1e-4
    assert _rel(_grad_np(Bt), np.conj(np.asarray(gj[1]))) < 1e-4


def test_closed_loop_solve_pallas_generic_loop_raises_k6():
    """A generic (non-FDN) loop with method='pallas' needs K6, the dense
    per-bin solve, and no longer raises for want of it: for CPU tensors it
    runs K6's plain version (no launch), which equals the pivoted 'ge'
    solve (1e-6 of the max), in closed_loop_solve and in a Recursion."""
    A, B = _random_system(8, 3, seed=0)
    At, Bt = torch.tensor(A), torch.tensor(B)
    fk.reset_launch_counts()
    y = closed_loop_solve(At, Bt, method="pallas")
    assert torch.equal(y, fk.dense_solve_plain(At, Bt))
    assert _rel(y, closed_loop_solve(At, Bt, method="ge")) < 1e-6
    g = torch.Generator().manual_seed(0)
    fF = dsp.Gain(size=(3, 3), nfft=16, generator=g, device="cpu")
    fB = dsp.Gain(size=(3, 3), nfft=16, generator=g, device="cpu")
    x = torch.ones((1, 9, 3), dtype=torch.complex64)
    with torch.no_grad():
        y = system.Recursion(fF, fB, solve_method="pallas")(x)
        y_ge = system.Recursion(fF, fB, solve_method="ge")(x)
    assert _rel(y, y_ge) < 1e-6
    assert fk.LAUNCHES["dense_solve"] == 0


def test_expm_skew_matches_jax():
    from flamo_tpu.functional import expm_skew as jax_expm_skew

    X = np.random.default_rng(2).normal(size=(6, 6)).astype(np.float32)
    Uj = np.asarray(jax_expm_skew(jnp.asarray(X)))
    Ut = expm_skew(torch.tensor(X)).numpy()
    assert float(np.abs(Ut - Uj).max()) < 1e-5
    assert float(np.abs(Ut @ Ut.T - np.eye(6)).max()) < 1e-5


def test_masked_adam_matches_optax():
    """Adam over the trainable parameters only, pinned against
    optax.adam for 10 steps; the frozen parameter gets no state."""
    import optax

    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(6, 6)).astype(np.float32)
    target = rng.normal(size=(6, 6)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    mat = dsp.Matrix(size=(6, 6), nfft=16, requires_grad=True, generator=g,
                     device="cpu")
    frozen = dsp.Gain(size=(6, 6), nfft=16, generator=g, device="cpu")
    model = torch.nn.ModuleList([mat, frozen])
    mat.assign_value(p0)
    opt = masked_optimizer(model, lr=1e-2)
    assert trainable_mask(model) == {"0.param": True, "1.param": False}

    tx = optax.adam(1e-2)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for _ in range(10):
        gj = 2 * (pj - target) ** 3
        upd, state = tx.update(gj, state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.zero_grad()
        torch.sum(0.5 * (mat.param - torch.tensor(target)) ** 4).backward()
        opt.step()
    assert float(np.abs(mat.param.detach().numpy() - np.asarray(pj)).max()) \
        < 1e-5
    assert frozen.param not in opt.state


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def test_import_loads_no_jax():
    code = ("import sys, flamo_tpu_torch, flamo_tpu_torch.models, "
            "flamo_tpu_torch.models.attenuated_fdn, "
            "flamo_tpu_torch.ops.sos_kernels, flamo_tpu_torch.auxiliary.eq, "
            "flamo_tpu_torch.models.active_acoustics, "
            "flamo_tpu_torch.ops.aa_kernels, flamo_tpu_torch.ops.eig_kernels, "
            "flamo_tpu_torch.ops.phase2_micro, "
            "flamo_tpu_torch.scripts.bench_phase2_micro, "
            "flamo_tpu_torch.optimize.dataset, "
            "flamo_tpu_torch.optimize.trainer, "
            "flamo_tpu_torch.models.dispatch, flamo_tpu_torch.examples, "
            "flamo_tpu_torch.examples.e8_colorless_fdn, "
            "flamo_tpu_torch.examples.e8_colorless_sfdn, "
            "flamo_tpu_torch.examples.e8_active_acoustics, "
            "flamo_tpu_torch.ops.qr_eig, flamo_tpu_torch.parallel, "
            "flamo_tpu_torch.parallel.launch, "
            "flamo_tpu_torch.scripts.shard_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'flamo_tpu') or "
            "m.startswith(('jax.', 'flamo_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|flamo_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "flamo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    port = REPO / "flamo_tpu_torch"
    for new in ("ops/sos_kernels.py", "auxiliary/eq.py",
                "models/attenuated_fdn.py", "ops/aa_kernels.py",
                "ops/eig_kernels.py", "models/active_acoustics.py",
                "ops/phase2_micro.py", "scripts/bench_phase2_micro.py",
                "optimize/dataset.py", "optimize/trainer.py",
                "models/dispatch.py", "examples/_common.py",
                "examples/e8_colorless_fdn.py",
                "examples/e8_colorless_sfdn.py",
                "examples/e8_active_acoustics.py", "ops/qr_eig.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/dp.py", "parallel/ensemble.py",
                "parallel/fused.py", "parallel/launch.py",
                "scripts/shard_smoke.py"):
        assert port / new in files, new
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_default_device_without_cuda_raises(monkeypatch):
    from flamo_tpu_torch.models import build_colorless_fdn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_colorless_fdn(nfft=512, delays=(89, 97))
    with pytest.raises(RuntimeError, match="CUDA"):
        flamo_tpu_torch.default_device()
