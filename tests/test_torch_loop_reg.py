"""The register-resident K2 and K5 (flamo_tpu_torch/csrc/fdn_reg.cu, 17..64
channels), on the CPU: their shared-memory and group-size rules' Python
mirror, pinned at 17, 32, 33, 48, 64 channels and at the boundary; the
wrappers' dispatch on the card (the register-resident kernel from 17 to
64 channels, the shared-memory one above it, each under its launch key),
with the device test, the library and the stream stubbed, so that the
entry point each call reaches is recorded; the limits the card took
before, unchanged and named before a library loads; a failed build or
launch raising with nothing counted and no fallback; the plain K2 and K5
at 33 channels (the first size on a group of warps) against the JAX
package's; and chip_smoke.py's phase 4l/5m checks of these kernels.

The oracle for the plain versions is the JAX package's rolled elimination
``gauss_solve_loop`` on the assembled loop matrix, with ``cascade_prods``
and ``_iir_guard_prods`` for the attenuation, as in
tests/test_torch_n_gt16.py and tests/test_torch_tf_sos_gt16.py: the
Pallas kernels interpreted take ~25 s a call at N = 8 on a CPU and grow
as N^3 with their unrolled trace.  Tolerances: values and losses 1e-5 of
the max, gradients 1e-4 of the max (a second, transposed solve and sums
over bins); a torch complex gradient is the conjugate of JAX's cotangent.

The file runs on one torch thread (tests/test_torch_n_gt16.py's reason).
tests/test_torch_cuda.py holds the kernels to these plain versions on the
card.
"""

from __future__ import annotations

import contextlib
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from flamo_tpu.functional import cascade_prods
from flamo_tpu.ops.solve import gauss_solve_loop
from flamo_tpu.processor.dsp import _iir_guard_prods
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import sos_kernels as sk

M = 33
NFFT = 2 * (M - 1)
K, P = 12, 3
VAL_TOL, GRAD_TOL = 1e-5, 1e-4


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


def _operands(N: int, seed: int = 0) -> dict:
    """U orthogonal, |D| = 0.9, SOS taps with poles of radius 0.2-0.6 and
    numerators within 0.02 of the denominators."""
    rng = np.random.default_rng(seed + N)
    U, _ = np.linalg.qr(rng.normal(size=(N, N)))
    r = rng.uniform(0.2, 0.6, (K, N))
    th = rng.uniform(0, np.pi, (K, N))
    at = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    bt = at + 0.02 * rng.normal(size=(P, K, N))
    return dict(
        D=(0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N)))).astype(
            np.complex64),
        U=U.astype(np.float32), U6=(0.6 * U).astype(np.float32),
        B=_cplx(rng, (M, N)), W=_cplx(rng, (M, N)),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        X=_cplx(rng, (M,)), t=rng.uniform(size=M).astype(np.float32),
        bt=bt.astype(np.float32), at=at.astype(np.float32))


# ---------------------------------------------------------------------------
# the shared-memory and group rules, and the limits
# ---------------------------------------------------------------------------
def _al4(n: int) -> int:
    return -(-n // 4) * 4


@pytest.mark.parametrize("N,warps,float2s,k2_bins,k5_bins", [
    (16, 1, 168, 0, 0), (17, 1, 168, 4, 8), (32, 1, 168, 4, 8),
    (33, 3, 620, 1, 4), (48, 3, 620, 1, 4), (49, 4, 762, 1, 4),
    (64, 4, 762, 1, 4), (65, 5, 904, 0, 0)])
def test_reg_rules_pinned(N, warps, float2s, k2_bins, k5_bins):
    """A bin's group (one warp to 32 channels, ceil(N / 16) warps above),
    its shared memory (two parities of pivot rows a warp, 34 complex slots
    at one thread a row and 70 at two, the arg-max words, y, w, d and two
    scalars), a block's bins (K2 4 and 1, K5 8 and 4 at K = 12, P = 3) and
    the blocks' shared memory, term by term; nothing outside 17..64."""
    assert fk.reg_group_warps(N) == warps
    W, RL = (32, 34) if N <= 32 else (64, 70)
    n = 2 * warps * RL + 2 * warps + 3 * W + 2
    assert fk.reg_bin_float2s(N) == float2s == n + (n & 1)
    assert fk.reg_bins(N) == k2_bins
    assert sk.reg_tf_mse_bins(N, K, P, True) == k5_bins
    for bins in (1, 3):
        assert fk.reg_smem_bytes(N, bins) == (
            4 * _al4(N * (N | 1)) + 8 * bins * float2s)
        taps = 2 * P * K * N
        assert sk.reg_tf_mse_smem_bytes(N, K, P, True, bins) == 4 * (
            _al4(N * (N | 1)) + _al4(2 * N) + _al4(taps)
            + _al4(N * N + 2 * N + 1 + taps) + bins * _al4(8 * N + 3)
        ) + 8 * bins * float2s


def test_reg_block_sizes_at_the_extremes():
    """At 64 channels of a 1/3-octave GEQ (K = 30, the paths' largest
    taps) the K5 block still holds its 4 bins (142 KB); at 64 sections of
    8 taps it holds 8 bins at 17 channels and none from 32; K5 without
    fused taps needs no tap sums."""
    assert sk.reg_tf_mse_bins(64, 30, 3, True) == 4
    assert sk.reg_tf_mse_smem_bytes(64, 30, 3, True, 4) <= fk.LOOP_SMEM
    assert sk.reg_tf_mse_bins(17, 64, 8, True) == 8
    assert sk.reg_tf_mse_bins(32, 64, 8, True) == 0
    assert (sk.reg_tf_mse_smem_bytes(64, 12, 3, True, 1)
            - sk.reg_tf_mse_smem_bytes(64, 12, 3, False, 1)) == (
                4 * 2 * 3 * 12 * 64)
    for K_, P_ in ((0, 3), (65, 3), (12, 0), (12, 9)):
        assert sk.reg_tf_mse_bins(32, K_, P_, True) == 0


def test_limits_unchanged_and_every_count_taken():
    """The limits the card took before are the same (K2 137, K5 101 at an
    octave GEQ and 82 at a 1/3-octave one), and every channel count up to
    them runs on one of the two looped kernels: the register-resident one
    at 17..64 where its block fits, the shared-memory one elsewhere."""
    assert fk.LOOP_MAX_N["fdn_solve"] == 137
    assert sk.loop_tf_mse_max_n(12, 3, True) == 101
    assert sk.loop_tf_mse_max_n(30, 3, True) == 82
    for N in range(17, 138):
        assert fk.reg_bins(N) > 0 or fk.loop_warps("fdn_solve", N) > 0
        assert (fk.reg_bins(N) > 0) == (N <= fk.REG_MAX_N)
    for K_, P_, fuse in ((12, 3, True), (30, 3, True), (12, 3, False),
                         (64, 8, True), (1, 1, False)):
        for N in range(17, sk.loop_tf_mse_max_n(K_, P_, fuse) + 1):
            assert (sk.reg_tf_mse_bins(N, K_, P_, fuse)
                    or sk.loop_tf_mse_warps(N, K_, P_, fuse))


# ---------------------------------------------------------------------------
# the dispatch on the card, the launch keys, no fallback
# ---------------------------------------------------------------------------
class _Lib:
    """A stand-in for the looped library: records each entry point called
    and returns ``rc`` from the launches (3 blocks from K5's grids)."""

    def __init__(self, rc: int = 0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 3 if name.endswith("_grid") else self.rc
        return entry


@pytest.fixture()
def card(monkeypatch):
    """The wrappers' device test patched to say CUDA, the library a _Lib,
    the stream and the device context stubbed; the launch counts reset."""
    lib = _Lib()
    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(fk, "_stream", lambda x: 0)
    monkeypatch.setattr(sk, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cuda_build, "load", lambda n, name: lib)
    monkeypatch.setattr(cuda_build, "check", lambda rc, what, n, name: (
        None if rc == 0 else (_ for _ in ()).throw(RuntimeError(what))))
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    yield lib
    fk.reset_launch_counts()
    sk.reset_launch_counts()


def _counts() -> dict:
    return {k: v for k, v in {**fk.LAUNCHES, **sk.LAUNCHES}.items() if v}


@pytest.mark.parametrize("N", [17, 32, 33, 48, 64, 65, 101])
def test_dispatch_register_resident_to_64(card, N):
    """K2 (both ways, through fdn_solve_kernel) and K5 (through
    fdn_sos_tf_mse_kernel) reach the register-resident entry points at
    17..64 channels, counted under fdn_solve_loop(_transposed) and
    fdn_sos_tf_mse_loop, and fdn_loop.cu's shared-memory ones above,
    counted under their "_smem" keys."""
    o = {k: torch.tensor(v) for k, v in _operands(N).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    fk.fdn_solve_kernel(D, U, B)
    fk.fdn_solve_kernel(D, U, B, True)
    sk.fdn_sos_tf_mse_kernel(D, o["bt"], o["at"], U, b, c, X, t, NFFT)
    reg = N <= fk.REG_MAX_N
    assert card.calls == (
        ["fl_reg_solve_launch"] * 2
        + ["fl_reg_sos_tf_mse_grid", "fl_reg_sos_tf_mse_launch"] if reg else
        ["fl_solve_launch"] * 2
        + ["fl_sos_tf_mse_grid", "fl_sos_tf_mse_launch"])
    sfx = "" if reg else "_smem"
    assert _counts() == {f"fdn_solve_loop{sfx}": 1,
                         f"fdn_solve_loop{sfx}_transposed": 1,
                         f"fdn_sos_tf_mse_loop{sfx}": 1}


def test_smem_kernels_callable_in_range(card):
    """The shared-memory kernels stay callable at 17..64 channels (the
    timing's previous kernels), counted under their own keys."""
    o = {k: torch.tensor(v) for k, v in _operands(32).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    fk.fdn_solve_loop_smem_kernel(D, U, B, True)
    sk.fdn_sos_tf_mse_loop_smem_kernel(D, o["bt"], o["at"], U, b, c, X, t,
                                       NFFT)
    assert card.calls == ["fl_solve_launch", "fl_sos_tf_mse_grid",
                          "fl_sos_tf_mse_launch"]
    assert _counts() == {"fdn_solve_loop_smem_transposed": 1,
                         "fdn_sos_tf_mse_loop_smem": 1}


def test_limits_named_before_loading(card, monkeypatch):
    """Past the shared-memory kernels' limits the wrappers raise, naming
    them, before anything loads."""
    monkeypatch.setattr(cuda_build, "load", lambda n, name: pytest.fail(
        "loaded a library past the limit"))
    N = fk.LOOP_MAX_N["fdn_solve"] + 1
    D = torch.zeros((2, N), dtype=torch.complex64)
    with pytest.raises(ValueError, match=r"takes 1\.\.137"):
        fk.fdn_solve_loop_kernel(D, torch.zeros((N, N)), D)
    N = sk.loop_tf_mse_max_n(30, 3, True) + 1
    D = torch.zeros((2, N), dtype=torch.complex64)
    taps, v = torch.zeros((3, 30, N)), torch.zeros(N)
    with pytest.raises(ValueError, match=r"takes 1\.\.82 channels"):
        sk.fdn_sos_tf_mse_loop_kernel(D, taps, taps, torch.zeros((N, N)), v,
                                      v, D[:, 0], torch.zeros(2), 2)
    assert not _counts()


def test_a_failed_launch_raises_and_counts_nothing(card):
    """A launch that reports an error raises from the register-resident
    entry point itself: no call reaches the shared-memory kernel or the
    plain version, and nothing is counted."""
    card.rc = 719
    o = {k: torch.tensor(v) for k, v in _operands(48).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    with pytest.raises(RuntimeError, match="fl_reg_solve_launch"):
        fk.fdn_solve_loop_kernel(D, U, B)
    with pytest.raises(RuntimeError, match="fl_reg_sos_tf_mse_launch"):
        sk.fdn_sos_tf_mse_loop_kernel(D, o["bt"], o["at"], U, b, c, X, t,
                                      NFFT)
    assert card.calls == ["fl_reg_solve_launch", "fl_reg_sos_tf_mse_grid",
                          "fl_reg_sos_tf_mse_launch"]
    assert not _counts()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """With a compiler that fails, the K2 and K5 wrappers on the card raise
    the build's error at 32 channels; nothing falls back and nothing is
    counted."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho nvcc refused fdn_reg.cu\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sk, "_on_cuda", lambda *t: True)
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    o = {k: torch.tensor(v) for k, v in _operands(32).items()}
    D, U, B, b, c, X, t = (o[k] for k in "DUBbcXt")
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        fk.fdn_solve_loop_kernel(D, U, B)
    with pytest.raises(RuntimeError, match="nvcc refused fdn_reg.cu"):
        sk.fdn_sos_tf_mse_loop_kernel(D, o["bt"], o["at"], U, b, c, X, t,
                                      NFFT)
    assert not _counts()
    assert not list((tmp_path / "build").glob("*.o"))


# ---------------------------------------------------------------------------
# the plain versions at 33 channels against the JAX package
# ---------------------------------------------------------------------------
def _jax_loop(D, U):
    return jnp.eye(D.shape[1], dtype=D.dtype) - D[:, :, None] * U.astype(
        D.dtype)


@jax.jit
def _jax_fdn_solve(D, U, B, W):
    def f(D, U, B):
        return jnp.real(jnp.sum(W * gauss_solve_loop(_jax_loop(D, U), B)))

    return (gauss_solve_loop(_jax_loop(D, U), B),
            jax.grad(f, argnums=(0, 1, 2))(D, U, B))


@jax.jit
def _jax_sos_tf_mse(D, bt, at, U, b, c, X, t):
    def f(D, bt, at, U, b, c):
        gam = _iir_guard_prods(*cascade_prods(bt, at, NFFT))
        y = gauss_solve_loop(_jax_loop(D * gam, U), D * b.astype(D.dtype))
        tf = y @ c.astype(y.dtype)
        return jnp.mean((jnp.abs(tf * X) - t) ** 2)

    return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4, 5))(
        D, bt, at, U, b, c)


def test_fdn_solve_plain_matches_jax_at_33():
    """K2's function at 33 channels, forward and (its VJP) transposed: y and
    the gradients of Re <W, y> in D, U and B."""
    o = _operands(33)
    D, U, B = (torch.tensor(o[k]).requires_grad_() for k in "DUB")
    y = fk.fdn_solve(D, U, B)
    torch.real(torch.sum(torch.tensor(o["W"]) * y)).backward()
    yj, (gD, gU, gB) = _jax_fdn_solve(*(jnp.asarray(o[k]) for k in "DUBW"))
    assert _rel(y.detach(), yj) < VAL_TOL
    assert _rel(D.grad, np.conj(gD)) < GRAD_TOL
    assert _rel(U.grad, gU) < GRAD_TOL
    assert _rel(B.grad, np.conj(gB)) < GRAD_TOL


@pytest.mark.parametrize("pivot,with_dbar,fuse_taps", [
    (False, False, True), (True, True, True), (False, True, False)],
    ids=["training", "pivot-dbar", "k4b-taps"])
def test_fdn_sos_tf_mse_plain_matches_jax_at_33(pivot, with_dbar, fuse_taps):
    """K5's function at 33 channels (K = 12 sections of P = 3 taps): the
    loss and its gradients in D (with_dbar), the taps, U, b and c."""
    o = _operands(33, seed=3)
    o["U"] = o["U6"]
    D, bt, at, U, b, c = (torch.tensor(o[k]).requires_grad_()
                          for k in ("D", "bt", "at", "U", "b", "c"))
    loss = sk.fdn_sos_tf_mse(D, bt, at, U, b, c, torch.tensor(o["X"]),
                             torch.tensor(o["t"]), NFFT, with_dbar=with_dbar,
                             pivot=pivot, fuse_taps=fuse_taps)
    loss.backward()
    lj, grads = _jax_sos_tf_mse(*(jnp.asarray(o[k]) for k in (
        "D", "bt", "at", "U", "b", "c", "X", "t")))
    assert abs(float(loss.detach()) - float(lj)) < VAL_TOL * abs(float(lj))
    if with_dbar:
        assert _rel(D.grad, np.conj(grads[0])) < GRAD_TOL
    else:
        assert D.grad is None
    for got, want in zip((bt.grad, at.grad, U.grad, b.grad, c.grad),
                         grads[1:]):
        assert _rel(got, want) < GRAD_TOL


# ---------------------------------------------------------------------------
# chip_smoke.py's checks of these kernels, on the CPU
# ---------------------------------------------------------------------------
def test_phase_checks_on_cpu(capsys):
    """Phase 4l's K2 checks and phase 5m's K5 checks at 33 and 65 channels
    (the plain versions against themselves): every error 0, the tied
    systems counted, each variant, the bin offset and K = 30 printed."""
    for N in (33, 65):
        errs, tied = cs.k2_loop_checks(N, M=40, device="cpu",
                                       twin=N > fk.REG_MAX_N)
        assert errs == {"fdn_solve_loop": 0.0,
                        "fdn_solve_loop_transposed": 0.0}
        assert tied == 2 * 40
    assert cs.reg_k5_checks(33, M=40, device="cpu", offset=17) == 0.0
    text = capsys.readouterr().out
    for name in ("K2 looped N=65 tied lower transposed",
                 "K5 looped N=33 pivot=True with_dbar=True fuse_taps=False",
                 "K5 looped N=33 bin_offset=17", "K5 looped N=33 K=30"):
        assert name in text, name
    assert len(cs.K5_ALL) == 8 and set(cs.K5_REST) | set(
        cs.K5_VARIANTS) == set(cs.K5_ALL)


def test_reg_gate_holds_the_previous_kernel(capsys):
    """The timing rows' gate: a register-resident kernel at most
    PREVIOUS_GATE times the shared-memory kernel's time passes, above it
    fails; rows without a previous time are not gated."""
    row = dict(name="fdn_solve_loop@N64", ms=1.0, previous_ms=1.0,
               bound_ms=0.5, resident_warps=16, previous_resident_warps=6)
    cs.reg_gate([row, dict(name="fdn_tf_fwd_loop@N64", ms=9.0)])
    text = capsys.readouterr().out
    assert "fdn_solve_loop@N64 (fdn_reg.cu)" in text and "1.000x" in text
    assert "fdn_tf_fwd_loop" not in text
    with pytest.raises(AssertionError, match="more than 1.05"):
        cs.reg_gate([{**row, "ms": 1.06}])


def test_twin_check_on_a_system_past_float32():
    """k2_twin_check at the boundary: a result as far from a complex128
    solve as twice the plain version's own distance passes, one that is
    far from it where the plain version is not fails."""
    system = cs.k2_systems(np.random.default_rng(0), 8, 65, True)["random"]
    Ds, Us, Bs = cs.k2_tensors(system, "cpu")
    ref = fk.fdn_solve_plain(Ds, Us, Bs, True)
    with pytest.raises(AssertionError, match="complex128"):
        cs.k2_twin_check("probe", ref * (1 + 3e-5), ref, system, True, "cpu")
