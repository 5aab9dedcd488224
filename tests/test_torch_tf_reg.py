"""The register-resident K3f and K3b (flamo_tpu_torch/csrc/fdn_reg.cu, 17..64
channels), on the CPU: their block rules' Python mirror, pinned at 17, 32,
33, 48, 64 and 65 channels and over the whole range; the wrappers' dispatch
on the card (the register-resident kernel from 17 to 64 channels, the
shared-memory one above it, each under its launch key), with the device
test, the library and the stream stubbed, so that the entry point each
call reaches is recorded; the limits the card took before, unchanged and
named before a library loads; a failed build, grid or launch raising with
nothing counted and no fallback; the plain K3f and K3b at 33 channels (the
first size on a group of warps) against the JAX package's; and
chip_smoke.py's phase 5m checks of these kernels.

The oracle for the plain versions is the JAX package's rolled elimination
``gauss_solve_loop`` on the assembled loop matrix, as in
tests/test_torch_loop_reg.py: the Pallas K3 kernels interpreted take
~25 s a call at N = 8 on a CPU and grow as N^3 with their unrolled trace,
too slow at N = 33.  Tolerances: tf and y 1e-5 of the max, gradients 1e-4
of the max (a second, transposed solve and sums over bins); a torch
complex gradient is the conjugate of JAX's cotangent.

The file runs on one torch thread (tests/test_torch_n_gt16.py's reason).
tests/test_torch_cuda.py (``-k reg_``) holds the kernels to these plain
versions on the card.
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
from flamo_tpu.ops.solve import gauss_solve_loop
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import fdn_kernels as fk

M = 33
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
KINDS = ("fdn_tf_fwd", "fdn_tf_bwd")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(N: int, seed: int = 0) -> dict:
    """U orthogonal, |D| = 0.9, gains b and c, a weight W of tf and a
    cotangent-shaped (M, N) y and (M,) tf_bar for the dispatch."""
    rng = np.random.default_rng(seed + N)

    def cplx(shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64)

    return dict(
        D=(0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N)))).astype(
            np.complex64),
        U=np.linalg.qr(rng.normal(size=(N, N)))[0].astype(np.float32),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        W=cplx(M), y=cplx((M, N)), tb=cplx(M))


def _tensors(N: int) -> tuple:
    o = {k: torch.tensor(v) for k, v in _operands(N).items()}
    return tuple(o[k] for k in ("D", "U", "b", "c", "y", "tb"))


# ---------------------------------------------------------------------------
# the block rules and the limits
# ---------------------------------------------------------------------------
def _al4(n: int) -> int:
    return -(-n // 4) * 4


@pytest.mark.parametrize("N,fwd_bins,bwd_bins", [
    (16, 0, 0), (17, 4, 8), (32, 4, 8), (33, 1, 4), (48, 1, 4), (64, 1, 4),
    (65, 0, 0)])
def test_reg_tf_rules_pinned(N, fwd_bins, bwd_bins):
    """A block's bins (K3f K2's 4 and 1, K3b K5's 8 and 4) and its shared
    memory term by term: U (N rows of stride N | 1), b and c once, K3b's
    N^2 + 2N + 1 sums and a tile slot of 8 N + 3 floats a bin, each
    region on 16 bytes, and each bin's region (reg_bin_float2s); nothing
    outside 17..64."""
    assert fk.reg_tf_bins("fdn_tf_fwd", N) == fwd_bins
    assert fk.reg_tf_bins("fdn_tf_bwd", N) == bwd_bins
    for bins in (1, 3, 8):
        region = 8 * bins * fk.reg_bin_float2s(N)
        head = _al4(N * (N | 1)) + _al4(2 * N)
        assert fk.reg_tf_smem_bytes("fdn_tf_fwd", N, bins) == (
            4 * head + region)
        assert fk.reg_tf_smem_bytes("fdn_tf_bwd", N, bins) == 4 * (
            head + _al4(N * N + 2 * N + 1) + bins * _al4(8 * N + 3)) + region


def test_reg_tf_blocks_whole_over_the_range():
    """Every count of 17..64 takes its kind's full block (no shrinking for
    shared memory: K3b's 4 bins at 64 channels take 66704 bytes), the
    K3b block at 17..32 is one 8-warp block as K5's, and nothing below 17
    or above 64 is taken."""
    assert fk.reg_tf_smem_bytes("fdn_tf_bwd", 64, 4) == 66704
    for N in range(1, 140):
        for kind in KINDS:
            want = (fk.REG_MAX_BINS[kind][N > 32]
                    if fk.REG_MIN_N <= N <= fk.REG_MAX_N else 0)
            assert fk.reg_tf_bins(kind, N) == want, (kind, N)
            if want:
                assert fk.reg_tf_smem_bytes(kind, N, want) <= fk.LOOP_SMEM
    assert fk.REG_MAX_BINS["fdn_tf_bwd"] == fk.REG_MAX_BINS["fdn_sos_tf_mse"]
    assert fk.REG_MAX_BINS["fdn_tf_fwd"] == fk.REG_MAX_BINS["fdn_solve"]


def test_limits_unchanged_and_every_count_taken():
    """The limits the card took before are the same (K3f 137, K3b 119), and
    every count up to them runs on one of the two looped kernels: the
    register-resident one at 17..64, the shared-memory one elsewhere."""
    assert fk.LOOP_MAX_N["fdn_tf_fwd"] == 137
    assert fk.LOOP_MAX_N["fdn_tf_bwd"] == 119
    for kind in KINDS:
        for N in range(17, fk.LOOP_MAX_N[kind] + 1):
            assert (fk.reg_tf_bins(kind, N) > 0) == (N <= fk.REG_MAX_N)
            assert fk.reg_tf_bins(kind, N) or fk.loop_warps(kind, N)


# ---------------------------------------------------------------------------
# the dispatch on the card, the launch keys, no fallback
# ---------------------------------------------------------------------------
class _Lib:
    """A stand-in for the looped library: records each entry point called
    and returns ``grid`` from the grids (3 blocks) and ``rc`` from the
    launches."""

    def __init__(self, rc: int = 0, grid: int = 3):
        self.calls, self.rc, self.grid = [], rc, grid

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return self.grid if name.endswith("_grid") else self.rc
        return entry


@pytest.fixture()
def card(monkeypatch):
    """The wrappers' device test patched to say CUDA, the library a _Lib,
    the stream and the device context stubbed; the launch counts reset."""
    lib = _Lib()
    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(fk, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cuda_build, "load", lambda n, name: lib)
    monkeypatch.setattr(cuda_build, "check", lambda rc, what, n, name: (
        None if rc == 0 else (_ for _ in ()).throw(RuntimeError(what))))
    fk.reset_launch_counts()
    yield lib
    fk.reset_launch_counts()


def _counts() -> dict:
    return {k: v for k, v in fk.LAUNCHES.items() if v}


@pytest.mark.parametrize("N", [17, 32, 33, 48, 64, 65, 101])
def test_dispatch_register_resident_to_64(card, N):
    """K3f and K3b (through fdn_tf_fwd_kernel and fdn_tf_bwd_kernel) reach
    the register-resident entry points at 17..64 channels, counted under
    fdn_tf_fwd_loop and fdn_tf_bwd_loop, and fdn_loop.cu's shared-memory
    ones above, counted under their "_smem" keys; K3b's partials (3
    blocks from the stubbed grid) are summed into its cotangents."""
    D, U, b, c, y, tb = _tensors(N)
    fk.fdn_tf_fwd_kernel(D, U, b, c)
    D_bar, U_bar, b_bar, c_bar = fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb)
    assert (tuple(D_bar.shape), tuple(U_bar.shape), tuple(b_bar.shape),
            tuple(c_bar.shape)) == ((M, N), (N, N), (N,), (N,))
    pre, sfx = ("fl_reg_", "") if N <= fk.REG_MAX_N else ("fl_", "_smem")
    assert card.calls == [f"{pre}tf_fwd_launch", f"{pre}tf_bwd_grid",
                          f"{pre}tf_bwd_launch"]
    assert _counts() == {f"fdn_tf_fwd_loop{sfx}": 1,
                         f"fdn_tf_bwd_loop{sfx}": 1}


def test_smem_kernels_callable_in_range(card):
    """The shared-memory kernels stay callable at 17..64 channels (the
    timing's previous kernels), counted under their own keys."""
    D, U, b, c, y, tb = _tensors(32)
    fk.fdn_tf_fwd_loop_smem_kernel(D, U, b, c)
    fk.fdn_tf_bwd_loop_smem_kernel(D, U, b, c, y, tb)
    assert card.calls == ["fl_tf_fwd_launch", "fl_tf_bwd_grid",
                          "fl_tf_bwd_launch"]
    assert _counts() == {"fdn_tf_fwd_loop_smem": 1,
                         "fdn_tf_bwd_loop_smem": 1}


def test_limits_named_before_loading(card, monkeypatch):
    """Past the shared-memory kernels' limits the wrappers raise, naming
    them, before anything loads."""
    monkeypatch.setattr(cuda_build, "load", lambda n, name: pytest.fail(
        "loaded a library past the limit"))
    for kind, call in (
            ("fdn_tf_fwd", lambda D, U, v: fk.fdn_tf_fwd_loop_kernel(
                D, U, v, v)),
            ("fdn_tf_bwd", lambda D, U, v: fk.fdn_tf_bwd_loop_kernel(
                D, U, v, v, D, D[:, 0]))):
        N = fk.LOOP_MAX_N[kind] + 1
        D = torch.zeros((2, N), dtype=torch.complex64)
        with pytest.raises(ValueError, match=rf"takes 1\.\.{N - 1} on"):
            call(D, torch.zeros((N, N)), torch.zeros(N))
    assert not _counts()


@pytest.mark.parametrize("fails", ["launch", "grid"])
def test_a_failed_launch_raises_and_counts_nothing(card, fails):
    """A launch, or K3b's grid, that reports an error raises from the
    register-resident entry point itself: no call reaches the
    shared-memory kernel or the plain version, and nothing is counted."""
    if fails == "launch":
        card.rc = 719
    else:
        card.grid = -1000 - 719
    D, U, b, c, y, tb = _tensors(48)
    if fails == "launch":
        with pytest.raises(RuntimeError, match="fl_reg_tf_fwd_launch"):
            fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    with pytest.raises(RuntimeError, match="fl_reg_tf_bwd_launch"):
        fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, tb)
    assert card.calls == (["fl_reg_tf_fwd_launch"] * (fails == "launch")
                          + ["fl_reg_tf_bwd_grid"]
                          + ["fl_reg_tf_bwd_launch"] * (fails == "launch"))
    assert not _counts()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """With a compiler that fails, the K3f and K3b wrappers on the card
    raise the build's error at 32 channels; nothing falls back and
    nothing is counted."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho nvcc refused fdn_reg.cu\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(fk, "_on_cuda", lambda *t: True)
    fk.reset_launch_counts()
    D, U, b, c, y, tb = _tensors(32)
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    with pytest.raises(RuntimeError, match="nvcc refused fdn_reg.cu"):
        fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, tb)
    assert not _counts()
    assert not list((tmp_path / "build").glob("*.o"))


# ---------------------------------------------------------------------------
# the plain K3f and K3b at 33 channels against the JAX package
# ---------------------------------------------------------------------------
@jax.jit
def _jax_fdn_tf(D, U, b, c, W):
    def solve(D, U, b):
        A = jnp.eye(D.shape[1], dtype=D.dtype) - D[:, :, None] * U.astype(
            D.dtype)
        return gauss_solve_loop(A, D * b.astype(D.dtype))

    def f(D, U, b, c):
        return jnp.real(jnp.sum(W * (solve(D, U, b) @ c.astype(D.dtype))))

    y = solve(D, U, b)
    return (y @ c.astype(y.dtype), y,
            jax.grad(f, argnums=(0, 1, 2, 3))(D, U, b, c))


def test_fdn_tf_plain_matches_jax_at_33():
    """K3f's function at 33 channels (tf and y) and K3b's through the VJP
    of fdn_tf: the gradients of Re <W, tf> in D, U, b and c."""
    o = _operands(33, seed=5)
    D, U, b, c = (torch.tensor(o[k]).requires_grad_() for k in "DUbc")
    tf = fk.fdn_tf(D, U, b, c)
    torch.real(torch.sum(torch.tensor(o["W"]) * tf)).backward()
    _, y = fk.fdn_tf_fwd_plain(*(torch.tensor(o[k]) for k in "DUbc"))
    tfj, yj, (gD, gU, gb, gc) = _jax_fdn_tf(
        *(jnp.asarray(o[k]) for k in "DUbcW"))
    assert _rel(tf.detach(), tfj) < VAL_TOL
    assert _rel(y, yj) < VAL_TOL
    assert _rel(D.grad, np.conj(gD)) < GRAD_TOL
    for got, want in ((U.grad, gU), (b.grad, gb), (c.grad, gc)):
        assert _rel(got, want) < GRAD_TOL


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 5m checks of these kernels, on the CPU
# ---------------------------------------------------------------------------
def test_phase_5m_k3_checks_on_cpu(capsys):
    """k3_loop_checks at 33 and 65 channels (the plain versions against
    themselves): every error 0, the tied systems counted, the transposed
    systems printed; the launch check passes the register-resident keys
    up to 64 channels and the "_smem" ones above, and refuses the
    others; both kernels' rows name fdn_reg.cu."""
    for N in (33, 65):
        errs, tied = cs.k3_loop_checks(N, M=40, device="cpu")
        assert errs == {"fdn_tf_fwd_loop": 0.0, "fdn_tf_bwd_loop": 0.0}
        assert tied == 40
    text = capsys.readouterr().out
    for name in ("K3f looped N=33 tied lower y",
                 "K3b looped N=65 tied upper transposed c_bar",
                 "K3b looped N=33 pivoting transposed D_bar"):
        assert name in text, name
    reg = {"fdn_tf_fwd_loop": 1, "fdn_tf_bwd_loop": 1}
    smem = {"fdn_tf_fwd_loop_smem": 1, "fdn_tf_bwd_loop_smem": 1}
    cs.reg_launch_check("K3", 32, "cuda", reg)
    cs.reg_launch_check("K3", 65, "cuda", smem)
    for N, counts in ((64, smem), (65, reg), (48, {**reg, **smem})):
        with pytest.raises(AssertionError, match="17..64"):
            cs.reg_launch_check("K3", N, "cuda", counts)
    for name in reg:
        assert cs.SOURCES[name] == "flamo_tpu_torch/csrc/fdn_reg.cu"


def test_ptxas_report_reads_the_new_kernels(capsys):
    """print_ptxas reads the new kernels' registers and spills from nvcc's
    report, with the warps an SM their registers allow at their blocks
    (K3f 4 warps, K3b 8 at one thread a row and 16 at two)."""
    report = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN3fdn3reg{len(k)}{k}"
        f"ILi{h}EEEvPK6float2' for 'sm_90a'\n"
        f"    32 bytes stack frame, {s} bytes spill stores, {s} bytes spill "
        f"loads\nptxas info    : Used 128 registers, used 1 barriers"
        for k, h, s in (("reg_tf_fwd_kernel", 1, 12),
                        ("reg_tf_bwd_kernel", 2, 28)))
    cs.print_ptxas(report)
    text = capsys.readouterr().out
    assert ("ptxas reg_tf_fwd_kernel<1>: 128 registers, 12 bytes spill "
            "stores, 12 bytes spill loads; 16 warps an SM") in text
    assert ("ptxas reg_tf_bwd_kernel<2>: 128 registers, 28 bytes spill "
            "stores, 28 bytes spill loads; 16 warps an SM") in text
