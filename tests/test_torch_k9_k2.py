"""K9 'highest' and K2 after their redesign for the H100, on the CPU: what
of them the CPU can check.

* The FP32 K9's shared-memory size rule (``aa_kernels.taps_smem_bytes``,
  as ``f32_smem_bytes`` and ``f32_stage_tw`` in aa_kernels.cu) admits
  every (order, L N) that the previous kernel's rule admitted, and the
  wrapper still raises, naming the limit, outside it, before it loads a
  library.
* K2's plain version (``fdn_solve_plain``, which the CUDA kernel is held
  to on the card) against the JAX package's ``pallas_fdn_solve`` in
  interpret mode (TILE = 256, as ``tests/test_ops.py`` runs it), eagerly,
  both ways (the transposed solve is its VJP's), on systems that pivot at
  every step (1e-5 of the max, the JAX kernel tests' bound on values) and
  on tied pivots (``chip_smoke.k2_systems``), whose exact systems agree
  bit for bit: another pivot rule rounds their rhs another way.
* ``chip_smoke.pivot_vote_share`` on those systems, and the K2 and K9
  bounds of ``chip_smoke.kernel_work``, unchanged by the redesign.

tests/test_torch_cuda.py holds the CUDA kernels to these plain versions
and to the previous libraries on the card.
"""

from __future__ import annotations

import importlib.util
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import fdn_kernels as fk

REPO = Path(__file__).resolve().parents[1]
MAX_SMEM = 232448


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


def _previous_taps_smem_bytes(order: int, LN: int) -> int:
    """The previous FP32 K9's shared memory: a tile of 64 bins' power rows
    and S rows (float2, odd strides, padded to 4) and its (order, L N)
    sum."""
    op, lp = -(-order // 4) * 4, -(-LN // 4) * 4
    return 64 * 8 * (op + 1 + lp + 1) + 4 * op * lp


def test_k9_size_rule_admits_every_previous_size():
    """Over orders 1..450 and L N 1..440 (the previous rule's edges are
    order 284 at L N = 52, 434 at L N = 1 and L N 434 at order 1): every
    size the previous rule admitted fits a block now, and the kernel
    stages tw only where a block can hold it."""
    admitted = 0
    for order in range(1, 451):
        for LN in list(range(1, 65)) + list(range(65, 441, 7)) + [434, 436]:
            need = ak.taps_smem_bytes(order, LN)
            without = 4 * 132 * (order + LN)
            assert need in (without, without + 4 * order * (-(-LN // 4) * 4))
            assert need <= MAX_SMEM or without > MAX_SMEM
            if _previous_taps_smem_bytes(order, LN) <= MAX_SMEM:
                admitted += 1
                assert need <= MAX_SMEM, (order, LN)
    assert admitted > 15000
    # the rig's size: tw staged, two blocks an SM
    assert ak.taps_smem_bytes(100, 52) == 4 * (132 * 152 + 100 * 52) <= 115712


def test_k9_wrapper_raises_naming_the_limit(monkeypatch):
    """Outside the size rule the wrapper raises ValueError naming the FP32
    kernel, its bytes and the 227 KB limit, before it loads a library;
    inside it, it goes on to load one.  (CPU tensors stand in for CUDA
    ones here: the device test is patched to say CUDA.)"""
    loads = []

    def no_load(n, lib):
        loads.append((n, lib))
        raise RuntimeError("no library here")

    monkeypatch.setattr(ak, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_build, "load", no_load)
    rng = np.random.default_rng(0)

    def rows(N, L, M, order):
        def r(n):
            return torch.tensor(rng.normal(size=(n, M)).astype(np.float32))
        return (r(N * L), r(N * L),
                torch.tensor(rng.normal(size=(order, L * N)).astype(
                    np.float32)), r(N), r(N), r(N))

    for N, L, order in ((4, 13, 441), (8, 55, 1), (1, 1, 440)):
        need = ak.taps_smem_bytes(order, L * N)
        assert need > MAX_SMEM
        with pytest.raises(ValueError, match=rf"aa_taps_tf_mse_kernel.*"
                           rf"'highest'.*{need} bytes.*{MAX_SMEM}"):
            ak.aa_taps_tf_mse_kernel(*rows(N, L, 8, order), N, L, 64,
                                     precision="highest")
    assert loads == []
    for N, L, order in ((4, 13, 284), (8, 54, 1), (1, 1, 434)):
        with pytest.raises(RuntimeError, match="no library"):
            ak.aa_taps_tf_mse_kernel(*rows(N, L, 8, order), N, L, 64,
                                     precision="highest")
    assert loads == [(4, "aa_kernels"), (8, "aa_kernels"), (1, "aa_kernels")]


def _jax_fdn_solve(ps, D, U, B, transpose):
    y = ps._fdn_impl(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B),
                     transpose)
    return np.asarray(y)


@pytest.mark.parametrize("N,label,transpose", [
    (3, "pivoting", False), (3, "pivoting", True), (3, "tied lower", False),
    (3, "tied upper", True), (4, "pivoting", False), (4, "pivoting", True),
])
def test_fdn_solve_plain_matches_pallas_pivoting_and_tied(ps, smoke, N,
                                                          label, transpose):
    """fdn_solve_plain against pallas_fdn_solve's kernel, forward or
    transposed, on systems that pivot at every step in every bin (1e-5 of
    the max) and on tied pivots, whose exact systems agree bit for bit
    (N = 3 and 4: each JAX call interprets the unrolled elimination,
    eagerly, ~1 s at N = 3 and ~6 s at N = 6 on one CPU core)."""
    systems = smoke.k2_systems(np.random.default_rng(N + transpose), 40, N,
                               transpose)
    D, U, B, exact = systems[label]
    D, U, B = (D.astype(np.complex64), U.astype(np.float32),
               B.astype(np.complex64))
    got = fk.fdn_solve_plain(torch.tensor(D), torch.tensor(U),
                             torch.tensor(B), transpose).numpy()
    ref = _jax_fdn_solve(ps, D, U, B, transpose)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel
    assert exact.all() == label.startswith("tied")
    assert np.array_equal(got[exact], ref[exact])
    if label == "pivoting":
        A = fk._loop_matrix(torch.tensor(D), torch.tensor(U), transpose)
        assert smoke.pivot_vote_share(A) == (1.0, 1.0)


def test_k2_systems_and_vote_shares(smoke):
    """The exact tied systems tie in |a| at the first step, one way or
    the other, and solve to float32 rounding of the float64 solve; the
    vote shares: every step of the pivoting systems, none of the forward
    lower-triangular ones (ties take the first row), and a warp's share
    at least its bins'."""
    for N in (2, 3, 6, 16):
        for transpose in (False, True):
            systems = smoke.k2_systems(np.random.default_rng(N), 96, N,
                                       transpose)
            for label, (D, U, B, exact) in systems.items():
                A64 = np.eye(N) - D[:, :, None] * U
                if transpose:
                    A64 = A64.transpose(0, 2, 1)
                Dt, Ut, Bt = smoke.k2_tensors((D, U, B, exact), "cpu")
                bins, warps = smoke.pivot_vote_share(
                    fk._loop_matrix(Dt, Ut, transpose))
                assert 0.0 <= bins <= warps <= 1.0
                if label == "pivoting":
                    assert bins == 1.0
                if label == "tied lower" and not transpose:
                    assert (bins, warps) == (0.0, 0.0)
                if not exact.any():
                    continue
                col = np.abs(A64[:, :, 0])
                assert np.all(np.isin(col, (0.0, 1.0, 2.0)))
                y = fk.fdn_solve_plain(Dt, Ut, Bt, transpose).numpy()
                ref = np.linalg.solve(
                    A64.astype(np.complex64).astype(np.complex128),
                    B.astype(np.complex64)[..., None].astype(
                        np.complex128))[..., 0]
                assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()


def test_k2_k9_bounds_unchanged(smoke):
    """chip_smoke.kernel_work's bytes and operations of K2 and K9, and the
    bounds from them at the main paths' shapes (0.0020634 ms by bytes,
    0.0321879 ms by FP32 operations, 'high' 0.0121021 by TF32
    operations), are those of the kernels before the redesign: the work
    the functions need did not change."""
    assert smoke.kernel_work("fdn_solve", 48001, 6) == (6912288, 49633034)
    assert smoke.kernel_work("aa_taps_tf_mse", 48001, 4) == (22506068,
                                                            2156588928)
    ms, by = smoke.bound("fdn_solve", 48001, 6)
    assert (round(ms, 6), by) == (0.002063, "bytes")
    ms, by = smoke.bound("aa_taps_tf_mse", 48001, 4)
    assert (round(ms, 6), by) == (0.032188, "operations")
    ms, by = smoke.bound("aa_taps_tf_mse_tc", 48001, 4, passes=3)
    assert (round(ms, 6), by) == (0.012102, "operations")


@pytest.mark.parametrize("pivot", [False, True])
def test_k9_default_tf32_pass_bound_holds_on_the_cpu(smoke, pivot):
    """``chip_smoke.tf32_pass_bound``, phase 2's bound on K9 'default''s
    tap cotangent (fault F4): the plain 'default' cotangent lies within
    half of it (one TF32 pass) of the float64 product of its own rounded
    operands' exact values, and the two eliminations' 'default'
    cotangents within all of it of each other."""
    N, L, order, nfft = 2, 3, 8, 512
    M = nfft // 2 + 1
    rng = np.random.default_rng(0)

    def rows(*shape, scale=1.0):
        return torch.tensor(scale * rng.normal(size=shape),
                            dtype=torch.float32)

    rows9 = [rows(N * L, M), rows(N * L, M), rows(order, L * N, scale=0.05),
             rows(N, M), rows(N, M), rows(N, M).abs()]
    bound = smoke.tf32_pass_bound(rows9, pivot, 0, N=N, L=L, nfft=nfft)
    assert bound.shape == (order, L * N) and bool((bound > 0).all())
    _, tb = ak.aa_taps_tf_mse_plain(*rows9, N, L, nfft, pivot, 0, "default")
    # the exact product of the same S rows: 'highest''s contraction in
    # float64 over the 'default' mixer response
    Pr, Pi = ak.dft_powers(order, M, nfft)
    P2 = torch.cat([Pr, Pi], dim=1)
    G2 = ak._tf32_matmul(rows9[2].T, P2, "default")
    _, Sr, Si = ak.aa_tf_mse_plain(rows9[0], rows9[1], G2[:, :M], G2[:, M:],
                                   *rows9[3:], N, L, pivot)
    exact = P2.double() @ torch.cat([Sr, -Si], dim=1).double().T
    assert float(((tb.double() - exact).abs() / bound).max()) <= 0.5
    _, other = ak.aa_taps_tf_mse_plain(*rows9, N, L, nfft, not pivot, 0,
                                       "default")
    assert float(((tb - other).double().abs() / bound).max()) <= 1.0



def test_k9_default_tf32_pass_bound_refuses_a_bf16_contraction(smoke):
    """At the card's size (M = 48001, N = 4, L = 13, 100 taps) the bound
    of ``tf32_pass_bound`` discriminates: the TF32 contraction of the
    plain 'default' cotangent lies within it of the other elimination's,
    and a contraction whose operands are rounded to bfloat16 (8x more
    coarsely) against the TF32 one lies outside it."""
    N, L, order, nfft, pivot = smoke.AA_N, smoke.AA_L, 100, smoke.NFFT, False
    M = nfft // 2 + 1
    rng = np.random.default_rng(0)

    def rows(*shape, scale=1.0):
        return torch.tensor(scale * rng.normal(size=shape),
                            dtype=torch.float32)

    rows9 = [rows(N * L, M), rows(N * L, M), rows(order, L * N, scale=0.05),
             rows(N, M), rows(N, M), rows(N, M).abs()]
    bound = smoke.tf32_pass_bound(rows9, pivot, 0, N=N, L=L, nfft=nfft)
    _, tb = ak.aa_taps_tf_mse_plain(*rows9, N, L, nfft, pivot, 0, "default")
    _, other = ak.aa_taps_tf_mse_plain(*rows9, N, L, nfft, not pivot, 0,
                                       "default")
    assert float(((tb - other).double().abs() / bound).max()) <= 1.0
    Pr, Pi = ak.dft_powers(order, M, nfft)
    P2 = torch.cat([Pr, Pi], dim=1)
    G2 = ak._tf32_matmul(rows9[2].T, P2, "default")
    _, Sr, Si = ak.aa_tf_mse_plain(rows9[0], rows9[1], G2[:, :M], G2[:, M:],
                                   *rows9[3:], N, L, pivot)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    coarse = bf16(P2) @ bf16(torch.cat([Sr, -Si], dim=1)).T
    assert float(((coarse - tb).double().abs() / bound).max()) > 1.0
