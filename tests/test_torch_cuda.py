"""Each hand-written CUDA kernel of flamo_tpu_torch against its plain
PyTorch version, on the card.  Imports no JAX, so it runs where the card
is:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test skips (the decision is taken inside a
fixture, so every worker collects the same tests).  Tolerances: per-bin
values 1e-5 of the max (the two differ only by rounding: FMA
contraction, division order, the kernels' (2 pi / nfft) (m + off) phase
against the plain 2 pi m / nfft); cotangents 1e-4 of the max (a second
elimination, and sums over bins reduced in another order).  Those hold
for well-conditioned random SOS taps; the 12-section GEQ cascade is
ill-conditioned near DC in float32, and its taps are held to the JAX
package's bounds for its two GEQ backends (5e-3 values, 1e-3 gradients).
The Durand-Kerner roots (K7) are held to the JAX package's 1e-4 max abs
(the library is built without FMA contraction, so kernel and plain
version should agree exactly); the active-acoustics steps K8 and K9 to
1e-5 on the loss and 1e-4 of the max on the S rows and the tap
cotangent (a second solve, and K9's sums over bins in another order),
K9 at each precision against the plain version of that precision.
The phase-2 micro-benchmark kernels (K10) are held to 1e-5 of the sum of
their terms' magnitudes (float32 sums of ~7e6 terms of both signs in
another order).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from flamo_tpu_torch.functional import charpoly, expm_skew, poly_roots_rows
from flamo_tpu_torch.models import build_colorless_fdn
from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import eig_kernels as ek
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import phase2_micro as pm
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.processor import dsp


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(seed: int, M: int, N: int):
    rng = np.random.default_rng(seed)
    U = expm_skew(torch.tensor(rng.normal(size=(N, N)), dtype=torch.float32))
    host = dict(
        D=(0.85 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))))
        .astype(np.complex64),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        B=(rng.normal(size=(M, N)) + 1j * rng.normal(size=(M, N)))
        .astype(np.complex64),
        X=(rng.normal(size=M) + 1j * rng.normal(size=M)).astype(np.complex64),
        t=rng.uniform(size=M).astype(np.float32),
    )
    out = {k: torch.tensor(v, device="cuda") for k, v in host.items()}
    out["U"] = U.cuda()
    return out


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 6, 9, 16])
@pytest.mark.parametrize("M", [1000, 4097])
def test_cuda_kernels_match_plain(cuda, N, M):
    o = _operands(N + M, M, N)
    D, U, b, c, B, X, t = (o[n] for n in "DUbcBXt")
    for transpose in (False, True):
        assert _rel(fk.fdn_solve_kernel(D, U, B, transpose),
                    fk.fdn_solve_plain(D, U, B, transpose)) < 1e-5
    tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    tfp, yp = fk.fdn_tf_fwd_plain(D, U, b, c)
    assert _rel(tf, tfp) < 1e-5
    assert _rel(y, yp) < 1e-5
    got = fk.fdn_tf_bwd_kernel(D, U, b, c, yp, X)
    ref = fk.fdn_tf_bwd_plain(D, U, b, c, yp, X)
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-4
    for pivot in (True, False):
        for with_dbar in (True, False):
            got = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar, pivot)
            ref = fk.fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
            for g, r in zip(got[1:], ref[1:]):
                if r is None:
                    assert g is None
                else:
                    assert _rel(g, r) < 1e-4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_autograd_matches_plain_and_counts_launches(cuda):
    """The public functions on the card: gradients equal those of the same
    functions on the CPU (plain versions), and each launch is counted."""
    o = _operands(0, 300, 6)
    names = ("D", "U", "b", "c")

    def run(device):
        leaves = [o[n].detach().to(device).requires_grad_(True)
                  for n in names]
        X, t, B = (o[n].to(device) for n in ("X", "t", "B"))
        loss = (torch.abs(fk.fdn_tf(*leaves)).sum()
                + fk.fdn_tf_mse(*leaves, X, t, with_dbar=False, pivot=False)
                + torch.abs(fk.fdn_solve(leaves[0], leaves[1], B)).sum())
        loss.backward()
        return [x.grad.cpu() for x in leaves]

    fk.reset_launch_counts()
    on_card = run("cuda")
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fdn_tf_mse": 1, "fdn_solve": 2, "fdn_tf_fwd": 1, "fdn_tf_bwd": 1}
    on_cpu = run("cpu")
    assert fk.LAUNCHES["fdn_tf_fwd"] == 1  # the CPU run launches nothing
    for g, r in zip(on_card, on_cpu):
        assert _rel(g, r) < 1e-4


@pytest.mark.gpu
def test_cuda_kernel_rejects_unsupported_n(cuda):
    """Past the looped kernels' limits K2, K6, K3f, K3b and K5 raise,
    naming them."""
    N = fk.LOOP_MAX_N["fdn_solve"] + 1
    D = torch.zeros((8, N), dtype=torch.complex64, device="cuda")
    with pytest.raises(ValueError, match="channels"):
        fk.fdn_solve_kernel(D, torch.zeros((N, N), device="cuda"), D)
    N = fk.LOOP_MAX_N["dense_solve"] + 1
    D = torch.zeros((8, N), dtype=torch.complex64, device="cuda")
    A = torch.zeros((8, N, N), dtype=torch.complex64, device="cuda")
    with pytest.raises(ValueError, match="channels"):
        fk.dense_solve_kernel(A, D)
    with pytest.raises(ValueError, match="channels"):
        fk.dense_solve(A, D)
    for kind in ("fdn_tf_fwd", "fdn_tf_bwd"):
        N = fk.LOOP_MAX_N[kind] + 1
        v = torch.zeros(N, device="cuda")
        U = torch.zeros((N, N), device="cuda")
        with pytest.raises(ValueError, match=rf"N = {N} channels.*"
                           rf"takes 1\.\.{N - 1}"):
            if kind == "fdn_tf_fwd":
                fk.fdn_tf_fwd_kernel(D[:, :N], U, v, v)
            else:
                fk.fdn_tf_bwd_kernel(D[:, :N], U, v, v, D[:, :N], D[:, 0])
    N = sk.loop_tf_mse_max_n(30, 3, True) + 1
    v = torch.zeros(N, device="cuda")
    bt = torch.zeros((3, 30, N), device="cuda")
    with pytest.raises(ValueError, match=rf"N = {N} channels, K = 30 "
                       rf"sections of P = 3 taps.*takes 1\.\.{N - 1}"):
        sk.fdn_sos_tf_mse_kernel(D[:, :N], bt, bt, torch.zeros(
            (N, N), device="cuda"), v, v, D[:, 0], D[:, 0].real, 14)


@pytest.mark.gpu
def test_cuda_loop_smem_rule_matches_python(cuda):
    """fdn_loop.cu's shared memory and warps a block equal the wrapper's
    rule at every N up to past each kernel's limit."""
    lib = cuda_build.load(1, fk.LOOP_LIB)
    for kind, code in fk.LOOP_KINDS.items():
        for N in range(1, fk.LOOP_MAX_N[kind] + 3):
            assert lib.fl_warps(code, N) == fk.loop_warps(kind, N)
            for w in (1, 3, 8):
                assert lib.fl_smem_bytes(code, N, w) == fk.loop_smem_bytes(
                    kind, N, w)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [16, 17, 32, 64])
@pytest.mark.parametrize("M", [33, 4097])
def test_cuda_looped_kernels_match_plain(cuda, N, M):
    """K2, K6 and K1 looped against their plain versions (values 1e-5 of
    the max, cotangents 1e-4), both ways and in K1's four variants, and
    at N = 16 against the unrolled kernels on the same operands at the
    same bounds; two K1 launches equal bit for bit."""
    o = _operands(N + 7 * M, M, N)
    D, U, b, c, B, X, t = (o[n] for n in "DUbcBXt")
    A = fk._loop_matrix(D, U)
    for transpose in (False, True):
        y = fk.fdn_solve_loop_kernel(D, U, B, transpose)
        assert _rel(y, fk.fdn_solve_plain(D, U, B, transpose)) < 1e-5
        yd = fk.dense_solve_loop_kernel(A, B, transpose)
        assert _rel(yd, fk.dense_solve_plain(A, B, transpose)) < 1e-5
        if N <= fk.MAX_N:
            assert _rel(y, fk.fdn_solve_kernel(D, U, B, transpose)) < 1e-5
            assert _rel(yd, fk.dense_solve_kernel(A, B, transpose)) < 1e-5
    for pivot in (True, False):
        for with_dbar in (True, False):
            got = fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar,
                                            pivot)
            refs = [fk.fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)]
            if N <= fk.MAX_N:
                refs.append(fk.fdn_tf_mse_kernel(D, U, b, c, X, t,
                                                 with_dbar, pivot))
            for ref in refs:
                assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
                for g, r in zip(got[1:], ref[1:]):
                    if r is None:
                        assert g is None
                    else:
                        assert _rel(g, r) < 1e-4
            again = fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar,
                                              pivot)
            for g, r in zip(got, again):
                assert (g is None and r is None) or torch.equal(g, r)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_looped_dispatch_and_counts(cuda):
    """Past 16 channels the public functions launch the looped kernels,
    counted under their own keys, and their gradients equal those of the
    same functions on the CPU."""
    o = _operands(3, 500, 24)

    def run(device):
        leaves = [o[n].detach().to(device).requires_grad_(True)
                  for n in ("D", "U", "b", "c")]
        X, t, B = (o[n].to(device) for n in ("X", "t", "B"))
        A = fk._loop_matrix(leaves[0], leaves[1])
        loss = (fk.fdn_tf_mse(*leaves, X, t, with_dbar=True, pivot=True)
                + torch.abs(fk.fdn_solve(leaves[0], leaves[1], B)).sum()
                + torch.abs(fk.dense_solve(A, B)).sum())
        loss.backward()
        return [x.grad.cpu() for x in leaves]

    fk.reset_launch_counts()
    on_card = run("cuda")
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fdn_tf_mse_loop": 1, "fdn_solve_loop": 1,
        "fdn_solve_loop_transposed": 1, "dense_solve_loop": 1,
        "dense_solve_loop_transposed": 1}
    on_cpu = run("cpu")
    for g, r in zip(on_card, on_cpu):
        assert _rel(g, r) < 1e-4


@pytest.mark.gpu
def test_cuda_loop_sos_smem_rule_matches_python(cuda):
    """fdn_loop.cu's shared memory and warps a block of K5 looped equal
    the wrapper's rule (loop_tf_mse_smem_bytes) over N, K, P and
    fuse_taps, past the limit too."""
    lib = cuda_build.load(1, fk.LOOP_LIB)
    for K, P in ((1, 1), (12, 3), (30, 3), (64, 8)):
        for fuse in (True, False):
            for N in range(1, sk.loop_tf_mse_max_n(K, P, fuse) + 3, 5):
                assert lib.fl_sos_warps(N, K, P, int(fuse)) == (
                    sk.loop_tf_mse_warps(N, K, P, fuse))
                for w in (1, 2, 8):
                    assert lib.fl_sos_smem_bytes(N, K, P, int(fuse), w) == (
                        sk.loop_tf_mse_smem_bytes(N, K, P, fuse, w))


def _check_tf_loop(o, refs_unrolled: bool):
    """K3f and K3b looped against their plain versions (tf and y 1e-5 of
    the max, cotangents 1e-4) and, with ``refs_unrolled``, against the
    unrolled kernels at the same bounds; two K3b launches equal bit for
    bit."""
    D, U, b, c, B = (o[n] for n in "DUbcB")
    tf, y = fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    refs = [fk.fdn_tf_fwd_plain(D, U, b, c)]
    if refs_unrolled:
        refs.append(fk.fdn_tf_fwd_kernel(D, U, b, c))
    for tf_r, y_r in refs:
        assert _rel(tf, tf_r) < 1e-5 and _rel(y, y_r) < 1e-5
    tb = B[:, 0]
    got = fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, tb)
    refs = [fk.fdn_tf_bwd_plain(D, U, b, c, y, tb)]
    if refs_unrolled:
        refs.append(fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb))
    for ref in refs:
        for g, r in zip(got, ref):
            assert _rel(g, r) < 1e-4
    again = fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, tb)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def _check_k5_loop(o, bt, at, nfft, bin_offset=None, variants=None,
                   unrolled: bool = False):
    """K5 looped against its plain version (loss 1e-5, cotangents 1e-4 of
    the max) in each (pivot, with_dbar, fuse_taps) variant, and with
    ``unrolled`` against the unrolled K5 at the same bounds; two launches
    of each variant equal bit for bit."""
    D, U, b, c, X, t = (o[n] for n in "DUbcXt")
    for v in variants or itertools.product((True, False), repeat=3):
        pivot, with_dbar, fuse_taps = v
        args = (D, bt, at, 0.6 * U, b, c, X, t, nfft, with_dbar, pivot,
                fuse_taps, bin_offset)
        got = sk.fdn_sos_tf_mse_loop_kernel(*args)
        refs = [sk.fdn_sos_tf_mse_plain(*args)]
        if unrolled:
            refs.append(sk.fdn_sos_tf_mse_kernel(*args))
        for ref in refs:
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5, v
            for g, r in zip(got[1:], ref[1:]):
                if r is None:
                    assert g is None
                else:
                    assert _rel(g, r) < 1e-4, v
        again = sk.fdn_sos_tf_mse_loop_kernel(*args)
        assert all(torch.equal(g, a) for g, a in zip(got, again)
                   if g is not None), v


@pytest.mark.gpu
@pytest.mark.parametrize("N", [16, 17, 32, 64])
@pytest.mark.parametrize("M", [33, 4097])
def test_cuda_looped_tf_and_k5_match_plain(cuda, N, M):
    """K3f, K3b and K5 looped against their plain versions and, at N = 16,
    against the unrolled kernels on the same operands: K5 in all eight
    variants (K = 12 sections of P = 3 taps), also at a bin offset; two
    launches equal bit for bit."""
    o = _operands(N + 11 * M, M, N)
    _check_tf_loop(o, N <= fk.MAX_N)
    nfft = 2 * (M - 1)
    bt, at = _sos_taps(N + M, 3, 12, N)
    _check_k5_loop(o, bt, at, nfft, unrolled=N <= fk.MAX_N)
    _check_k5_loop(o, bt, at, 2 * nfft, bin_offset=M - 1,
                   variants=[(False, False, True), (True, True, False)],
                   unrolled=N <= fk.MAX_N)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_looped_k5_third_octave_at_64(cuda):
    """K5 looped at its shared-memory extreme on the main path's widths:
    N = 64 channels of a 1/3-octave GEQ's K = 30 sections of P = 3 taps
    with fused tap sums, one warp a block, against its plain version."""
    assert sk.loop_tf_mse_warps(64, 30, 3, True) == 1
    o = _operands(64, 4097, 64)
    _check_k5_loop(o, *_k5_taps(30, 3, 30, 64), 8192,
                   variants=[(False, False, True), (True, True, True)])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_looped_tf_and_k5_dispatch_and_counts(cuda):
    """Past 16 channels fdn_tf and fdn_sos_tf_mse launch the looped K3f,
    K3b and K5, counted under their own keys, and their gradients equal
    those of the same functions on the CPU."""
    o = _operands(5, 500, 24)
    bt, at = _sos_taps(6, 3, 12, 24)

    def run(device):
        leaves = [o[n].detach().to(device).requires_grad_(True)
                  for n in ("D", "U", "b", "c")]
        taps = [x.detach().to(device).requires_grad_(True) for x in (bt, at)]
        X, t = (o[n].to(device) for n in ("X", "t"))
        D, U, b, c = leaves
        loss = (torch.abs(fk.fdn_tf(D, U, b, c)).sum()
                + sk.fdn_sos_tf_mse(D, *taps, 0.6 * U, b, c, X, t, 998,
                                    with_dbar=True))
        loss.backward()
        return [x.grad.cpu() for x in leaves + taps]

    fk.reset_launch_counts()
    sk.reset_launch_counts()
    on_card = run("cuda")
    assert {k: v for k, v in {**fk.LAUNCHES, **sk.LAUNCHES}.items()
            if v} == {"fdn_tf_fwd_loop": 1, "fdn_tf_bwd_loop": 1,
                      "fdn_sos_tf_mse_loop": 1}
    on_cpu = run("cpu")
    for g, r in zip(on_card, on_cpu):
        assert _rel(g, r) < 1e-4


def _dense_system(seed: int, shape, N: int):
    """Random well-conditioned complex systems: I plus a normal matrix of
    norm ~0.5, and a normal rhs, on the card."""
    rng = np.random.default_rng(seed)
    A = (np.eye(N) + (rng.normal(size=shape + (N, N))
                      + 1j * rng.normal(size=shape + (N, N)))
         / (4 * np.sqrt(N))).astype(np.complex64)
    B = (rng.normal(size=shape + (N,))
         + 1j * rng.normal(size=shape + (N,))).astype(np.complex64)
    return torch.tensor(A, device="cuda"), torch.tensor(B, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 6, 16])
def test_cuda_dense_solve_matches_plain(cuda, N):
    """K6 forward and transposed against its plain version (1e-5 of the
    max) at M = 4097; the public function with A (M, N, N) broadcast
    against a batched B (2, M, N) on the card against the same function
    on the CPU (values 1e-5, gradients 1e-4), one forward and one
    transposed launch counted; closed_loop_solve('pallas') runs K6."""
    from flamo_tpu_torch.ops.solve import closed_loop_solve

    M = 4097
    A, B = _dense_system(N, (M,), N)
    for transpose in (False, True):
        assert _rel(fk.dense_solve_kernel(A, B, transpose),
                    fk.dense_solve_plain(A, B, transpose)) < 1e-5
    _, B2 = _dense_system(N + 100, (2, M), N)

    def run(device):
        a = A.detach().to(device).requires_grad_(True)
        b = B2.detach().to(device).requires_grad_(True)
        y = fk.dense_solve(a, b)
        assert y.shape == b.shape
        torch.sum(torch.abs(y) ** 2).backward()
        return y.detach().cpu(), a.grad.cpu(), b.grad.cpu()

    fk.reset_launch_counts()
    on_card = run("cuda")
    assert fk.LAUNCHES["dense_solve"] == 1
    assert fk.LAUNCHES["dense_solve_transposed"] == 1
    on_cpu = run("cpu")
    assert fk.LAUNCHES["dense_solve"] == 1  # the CPU run launches nothing
    assert _rel(on_card[0], on_cpu[0]) < 1e-5
    for g, r in zip(on_card[1:], on_cpu[1:]):
        assert _rel(g, r) < 1e-4
    y = closed_loop_solve(A, B, method="pallas")
    assert fk.LAUNCHES["dense_solve"] == 2
    assert _rel(y, fk.dense_solve_plain(A, B)) < 1e-5
    torch.cuda.synchronize()


def _sos_taps(seed: int, P: int, K: int, N: int):
    """Well-conditioned taps: poles of radius 0.2-0.6 and numerators close
    to the denominators, so that each section's response stays near 1
    and the attenuated loop I - diag(D Gam) U stays far from singular."""
    rng = np.random.default_rng(seed)
    if P == 3:
        r = rng.uniform(0.2, 0.6, (K, N))
        th = rng.uniform(0, np.pi, (K, N))
        a = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    else:
        a = np.concatenate([np.ones((1, K, N)),
                            0.1 * rng.normal(size=(P - 1, K, N))])
    b = a + 0.02 * rng.normal(size=(P, K, N))
    return (torch.tensor(b.astype(np.float32), device="cuda"),
            torch.tensor(a.astype(np.float32), device="cuda"))


def _geq_taps(N: int, nfft: int):
    g = torch.Generator().manual_seed(N)
    geq = dsp.parallelGEQ(size=(N,), nfft=nfft, generator=g, device="cuda")
    with torch.no_grad():
        return geq.sos_taps(geq.map(geq.param))


def _check_k4(b, a, nfft, val_tol, grad_tol, bin_offset=None):
    M, N = nfft // 2 + 1, b.shape[2]
    H = sk.sos_cascade_fwd_kernel(b, a, nfft, bin_offset)
    assert H.shape == (M, N)
    assert _rel(H, sk.sos_cascade_fwd_plain(b, a, nfft, bin_offset)) < val_tol
    rng = np.random.default_rng(M)
    g = torch.tensor((rng.normal(size=(M, N)) + 1j * rng.normal(size=(M, N)))
                     .astype(np.complex64), device="cuda")
    got = sk.sos_cascade_bwd_kernel(b, a, g, nfft, bin_offset)
    ref = sk.sos_cascade_bwd_plain(b, a, g, nfft, bin_offset)
    for x, r in zip(got, ref):
        assert _rel(x, r) < grad_tol


@pytest.mark.gpu
@pytest.mark.parametrize("nfft", [2000, 96000])
def test_cuda_sos_cascade_matches_plain(cuda, nfft):
    """K4f and K4b at a small M and at M = 48001: random taps (P = 3,
    K = 12, N = 6; P = 5; a bin offset; N = 16; N = 17, 25 and 40, more
    than one block of K4's channels) and a GEQ's taps."""
    _check_k4(*_sos_taps(0, 3, 12, 6), nfft, 1e-5, 1e-4)
    _check_k4(*_sos_taps(1, 5, 2, 2), nfft, 1e-5, 1e-4)
    _check_k4(*_sos_taps(2, 3, 4, 3), nfft, 1e-5, 1e-4, bin_offset=17.0)
    _check_k4(*_sos_taps(3, 3, 3, 16), nfft, 1e-5, 1e-4)
    for N in (17, 25, 40):
        _check_k4(*_sos_taps(N, 3, 12, N), nfft, 1e-5, 1e-4)
    _check_k4(*_geq_taps(6, nfft), nfft, 5e-3, 1e-3)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["Biquad", "parallelBiquad", "PEQ",
                                    "parallelPEQ", "SVF"])
def test_cuda_filter_family_pallas_route_matches_plain(cuda, family):
    """A filter family on the 'pallas' route on the card (K4f, its gradient
    K4b, launched once each) against the same filter on 'xla' (the plain
    cascade), from one seed at nfft = 96000: response 1e-5 and gradient
    1e-4 of the max, the channel dims folded into K4's channel axis."""
    kw = {"Biquad": dict(size=(2, 1), n_sections=2, filter_type="highpass",
                         alias_decay_db=30),
          "parallelBiquad": dict(size=(2,), n_sections=2,
                                 filter_type="highpass"),
          "PEQ": dict(size=(2, 1), n_bands=6),
          "parallelPEQ": dict(size=(2,), n_bands=6),
          "SVF": dict(size=(2, 1), n_sections=4)}[family]

    def build(backend):
        gen = torch.Generator().manual_seed(5)
        cls = getattr(dsp, family)
        if family == "SVF":
            m = cls(nfft=96000, requires_grad=True, generator=gen,
                    device="cuda", **kw)
            m.cascade_backend = backend
            return m
        return cls(nfft=96000, requires_grad=True, generator=gen,
                   device="cuda", cascade_backend=backend, **kw)

    out = {}
    for backend in ("xla", "pallas"):
        m = build(backend)
        sk.reset_launch_counts()
        H = m.response()
        torch.sum(torch.abs(H)).backward()
        torch.cuda.synchronize()
        launched = {k: v for k, v in sk.LAUNCHES.items() if v}
        assert launched == ({} if backend == "xla" else
                            {"sos_cascade_fwd": 1, "sos_cascade_bwd": 1})
        out[backend] = (H.detach(), m.param.grad)
    assert _rel(out["pallas"][0], out["xla"][0]) < 1e-5
    assert _rel(out["pallas"][1], out["xla"][1]) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("P", range(1, 9))
def test_cuda_sos_cascade_every_channel_block(cuda, P):
    """K4f and K4b at every P and every channel block (one compiled copy of
    each kernel per (channels a block, P)): N = 1..8 is one block of N
    channels, N = 9 two of 5 and 4, at a ragged M = 301 (three blocks of
    bins, the last partial) and 8 sections."""
    for N in range(1, 10):
        _check_k4(*_k5_taps(10 * P + N, P, 8, N), 600, 1e-5, 1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N", [6, 25])
def test_cuda_sos_cascade_bwd_is_deterministic(cuda, N):
    """Two launches of K4b give the same tap cotangents to the bit (no
    atomics: each block's row is summed in a fixed order)."""
    b, a = _sos_taps(N, 3, 12, N)
    rng = np.random.default_rng(N)
    g = torch.tensor((rng.normal(size=(48001, N)) + 1j * rng.normal(
        size=(48001, N))).astype(np.complex64), device="cuda")
    first = sk.sos_cascade_bwd_kernel(b, a, g, 96000)
    again = sk.sos_cascade_bwd_kernel(b, a, g, 96000)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N", [3, 6])
@pytest.mark.parametrize("nfft", [2000, 96000])
def test_cuda_fdn_sos_tf_mse_matches_plain(cuda, N, nfft):
    """K5 in every (pivot, with_dbar, fuse_taps) combination against its
    plain version, with random well-conditioned taps (K = 12, P = 3);
    fuse_taps=False takes its tap cotangents from K4b."""
    M = nfft // 2 + 1
    o = _operands(N + M, M, N)
    D, U, b, c, X, t = (o[n] for n in "DUbcXt")
    U = 0.6 * U
    bt, at = _sos_taps(N, 3, 12, N)
    for pivot in (True, False):
        for with_dbar in (True, False):
            for fuse_taps in (True, False):
                args = (D, bt, at, U, b, c, X, t, nfft, with_dbar, pivot,
                        fuse_taps)
                got = sk.fdn_sos_tf_mse_kernel(*args)
                ref = sk.fdn_sos_tf_mse_plain(*args)
                assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
                for g, r in zip(got[1:], ref[1:]):
                    if r is None:
                        assert g is None
                    else:
                        assert _rel(g, r) < 1e-4
    torch.cuda.synchronize()


def _k5_taps(seed: int, P: int, K: int, N: int):
    """Well-conditioned taps at any P and K: denominators 1 + 0.1 noise
    on the higher taps, numerators within 0.02 / sqrt(K) of them, so
    that each channel's cascade of K sections stays near 1 and the
    attenuated loop stays far from singular."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.ones((1, K, N)),
                        0.1 * rng.normal(size=(P - 1, K, N))])
    b = a + 0.02 / np.sqrt(K) * rng.normal(size=(P, K, N))
    return (torch.tensor(b.astype(np.float32), device="cuda"),
            torch.tensor(a.astype(np.float32), device="cuda"))


def _check_k5(o, bt, at, nfft, loss_tol, grad_tol, bin_offset=None,
              variants=None):
    """K5 against its plain version in each (pivot, with_dbar, fuse_taps)
    variant; returns the kernel's results by variant."""
    D, U, b, c, X, t = (o[n] for n in "DUbcXt")
    out = {}
    for v in variants or itertools.product((True, False), repeat=3):
        pivot, with_dbar, fuse_taps = v
        args = (D, bt, at, 0.6 * U, b, c, X, t, nfft, with_dbar, pivot,
                fuse_taps, bin_offset)
        got = sk.fdn_sos_tf_mse_kernel(*args)
        ref = sk.fdn_sos_tf_mse_plain(*args)
        assert abs(float(got[0] - ref[0])) / float(ref[0]) < loss_tol, v
        for g, r in zip(got[1:], ref[1:]):
            if r is None:
                assert g is None
            else:
                assert _rel(g, r) < grad_tol, v
        out[v] = got
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("P", range(1, 9))
@pytest.mark.parametrize("N", [1, 3, 6, 16])
def test_cuda_fdn_sos_tf_mse_sizes_match_plain(cuda, N, P):
    """K5 in all eight (pivot, with_dbar, fuse_taps) variants at every P
    (one unrolled copy each in the fused kernels), K = 1, 12 and 64
    sections, ragged M = 1, 100 (with a bin offset) and 1001 bins (one
    block, a partial one, eight); at P = 3 also on a GEQ's taps, at the
    JAX package's GEQ bounds (5e-3 on the loss, 1e-3 on cotangents).  At
    M = 1 the loss is one bin's (|tf X| - t)^2, which float32 cancels
    where |tf X| is near t (a random t at 1.2e-3 of it put one ulp of
    |tf X| at 1e-4 of the loss), so that bin's target is 0."""
    nfft = 2000
    for K in (1, 12, 64):
        for M, off in ((1, None), (100, 17.0), (1001, None)):
            o = _operands(1000 * N + 10 * P + K + M, M, N)
            if M == 1:
                o["t"] = torch.zeros_like(o["t"])
            _check_k5(o, *_k5_taps(N + P + K, P, K, N), nfft, 1e-5, 1e-4,
                      off)
    if P == 3:
        o = _operands(N, nfft // 2 + 1, N)
        _check_k5(o, *_geq_taps(N, nfft), nfft, 5e-3, 1e-3)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_fdn_sos_tf_mse_is_deterministic(cuda):
    """Two launches of K5 give the same results to the bit in every
    variant at the main path's size (no atomics: each block's partials
    row is summed in a fixed order)."""
    o = _operands(5, 48001, 6)
    bt, at = _sos_taps(5, 3, 12, 6)
    first = _check_k5(o, bt, at, 96000, 1e-5, 1e-4)
    for v, got in _check_k5(o, bt, at, 96000, 1e-5, 1e-4).items():
        assert all(torch.equal(g, f) for g, f in zip(got, first[v])
                   if g is not None), v
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N", [6, 16])
def test_cuda_fdn_sos_tf_mse_launches_every_old_size(cuda, N):
    """With fuse_taps, every P at the largest K that the old limit took
    (four warps' rows of head and tap sums in 48 KB: P K <= 251 at N = 6,
    <= 86 at N = 16) still launches and matches its plain version, and so
    does the largest size of all, K = 64, P = 8, which needs more than 48
    KB of shared memory."""
    o = _operands(N, 300, N)
    sizes = [(P, min(64, (3072 - (N + 1) ** 2) // (2 * P * N)))
             for P in range(1, 9)] + [(8, 64)]
    for P, K in sizes:
        assert 4 * ((N + 1) ** 2 + 2 * P * K * N) <= 12288 or (P, K) == (8, 64)
        _check_k5(o, *_k5_taps(P + K, P, K, N), 600, 1e-5, 1e-4,
                  variants=[(False, False, True), (True, True, True)])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_sos_autograd_matches_plain_and_counts_launches(cuda):
    """sos_cascade and fdn_sos_tf_mse on the card: gradients equal those
    of the same functions on the CPU (plain versions), and each launch is
    counted (fuse_taps=False launches K4b after K5)."""
    o = _operands(7, 300, 4)
    bt0, at0 = _sos_taps(7, 3, 5, 4)

    def run(device):
        D, U, b, c = (o[n].detach().to(device).requires_grad_(True)
                      for n in "DUbc")
        bt, at = (x.detach().to(device).requires_grad_(True)
                  for x in (bt0, at0))
        X, t = o["X"].to(device), o["t"].to(device)
        loss = (torch.abs(sk.sos_cascade(bt, at, 598)).sum()
                + sk.fdn_sos_tf_mse(D, bt, at, 0.6 * U, b, c, X, t, 598,
                                    with_dbar=True)
                + sk.fdn_sos_tf_mse(D, bt, at, 0.6 * U, b, c, X, t, 598,
                                    fuse_taps=False))
        loss.backward()
        return [x.grad.cpu() for x in (D, U, b, c, bt, at)]

    sk.reset_launch_counts()
    on_card = run("cuda")
    assert sk.LAUNCHES == {"sos_cascade_fwd": 1, "sos_cascade_bwd": 2,
                           "fdn_sos_tf_mse": 2}
    on_cpu = run("cpu")
    assert sk.LAUNCHES["fdn_sos_tf_mse"] == 2  # the CPU run launches nothing
    for g, r in zip(on_card, on_cpu):
        assert _rel(g, r) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("N", range(1, 9))
def test_cuda_dk_roots_matches_plain(cuda, N):
    """K7 gives exactly its plain version's roots (the library is built
    without FMA contraction and repeats the plain arithmetic) at B = 1, 7
    (partial lane groups) and the eigenvalue step's 1601 polynomials,
    after 0, 1 and 96 iterations, in rows and in the complex layout; each
    launch counted.  The polynomials are those eigvals_dk makes: the
    char-polys of centred and scaled random complex matrices."""
    rng = np.random.default_rng(N)
    for B in (1, 7, 1601):
        A = torch.tensor((rng.normal(size=(B, N, N)) + 1j * rng.normal(
            size=(B, N, N))).astype(np.complex64), device="cuda")
        Bm = A - torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)[:, None, None] \
            * torch.eye(N, dtype=A.dtype, device="cuda")
        s = torch.sqrt(torch.sum(torch.abs(Bm) ** 2, dim=(-2, -1)) / N)
        c = charpoly(Bm / torch.clamp(s, min=1e-30)[:, None, None]).T
        cr, ci = torch.real(c).contiguous(), torch.imag(c).contiguous()
        for iters in (0, 1, 96):
            ek.reset_launch_counts()
            zr, zi = ek.dk_roots_rows(cr, ci, iters)
            pr, pi = ek.dk_roots_rows_plain(cr, ci, iters)
            assert ek.LAUNCHES["dk_roots"] == 1
            assert torch.equal(zr, pr) and torch.equal(zi, pi), (B, iters)
        z = ek.dk_roots(torch.complex(cr, ci).T.contiguous())
        torch.testing.assert_close(z, torch.complex(zr, zi).T, rtol=0, atol=0)
    torch.cuda.synchronize()


def _aa_operands(seed: int, N: int, L: int, M: int, order: int):
    rng = np.random.default_rng(seed)

    def rows(n, scale=1.0):
        return torch.tensor((scale * rng.normal(size=(n, M)))
                            .astype(np.float32), device="cuda")

    return dict(hr=rows(N * L), hi=rows(N * L), gr=rows(L * N, 0.05),
                gi=rows(L * N, 0.05), rr=rows(N), ri=rows(N),
                t=torch.tensor(rng.uniform(size=(N, M)).astype(np.float32),
                               device="cuda"),
                tw=torch.tensor((0.05 / order * rng.normal(
                    size=(order, L * N))).astype(np.float32), device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("N,L", [(1, 1), (2, 3), (4, 13), (8, 5)])
@pytest.mark.parametrize("pivot", [True, False])
def test_cuda_aa_tf_mse_matches_plain(cuda, N, L, pivot):
    """K8 against its plain version at M = 4097 (1e-5 on the loss, 1e-4 of
    the max on the S rows)."""
    o = _aa_operands(N * 10 + L, N, L, 4097, 8)
    args = [o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")]
    got = ak.aa_tf_mse_kernel(*args, N, L, pivot)
    ref = ak.aa_tf_mse_plain(*args, N, L, pivot)
    assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
    for g, r in zip(got[1:], ref[1:]):
        assert _rel(g, r) < 1e-4
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,order", [(1, 1, 1), (2, 3, 8), (4, 13, 100),
                                       (3, 5, 37)])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("bin_offset", [0, 1000])
@pytest.mark.parametrize("precision", ak.PRECISIONS)
def test_cuda_aa_taps_tf_mse_matches_plain(cuda, N, L, order, pivot,
                                           bin_offset, precision):
    """K9 against its plain version of the same precision at M = 4097,
    nfft = 8192, with and without a bin offset (1e-5 on the loss, 1e-4 of
    the max on the tap cotangent): the FP32 kernel at 'highest', the
    tensor-core kernel at 'high' (3 TF32 passes) and 'default' (1).  The
    odd sizes (order 1 and 37, L N 1 and 15) pad every fragment."""
    o = _aa_operands(order + N, N, L, 4097, order)
    args = [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]
    got = ak.aa_taps_tf_mse_kernel(*args, N, L, 8192, pivot, precision,
                                   bin_offset)
    ref = ak.aa_taps_tf_mse_plain(*args, N, L, 8192, pivot, bin_offset,
                                  precision)
    assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
    assert _rel(got[1], ref[1]) < 1e-4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_aa_autograd_matches_plain_and_counts_launches(cuda):
    """aa_tf_mse, aa_taps_tf_mse (precision 'high') and poly_roots_rows
    on the card: gradients equal those of the same functions on the CPU
    (plain versions), and each launch is counted."""
    o = _aa_operands(5, 4, 13, 1000, 20)
    rng = np.random.default_rng(6)
    c0 = rng.normal(size=(2, 4, 300)).astype(np.float32)

    def run(device):
        x = {k: v.to(device) for k, v in o.items()}
        gr, gi, tw = (x[k].detach().requires_grad_(True)
                      for k in ("gr", "gi", "tw"))
        cr, ci = (torch.tensor(c, device=device, requires_grad=True)
                  for c in c0)
        zr, zi = poly_roots_rows(cr, ci)
        loss = (ak.aa_tf_mse(x["hr"], x["hi"], gr, gi, x["rr"], x["ri"],
                             x["t"], 4, 13)
                + ak.aa_taps_tf_mse(x["hr"], x["hi"], tw, x["rr"], x["ri"],
                                    x["t"], 4, 13, 1998)
                + torch.sum(zr * zr - zi))
        loss.backward()
        return [v.grad.cpu() for v in (gr, gi, tw, cr, ci)]

    ak.reset_launch_counts()
    ek.reset_launch_counts()
    on_card = run("cuda")
    assert ak.LAUNCHES == {k: int(k in ("aa_tf_mse", "aa_taps_tf_mse_tc_high"))
                           for k in ak.LAUNCHES}
    assert ek.LAUNCHES == {"dk_roots": 1}
    on_cpu = run("cpu")
    assert ak.LAUNCHES["aa_taps_tf_mse_tc_high"] == 1  # none on the CPU
    for g, r in zip(on_card, on_cpu):
        assert _rel(g, r) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ak.PRECISIONS)
def test_cuda_aa_taps_tf_mse_counts_the_precisions_kernel(cuda, precision):
    """One aa_taps_tf_mse call on the card launches the kernel of its
    precision once, and no other: the FP32 kernel for 'highest', the
    tensor-core kernel with 3 or 1 passes for 'high' or 'default'."""
    o = _aa_operands(3, 4, 13, 1000, 100)
    tw = o["tw"].detach().requires_grad_(True)
    ak.reset_launch_counts()
    loss = ak.aa_taps_tf_mse(o["hr"], o["hi"], tw, o["rr"], o["ri"], o["t"],
                             4, 13, 8192, precision=precision)
    loss.backward()
    key = ("aa_taps_tf_mse" if precision == "highest"
           else f"aa_taps_tf_mse_tc_{precision}")
    assert ak.LAUNCHES == {k: int(k == key) for k in ak.LAUNCHES}
    assert torch.isfinite(tw.grad).all()


@pytest.mark.gpu
def test_cuda_aa_taps_tc_kernel_rejects_unsupported_sizes(cuda):
    """The tensor-core K9 raises by name outside its limits: a working
    set above a block's shared memory, more microphones than the looped
    kernel takes, a fractional bin offset; its library refuses a pass count other than 0
    (the FP32 kernel), 1 or 3.  No CUDA tensor goes to the FP32 kernel or the plain version
    instead."""
    o = _aa_operands(1, 4, 13, 100, 400)
    args = [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]
    ak.reset_launch_counts()
    for precision in ("high", "default"):
        with pytest.raises(ValueError, match="aa_taps_tf_mse_tc_kernel.*"
                           "shared memory"):
            ak.aa_taps_tf_mse_kernel(*args, 4, 13, 8192,
                                     precision=precision)
        with pytest.raises(ValueError, match="whole number"):
            ak.aa_taps_tf_mse_kernel(*args[:2], o["tw"][:100], *args[3:], 4,
                                     13, 8192, precision=precision,
                                     bin_offset=0.5)
    top = ak.loop_max_n(1, 2)
    z = torch.zeros((top + 1, top + 1), device="cuda")
    with pytest.raises(ValueError, match=rf"1\.\.{top} microphones"):
        ak.aa_taps_tf_mse_kernel(z, z, z[:2, :top + 1], z, z, z, top + 1, 1,
                                 64)
    assert all(v == 0 for v in ak.LAUNCHES.values())
    lib = cuda_build.load(4, ak.LIB)
    assert lib.aa_taps_grid(4, 0, 2, 100, 13, 1000) == -2
    assert all(lib.aa_taps_grid(4, 0, p, 100, 13, 1000) > 0
               for p in (0, 1, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,order,M", [(9, 13, 100, 4097), (16, 13, 100, 4097),
                                         (32, 13, 100, 1000), (12, 3, 37, 301)])
@pytest.mark.parametrize("pivot", [True, False])
def test_cuda_aa_loop_matches_plain(cuda, N, L, order, M, pivot):
    """K8 looped and K9 looped at every precision (past 8 microphones,
    aa_loop.cu) against their plain versions, K9 also at a bin offset: the
    loss 1e-5, the S rows and the tap cotangent 1e-4 of the max, as the
    unrolled kernels; each call launches its looped kernel once."""
    o = _aa_operands(N * 7 + L + M, N, L, M, order)
    args = [o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")]
    ak.reset_launch_counts()
    got = ak.aa_tf_mse_kernel(*args, N, L, pivot)
    ref = ak.aa_tf_mse_plain(*args, N, L, pivot)
    assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
    for g, r in zip(got[1:], ref[1:]):
        assert _rel(g, r) < 1e-4
    args = [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]
    for precision in ak.PRECISIONS:
        for off in (0, 1000):
            got = ak.aa_taps_tf_mse_kernel(*args, N, L, 8192, pivot, precision,
                                           off)
            ref = ak.aa_taps_tf_mse_plain(*args, N, L, 8192, pivot, off,
                                          precision)
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5, \
                (precision, off)
            assert _rel(got[1], ref[1]) < 1e-4, (precision, off)
    assert ak.LAUNCHES == {k: (1 if k == "aa_tf_mse_loop" else
                               2 if k.endswith("_loop") else 0)
                           for k in ak.LAUNCHES}
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ak.PRECISIONS)
def test_cuda_aa_loop_against_unrolled_at_8(cuda, precision):
    """At 8 microphones both designs run: the looped K8 and K9 against the
    unrolled ones on the same operands (loss 1e-5, rows 1e-4 of the max)."""
    o = _aa_operands(88, 8, 13, 4097, 100)
    rows8 = [o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")]
    rows9 = [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]
    for pivot in (True, False):
        for got, ref in ((ak.aa_tf_mse_loop_kernel(*rows8, 8, 13, pivot),
                          ak.aa_tf_mse_kernel(*rows8, 8, 13, pivot)),
                         (ak.aa_taps_tf_mse_loop_kernel(
                             *rows9, 8, 13, 8192, pivot, precision, 100),
                          ak.aa_taps_tf_mse_kernel(*rows9, 8, 13, 8192, pivot,
                                                   precision, 100))):
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
            for g, r in zip(got[1:], ref[1:]):
                assert _rel(g, r) < 1e-4


@pytest.mark.gpu
def test_cuda_aa_loop_smem_rule_matches_python(cuda):
    """The looped kernels' shared-memory rules and plans in aa_loop.cu
    equal their Python mirrors, which check_aa_loop applies before a
    library loads."""
    lib = cuda_build.load(1, ak.LOOP_LIB)
    for N in (1, 9, 16, 17, 32, 49, 50, 64, 155, 156):
        for L in (1, 3, 13):
            for w in (1, 8):
                assert lib.aal_tf_mse_smem_bytes(N, L, w) == \
                    ak.loop_tf_mse_smem_bytes(N, L, w)
            assert lib.aal_tf_mse_warps(N, L) == ak.loop_tf_mse_warps(N, L)
            for passes in (0, 1, 3):
                for order in (1, 37, 100):
                    assert (lib.aal_taps_bins(passes, order, N, L),
                            lib.aal_taps_solvers(passes, order, N, L)) == \
                        ak.loop_taps_plan(passes, order, N, L)
                    for bins, solvers in ((64, 8), (32, 3)):
                        assert lib.aal_taps_smem_bytes(
                            passes, order, N, L, bins, solvers) == \
                            ak.loop_taps_smem_bytes(passes, order, N, L, bins,
                                                    solvers)
    assert ak.loop_max_n(13) == 155
    assert ak.loop_max_n(13, 100, "high") == 49


@pytest.mark.gpu
def test_cuda_aa_loop_autograd_matches_cpu(cuda):
    """aa_tf_mse and aa_taps_tf_mse at 12 microphones on the card (the
    looped kernels, once each) give the gradients of the same functions
    on the CPU (plain versions), 1e-4 of the max."""
    o = _aa_operands(12, 12, 5, 1000, 20)

    def run(device):
        x = {k: v.to(device) for k, v in o.items()}
        gr, gi, tw = (x[k].detach().requires_grad_(True)
                      for k in ("gr", "gi", "tw"))
        loss = (ak.aa_tf_mse(x["hr"], x["hi"], gr, gi, x["rr"], x["ri"],
                             x["t"], 12, 5)
                + ak.aa_taps_tf_mse(x["hr"], x["hi"], tw, x["rr"], x["ri"],
                                    x["t"], 12, 5, 1998))
        loss.backward()
        return [v.grad.cpu() for v in (gr, gi, tw)]

    ak.reset_launch_counts()
    on_card = run("cuda")
    assert ak.LAUNCHES == {k: int(k in ("aa_tf_mse_loop",
                                        "aa_taps_tf_mse_tc_high_loop"))
                           for k in ak.LAUNCHES}
    for g, r in zip(on_card, run("cpu")):
        assert _rel(g, r) < 1e-4


@pytest.mark.gpu
def test_cuda_aa_and_eig_kernels_reject_unsupported_sizes(cuda):
    o = _aa_operands(1, 4, 13, 100, 2000)
    with pytest.raises(ValueError, match="shared memory"):
        ak.aa_taps_tf_mse_kernel(*(o[k] for k in ("hr", "hi", "tw", "rr",
                                                  "ri", "t")), 4, 13, 8192)
    top = ak.loop_max_n(1)
    z = torch.zeros((top + 1, 10), device="cuda")
    with pytest.raises(ValueError, match=rf"1\.\.{top} microphones"):
        ak.aa_tf_mse_kernel(z, z, z, z, z, z, z, top + 1, 1)
    z = z[:9]
    with pytest.raises(ValueError, match="EIG_DK_MAX_N"):
        ek.dk_roots_rows(z, z)
    with pytest.raises(TypeError, match="float32"):
        ek.dk_roots_rows(z[:4].double(), z[:4].double())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", pm.VARIANTS)
@pytest.mark.parametrize("P,K,N,M,nfft,ones", [
    (3, 12, 6, 48128, 96000, True),   # the micro-benchmark's operands
    (3, 12, 6, 48128, 96000, False),
    (2, 5, 3, 1000, 2000, False),
    (5, 16, 2, 4097, 8192, False),    # ps at its register limit
    (3, 4, 6, 2048, 4096, False),     # gcd(K, N) = 2: full's passes x 4
    (4, 7, 1, 3001, 6000, False),     # one channel
    (8, 12, 6, 4097, 8192, False),    # the most taps full unrolls
])
def test_cuda_phase2_micro_matches_plain(cuda, variant, P, K, N, M, nfft,
                                         ones):
    rng = np.random.default_rng(P * K * N + M)
    t = (np.ones((2, M)) if ones else rng.normal(size=(2, M)))
    t = torch.tensor(t.astype(np.float32), device="cuda")
    c = torch.tensor(rng.uniform(0.5, 1.5, (P, K, N)).astype(np.float32),
                     device="cuda")
    pm.reset_launch_counts()
    got = pm.phase2_micro(variant, t, c, nfft)
    assert pm.LAUNCHES[variant] == 1
    assert torch.equal(got, pm.phase2_micro(variant, t, c, nfft))
    ref = pm.phase2_micro_plain(variant, t, c, nfft)
    scale = pm.phase2_micro_plain(variant, t, c, nfft, magnitude=True)
    assert got.shape == ref.shape == (3,)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * scale)), (got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("full", "noreduce", "lanered"))
@pytest.mark.parametrize("P,K,N,M,nfft", [
    (2, 64, 7, 3001, 6000),   # lcm 448: 38 pass groups, the last of 4
    (8, 64, 7, 2048, 4096),
    (6, 24, 9, 1500, 3000),   # lcm 72: 6 groups, scaled by 6
])
def test_cuda_phase2_micro_pass_groups_match_plain(cuda, variant, P, K, N,
                                                   M, nfft):
    """The distinct-pass variants over plans of several pass groups, at
    the fewest and the most taps; two launches give the same partials."""
    rng = np.random.default_rng(P * K * N + M)
    t = torch.tensor(rng.normal(size=(2, M)).astype(np.float32),
                     device="cuda")
    c = torch.tensor(rng.uniform(0.5, 1.5, (P, K, N)).astype(np.float32),
                     device="cuda")
    got = pm.phase2_micro(variant, t, c, nfft)
    assert torch.equal(got, pm.phase2_micro(variant, t, c, nfft))
    ref = pm.phase2_micro_plain(variant, t, c, nfft)
    scale = pm.phase2_micro_plain(variant, t, c, nfft, magnitude=True)
    assert bool(torch.all((got - ref).abs() <= 1e-5 * scale)), (got, ref)


@pytest.mark.gpu
def test_cuda_phase2_micro_rejects_unsupported_sizes(cuda):
    t = torch.ones((2, 256), device="cuda")
    with pytest.raises(ValueError, match="1..64"):
        pm.phase2_micro("full", t, torch.ones((3, 65, 2), device="cuda"), 512)
    with pytest.raises(ValueError, match="1..16"):
        pm.phase2_micro("ps", t, torch.ones((3, 17, 2), device="cuda"), 512)
    with pytest.raises(ValueError, match="2..8"):
        pm.phase2_micro("full", t, torch.ones((9, 4, 2), device="cuda"), 512)
    with pytest.raises(ValueError, match="different devices"):
        pm.phase2_micro("full", t, torch.ones((3, 4, 2)), 512)


def _smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 2, 6, 8, 16])
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 2000, 2001, 48001])
def test_cuda_dense_solve_rows_and_ties(cuda, N, rows):
    """K6 (one thread a row, blocks of 32 rows) around its block edges and
    at the slice's row counts, both ways, against its plain version (1e-5
    of the max), one launch counted each; and on tied-pivot systems
    (chip_smoke.tied_pivot_systems), whose exact ones equal the plain
    version on the CPU bit for bit: another pivot than the first maximal
    row shows there."""
    A, B = _dense_system(N * 100000 + rows, (rows,), N)
    At, Bt, exact = _smoke().tied_pivot_systems(
        np.random.default_rng(rows + N), min(rows, 2001), N)
    At = torch.tensor(At.astype(np.complex64), device="cuda")
    Bt = torch.tensor(Bt.astype(np.complex64), device="cuda")
    exact = torch.from_numpy(exact)
    for transpose in (False, True):
        name = "dense_solve_transposed" if transpose else "dense_solve"
        fk.reset_launch_counts()
        assert _rel(fk.dense_solve_kernel(A, B, transpose),
                    fk.dense_solve_plain(A, B, transpose)) < 1e-5
        got = fk.dense_solve_kernel(At, Bt, transpose)
        assert fk.LAUNCHES[name] == 2
        assert _rel(got, fk.dense_solve_plain(At, Bt, transpose)) < 1e-5
        ref = fk.dense_solve_plain(At.cpu(), Bt.cpu(), transpose)
        assert torch.equal(got.cpu()[exact], ref[exact])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 6, 16])
@pytest.mark.parametrize("M", [1, 63, 65, 4097])
def test_cuda_tf_mse_and_bwd_ragged(cuda, N, M):
    """K1 in its four (pivot, with_dbar) variants and K3b, whose block sums
    are recursive halvings, at bin counts off the 128-bin blocks: against
    their plain versions (the loss 1e-5, the cotangents 1e-4 of the max),
    two launches equal bit for bit, each launch counted."""
    o = _operands(7 * M + N, M, N)
    D, U, b, c, X, t = (o[n] for n in "DUbcXt")
    if M == 1:  # a target near |tf X| would make one bin's loss ~0
        t = torch.zeros_like(t)
    fk.reset_launch_counts()
    for pivot in (True, False):
        for with_dbar in (True, False):
            got = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar, pivot)
            again = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar, pivot)
            ref = fk.fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
            for g, a, r in zip(got[1:], again[1:], ref[1:]):
                if r is None:
                    assert g is None
                    continue
                assert _rel(g, r) < 1e-4
                assert torch.equal(g, a)
            assert torch.equal(got[0], again[0])
    assert fk.LAUNCHES["fdn_tf_mse"] == 8
    _, yp = fk.fdn_tf_fwd_plain(D, U, b, c)
    got = fk.fdn_tf_bwd_kernel(D, U, b, c, yp, X)
    again = fk.fdn_tf_bwd_kernel(D, U, b, c, yp, X)
    for g, a, r in zip(got, again, fk.fdn_tf_bwd_plain(D, U, b, c, yp, X)):
        assert _rel(g, r) < 1e-4
        assert torch.equal(g, a)
    assert fk.LAUNCHES["fdn_tf_bwd"] == 2
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def previous():
    """The previous libraries (controls/aa_kernels_prev, K9 before its FP32
    kernel's redesign, controls/fdn_kernels_prev, whose K2 is the one
    before its redesign, and controls/fdn_tf_prev, K3f and K3b before
    theirs) for the channel counts below, one nvcc each, all at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    return smoke.Previous(smoke.Previous.start(
        False, [("aa", n) for n in (1, 4, 8)]
        + [("fdn", n) for n in (1, 3, 6)] + [("tf", n) for n in (3, 5, 6)]))


def _taps_args(o):
    return [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]


def _k9_cases(args, N, L, nfft=8192):
    """K9 'highest' against its plain version (1e-5 on the loss, 1e-4 of
    the max on the tap cotangent), pivot both ways, bin offset 0 and 1000,
    each launched twice with equal results."""
    ak.reset_launch_counts()
    for pivot in (False, True):
        for off in (0, 1000):
            got = ak.aa_taps_tf_mse_kernel(*args, N, L, nfft, pivot,
                                           "highest", off)
            again = ak.aa_taps_tf_mse_kernel(*args, N, L, nfft, pivot,
                                             "highest", off)
            ref = ak.aa_taps_tf_mse_plain(*args, N, L, nfft, pivot, off,
                                          "highest")
            assert abs(float(got[0] - ref[0])) / float(ref[0]) < 1e-5
            assert _rel(got[1], ref[1]) < 1e-4, (pivot, off)
            assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert ak.LAUNCHES["aa_taps_tf_mse"] == 8
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 63, 65, 4097])
@pytest.mark.parametrize("order", [1, 17, 100, 200, 284])
def test_cuda_aa_taps_highest_orders_and_ragged_bins(cuda, M, order):
    """K9 'highest' (the FP32 kernel: 64-bin tiles, 6 x 4 cotangent tiles
    in registers) on the 4 x 13 rig's shape at bin counts off its tiles
    and orders around its shared-memory paths: tw staged with two blocks
    an SM (orders 1, 17, 100), staged with one (200), through L1 at 284,
    the largest order the previous kernel's size rule took at L N = 52,
    where its 624 cotangent tiles take three passes over the bins."""
    o = _aa_operands(7 * M + order, 4, 13, M, order)
    assert ak.taps_smem_bytes(order, 52) <= 232448
    _k9_cases(_taps_args(o), 4, 13)


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,order,M", [(n, 3, 17, 4097) for n in range(1, 9)]
                         + [(8, 54, 1, 65), (8, 54, 4, 130), (1, 1, 300, 65)])
def test_cuda_aa_taps_highest_every_mic_count(cuda, N, L, order, M):
    """K9 'highest' at every microphone count 1..8, and at the edges of
    the previous kernel's size rule: L N = 432 at orders 1 and 4 (its
    synthesis tiles go round the block more than once), L N = 1 at order
    300 (tw staged with one block an SM).  The loop gain |H G| grows with
    the square root of L, so the taps are scaled by sqrt(13 / L) to keep
    the 4 x 13 rig's gain: unscaled, L = 54 at order 1 puts the loop's
    condition number at ~600, and the float32 plain version alone lies
    2e-5 from a float64 one on the loss, past the 1e-5 that rounding in
    another order is held to."""
    o = _aa_operands(N * 100 + L + order, N, L, M, order)
    o["tw"] = o["tw"] * min(1.0, (13 / L) ** 0.5)
    _k9_cases(_taps_args(o), N, L)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 4, 8])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_cuda_aa_taps_tc_bit_identical_to_previous(cuda, previous, N,
                                                   precision):
    """K9 'high' and 'default' (the tensor-core kernel, which now shares
    its tile frame with the FP32 kernel) equal the previous library's
    bit for bit: loss and tap cotangent, pivot both ways, bin offset 0 and
    1000, at ragged M."""
    L = 13 if N == 4 else 3
    for M in (63, 4097):
        o = _aa_operands(N + M, N, L, M, 100)
        args = _taps_args(o)
        for pivot in (False, True):
            for off in (0, 1000):
                got = ak.aa_taps_tf_mse_kernel(*args, N, L, 8192, pivot,
                                               precision, off)
                ref = previous.aa_taps(*args, N, L, 8192, pivot, precision,
                                       off)
                assert all(torch.equal(g, r) for g, r in zip(got, ref)), (
                    M, pivot, off)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 6])
@pytest.mark.parametrize("M", [1, 31, 33, 4097])
def test_cuda_fdn_solve_bit_identical_to_previous(cuda, previous, N, M):
    """K2 (a warp's vote on each row exchange, U staged, float4 rows)
    forward and transposed equals the previous K2 bit for bit on random,
    pivot-every-step and tied-pivot systems (chip_smoke.k2_systems) at
    bin counts off its warps and blocks, and on the exact tied systems
    its plain version on the CPU too: another pivot than the first
    maximal row shows there.  One launch counted a call."""
    smoke = _smoke()
    rng = np.random.default_rng(N * 10000 + M)
    for transpose in (False, True):
        for label, system in smoke.k2_systems(rng, M, N, transpose).items():
            D, U, B = smoke.k2_tensors(system)
            fk.reset_launch_counts()
            got = fk.fdn_solve_kernel(D, U, B, transpose)
            assert fk.LAUNCHES["fdn_solve"] == 1
            assert torch.equal(got, previous.fdn_solve(D, U, B, transpose)), (
                label, transpose)
            ref = fk.fdn_solve_plain(D, U, B, transpose)
            assert _rel(got, ref) < 1e-5, (label, transpose)
            exact = torch.from_numpy(system[3])
            if exact.any():
                ref_cpu = fk.fdn_solve_plain(D.cpu(), U.cpu(), B.cpu(),
                                             transpose)
                assert torch.equal(got.cpu()[exact], ref_cpu[exact]), label
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_fdn_solve_takes_misaligned_rows(cuda):
    """K2 moves a bin's rows as float4s at even N: rows that start 8 bytes
    off 16 (a view into a larger buffer) are copied first, and solve to
    the same bits as aligned ones."""
    o = _operands(3, 1000, 6)
    D, U, B = o["D"], o["U"], o["B"]
    buf = torch.zeros(D.numel() + 1, dtype=D.dtype, device="cuda")
    buf[1:] = D.reshape(-1)
    D_off = buf[1:].view(D.shape)
    assert D_off.data_ptr() % 16 == 8
    for transpose in (False, True):
        assert torch.equal(fk.fdn_solve_kernel(D_off, U, B, transpose),
                           fk.fdn_solve_kernel(D, U, B, transpose))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [3, 5, 6])
@pytest.mark.parametrize("M", [33, 4097, 48001])
def test_cuda_fdn_tf_bit_identical_to_previous(cuda, previous, N, M):
    """K3f and K3b (a warp's vote on each row exchange, U, b and c staged,
    float4 rows where N is even) equal the previous K3f and K3b
    (controls/fdn_tf_prev) bit for bit on chip_smoke.k3_systems (random,
    pivoting at every step, tied pivots, a cycle), K3f on the forward
    systems and K3b on the transposed ones, at bin counts off the warps
    and blocks and at odd N (float2 rows); each is within 1e-5 (tf, y)
    or 1e-4 of the max (the cotangents) of its plain version, K3b
    launched twice gives the same bits, and each launch is counted."""
    smoke = _smoke()
    rng = np.random.default_rng(N * 100000 + M)
    for transpose in (False, True):
        for label, system in smoke.k3_systems(rng, M, N, transpose).items():
            D, U, b, c, tb = smoke.k3_tensors(system)
            fk.reset_launch_counts()
            tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
            assert fk.LAUNCHES["fdn_tf_fwd"] == 1
            if not transpose:
                old = previous.tf_fwd(D, U, b, c)
                assert torch.equal(tf, old[0]) and torch.equal(y, old[1]), (
                    label)
                tfp, yp = fk.fdn_tf_fwd_plain(D, U, b, c)
                assert _rel(tf, tfp) < 1e-5 and _rel(y, yp) < 1e-5, label
                continue
            got = fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb)
            again = fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb)
            assert fk.LAUNCHES["fdn_tf_bwd"] == 2
            for g, a, o, r in zip(got, again,
                                  previous.tf_bwd(D, U, b, c, y, tb),
                                  fk.fdn_tf_bwd_plain(D, U, b, c, y, tb)):
                assert torch.equal(g, o) and torch.equal(g, a), label
                assert _rel(g, r) < 1e-4, label
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_fdn_tf_takes_misaligned_rows(cuda):
    """K3f and K3b move a bin's rows as float4s at even N: D and y that
    start 8 bytes off 16 (views into larger buffers) are copied first,
    and give the same bits as aligned ones."""
    o = _operands(4, 1000, 6)
    D, U, b, c, tb = o["D"], o["U"], o["b"], o["c"], o["X"]

    def off(x):
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")
        buf[1:] = x.reshape(-1)
        view = buf[1:].view(x.shape)
        assert view.data_ptr() % 16 == 8
        return view

    tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    for g, r in zip(fk.fdn_tf_fwd_kernel(off(D), U, b, c), (tf, y)):
        assert torch.equal(g, r)
    for g, r in zip(fk.fdn_tf_bwd_kernel(off(D), U, b, c, off(y), tb),
                    fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb)):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_cuda_fused_tf_step_and_response_launch_counts(cuda):
    """One fused-tf step (chip_smoke.fused_tf_steps, Adam on
    colorless_loss_fused_tf) launches K3f and K3b once each and nothing
    else of the FDN kernels; one fused response (chip_smoke.fused_evals)
    launches K3f once."""
    smoke = _smoke()
    model = build_colorless_fdn(nfft=4096, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    fk.reset_launch_counts()
    smoke.fused_tf_steps(model)(1)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fdn_tf_fwd": 1, "fdn_tf_bwd": 1}
    fk.reset_launch_counts()
    smoke.fused_evals(model)(1)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fdn_tf_fwd": 1}


@pytest.mark.gpu
def test_cuda_fused_trainer_launches_k1_once_a_step(cuda):
    """Trainer(fused='auto') on the card takes colorless_fused_step and
    then launches K1 once per train step, once per valid step and once per
    fit_scan step, and no other FDN kernel."""
    from flamo_tpu_torch.optimize import (DatasetColorless, Trainer,
                                          load_dataset, mse_loss,
                                          sparsity_loss)

    nfft = 4096
    M = nfft // 2 + 1
    model = build_colorless_fdn(nfft=nfft, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    tl, vl = load_dataset(
        DatasetColorless((1, M, 1), (1, M, 1), expand=5, device="cuda"),
        batch_size=1, split=0.8, seed=0)
    tr = Trainer(model, max_epochs=1, log=False)
    tr.register_criterion(mse_loss(nfft=nfft), 1)
    tr.register_criterion(sparsity_loss(), 0.2, requires_model=True)
    x, t = next(iter(tl))
    tr.train_step((x, t))
    assert tr.fused_path == "colorless_fused_step"
    fk.reset_launch_counts()
    tr.train(tl, vl)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fdn_tf_mse": 5}
    fk.reset_launch_counts()
    hist = tr.fit_scan(x, t, n_steps=7, steps_per_call=3)
    assert hist.shape == (7,) and np.isfinite(hist).all()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fdn_tf_mse": 7}


@pytest.mark.gpu
@pytest.mark.parametrize("scenario", ["fdn", "direct"])
def test_cuda_e8_fdn_step_pallas_matches_xla(cuda, scenario):
    """The e8_fdn example's model at nfft = 8192 on the card: the
    'pallas'/'pallas' build (K4f + K2, backward K4b + K2 transposed)
    against the 'xla'/'ge' build of the same seed, the first loss (mss +
    sparsity) at 1e-5 and its gradients at the GEQ gradient bound 1e-3 of
    the max, then one Trainer step, launches counted exactly."""
    import types

    from flamo_tpu_torch.convert import jax_named_tensors
    from flamo_tpu_torch.examples import e8_fdn
    from flamo_tpu_torch.optimize import Trainer, mss_loss, sparsity_loss
    from flamo_tpu_torch.utils import set_seed

    nfft = 8192
    args = types.SimpleNamespace(nfft=nfft, samplerate=48000, rir=None)
    set_seed(0)
    target = e8_fdn._target_rir(args, nfft, cuda)

    def build(backend):
        set_seed(1)
        return e8_fdn._build_reference_fdn(
            args, 6, e8_fdn.DELAYS, 30, direct=scenario == "direct",
            backend=backend, device=cuda)

    def first(model):
        model.zero_grad(set_to_none=True)
        loss = e8_fdn.first_loss(model, target)
        loss.backward()
        return float(loss.detach()), {
            k: v.grad for k, v in jax_named_tensors(model).items()
            if v.requires_grad}

    lx, gx = first(build("xla"))
    mk = build("pallas")
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    lk, gk = first(mk)
    assert (fk.LAUNCHES["fdn_solve"], sk.LAUNCHES["sos_cascade_fwd"],
            sk.LAUNCHES["sos_cascade_bwd"]) == (2, 1, 1)
    assert abs(lk - lx) / lx < 1e-5
    for k in gx:
        assert _rel(gk[k], gx[k]) < 1e-3, k
    tr = Trainer(mk, log=False)
    tr.register_criterion(mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    tr.register_criterion(sparsity_loss(), 1, requires_model=True)
    x = torch.zeros((1, nfft, 1), device=cuda)
    x[:, 0, :] = 1.0
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    hist = tr.fit_scan(x, target, n_steps=2, steps_per_call=2)
    assert tr.fused_path is None and np.isfinite(hist).all()
    assert abs(hist[0] - lk) / lk < 1e-5
    assert (fk.LAUNCHES["fdn_solve"], sk.LAUNCHES["sos_cascade_fwd"],
            sk.LAUNCHES["sos_cascade_bwd"]) == (4, 2, 2)


# ---------------------------------------------------------------------------
# the register-resident K2, K3f, K3b and K5 of fdn_reg.cu (17..64 channels)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_reg_smem_rule_matches_python(cuda):
    """fdn_reg.cu's bins a block, shared memory and a bin's warps equal
    the wrappers' rules (fk.reg_bins, fk.reg_tf_bins, sk.reg_tf_mse_bins
    and their shared-memory mirrors) over N, K, P and fuse_taps, past the
    range too."""
    lib = cuda_build.load(1, fk.LOOP_LIB)
    for N in range(1, 70):
        assert lib.fl_reg_bins(0, N, 0, 0, 0) == fk.reg_bins(N)
        if fk.REG_MIN_N <= N <= fk.REG_MAX_N:
            assert lib.fl_reg_group_warps(N) == fk.reg_group_warps(N)
        for bins in (1, 2, 4):
            assert lib.fl_reg_smem_bytes(0, N, 0, 0, 0, bins) == (
                fk.reg_smem_bytes(N, bins))
        for kind, name in ((2, "fdn_tf_fwd"), (3, "fdn_tf_bwd")):
            assert lib.fl_reg_bins(kind, N, 0, 0, 0) == fk.reg_tf_bins(
                name, N)
            for bins in (1, 3, 8):
                assert lib.fl_reg_smem_bytes(kind, N, 0, 0, 0, bins) == (
                    fk.reg_tf_smem_bytes(name, N, bins))
        for K, P in ((1, 1), (12, 3), (30, 3), (64, 8)):
            for fuse in (True, False):
                assert lib.fl_reg_bins(1, N, K, P, int(fuse)) == (
                    sk.reg_tf_mse_bins(N, K, P, fuse))
                for bins in (1, 2, 8):
                    assert lib.fl_reg_smem_bytes(1, N, K, P, int(fuse),
                                                 bins) == (
                        sk.reg_tf_mse_smem_bytes(N, K, P, fuse, bins))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [17, 32, 33, 48, 64])
@pytest.mark.parametrize("M", [33, 4097])
def test_cuda_reg_kernels_match_plain(cuda, N, M):
    """The register-resident K2 (both ways) against its plain version and
    the shared-memory kernel (values 1e-5 of the max), K3f and K3b against
    their plain versions (tf and y 1e-5, cotangents 1e-4 of the max) and
    the shared-memory kernels, and K5 in all eight variants against its
    plain version (loss 1e-5, cotangents 1e-4 of the max), also at a bin
    offset; each launch counted under the looped kernels' keys, the
    shared-memory kernels' never; two launches equal bit for bit."""
    o = _operands(N + 13 * M, M, N)
    D, U, B, b, c = (o[n] for n in "DUBbc")
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    for transpose in (False, True):
        y = fk.fdn_solve_loop_kernel(D, U, B, transpose)
        assert _rel(y, fk.fdn_solve_plain(D, U, B, transpose)) < 1e-5
        assert torch.equal(y, fk.fdn_solve_loop_kernel(D, U, B, transpose))
    _check_tf_loop(o, False)  # K3f once, K3b twice
    tf, y = fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    assert all(torch.equal(g, a) for g, a in zip(
        (tf, y), fk.fdn_tf_fwd_loop_kernel(D, U, b, c)))
    nfft = 2 * (M - 1)
    bt, at = _sos_taps(N + M, 3, 12, N)
    _check_k5_loop(o, bt, at, nfft)
    _check_k5_loop(o, bt, at, 2 * nfft, bin_offset=M - 1,
                   variants=[(False, False, True), (True, True, False)])
    # the four variants without fused taps also launch K4b on their rows
    assert {k: v for k, v in {**fk.LAUNCHES, **sk.LAUNCHES}.items()
            if v} == {"fdn_solve_loop": 2, "fdn_solve_loop_transposed": 2,
                      "fdn_tf_fwd_loop": 3, "fdn_tf_bwd_loop": 2,
                      "fdn_sos_tf_mse_loop": 2 * (8 + 2),
                      "sos_cascade_bwd": 2 * (4 + 1)}
    for transpose in (False, True):
        assert _rel(fk.fdn_solve_loop_kernel(D, U, B, transpose),
                    fk.fdn_solve_loop_smem_kernel(D, U, B, transpose)) < 1e-5
    tf_s, y_s = fk.fdn_tf_fwd_loop_smem_kernel(D, U, b, c)
    assert _rel(tf, tf_s) < 1e-5 and _rel(y, y_s) < 1e-5
    for g, r in zip(fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, B[:, 0]),
                    fk.fdn_tf_bwd_loop_smem_kernel(D, U, b, c, y, B[:, 0])):
        assert _rel(g, r) < 1e-4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_reg_range_boundary(cuda):
    """At 64 channels K2, K3f, K3b and K5 (1/3-octave taps, K = 30) launch
    the register-resident kernels, at 65 the shared-memory ones, counted
    under their own keys, each held to its plain version."""
    for N, sfx in ((64, ""), (65, "_smem")):
        o = _operands(N, 1000, N)
        D, U, B = (o[n] for n in "DUB")
        fk.reset_launch_counts()
        sk.reset_launch_counts()
        assert _rel(fk.fdn_solve_loop_kernel(D, U, B),
                    fk.fdn_solve_plain(D, U, B)) < 1e-5
        _check_tf_loop(o, False)
        _check_k5_loop(o, *_k5_taps(30, 3, 30, N), 8192,
                       variants=[(False, False, True)])
        assert {k: v for k, v in {**fk.LAUNCHES, **sk.LAUNCHES}.items()
                if v} == {f"fdn_solve_loop{sfx}": 1,
                          f"fdn_tf_fwd_loop{sfx}": 1,
                          f"fdn_tf_bwd_loop{sfx}": 2,
                          f"fdn_sos_tf_mse_loop{sfx}": 2}
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_reg_build_error_raises(cuda, tmp_path, monkeypatch):
    """A looped library that fails to build raises from the K2, K3f, K3b
    and K5 wrappers at 32 channels; nothing falls back to the
    shared-memory kernel or the plain version, and nothing is counted."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in cuda_build.SOURCES:
        (src / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    with open(src / "fdn_reg.cu", "a") as f:
        f.write("\nthis does not compile;\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    o = _operands(1, 100, 32)
    D, U, B, b, c, X, t = (o[n] for n in "DUBbcXt")
    bt, at = _sos_taps(2, 3, 12, 32)
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        fk.fdn_solve_loop_kernel(D, U, B)
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        sk.fdn_sos_tf_mse_loop_kernel(D, bt, at, U, b, c, X, t, 198)
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    with pytest.raises(RuntimeError, match="nvcc failed for fdn_loop"):
        fk.fdn_tf_bwd_loop_kernel(D, U, b, c, B, X)
    assert not any({**fk.LAUNCHES, **sk.LAUNCHES}.values())
