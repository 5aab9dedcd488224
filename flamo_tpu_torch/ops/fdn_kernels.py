"""The per-bin solve kernels K1, K2, K3 and K6 (counterpart of the
elimination kernels of ``flamo_tpu/ops/pallas_solve.py``): wrappers
around the hand-written CUDA kernels of
``flamo_tpu_torch/csrc/fdn_kernels.cu``, their plain PyTorch versions, and
the ``autograd.Function``s of the public functions.

Public functions keep the JAX signatures and layouts (D (M, N)
complex64, U (N, N) float32, b and c (N,) float32, X (M,) complex64,
t (M,) float32):

* :func:`fdn_solve` (K2): ``(I - diag(D_m) U) y_m = B_m``;
* :func:`fdn_tf` (K3f forward, K3b gradient):
  ``tf_m = c^T (I - diag(D_m) U)^{-1} diag(D_m) b``;
* :func:`fdn_tf_mse` (K1): ``L = (1/M) sum_m (|tf_m X_m| - t_m)^2`` with
  its cotangents in the same pass;
* :func:`dense_solve` (K6): ``A_m y_m = B_m`` for a dense (..., M, N, N)
  complex64 A and a vector rhs B (..., M, N); the gradient is K6 on the
  transposed systems.

Each ``*_kernel`` wrapper launches its CUDA kernel for CUDA tensors (and
counts the launch in :data:`LAUNCHES`) and runs the plain version for CPU
tensors, at any channel count; it never falls back from one to the
other.  On the card K1, K2, K3f, K3b and K6 take the unrolled kernels of
``fdn_kernels.cu`` up to ``MAX_N`` = 16 channels and the looped ones of
``fdn_loop.cu`` (``*_loop_kernel``, one warp a bin) above, up to
:data:`LOOP_MAX_N`, where one bin's system fills a block's 227 KB of
shared memory; from ``REG_MIN_N`` to ``REG_MAX_N`` (17..64) channels the
looped K2, K3f and K3b run on ``fdn_reg.cu``'s register-resident core
instead (a bin's rows in registers), linked into the same library.  The
plain versions are the per-bin eliminations of
:mod:`flamo_tpu_torch.ops.solve` on the assembled loop matrices,
vectorised over bins; like the kernels, they pivot on the first row of
largest magnitude.

Cotangents: the kernels, like the TPU ones, compute JAX's cotangent of a
complex tensor, ``dL/dRe - i dL/dIm``.  PyTorch's autograd works with the
conjugate, ``dL/dRe + i dL/dIm``, so each backward conjugates the
incoming complex gradient before the kernel and the complex cotangents
it returns after.  Real cotangents (U, b, c) are the same in both.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops.solve import (_gauss_solve_raw, _ge_nopivot_factor,
                                       _lu_transpose_solve)

MAX_N = cuda_build.MAX_N
LOOP_LIB = "fdn_loop"

# launches of each CUDA kernel since the last reset (plain CPU runs do not
# count); K6 counts its forward and its transposed (gradient) launches
# apart; K2 counts both under "fdn_solve", and its transposed ones also in
# K2_TRANSPOSED; the looped kernels count under their own keys, K2 looped
# and K6 looped each way apart; K2, K3f and K3b looped count their
# register-resident kernels (17..64 channels) under "fdn_solve_loop",
# "fdn_tf_fwd_loop" and "fdn_tf_bwd_loop" and fdn_loop.cu's shared-memory
# kernels under the same keys with "_smem" (K2 each way apart)
LAUNCHES = {"fdn_tf_mse": 0, "fdn_solve": 0, "fdn_tf_fwd": 0,
            "fdn_tf_bwd": 0, "dense_solve": 0, "dense_solve_transposed": 0,
            "fdn_tf_mse_loop": 0, "fdn_solve_loop": 0,
            "fdn_solve_loop_transposed": 0, "fdn_solve_loop_smem": 0,
            "fdn_solve_loop_smem_transposed": 0, "dense_solve_loop": 0,
            "dense_solve_loop_transposed": 0, "fdn_tf_fwd_loop": 0,
            "fdn_tf_bwd_loop": 0, "fdn_tf_fwd_loop_smem": 0,
            "fdn_tf_bwd_loop_smem": 0}
K2_TRANSPOSED = [0]

# The looped kernels' shared memory (as fdn_loop.cu's smem_bytes): a block
# of W warps holds a warp's system (N rows of stride N | 1 complex) and
# vectors (d, rhs, y for K2 and K3f; rhs, y for K6; d, rhs, y, w for K1
# and K3b) each, K1's and K3b's sums (N^2 + 2N + 1 floats) each, and once
# the staged U (N rows of stride N | 1) and, but for K2, b and c.  W is
# as many warps as fit LOOP_SMEM (227 KB, the most a block may opt in to
# on sm_90), at most LOOP_MAX_WARPS.  K5 looped's rule, which also
# depends on its taps, is sos_kernels.loop_tf_mse_smem_bytes.
LOOP_SMEM = 232448
LOOP_MAX_WARPS = 8
LOOP_KINDS = {"fdn_solve": 0, "dense_solve": 1, "fdn_tf_mse": 2,
              "fdn_tf_fwd": 3, "fdn_tf_bwd": 4}
LOOP_LABELS = {"fdn_solve": "K2", "dense_solve": "K6", "fdn_tf_mse": "K1",
               "fdn_tf_fwd": "K3f", "fdn_tf_bwd": "K3b"}


def loop_smem_bytes(kind: str, N: int, warps: int) -> int:
    """Dynamic shared memory of a looped kernel's block of ``warps``."""
    S = N | 1
    common = {"fdn_solve": N * S, "dense_solve": 0}.get(kind, N * S + 2 * N)
    vecs = {"fdn_solve": 3, "dense_solve": 2, "fdn_tf_mse": 4,
            "fdn_tf_fwd": 3, "fdn_tf_bwd": 4}[kind]
    sums = (N * N + 2 * N + 1 if kind in ("fdn_tf_mse", "fdn_tf_bwd")
            else 0)
    return 4 * (common + common % 2) + warps * (8 * (N * S + vecs * N)
                                                + 4 * sums)


def loop_warps(kind: str, N: int) -> int:
    """A looped kernel's warps a block at N channels (0: one bin's system
    does not fit)."""
    w = 0
    while (w < LOOP_MAX_WARPS
           and loop_smem_bytes(kind, N, w + 1) <= LOOP_SMEM):
        w += 1
    return w


def _loop_max_n(kind: str) -> int:
    N = 1
    while loop_warps(kind, N + 1):
        N += 1
    return N


# the most channels of each looped kernel on the card: 137 (K2), 169 (K6),
# 119 (K1), 137 (K3f), 119 (K3b)
LOOP_MAX_N = {kind: _loop_max_n(kind) for kind in LOOP_KINDS}


def check_loop_n(kind: str, N: int) -> None:
    """Raise unless the looped kernel ``kind`` takes N channels on the card,
    naming its limit (before any library is loaded)."""
    if not 1 <= N <= LOOP_MAX_N[kind]:
        raise ValueError(
            f"N = {N} channels; the looped kernel {LOOP_LABELS[kind]} "
            f"({kind}) takes 1..{LOOP_MAX_N[kind]} on the card, where one "
            f"bin's system must fit a block's {LOOP_SMEM} bytes (227 KB) of "
            "shared memory")


# The register-resident K2, K3f, K3b and K5 of fdn_reg.cu take
# REG_MIN_N..REG_MAX_N channels: one warp a bin up to 32 (a lane a row), a
# group of ceil(N / 16) warps a bin above (two threads a row).  A block of
# ``bins`` bins holds U (N rows of stride N | 1) once and each bin's pivot
# buffers and vectors (reg_bin_float2s); K3f adds b and c, K3b also its
# sums and tile (reg_tf_smem_bytes), K5 its b, c, taps, sums and tile
# (sos_kernels.reg_tf_mse_smem_bytes).  A block holds at most
# REG_MAX_BINS bins of a kind (at N <= 32, above), fewer where shared
# memory runs out; 0 bins: the kernel does not take the size.
REG_MIN_N, REG_MAX_N = 17, 64
REG_MAX_BINS = {"fdn_solve": (4, 1), "fdn_sos_tf_mse": (8, 4),
                "fdn_tf_fwd": (4, 1), "fdn_tf_bwd": (8, 4)}


def reg_group_warps(N: int) -> int:
    """The warps of one bin's group in fdn_reg.cu."""
    return 1 if N <= 32 else -(-N // 16)


def _al4(n: int) -> int:
    return (n + 3) & ~3


def reg_bin_float2s(N: int) -> int:
    """A bin's shared memory in complex slots: its pivot buffers (2 x G
    rows of 34 slots, or 70 at two threads a row: each half's 32 places,
    padded by 2 at two threads, and the rhs and cp), arg-max words (2 G),
    y, w, d (W = 32 or 64 each) and two scalars, made even."""
    G, two = reg_group_warps(N), N > 32
    W, RL = (64, 70) if two else (32, 34)
    n = 2 * G * RL + 2 * G + 3 * W + 2
    return n + (n & 1)


def reg_smem_bytes(N: int, bins: int) -> int:
    """Dynamic shared memory of a register-resident K2 block of ``bins``
    (as fdn_reg.cu's smem_bytes)."""
    return 4 * _al4(N * (N | 1)) + bins * 8 * reg_bin_float2s(N)


def reg_fit_bins(kind: str, N: int, smem) -> int:
    """The most bins a block of ``kind`` holds at N channels, where
    ``smem(bins)`` gives its shared memory: at most REG_MAX_BINS, 0 outside
    REG_MIN_N..REG_MAX_N or where one bin does not fit."""
    if not REG_MIN_N <= N <= REG_MAX_N:
        return 0
    b = 0
    while (b < REG_MAX_BINS[kind][N > 32] and smem(b + 1) <= LOOP_SMEM):
        b += 1
    return b


def reg_bins(N: int) -> int:
    """The register-resident K2's bins a block (0: it does not take N)."""
    return reg_fit_bins("fdn_solve", N, lambda b: reg_smem_bytes(N, b))


def reg_tf_smem_bytes(kind: str, N: int, bins: int) -> int:
    """Dynamic shared memory of a register-resident K3f ("fdn_tf_fwd") or
    K3b ("fdn_tf_bwd") block of ``bins`` (as fdn_reg.cu's smem_bytes):
    U (N rows of stride N | 1), b and c once; K3b also the block's sums
    (N^2 + 2N + 1 floats) and each bin's tile slot of 8 N + 3 floats,
    every region on 16 bytes; and each bin's region."""
    floats = _al4(N * (N | 1)) + _al4(2 * N)
    if kind == "fdn_tf_bwd":
        floats += _al4(N * N + 2 * N + 1) + bins * _al4(8 * N + 3)
    return 4 * floats + bins * 8 * reg_bin_float2s(N)


def reg_tf_bins(kind: str, N: int) -> int:
    """The register-resident K3f's or K3b's bins a block (0: it does not
    take N)."""
    return reg_fit_bins(kind, N, lambda b: reg_tf_smem_bytes(kind, N, b))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    K2_TRANSPOSED[0] = 0


# ---------------------------------------------------------------------------
# plain versions (JAX-convention outputs): the eliminations of ops/solve.py
# on the assembled (M, N, N) loop matrices, and the cotangent arithmetic
# ---------------------------------------------------------------------------
def _loop_matrix(D, U, transpose: bool = False):
    """``I - diag(D_m) U`` for every bin, (M, N, N) complex, or its
    transpose."""
    A = (torch.eye(D.shape[1], dtype=D.dtype, device=D.device)
         - D[:, :, None] * U.to(D.dtype))
    return A.transpose(1, 2) if transpose else A


def _cotangents(D, U, b, y, w, tb, with_dbar: bool, gam=None):
    """JAX-convention cotangents (D_bar or None, U_bar, b_bar, c_bar) of
    ``tf = c^T y``, ``y = A^{-1} diag(D) b``, given ``w = A^{-T} c`` and
    the cotangent ``tb`` of tf (see fdn_ge.cuh).  The loop matrix is
    ``A = I - diag(D gam) U``, with ``gam`` 1 when None (the attenuation
    of the attenuated FDN enters the loop only)."""
    bb = tb[:, None] * w  # cotangent of the right-hand side diag(D) b
    D_loop = D if gam is None else D * gam
    D_bar = None
    if with_dbar:
        Uy = torch.einsum("ij,mj->mi", U.to(y.dtype), y)
        D_bar = bb * ((Uy if gam is None else Uy * gam) + b)
    U_bar = torch.real(torch.einsum("mi,mi,mj->ij", bb, D_loop, y))
    b_bar = torch.sum(torch.real(bb * D), dim=0)
    c_bar = torch.sum(torch.real(tb[:, None] * y), dim=0)
    return D_bar, U_bar, b_bar, c_bar


def fdn_solve_plain(D, U, B, transpose: bool = False):
    """K2's function: (I - diag(D) U) y = B, or the transposed system."""
    return _gauss_solve_raw(_loop_matrix(D, U, transpose), B)


def dense_solve_plain(A, B, transpose: bool = False):
    """K6's function: A y = B per row, or A^T y = B; A (M, N, N), B (M, N)."""
    return _gauss_solve_raw(A.transpose(-1, -2) if transpose else A, B)


def fdn_tf_fwd_plain(D, U, b, c):
    """K3f's function: (tf (M,), y (M, N))."""
    y = _gauss_solve_raw(_loop_matrix(D, U), D * b)
    return y @ c.to(y.dtype), y


def fdn_tf_bwd_plain(D, U, b, c, y, tf_bar):
    """K3b's function: (D_bar, U_bar, b_bar, c_bar) for JAX's tf_bar."""
    w = _gauss_solve_raw(_loop_matrix(D, U, True), c.to(D.dtype).expand_as(D))
    return _cotangents(D, U, b, y, w, tf_bar, with_dbar=True)


def fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar: bool = True,
                     pivot: bool = True):
    """K1's function: (loss, D_bar or None, U_bar, b_bar, c_bar).
    ``pivot=False`` eliminates without pivoting and solves the adjoint
    system from the same L/U factors."""
    loss, y, w, tb = _tf_mse_solves(D, U, b, c, X, t, pivot)
    return (loss, *_cotangents(D, U, b, y, w, tb, with_dbar))


def _tf_mse_solves(D, U, b, c, X, t, pivot: bool, D_loop=None):
    """(loss, y, w, tb) of ``L = (1/M) sum (|tf X| - t)^2``:
    ``y = A^{-1} diag(D) b`` and ``w = A^{-T} c`` for the loop matrix
    ``A = I - diag(D_loop) U`` (``D_loop`` defaults to D), and JAX's
    cotangent ``tb`` of tf."""
    M = D.shape[0]
    A = _loop_matrix(D if D_loop is None else D_loop, U)
    cc = c.to(D.dtype).expand_as(D)
    if pivot:
        y = _gauss_solve_raw(A, D * b)
        w = _gauss_solve_raw(A.transpose(1, 2), cc)
    else:
        Y, arows, factors = _ge_nopivot_factor(A, (D * b)[..., None])
        y = Y[..., 0]
        w = _lu_transpose_solve(arows, factors, cc[..., None])[..., 0]
    z = (y @ c.to(y.dtype)) * X
    a = torch.abs(z)
    diff = a - t
    loss = torch.sum(diff * diff) / M
    g = (2.0 / M) * diff / torch.where(a > 0.0, a, 1.0)
    tb = g * torch.conj(z) * X  # JAX's cotangent of tf
    return loss, y, w, tb


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors -> the kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------
def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"tensors on different devices: {x.device} "
                             f"and {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(D, U, vecs=(), cplx_rows=(), real_rows=(), cplx_mats=()):
    if D.ndim != 2 or D.dtype != torch.complex64:
        raise TypeError(f"D must be (M, N) complex64, got {tuple(D.shape)} "
                        f"{D.dtype}")
    M, N = D.shape
    if N == 0:
        raise ValueError("no channels (N = 0)")
    if M == 0:
        raise ValueError("no bins (M = 0)")
    for name, x, shape, dtype in (
            [("U", U, (N, N), torch.float32)]
            + [(n, x, (N,), torch.float32) for n, x in vecs]
            + [(n, x, (M,), torch.complex64) for n, x in cplx_rows]
            + [(n, x, (M,), torch.float32) for n, x in real_rows]
            + [(n, x, (M, N), torch.complex64) for n, x in cplx_mats]):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise TypeError(f"{name} must be {shape} {dtype}, got "
                            f"{tuple(x.shape)} {x.dtype}")
    return M, N


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _partials(M: int, N: int, like):
    n_blocks = -(-M // cuda_build.threads_per_block(N))
    return torch.empty((n_blocks, N * N + 2 * N + 1), dtype=torch.float32,
                       device=like.device)


def _sum_partials(partials, N: int):
    s = torch.sum(partials, dim=0)
    return (s[:N * N].reshape(N, N), s[N * N:N * N + N],
            s[N * N + N:N * N + 2 * N], s[-1])


def _aligned16(x):
    """``x`` contiguous and starting on 16 bytes (a copy where it does not):
    K2 and K3 move a bin's row as float4s where N is even."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _loop_check(rc: int, what: str) -> None:
    cuda_build.check(rc, what, 1, LOOP_LIB)


def loop_grid(blocks: int, what: str) -> int:
    """A looped kernel's grid as its library's ``*_grid`` returned it (its
    blocks, one partials row each), raising on an error: -1000 - a CUDA
    error while sizing it, or a refused size."""
    if blocks < -1000:  # a CUDA error while sizing the grid
        _loop_check(-1000 - blocks, what)
    _loop_check(min(blocks, 0), what)
    return blocks


def _loop_solve(entry: str, key: str, D, U, B, transpose: bool):
    """Launch the looped library's K2 ``entry`` and count it under ``key``
    (``_transposed`` appended for the transposed system)."""
    M, N = D.shape
    lib = cuda_build.load(1, LOOP_LIB)
    D, U, B = (x.contiguous() for x in (D, U, B))
    Y = torch.empty_like(B)
    with torch.cuda.device(D.device):
        rc = getattr(lib, entry)(N, int(transpose), D.data_ptr(),
                                 U.data_ptr(), B.data_ptr(), Y.data_ptr(), M,
                                 _stream(D))
    _loop_check(rc, entry)
    LAUNCHES[key + ("_transposed" if transpose else "")] += 1
    return Y


def fdn_solve_loop_kernel(D, U, B, transpose: bool = False):
    """K2 looped (any N up to ``LOOP_MAX_N['fdn_solve']``): y (M, N)
    complex64.  On the card fdn_reg.cu's register-resident kernel where it
    takes N (REG_MIN_N..REG_MAX_N), else fdn_loop.cu's shared-memory one
    (:func:`fdn_solve_loop_smem_kernel`)."""
    M, N = _check(D, U, cplx_mats=[("B", B)])
    if not _on_cuda(D, U, B):
        return fdn_solve_plain(D, U, B, transpose)
    if not reg_bins(N):
        return fdn_solve_loop_smem_kernel(D, U, B, transpose)
    return _loop_solve("fl_reg_solve_launch", "fdn_solve_loop", D, U, B,
                       transpose)


def fdn_solve_loop_smem_kernel(D, U, B, transpose: bool = False):
    """K2 on fdn_loop.cu's shared-memory core (one warp a bin, any N up to
    ``LOOP_MAX_N['fdn_solve']``): y (M, N) complex64."""
    M, N = _check(D, U, cplx_mats=[("B", B)])
    if not _on_cuda(D, U, B):
        return fdn_solve_plain(D, U, B, transpose)
    check_loop_n("fdn_solve", N)
    return _loop_solve("fl_solve_launch", "fdn_solve_loop_smem", D, U, B,
                       transpose)


def dense_solve_loop_kernel(A, B, transpose: bool = False):
    """K6 looped (fdn_loop.cu, one warp a row, any N up to
    ``LOOP_MAX_N['dense_solve']``): y (M, N) complex64 for A (M, N, N),
    B (M, N)."""
    M, N = _check_dense(A, B)
    if not _on_cuda(A, B):
        return dense_solve_plain(A, B, transpose)
    check_loop_n("dense_solve", N)
    lib = cuda_build.load(1, LOOP_LIB)
    A, B = A.contiguous(), B.contiguous()
    Y = torch.empty_like(B)
    with torch.cuda.device(A.device):
        rc = lib.fl_dense_solve_launch(N, int(transpose), A.data_ptr(),
                                       B.data_ptr(), Y.data_ptr(), M,
                                       _stream(A))
    _loop_check(rc, "dense_solve_loop_kernel")
    LAUNCHES["dense_solve_loop_transposed" if transpose
             else "dense_solve_loop"] += 1
    return Y


def fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar: bool = True,
                           pivot: bool = True):
    """K1 looped (fdn_loop.cu, one warp a bin, any N up to
    ``LOOP_MAX_N['fdn_tf_mse']``): (loss, D_bar or None, U_bar, b_bar,
    c_bar).  Each block writes one row of partials, summed here."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)], cplx_rows=[("X", X)],
                  real_rows=[("t", t)])
    if not _on_cuda(D, U, b, c, X, t):
        return fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
    check_loop_n("fdn_tf_mse", N)
    lib = cuda_build.load(1, LOOP_LIB)
    D, U, b, c, X, t = (x.contiguous() for x in (D, U, b, c, X, t))
    D_bar = torch.empty_like(D) if with_dbar else None
    with torch.cuda.device(D.device):
        blocks = loop_grid(lib.fl_tf_mse_grid(int(pivot), int(with_dbar), N,
                                              M), "fdn_tf_mse_loop_kernel")
        partials = torch.empty((blocks, N * N + 2 * N + 1),
                               dtype=torch.float32, device=D.device)
        rc = lib.fl_tf_mse_launch(
            N, int(pivot), int(with_dbar), D.data_ptr(), U.data_ptr(),
            b.data_ptr(), c.data_ptr(), X.data_ptr(), t.data_ptr(),
            D_bar.data_ptr() if with_dbar else None, partials.data_ptr(),
            2.0 / M, M, blocks, _stream(D))
    _loop_check(rc, "fdn_tf_mse_loop_kernel")
    LAUNCHES["fdn_tf_mse_loop"] += 1
    U_bar, b_bar, c_bar, sq = _sum_partials(partials, N)
    return sq / M, D_bar, U_bar, b_bar, c_bar


def fdn_tf_fwd_loop_kernel(D, U, b, c):
    """K3f looped (any N up to ``LOOP_MAX_N['fdn_tf_fwd']``): (tf (M,),
    y (M, N)).  On the card fdn_reg.cu's register-resident kernel where it
    takes N (:func:`reg_tf_bins`), else fdn_loop.cu's shared-memory one
    (:func:`fdn_tf_fwd_loop_smem_kernel`)."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)])
    if not _on_cuda(D, U, b, c):
        return fdn_tf_fwd_plain(D, U, b, c)
    if not reg_tf_bins("fdn_tf_fwd", N):
        return fdn_tf_fwd_loop_smem_kernel(D, U, b, c)
    return _loop_tf_fwd("fl_reg_tf_fwd_launch", "fdn_tf_fwd_loop", D, U, b, c)


def fdn_tf_fwd_loop_smem_kernel(D, U, b, c):
    """K3f on fdn_loop.cu's shared-memory core (one warp a bin, any N up to
    ``LOOP_MAX_N['fdn_tf_fwd']``): (tf (M,), y (M, N))."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)])
    if not _on_cuda(D, U, b, c):
        return fdn_tf_fwd_plain(D, U, b, c)
    check_loop_n("fdn_tf_fwd", N)
    return _loop_tf_fwd("fl_tf_fwd_launch", "fdn_tf_fwd_loop_smem", D, U, b,
                        c)


def _loop_tf_fwd(entry: str, key: str, D, U, b, c):
    """Launch the looped library's K3f ``entry`` and count it under
    ``key``."""
    M, N = D.shape
    lib = cuda_build.load(1, LOOP_LIB)
    D, U, b, c = (x.contiguous() for x in (D, U, b, c))
    tf = torch.empty((M,), dtype=D.dtype, device=D.device)
    Y = torch.empty_like(D)
    with torch.cuda.device(D.device):
        rc = getattr(lib, entry)(N, D.data_ptr(), U.data_ptr(), b.data_ptr(),
                                 c.data_ptr(), tf.data_ptr(), Y.data_ptr(), M,
                                 _stream(D))
    _loop_check(rc, entry)
    LAUNCHES[key] += 1
    return tf, Y


def fdn_tf_bwd_loop_kernel(D, U, b, c, y, tf_bar):
    """K3b looped (any N up to ``LOOP_MAX_N['fdn_tf_bwd']``): (D_bar,
    U_bar, b_bar, c_bar) for JAX's tf_bar.  On the card fdn_reg.cu's
    register-resident kernel where it takes N (:func:`reg_tf_bins`), else
    fdn_loop.cu's shared-memory one (:func:`fdn_tf_bwd_loop_smem_kernel`).
    Each block writes one row of partials, summed here."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)],
                  cplx_rows=[("tf_bar", tf_bar)], cplx_mats=[("y", y)])
    if not _on_cuda(D, U, b, c, y, tf_bar):
        return fdn_tf_bwd_plain(D, U, b, c, y, tf_bar)
    if not reg_tf_bins("fdn_tf_bwd", N):
        return fdn_tf_bwd_loop_smem_kernel(D, U, b, c, y, tf_bar)
    return _loop_tf_bwd("fl_reg_tf_bwd", "fdn_tf_bwd_loop", D, U, b, c, y,
                        tf_bar)


def fdn_tf_bwd_loop_smem_kernel(D, U, b, c, y, tf_bar):
    """K3b on fdn_loop.cu's shared-memory core (one warp a bin, any N up to
    ``LOOP_MAX_N['fdn_tf_bwd']``), as :func:`fdn_tf_bwd_loop_kernel`."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)],
                  cplx_rows=[("tf_bar", tf_bar)], cplx_mats=[("y", y)])
    if not _on_cuda(D, U, b, c, y, tf_bar):
        return fdn_tf_bwd_plain(D, U, b, c, y, tf_bar)
    check_loop_n("fdn_tf_bwd", N)
    return _loop_tf_bwd("fl_tf_bwd", "fdn_tf_bwd_loop_smem", D, U, b, c, y,
                        tf_bar)


def _loop_tf_bwd(prefix: str, key: str, D, U, b, c, y, tf_bar):
    """Launch the looped library's K3b through its C entry points
    ``<prefix>_grid`` and ``<prefix>_launch``, count it under ``key`` and
    sum its partials."""
    M, N = D.shape
    lib = cuda_build.load(1, LOOP_LIB)
    D, U, b, c, y, tf_bar = (x.contiguous()
                             for x in (D, U, b, c, y, tf_bar))
    D_bar = torch.empty_like(D)
    what = f"{prefix}_launch"
    with torch.cuda.device(D.device):
        blocks = loop_grid(getattr(lib, f"{prefix}_grid")(N, M), what)
        partials = torch.empty((blocks, N * N + 2 * N + 1),
                               dtype=torch.float32, device=D.device)
        rc = getattr(lib, what)(N, D.data_ptr(), U.data_ptr(), b.data_ptr(),
                                c.data_ptr(), y.data_ptr(), tf_bar.data_ptr(),
                                D_bar.data_ptr(), partials.data_ptr(), M,
                                blocks, _stream(D))
    _loop_check(rc, what)
    LAUNCHES[key] += 1
    U_bar, b_bar, c_bar, _ = _sum_partials(partials, N)
    return D_bar, U_bar, b_bar, c_bar


def fdn_solve_kernel(D, U, B, transpose: bool = False):
    """K2 wrapper: y (M, N) complex64; on the card the looped kernel above
    MAX_N channels."""
    M, N = _check(D, U, cplx_mats=[("B", B)])
    if not _on_cuda(D, U, B):
        return fdn_solve_plain(D, U, B, transpose)
    if N > MAX_N:
        return fdn_solve_loop_kernel(D, U, B, transpose)
    lib = cuda_build.load(N)
    D, U, B = _aligned16(D), U.contiguous(), _aligned16(B)
    Y = torch.empty_like(B)
    with torch.cuda.device(D.device):
        rc = lib.fdn_solve_launch(N, int(transpose), D.data_ptr(),
                                  U.data_ptr(), B.data_ptr(), Y.data_ptr(),
                                  M, _stream(D))
    cuda_build.check(rc, "fdn_solve_kernel", N)
    LAUNCHES["fdn_solve"] += 1
    K2_TRANSPOSED[0] += bool(transpose)
    return Y


def _check_dense(A, B):
    if (A.ndim != 3 or B.ndim != 2 or A.dtype != torch.complex64
            or B.dtype != torch.complex64 or A.shape[1] != A.shape[2]
            or tuple(A.shape[:2]) != tuple(B.shape)):
        raise TypeError(f"A must be (M, N, N) and B (M, N), both complex64, "
                        f"got {tuple(A.shape)} {A.dtype} and "
                        f"{tuple(B.shape)} {B.dtype}")
    M, N = B.shape
    if N == 0:
        raise ValueError("no channels (N = 0)")
    if M == 0:
        raise ValueError("no rows (M = 0)")
    return M, N


def dense_solve_kernel(A, B, transpose: bool = False):
    """K6 wrapper: y (M, N) complex64 for A (M, N, N), B (M, N); on the
    card the looped kernel above MAX_N channels."""
    M, N = _check_dense(A, B)
    if not _on_cuda(A, B):
        return dense_solve_plain(A, B, transpose)
    if N > MAX_N:
        return dense_solve_loop_kernel(A, B, transpose)
    lib = cuda_build.load(N)
    A, B = A.contiguous(), B.contiguous()
    Y = torch.empty_like(B)
    with torch.cuda.device(A.device):
        rc = lib.fdn_dense_solve_launch(N, int(transpose), A.data_ptr(),
                                        B.data_ptr(), Y.data_ptr(), M,
                                        _stream(A))
    cuda_build.check(rc, "dense_solve_kernel", N)
    LAUNCHES["dense_solve_transposed" if transpose else "dense_solve"] += 1
    return Y


def fdn_tf_fwd_kernel(D, U, b, c):
    """K3f wrapper: (tf (M,), y (M, N)); on the card the looped kernel above
    MAX_N channels."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)])
    if not _on_cuda(D, U, b, c):
        return fdn_tf_fwd_plain(D, U, b, c)
    if N > MAX_N:
        return fdn_tf_fwd_loop_kernel(D, U, b, c)
    lib = cuda_build.load(N)
    D, U, b, c = _aligned16(D), U.contiguous(), b.contiguous(), c.contiguous()
    tf = torch.empty((M,), dtype=D.dtype, device=D.device)
    Y = torch.empty_like(D)
    with torch.cuda.device(D.device):
        rc = lib.fdn_tf_fwd_launch(N, D.data_ptr(), U.data_ptr(),
                                   b.data_ptr(), c.data_ptr(), tf.data_ptr(),
                                   Y.data_ptr(), M, _stream(D))
    cuda_build.check(rc, "fdn_tf_fwd_kernel", N)
    LAUNCHES["fdn_tf_fwd"] += 1
    return tf, Y


def fdn_tf_bwd_kernel(D, U, b, c, y, tf_bar):
    """K3b wrapper: (D_bar, U_bar, b_bar, c_bar) for JAX's tf_bar; on the
    card the looped kernel above MAX_N channels."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)],
                  cplx_rows=[("tf_bar", tf_bar)], cplx_mats=[("y", y)])
    if not _on_cuda(D, U, b, c, y, tf_bar):
        return fdn_tf_bwd_plain(D, U, b, c, y, tf_bar)
    if N > MAX_N:
        return fdn_tf_bwd_loop_kernel(D, U, b, c, y, tf_bar)
    lib = cuda_build.load(N)
    D, y = _aligned16(D), _aligned16(y)
    U, b, c, tf_bar = (x.contiguous() for x in (U, b, c, tf_bar))
    D_bar = torch.empty_like(D)
    partials = _partials(M, N, D)
    with torch.cuda.device(D.device):
        rc = lib.fdn_tf_bwd_launch(N, D.data_ptr(), U.data_ptr(),
                                   b.data_ptr(), c.data_ptr(), y.data_ptr(),
                                   tf_bar.data_ptr(), D_bar.data_ptr(),
                                   partials.data_ptr(), M, _stream(D))
    cuda_build.check(rc, "fdn_tf_bwd_kernel", N)
    LAUNCHES["fdn_tf_bwd"] += 1
    U_bar, b_bar, c_bar, _ = _sum_partials(partials, N)
    return D_bar, U_bar, b_bar, c_bar


def fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar: bool = True,
                      pivot: bool = True):
    """K1 wrapper: (loss, D_bar or None, U_bar, b_bar, c_bar); on the card
    the looped kernel above MAX_N channels."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)], cplx_rows=[("X", X)],
                  real_rows=[("t", t)])
    if not _on_cuda(D, U, b, c, X, t):
        return fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
    if N > MAX_N:
        return fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar, pivot)
    lib = cuda_build.load(N)
    D, U, b, c, X, t = (x.contiguous() for x in (D, U, b, c, X, t))
    D_bar = torch.empty_like(D) if with_dbar else None
    partials = _partials(M, N, D)
    with torch.cuda.device(D.device):
        rc = lib.fdn_tf_mse_launch(
            N, int(pivot), int(with_dbar), D.data_ptr(), U.data_ptr(),
            b.data_ptr(), c.data_ptr(), X.data_ptr(), t.data_ptr(),
            D_bar.data_ptr() if with_dbar else None, partials.data_ptr(),
            2.0 / M, M, _stream(D))
    cuda_build.check(rc, "fdn_tf_mse_kernel", N)
    LAUNCHES["fdn_tf_mse"] += 1
    U_bar, b_bar, c_bar, sq = _sum_partials(partials, N)
    return sq / M, D_bar, U_bar, b_bar, c_bar


# ---------------------------------------------------------------------------
# differentiable public functions
# ---------------------------------------------------------------------------
class _FdnSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, U, B):
        y = fdn_solve_kernel(D, U, B)
        ctx.save_for_backward(D, U, y)
        return y

    @staticmethod
    def backward(ctx, y_bar):
        D, U, y = ctx.saved_tensors
        # JAX's VJP: b_bar = A^{-T} y_bar, D_bar = b_bar (U y),
        # U_bar = Re sum_m (b_bar D)^T y, all in JAX's convention
        b_bar = fdn_solve_kernel(D, U, torch.conj_physical(y_bar), True)
        Uy = torch.einsum("ij,mj->mi", U.to(y.dtype), y)
        D_bar = b_bar * Uy
        U_bar = torch.real(torch.einsum("mi,mi,mj->ij", b_bar, D, y))
        return (torch.conj_physical(D_bar), U_bar.to(U.dtype),
                torch.conj_physical(b_bar))


class _DenseSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        N = A.shape[-1]
        # A broadcast to B's batch, the batch folded into the rows
        A2 = A.expand(B.shape[:-1] + (N, N)).reshape(-1, N, N)
        y = dense_solve_kernel(A2, B.reshape(-1, N)).reshape(B.shape)
        ctx.save_for_backward(A2, y)
        ctx.a_shape = A.shape
        return y

    @staticmethod
    def backward(ctx, y_bar):
        A2, y = ctx.saved_tensors
        N = y.shape[-1]
        # JAX's VJP: b_bar = A^{-T} y_bar, A_bar = -b_bar y^T, summed over
        # the dimensions A was broadcast along
        b_bar = dense_solve_kernel(
            A2, torch.conj_physical(y_bar).reshape(-1, N),
            transpose=True).reshape(y.shape)
        A_bar = None
        if ctx.needs_input_grad[0]:
            A_bar = (-b_bar[..., :, None] * y[..., None, :]).sum_to_size(
                ctx.a_shape)
            A_bar = torch.conj_physical(A_bar)
        return A_bar, torch.conj_physical(b_bar)


class _FdnTf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, U, b, c):
        tf, y = fdn_tf_fwd_kernel(D, U, b, c)
        ctx.save_for_backward(D, U, b, c, y)
        return tf

    @staticmethod
    def backward(ctx, tf_bar):
        D, U, b, c, y = ctx.saved_tensors
        D_bar, U_bar, b_bar, c_bar = fdn_tf_bwd_kernel(
            D, U, b, c, y, torch.conj_physical(tf_bar))
        return torch.conj_physical(D_bar), U_bar, b_bar, c_bar


class _FdnTfMse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, U, b, c, X, t, with_dbar, pivot):
        loss, D_bar, U_bar, b_bar, c_bar = fdn_tf_mse_kernel(
            D, U, b, c, X, t, with_dbar, pivot)
        if D_bar is not None:
            D_bar = torch.conj_physical(D_bar)
        ctx.save_for_backward(D_bar, U_bar, b_bar, c_bar)
        return loss

    @staticmethod
    def backward(ctx, g):
        D_bar, U_bar, b_bar, c_bar = ctx.saved_tensors
        return (None if D_bar is None else g * D_bar, g * U_bar, g * b_bar,
                g * c_bar, None, None, None, None)


def fdn_solve(D, U, B):
    """Fused FDN closed-loop solve ``(I - diag(D_m) U) y_m = B_m`` (K2)."""
    return _FdnSolve.apply(D, U, B)


def dense_solve(A, B):
    """Dense per-bin solve ``A_m y_m = B_m`` (K6; gradient K6 on A^T), the
    counterpart of ``pallas_gauss_solve``.  A (..., M, N, N) complex64,
    broadcast to B's batch; B (..., M, N) complex64; leading batch
    dimensions fold into the kernel's rows."""
    return _DenseSolve.apply(A, B)


def fdn_tf(D, U, b, c):
    """FDN SISO transfer function on the rfft grid (K3f; gradient K3b):
    ``tf_m = c^T (I - diag(D_m) U)^{-1} diag(D_m) b``, shape (M,)."""
    return _FdnTf.apply(D, U, b, c)


def fdn_tf_mse(D, U, b, c, X, t, with_dbar: bool = True,
               pivot: bool = True):
    """Fused training-step kernel (K1): the scalar
    ``L = (1/M) sum_m (|tf_m X_m| - t_m)^2`` whose gradients in D, U, b
    and c come from the same kernel pass.  X and t get no gradient.
    ``with_dbar=False`` skips the (M, N) D cotangent, and D gets none
    (frozen delays).  ``pivot=False`` drops the pivoting and reuses the
    forward L/U factors for the adjoint system: valid while the leading
    pivots stay away from zero (stable FDN loops)."""
    return _FdnTfMse.apply(D, U, b, c, X, t, with_dbar, pivot)
