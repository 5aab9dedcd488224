"""The fused active-acoustics step kernels K8 and K9 (counterpart of
``pallas_aa_tf_mse`` and ``pallas_aa_taps_tf_mse`` in
``flamo_tpu/ops/pallas_solve.py``): wrappers around the hand-written CUDA
kernels of ``flamo_tpu_torch/csrc/aa_kernels.cu`` (up to 8 microphones)
and ``aa_loop.cu`` (above), their plain PyTorch versions, and the
``autograd.Function``s of the public functions.

For a frozen room H_m (N microphones x L loudspeakers), a mixer response
G_m (L x N) and a frozen rhs r_m = H_m X_m, per rfft bin m:

    A_m = I_N - H_m G_m,   y_m = A_m^{-1} r_m,
    loss = (1/(M N)) sum_{m,i} (|y_mi| - t_mi)^2.

The operands keep the JAX package's channels-major rows (bins last, all
float32): ``hr``/``hi`` (N L, M), row i L + j = H[i, j]; ``gr``/``gi``
(L N, M), row j N + k = G[j, k]; ``rr``/``ri`` and the targets ``t``
(N, M).

* :func:`aa_tf_mse` (K8): the loss, differentiable in the response rows
  gr/gi; the kernel writes the S rows ``S_jk = (H^T xi)_j y_k`` of the
  adjoint ``A^T xi = w`` in the same pass, and the gradient is
  ``(g Re S, -g Im S)``.
* :func:`aa_taps_tf_mse` (K9): the same loss from the envelope-folded
  mixer taps ``tw`` (order, L N), ``G = tw^T P`` with the DFT powers
  ``P_t(m) = e^{-j 2 pi t (m + bin_offset) / nfft}`` made inside the
  kernel; the gradient is the tap cotangent
  ``tb[t, jk] = sum_m Re S_jk Re P_t - Im S_jk Im P_t``.  ``precision``
  sets the arithmetic of those two contractions: 'highest' is FP32 on
  CUDA cores (``aa_taps_tf_mse_kernel``); 'high' (the default) is three
  TF32 tensor-core products of split operands, ``a_hi b_hi + a_hi b_lo +
  a_lo b_hi`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, the scheme
  of JAX's 'high' with TF32 in place of bf16; 'default' is ``a_hi b_hi``
  alone (both ``aa_taps_tf_mse_tc_kernel``).

Each ``*_kernel`` wrapper launches its CUDA kernel for CUDA tensors (and
counts the launch in :data:`LAUNCHES`) and runs the plain version for CPU
tensors, at any microphone count; it never falls back from one to the
other.  On the card the unrolled kernels take 1..8 microphones (one
library per count) and the looped ones of ``aa_loop.cu`` (one warp a
bin, ``*_loop_kernel``) more, as many as one bin's system and the K9
frame fit a block's shared memory (:func:`check_aa_loop` names the limit
at the given loudspeakers and taps: 155 microphones for K8, 49 for K9
at 'high' and 'default' and 50 at 'highest', at the rig's 13
loudspeakers and 100 taps); any number of loudspeakers
and taps whose K9 working set fits; the wrappers raise outside those
limits, before any library loads.  ``pivot=False`` (the default,
as in the JAX package) eliminates without pivoting and solves the adjoint
from the same L/U factors: valid while the loop is well away from
instability, as at the rig's small initial mixer.
"""

from __future__ import annotations

import math

import torch

from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops.fdn_kernels import _on_cuda, _stream
from flamo_tpu_torch.ops.solve import (_gauss_solve_raw, _ge_nopivot_factor,
                                       _lu_transpose_solve)

LIB = "aa_kernels"
MAX_N = cuda_build.LIB_MAX_N[LIB]
LOOP_LIB = "aa_loop"
PRECISIONS = ("default", "high", "highest")
# K9's TF32 passes at each precision (0: the FP32 kernel)
PASSES = {"high": 3, "default": 1, "highest": 0}
# K9's dynamic shared memory limit, the most a block may take with two
# blocks an SM, and the row stride of both kernels' tiles of 64 bins (as
# in aa_kernels.cu)
_MAX_SMEM, _TWO_BLOCKS = 232448, 115712
_TAP_STRIDE = 2 * 64 + 4

# launches of each CUDA kernel since the last reset (plain CPU runs do not
# count); K9 counts its FP32 kernel ('highest') and its tensor-core kernel
# at each TF32 precision apart, and the looped kernels (more than MAX_N
# microphones) count under the same names with "_loop"
_KEYS = ("aa_tf_mse", "aa_taps_tf_mse", "aa_taps_tf_mse_tc_high",
         "aa_taps_tf_mse_tc_default")
LAUNCHES = {k + suffix: 0 for suffix in ("", "_loop") for k in _KEYS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (JAX-convention outputs)
# ---------------------------------------------------------------------------
def aa_tf_mse_plain(hr, hi, gr, gi, rr, ri, t, N: int, L: int,
                    pivot: bool = False):
    """K8's function: ``(loss, Sr, Si)``, the S rows (L N, M)."""
    M = hr.shape[-1]
    H = torch.complex(hr, hi).reshape(N, L, M).permute(2, 0, 1)  # (M, N, L)
    G = torch.complex(gr, gi).reshape(L, N, M).permute(2, 0, 1)  # (M, L, N)
    A = torch.eye(N, dtype=H.dtype, device=H.device) - H @ G
    r = torch.complex(rr, ri).T  # (M, N)
    if pivot:
        y = _gauss_solve_raw(A, r)
    else:
        Y, arows, factors = _ge_nopivot_factor(A, r[..., None])
        y = Y[..., 0]
    est = torch.abs(y)
    diff = est - t.T
    loss = torch.sum(diff * diff) / (M * N)
    g = (2.0 / (M * N)) * diff / torch.where(est > 0.0, est,
                                             torch.ones_like(est))
    w = g * torch.conj(y)
    if pivot:
        xi = _gauss_solve_raw(A.transpose(1, 2), w)
    else:
        xi = _lu_transpose_solve(arows, factors, w[..., None])[..., 0]
    a = torch.einsum("mil,mi->ml", H, xi)  # (H^T xi)_l
    S = (a[:, :, None] * y[:, None, :]).permute(1, 2, 0).reshape(L * N, M)
    return loss, torch.real(S), torch.imag(S)


def dft_powers(order: int, M: int, nfft: int, bin_offset: int = 0,
               device=None):
    """``(Pr, Pi)`` (order, M) float32: ``P_t(m) = e^{-j 2 pi idx / nfft}``
    with ``idx = t (m + bin_offset) mod nfft`` exact in integers, the
    powers K9 makes per bin."""
    t = torch.arange(order, dtype=torch.int64, device=device)[:, None]
    m = (torch.arange(M, dtype=torch.int64, device=device)[None, :]
         + int(bin_offset))
    idx = (t % nfft) * (m % nfft) % nfft
    w = (2.0 * math.pi / nfft) * idx.to(torch.float32)
    return torch.cos(w), -torch.sin(w)


def tf32_round(x):
    """``x`` (float32) rounded to TF32, 10 mantissa bits, to nearest with
    ties away from zero, as PTX ``cvt.rna.tf32.f32``: on the int32 bits,
    ``(bits + 0x1000) & 0xFFFFE000`` (for finite values; the carry rounds
    into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, precision: str):
    """``a @ b`` as K9's tensor-core kernel computes it: 'high' is
    ``a_hi b_hi + a_hi b_lo + a_lo b_hi``, 'default' ``a_hi b_hi``, with
    ``hi = tf32(x)`` and ``lo = tf32(x - hi)``; each product of TF32
    values is exact in float32, so float32 matmuls repeat it."""
    ah, bh = tf32_round(a), tf32_round(b)
    if precision == "default":
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def aa_taps_tf_mse_plain(hr, hi, tw, rr, ri, t, N: int, L: int, nfft: int,
                         pivot: bool = False, bin_offset: int = 0,
                         precision: str = "high"):
    """K9's function: ``(loss, tb)``, the tap cotangent (order, L N), with
    the two contractions in ``precision``'s arithmetic."""
    if precision not in PRECISIONS:
        raise ValueError("precision must be 'default', 'high' or 'highest'")
    M = hr.shape[-1]
    Pr, Pi = dft_powers(tw.shape[0], M, nfft, bin_offset, hr.device)
    if precision == "highest":
        loss, Sr, Si = aa_tf_mse_plain(hr, hi, tw.T @ Pr, tw.T @ Pi, rr, ri,
                                       t, N, L, pivot)
        return loss, Pr @ Sr.T - Pi @ Si.T
    P2 = torch.cat([Pr, Pi], dim=1)  # (order, 2 M)
    G2 = _tf32_matmul(tw.T, P2, precision)
    loss, Sr, Si = aa_tf_mse_plain(hr, hi, G2[:, :M], G2[:, M:], rr, ri, t,
                                   N, L, pivot)
    return loss, _tf32_matmul(P2, torch.cat([Sr, -Si], dim=1).T, precision)


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors -> the kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------
def _check_rows(N: int, L: int, rows: dict):
    if N < 1:
        raise ValueError(f"N = {N} microphone channels")
    if L < 1:
        raise ValueError(f"L = {L} loudspeakers")
    M = rows["t"].shape[-1]
    if M == 0:
        raise ValueError("no bins (M = 0)")
    for name, x in rows.items():
        want = {"hr": N * L, "hi": N * L, "gr": L * N, "gi": L * N}.get(
            name, N)
        if name == "tw":
            if x.ndim != 2 or x.shape[1] != L * N or x.shape[0] < 1:
                raise TypeError(f"tw must be (order, L N) = (order, {L * N}),"
                                f" got {tuple(x.shape)}")
        elif tuple(x.shape) != (want, M):
            raise TypeError(f"{name} must be ({want}, {M}), got "
                            f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    return M


def aa_tf_mse_kernel(hr, hi, gr, gi, rr, ri, t, N: int, L: int,
                     pivot: bool = False):
    """K8 wrapper: ``(loss, Sr, Si)``; on the card the looped kernel above
    MAX_N microphones."""
    M = _check_rows(N, L, dict(hr=hr, hi=hi, gr=gr, gi=gi, rr=rr, ri=ri, t=t))
    if not _on_cuda(hr, hi, gr, gi, rr, ri, t):
        return aa_tf_mse_plain(hr, hi, gr, gi, rr, ri, t, N, L, pivot)
    if N > MAX_N:
        return aa_tf_mse_loop_kernel(hr, hi, gr, gi, rr, ri, t, N, L, pivot)
    lib = cuda_build.load(N, LIB)
    hr, hi, gr, gi, rr, ri, t = (x.contiguous()
                                 for x in (hr, hi, gr, gi, rr, ri, t))
    loss_row = torch.empty((M,), dtype=torch.float32, device=hr.device)
    Sr, Si = torch.empty_like(gr), torch.empty_like(gi)
    with torch.cuda.device(hr.device):
        rc = lib.aa_tf_mse_launch(
            N, int(pivot), hr.data_ptr(), hi.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), rr.data_ptr(), ri.data_ptr(), t.data_ptr(),
            loss_row.data_ptr(), Sr.data_ptr(), Si.data_ptr(),
            2.0 / (M * N), L, M, _stream(hr))
    cuda_build.check(rc, "aa_tf_mse_kernel", N, LIB)
    LAUNCHES["aa_tf_mse"] += 1
    return torch.sum(loss_row) / (M * N), Sr, Si


def _f32_smem_bytes(order: int, LN: int, stage_tw: bool) -> int:
    return 4 * (_TAP_STRIDE * (order + LN)
                + (order * -(-LN // 4) * 4 if stage_tw else 0))


def taps_smem_bytes(order: int, LN: int) -> int:
    """The FP32 K9's dynamic shared memory per block (as in
    aa_kernels.cu): a tile's powers (order rows) and G/S rows (L N rows)
    of 2 x 64 bins + 4 floats, and the taps tw (order x L N, rows padded
    to 4) when staging them leaves an SM as many blocks as without."""
    with_tw = _f32_smem_bytes(order, LN, True)
    without = _f32_smem_bytes(order, LN, False)
    stage = with_tw <= _MAX_SMEM and (with_tw <= _TWO_BLOCKS
                                      or without > _TWO_BLOCKS)
    return with_tw if stage else without


def taps_tc_smem_bytes(order: int, LN: int) -> int:
    """The tensor-core K9's dynamic shared memory per block (as in
    aa_kernels.cu): a tile's powers (order padded to 16) and its G/S rows
    (L N padded to 8), rows of 2 x 64 bins + 4."""
    return 4 * _TAP_STRIDE * (-(-order // 16) * 16 + -(-LN // 8) * 8)


def _check_taps_args(precision: str, bin_offset, nfft: int):
    if precision not in PRECISIONS:
        raise ValueError("precision must be 'default', 'high' or 'highest'")
    off = 0 if bin_offset is None else bin_offset
    if float(off) != int(off):
        raise ValueError(f"bin_offset must be a whole number of bins, got "
                         f"{bin_offset!r}")
    if not 1 <= nfft <= 2 ** 30:
        raise ValueError(f"nfft = {nfft}; kernel K9 takes 1..2^30")
    return int(off)


def aa_taps_tf_mse_kernel(hr, hi, tw, rr, ri, t, N: int, L: int, nfft: int,
                          pivot: bool = False, precision: str = "high",
                          bin_offset=None):
    """K9 wrapper: ``(loss, tb)``.  On the card 'highest' launches the FP32
    kernel and 'high'/'default' the tensor-core kernel with 3 or 1 TF32
    passes (the looped ones above MAX_N microphones); on the CPU the plain
    version of the same precision runs."""
    off = _check_taps_args(precision, bin_offset, nfft)
    M = _check_rows(N, L, dict(hr=hr, hi=hi, tw=tw, rr=rr, ri=ri, t=t))
    if not _on_cuda(hr, hi, tw, rr, ri, t):
        return aa_taps_tf_mse_plain(hr, hi, tw, rr, ri, t, N, L, nfft, pivot,
                                    off, precision)
    if N > MAX_N:
        return aa_taps_tf_mse_loop_kernel(hr, hi, tw, rr, ri, t, N, L, nfft,
                                          pivot, precision, bin_offset)
    order, passes = tw.shape[0], PASSES[precision]
    key = f"aa_taps_tf_mse_tc_{precision}" if passes else "aa_taps_tf_mse"
    name = "aa_taps_tf_mse_tc_kernel" if passes else "aa_taps_tf_mse_kernel"
    need = (taps_tc_smem_bytes if passes else taps_smem_bytes)(order, L * N)
    if need > _MAX_SMEM:
        raise ValueError(f"kernel K9 ({name}, precision={precision!r}) "
                         f"needs {need} bytes of shared memory for order = "
                         f"{order} and L N = {L * N}; a block has "
                         f"{_MAX_SMEM}")
    lib = cuda_build.load(N, LIB)
    hr, hi, tw, rr, ri, t = (x.contiguous() for x in (hr, hi, tw, rr, ri, t))
    with torch.cuda.device(hr.device):
        grid = lib.aa_taps_grid(N, int(pivot), passes, order, L, M)
        cuda_build.check(grid if grid < 0 else 0, f"{name} grid", N, LIB)
        loss_row = torch.empty((M,), dtype=torch.float32, device=hr.device)
        partials = torch.empty((grid, order, L * N), dtype=torch.float32,
                               device=hr.device)
        rc = lib.aa_taps_tf_mse_launch(
            N, int(pivot), passes, hr.data_ptr(), hi.data_ptr(),
            tw.data_ptr(), rr.data_ptr(), ri.data_ptr(), t.data_ptr(),
            loss_row.data_ptr(), partials.data_ptr(), 2.0 / (M * N), L, M,
            order, nfft, off % nfft, 2.0 * math.pi / nfft, grid, _stream(hr))
    cuda_build.check(rc, name, N, LIB)
    LAUNCHES[key] += 1
    return torch.sum(loss_row) / (M * N), torch.sum(partials, dim=0)


# ---------------------------------------------------------------------------
# the looped kernels (aa_loop.cu): more than MAX_N microphones
# ---------------------------------------------------------------------------
# Their shared memory (as aa_loop.cu's): float2s of one bin's system
# (N x (N | 1)) and vectors (rhs, y, w, xi: N each; a = H^T xi: L); K8
# looped's blocks of W warps hold W bins, each also with its H and G
# (odd(N L) float2s each), r (N) and t (N floats); K9 looped's a tile of
# 64 or 32 bins (the powers and G/S rows, 2 bins + 4 floats a row) and
# its solver warps' bins, each with its H, r and t.
_LOOP_MAX_WARPS = 8


def _bin_float2s(N: int, L: int) -> int:
    return N * (N | 1) + 4 * N + L


def loop_tf_mse_smem_bytes(N: int, L: int, warps: int) -> int:
    """K8 looped's dynamic shared memory for a block of ``warps``."""
    return warps * (8 * (2 * (N * L | 1) + N + _bin_float2s(N, L)) + 4 * N)


def loop_tf_mse_warps(N: int, L: int) -> int:
    """K8 looped's warps a block (0: one bin does not fit)."""
    w = 0
    while (w < _LOOP_MAX_WARPS
           and loop_tf_mse_smem_bytes(N, L, w + 1) <= _MAX_SMEM):
        w += 1
    return w


def loop_taps_smem_bytes(passes: int, order: int, N: int, L: int,
                         bins: int, solvers: int) -> int:
    """K9 looped's dynamic shared memory for a tile of ``bins`` and
    ``solvers`` solver warps (the tensor-core kernel, ``passes`` 1 or 3,
    pads order to 16 and L N to 8)."""
    LN = L * N
    rows = (-(-order // 16) * 16 + -(-LN // 8) * 8 if passes
            else order + LN)
    solver = 8 * (_bin_float2s(N, L) + (N * L | 1) + N) + 4 * N
    return 4 * (2 * bins + 4) * rows + solvers * solver


def loop_taps_plan(passes: int, order: int, N: int, L: int) -> tuple:
    """K9 looped's (bins a tile, solver warps): 64 bins and eight solvers
    where they fit a block, else 32 bins and as many solvers as fit;
    (0, 0) when not even one does."""
    if loop_taps_smem_bytes(passes, order, N, L, 64,
                            _LOOP_MAX_WARPS) <= _MAX_SMEM:
        return 64, _LOOP_MAX_WARPS
    w = 0
    while (w < _LOOP_MAX_WARPS and loop_taps_smem_bytes(
            passes, order, N, L, 32, w + 1) <= _MAX_SMEM):
        w += 1
    return (32 if w else 0), w


def loop_max_n(L: int, order: int | None = None,
               precision: str = "high") -> int:
    """The most microphones the looped K8 (``order`` None) or K9 (at
    ``order`` taps and ``precision``) takes at L loudspeakers."""
    def fits(N):
        if order is None:
            return loop_tf_mse_warps(N, L) > 0
        return loop_taps_plan(PASSES[precision], order, N, L)[1] > 0

    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # fits(lo), not fits(hi); the rules grow with N
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def check_aa_loop(N: int, L: int, order: int | None = None,
                  precision: str = "high") -> None:
    """Raise unless the looped K8 (``order`` None) or K9 takes N
    microphones at L loudspeakers (and ``order`` taps, ``precision``) on
    the card, naming the limit (before any library is loaded)."""
    if order is None:
        fits, what = loop_tf_mse_warps(N, L) > 0, "K8 (aa_tf_mse)"
        extra = ""
    else:
        fits = loop_taps_plan(PASSES[precision], order, N, L)[1] > 0
        what = f"K9 (aa_taps_tf_mse, precision={precision!r})"
        extra = f" and order = {order} taps"
    if not fits:
        top = loop_max_n(L, order, precision)
        raise ValueError(
            f"N = {N} microphones, L = {L} loudspeakers{extra}: the looped "
            f"kernel {what} takes 1..{top} microphones at these sizes on "
            f"the card, where one bin's system"
            + ("" if order is None else " and the tile's powers and rows")
            + f" must fit a block's {_MAX_SMEM} bytes (227 KB) of shared "
            "memory")


def _loop_check(rc: int, what: str) -> None:
    cuda_build.check(rc, what, 1, LOOP_LIB)


def aa_tf_mse_loop_kernel(hr, hi, gr, gi, rr, ri, t, N: int, L: int,
                          pivot: bool = False):
    """K8 looped (aa_loop.cu, one warp a bin, any N up to
    ``loop_max_n(L)``): ``(loss, Sr, Si)``."""
    M = _check_rows(N, L, dict(hr=hr, hi=hi, gr=gr, gi=gi, rr=rr, ri=ri, t=t))
    if not _on_cuda(hr, hi, gr, gi, rr, ri, t):
        return aa_tf_mse_plain(hr, hi, gr, gi, rr, ri, t, N, L, pivot)
    check_aa_loop(N, L)
    lib = cuda_build.load(1, LOOP_LIB)
    hr, hi, gr, gi, rr, ri, t = (x.contiguous()
                                 for x in (hr, hi, gr, gi, rr, ri, t))
    loss_row = torch.empty((M,), dtype=torch.float32, device=hr.device)
    Sr, Si = torch.empty_like(gr), torch.empty_like(gi)
    with torch.cuda.device(hr.device):
        rc = lib.aal_tf_mse_launch(
            N, int(pivot), hr.data_ptr(), hi.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), rr.data_ptr(), ri.data_ptr(), t.data_ptr(),
            loss_row.data_ptr(), Sr.data_ptr(), Si.data_ptr(),
            2.0 / (M * N), L, M, _stream(hr))
    _loop_check(rc, "aa_loop_tf_mse_kernel")
    LAUNCHES["aa_tf_mse_loop"] += 1
    return torch.sum(loss_row) / (M * N), Sr, Si


def aa_taps_tf_mse_loop_kernel(hr, hi, tw, rr, ri, t, N: int, L: int,
                               nfft: int, pivot: bool = False,
                               precision: str = "high", bin_offset=None):
    """K9 looped (aa_loop.cu, one warp a bin, any N up to
    ``loop_max_n(L, order, precision)``): ``(loss, tb)``; 'highest' is
    ``aa_loop_taps_tf_mse_kernel`` (FP32), 'high' and 'default'
    ``aa_loop_taps_tf_mse_tc_kernel`` (3 or 1 TF32 passes).  Each block
    adds its tiles into one row of partials, summed here."""
    off = _check_taps_args(precision, bin_offset, nfft)
    M = _check_rows(N, L, dict(hr=hr, hi=hi, tw=tw, rr=rr, ri=ri, t=t))
    if not _on_cuda(hr, hi, tw, rr, ri, t):
        return aa_taps_tf_mse_plain(hr, hi, tw, rr, ri, t, N, L, nfft, pivot,
                                    off, precision)
    order, passes = tw.shape[0], PASSES[precision]
    check_aa_loop(N, L, order, precision)
    name = ("aa_loop_taps_tf_mse_tc_kernel" if passes
            else "aa_loop_taps_tf_mse_kernel")
    lib = cuda_build.load(1, LOOP_LIB)
    hr, hi, tw, rr, ri, t = (x.contiguous() for x in (hr, hi, tw, rr, ri, t))
    with torch.cuda.device(hr.device):
        grid = lib.aal_taps_grid(int(pivot), passes, order, N, L, M)
        _loop_check(min(grid, 0), f"{name} grid")
        loss_row = torch.empty((M,), dtype=torch.float32, device=hr.device)
        partials = torch.empty((grid, -(-order // 16) * 16,
                                -(-(L * N) // 8) * 8), dtype=torch.float32,
                               device=hr.device)
        rc = lib.aal_taps_launch(
            N, int(pivot), passes, hr.data_ptr(), hi.data_ptr(),
            tw.data_ptr(), rr.data_ptr(), ri.data_ptr(), t.data_ptr(),
            loss_row.data_ptr(), partials.data_ptr(), 2.0 / (M * N), L, M,
            order, nfft, off % nfft, 2.0 * math.pi / nfft, grid, _stream(hr))
    _loop_check(rc, name)
    LAUNCHES[(f"aa_taps_tf_mse_tc_{precision}" if passes
              else "aa_taps_tf_mse") + "_loop"] += 1
    return (torch.sum(loss_row) / (M * N),
            torch.sum(partials, dim=0)[:order, :L * N])


# ---------------------------------------------------------------------------
# differentiable public functions
# ---------------------------------------------------------------------------
class _AaTfMse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hr, hi, gr, gi, rr, ri, t, N, L, pivot):
        loss, Sr, Si = aa_tf_mse_kernel(hr, hi, gr, gi, rr, ri, t, N, L,
                                        pivot)
        ctx.save_for_backward(Sr, Si)
        return loss

    @staticmethod
    def backward(ctx, g):
        Sr, Si = ctx.saved_tensors
        # real rows: JAX's cotangents are PyTorch's gradients
        return (None, None, g * Sr, -(g * Si), None, None, None, None, None,
                None)


class _AaTapsTfMse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hr, hi, tw, rr, ri, t, N, L, nfft, pivot, precision,
                bin_offset):
        loss, tb = aa_taps_tf_mse_kernel(hr, hi, tw, rr, ri, t, N, L, nfft,
                                         pivot, precision, bin_offset)
        ctx.save_for_backward(tb)
        return loss

    @staticmethod
    def backward(ctx, g):
        (tb,) = ctx.saved_tensors
        return (None, None, g * tb) + (None,) * 9


def aa_tf_mse(hr, hi, gr, gi, rr, ri, t, N: int, L: int,
              pivot: bool = False):
    """Fused active-acoustics training-step loss (K8), differentiable in
    the mixer-response rows ``gr``/``gi`` only: the room rows, the rhs and
    the targets are frozen and get no gradient.  Counterpart of
    ``pallas_aa_tf_mse``, same arguments."""
    return _AaTfMse.apply(hr, hi, gr, gi, rr, ri, t, N, L, pivot)


def aa_taps_tf_mse(hr, hi, tw, rr, ri, t, N: int, L: int, nfft: int,
                   pivot: bool = False, precision: str = "high",
                   bin_offset=None):
    """The same loss differentiable in the envelope-folded mixer taps
    ``tw`` (order, L N), ``tw[t, j N + k] = gamma^t taps[t, j, k]`` (K9):
    the tap->response DFT and the cotangent->tap contraction run inside
    the kernel, so no basis or response rows exist in device memory.
    Counterpart of ``pallas_aa_taps_tf_mse``, same arguments.

    ``precision`` must be 'default', 'high' or 'highest' (anything else
    raises ``ValueError``): on the card 'highest' is FP32 on CUDA cores,
    'high' three TF32 tensor-core passes of split operands (JAX's 3-pass
    bf16 'high' with TF32 in place of bf16) and 'default' one TF32 pass.
    ``bin_offset`` (a whole number,
    default 0) evaluates row j at global bin ``j + bin_offset``; the loss
    is normalized by the local row count."""
    return _AaTapsTfMse.apply(hr, hi, tw, rr, ri, t, N, L, nfft, pivot,
                              precision, bin_offset)
