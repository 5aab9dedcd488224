"""The SOS-cascade kernels K4 and K5 (counterpart of the SOS part of
``flamo_tpu/ops/pallas_solve.py``): wrappers around the hand-written CUDA
kernels of ``flamo_tpu_torch/csrc/sos_kernels.cu``, their plain PyTorch
versions, and the ``autograd.Function``s of the public functions.

Public functions keep the JAX signatures and layouts (taps (P, K, N)
float32, tap-major; D (M, N) complex64; U (N, N), b and c (N,) float32;
X (M,) complex64, t (M,) float32):

* :func:`sos_cascade` (K4f forward, K4b gradient): the guarded cascade
  response ``H_n(z_m) = prod_k B_kn(z_m) / prod_k A_kn(z_m)``, (M, N)
  complex64, ``FLT_EPSILON`` where the denominator product vanishes
  (kernels of ``flamo_tpu_torch/csrc/sos_cascade.cu``);
* :func:`fdn_sos_tf_mse` (K5): the attenuated-FDN loss
  ``L = (1/M) sum_m (|tf_m X_m| - t_m)^2``,
  ``tf_m = c^T (I - diag(D_m Gam_m) U)^{-1} diag(D_m) b`` with
  ``Gam = sos_cascade(bt, at)``, and its cotangents in the same pass.

The cascades keep their running products near 1 by a power of two at
each section, the kernels (``sos_common.cuh`` ``pow2_scale``) and the
plain versions (``functional.cascade_prods_scaled``) alike, so a long
cascade does not underflow float32; the ratio is the unscaled one, bit
for bit wherever the unscaled products stay normal.

``bin_offset`` (a number, default 0) evaluates row j at bin
``j + bin_offset``.  Each ``*_kernel`` wrapper launches its CUDA kernel
for CUDA tensors (and counts the launch in :data:`LAUNCHES`) and runs the
plain version for CPU tensors; it never falls back from one to the other.
On the card K4 takes any channel count (one library, the channels in
blocks of at most ``K4_MAX_CB`` side by side in the grid) and K5 the
unrolled kernel of ``sos_kernels.cu`` up to 16 channels (one library per
channel count, as ``fdn_kernels``) and the looped ones above (N at run
time): ``fdn_reg.cu``'s register-resident kernel from 17 to 64 channels
where its block fits (:func:`reg_tf_mse_bins`), else ``fdn_loop.cu``'s
shared-memory one (one warp a bin), as far as one bin's system, its
sums and the staged taps fit a block's 227 KB of shared memory
(:func:`loop_tf_mse_max_n`: 101 channels at an octave GEQ's K = 12,
P = 3 with fused tap sums, 82 at a 1/3-octave GEQ's K = 30), each at
most ``MAX_P`` taps and ``MAX_K`` sections.
Cotangents follow ``fdn_kernels``: the kernels compute JAX's cotangent of
a complex tensor and each backward conjugates at the boundary.
"""

from __future__ import annotations

import math

import torch

from flamo_tpu_torch.functional import cascade_prods_scaled
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops.fdn_kernels import (LOOP_LIB, LOOP_MAX_WARPS,
                                             LOOP_SMEM, MAX_N, _al4, _check,
                                             _cotangents, _loop_check,
                                             _on_cuda, _stream,
                                             _tf_mse_solves, loop_grid,
                                             reg_bin_float2s, reg_fit_bins)

# the kernels' limits (sos_kernels.cu: kMaxP, kMaxK, kMaxSmemFloats)
MAX_P = 8
MAX_K = 64
_MAX_SMEM = 232448  # a block's 227 KB of shared memory, opted in
# bins a K4 or K5 block (kThreads of sos_cascade.cu and sos_kernels.cu)
_THREADS = 128
# K4's channels a block and the shared memory a block gets without opting
# in (sos_cascade.cu: kMaxCB, kMaxSharedFloats)
K4_MAX_CB = 8
_K4_SMEM_FLOATS = 48 * 1024 // 4
_K4_LIB = "sos_cascade"

# launches of each CUDA kernel since the last reset (plain CPU runs do not
# count); K5 looped under its own key: its register-resident kernel (17..64
# channels) under "fdn_sos_tf_mse_loop", fdn_loop.cu's shared-memory one
# under "fdn_sos_tf_mse_loop_smem"
LAUNCHES = {"sos_cascade_fwd": 0, "sos_cascade_bwd": 0, "fdn_sos_tf_mse": 0,
            "fdn_sos_tf_mse_loop": 0, "fdn_sos_tf_mse_loop_smem": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (JAX-convention outputs)
# ---------------------------------------------------------------------------
def _iir_guard_prods(prodB, prodA):
    """H = prodB / prodA, the real eps where prodA is 0.  Double where:
    the divide sees a safe denominator, so its gradient at guarded bins is
    0, not NaN (a gradient flows through both branches of a where)."""
    ok = torch.abs(prodA) != 0
    prodA_safe = torch.where(ok, prodA, torch.ones_like(prodA))
    eps = torch.finfo(prodA.real.dtype).eps
    return torch.where(ok, prodB / prodA_safe,
                       torch.full_like(prodB, eps))


def _phasor(nfft: int, M: int, bin_offset, device):
    """z^{-1} = e^{-j 2 pi (m + bin_offset) / nfft} for m < M:
    ``rfft_phasor``'s formula on a shifted grid."""
    m = torch.arange(M, dtype=torch.float32, device=device)
    if bin_offset is not None:
        m = m + float(bin_offset)
    return torch.exp(-1j * (2.0 * torch.pi * m / nfft))


def _tap_sums(b, a, zinv, t):
    """(b_bar, a_bar), each (P, K, N), from t (M, N) = cotangent of H
    times H (zero at guarded bins):
    ``b_bar[p,k,n] = sum_m Re(t / B_kn z^p)`` and
    ``a_bar = -sum_m Re(t / A_kn z^p)``, a section whose response is 0
    adding nothing."""
    P = b.shape[0]
    zp = [torch.ones_like(zinv)]
    for _ in range(1, P):
        zp.append(zp[-1] * zinv)
    zp = torch.stack(zp)  # (P, M)
    out = []
    for c, sign in ((b, 1.0), (a, -1.0)):
        sec = c[P - 1].to(zinv.dtype).expand(zinv.shape[0], *c.shape[1:])
        for p in range(P - 2, -1, -1):
            sec = sec * zinv[:, None, None] + c[p]
        ok = torch.abs(sec) != 0
        q = torch.where(ok, t[:, None, :] / torch.where(ok, sec, 1.0), 0.0)
        out.append(sign * torch.real(torch.einsum("pm,mkn->pkn", zp, q)))
    return tuple(out)


def sos_cascade_fwd_plain(b, a, nfft: int, bin_offset=None):
    """K4f's function: the code that ``cascade_backend='xla'`` runs."""
    zinv = (None if bin_offset is None
            else _phasor(nfft, nfft // 2 + 1, bin_offset, b.device))
    return _iir_guard_prods(*cascade_prods_scaled(b, a, nfft, zinv))


def sos_cascade_bwd_plain(b, a, g, nfft: int, bin_offset=None):
    """K4b's function: (b_bar, a_bar) for JAX's cotangent g (M, N) of H."""
    zinv = _phasor(nfft, g.shape[0], bin_offset, g.device)
    prodB, prodA = cascade_prods_scaled(b, a, nfft, zinv)
    ok = torch.abs(prodA) != 0
    H = prodB / torch.where(ok, prodA, torch.ones_like(prodA))
    return _tap_sums(b, a, zinv, torch.where(ok, g * H, 0.0))


def fdn_sos_tf_mse_plain(D, bt, at, U, b, c, X, t, nfft: int,
                         with_dbar: bool = False, pivot: bool = False,
                         fuse_taps: bool = True, bin_offset=None):
    """K5's function: (loss, D_bar or None, bt_bar, at_bar, U_bar, b_bar,
    c_bar).  ``fuse_taps=False`` takes the tap sums from K4b's plain
    version, as the kernel's wrapper takes them from K4b."""
    zinv = _phasor(nfft, D.shape[0], bin_offset, D.device)
    prodB, prodA = cascade_prods_scaled(bt, at, nfft, zinv)
    gam = _iir_guard_prods(prodB, prodA)
    gok = torch.abs(prodA) != 0
    loss, y, w, tb = _tf_mse_solves(D, U, b, c, X, t, pivot, D_loop=D * gam)
    D_bar, U_bar, b_bar, c_bar = _cotangents(D, U, b, y, w, tb, with_dbar,
                                             gam)
    Uy = torch.einsum("ij,mj->mi", U.to(y.dtype), y)
    gam_bar = torch.where(gok, tb[:, None] * w * Uy * D, 0.0)
    if fuse_taps:
        bt_bar, at_bar = _tap_sums(bt, at, zinv, gam_bar * gam)
    else:
        bt_bar, at_bar = sos_cascade_bwd_plain(bt, at, gam_bar, nfft,
                                               bin_offset)
    return loss, D_bar, bt_bar, at_bar, U_bar, b_bar, c_bar


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors -> the kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------
def _check_taps(b, a, N=None):
    if b.ndim != 3 or b.dtype != torch.float32:
        raise TypeError(f"taps must be (P, K, N) float32, got "
                        f"{tuple(b.shape)} {b.dtype}")
    if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
        raise TypeError(f"b and a taps differ: {tuple(b.shape)} {b.dtype} "
                        f"and {tuple(a.shape)} {a.dtype}")
    P, K, Nb = b.shape
    if not 1 <= P <= MAX_P:
        raise ValueError(f"P = {P} taps per section; the kernels take "
                         f"1..{MAX_P}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K = {K} sections; the kernels take 1..{MAX_K}")
    if N is not None and Nb != N:
        raise ValueError(f"taps have {Nb} channels, D has {N}")
    return P, K, Nb


def tf_mse_smem_bytes(N: int, K: int, P: int, fuse_taps: bool = True) -> int:
    """K5's least dynamic shared memory per block (as ``k5_smem_floats``
    in sos_kernels.cu with one run of tap sums): the staged taps, the
    warps' head rows and, with ``fuse_taps``, the bins' rows of z and the N
    values t_n.  At most 87568 bytes for N <= 16, K <= 64, P <= 8."""
    taps = 2 * P * K * N
    bins = 2 * _THREADS * (N + 1) if fuse_taps else 0
    return 4 * (bins + taps + _THREADS // 32 * (N * N + 2 * N + 1))


def loop_tf_mse_smem_bytes(N: int, K: int, P: int, fuse_taps: bool,
                           warps: int) -> int:
    """K5 looped's dynamic shared memory of a block of ``warps`` (as
    fdn_loop.cu's sos_smem_bytes): once U (N rows of stride N | 1), b, c
    and the 2 P K N taps; each warp its system (N rows of stride N | 1
    complex), six complex vectors (d, D Gam, Gam, rhs, y, w), the guard
    flags (N floats in ceil(N / 2) complex slots) and its sums, the
    N^2 + 2N + 1 head values and, with ``fuse_taps``, the 2 P K N tap
    sums.  At N = 64, K = 30, P = 3 with fused taps one warp takes
    162820 bytes."""
    S = N | 1
    common = N * S + 2 * N + 2 * P * K * N
    sums = N * N + 2 * N + 1 + (2 * P * K * N if fuse_taps else 0)
    return 4 * (common + common % 2) + warps * (
        8 * (N * S + 6 * N + (N + 1) // 2) + 4 * sums)


def loop_tf_mse_warps(N: int, K: int, P: int, fuse_taps: bool) -> int:
    """K5 looped's warps a block (0: one bin does not fit)."""
    w = 0
    while (w < LOOP_MAX_WARPS and loop_tf_mse_smem_bytes(
            N, K, P, fuse_taps, w + 1) <= LOOP_SMEM):
        w += 1
    return w


def loop_tf_mse_max_n(K: int, P: int, fuse_taps: bool) -> int:
    """The most channels K5 looped takes on the card at K sections of P
    taps (0 when not even one fits)."""
    N = 0
    while loop_tf_mse_warps(N + 1, K, P, fuse_taps):
        N += 1
    return N


def check_loop_tf_mse(N: int, K: int, P: int, fuse_taps: bool) -> None:
    """Raise unless K5 looped takes N channels at (K, P, fuse_taps) on the
    card, naming the limit (before any library is loaded)."""
    if not loop_tf_mse_warps(N, K, P, fuse_taps):
        top = loop_tf_mse_max_n(K, P, fuse_taps)
        raise ValueError(
            f"N = {N} channels, K = {K} sections of P = {P} taps, "
            f"fuse_taps={fuse_taps}: the looped kernel K5 (fdn_sos_tf_mse) "
            f"takes 1..{top} channels at this K and P on the card, where one "
            f"bin's system, its sums and the staged taps must fit a block's "
            f"{LOOP_SMEM} bytes (227 KB) of shared memory")


def reg_tf_mse_smem_bytes(N: int, K: int, P: int, fuse_taps: bool,
                          bins: int) -> int:
    """The register-resident K5's dynamic shared memory of a block of
    ``bins`` (as fdn_reg.cu's smem_bytes): once U (N rows of stride N | 1),
    b and c, the 2 P K N taps, the block's sums (N^2 + 2N + 1 and, with
    ``fuse_taps``, the 2 P K N tap sums) and each bin's tile slot of
    8 N + 3 floats, every region on 16 bytes; and each bin's region
    (fdn_kernels.reg_bin_float2s)."""
    taps = 2 * P * K * N
    sums = N * N + 2 * N + 1 + (taps if fuse_taps else 0)
    return 4 * (_al4(N * (N | 1)) + _al4(2 * N) + _al4(taps) + _al4(sums)
                + bins * _al4(8 * N + 3)) + bins * 8 * reg_bin_float2s(N)


def reg_tf_mse_bins(N: int, K: int, P: int, fuse_taps: bool) -> int:
    """The register-resident K5's bins a block (0: it does not take the
    size, and the shared-memory kernel does, as far as
    :func:`loop_tf_mse_max_n`)."""
    if not (1 <= K <= MAX_K and 1 <= P <= MAX_P):
        return 0
    return reg_fit_bins("fdn_sos_tf_mse", N, lambda b: reg_tf_mse_smem_bytes(
        N, K, P, fuse_taps, b))


def _phase_args(nfft: int, bin_offset):
    return 2.0 * math.pi / nfft, 0.0 if bin_offset is None else float(
        bin_offset)


def k4_channel_block(N: int) -> int:
    """K4's channels a block: N in the fewest blocks of at most
    ``K4_MAX_CB`` channels, as even as they come (25 -> 7, 7, 7, 4)."""
    n_blocks = -(-N // K4_MAX_CB)
    return -(-N // n_blocks)


def k4b_smem_floats(cb: int, K: int, P: int, parts: int) -> int:
    """K4b's dynamic shared memory per block in floats (as
    ``bwd_smem_floats`` in sos_cascade.cu): the staged taps of cb
    channels, the bins' rows of z and the cb values t, and with
    ``parts > 1`` the runs' tap sums."""
    taps = 2 * P * K * cb
    return taps + 2 * _THREADS * (cb + 1) + (parts * taps if parts > 1 else 0)


def k4b_tap_parts(cb: int, K: int, P: int) -> int:
    """The runs a K4b block's bins split into for its tap sums (a power of
    two, each run ``128 / parts`` bins; K5's rule, ``k5_tap_parts``): the
    2 K cb sections x parts work items should cover the block's threads
    evenly.  The fewest bin visits for the busiest thread wins, ties to
    fewer runs, within the 48 KB a block gets without opting in (2 K cb =
    144: 8 runs of 16 bins, 9 items a thread)."""
    S = 2 * K * cb
    best, best_cost = 1, -(-S // _THREADS) * _THREADS
    parts = 2
    while parts <= _THREADS:
        if k4b_smem_floats(cb, K, P, parts) > _K4_SMEM_FLOATS:
            break
        cost = -(-S * parts // _THREADS) * (_THREADS // parts)
        if cost < best_cost:
            best, best_cost = parts, cost
        parts *= 2
    return best


def _k4_check(rc: int, what: str) -> None:
    cuda_build.check(rc, what, 1, _K4_LIB)


def sos_cascade_fwd_kernel(b, a, nfft: int, bin_offset=None):
    """K4f wrapper: H (nfft//2+1, N) complex64."""
    P, K, N = _check_taps(b, a)
    if not _on_cuda(b, a):
        return sos_cascade_fwd_plain(b, a, nfft, bin_offset)
    M = nfft // 2 + 1
    lib = cuda_build.load(1, _K4_LIB)
    b, a = b.contiguous(), a.contiguous()
    H = torch.empty((M, N), dtype=torch.complex64, device=b.device)
    with torch.cuda.device(b.device):
        rc = lib.sos_cascade_fwd_launch(b.data_ptr(), a.data_ptr(),
                                        H.data_ptr(), M, N, K, P,
                                        k4_channel_block(N),
                                        *_phase_args(nfft, bin_offset),
                                        _stream(b))
    _k4_check(rc, "sos_cascade_fwd_kernel")
    LAUNCHES["sos_cascade_fwd"] += 1
    return H


def sos_cascade_bwd_kernel(b, a, g, nfft: int, bin_offset=None):
    """K4b wrapper: (b_bar, a_bar), each (P, K, N), for JAX's cotangent
    g (M, N) complex64 of the cascade response."""
    P, K, N = _check_taps(b, a)
    if g.ndim != 2 or g.shape[1] != N or g.dtype != torch.complex64:
        raise TypeError(f"g must be (M, {N}) complex64, got "
                        f"{tuple(g.shape)} {g.dtype}")
    if not _on_cuda(b, a, g):
        return sos_cascade_bwd_plain(b, a, g, nfft, bin_offset)
    M = g.shape[0]
    lib = cuda_build.load(1, _K4_LIB)
    b, a, g = b.contiguous(), a.contiguous(), g.contiguous()
    cb = k4_channel_block(N)
    # one row of tap sums per block of bins, in the taps' own order
    partials = torch.empty((-(-M // _THREADS), 2, P, K, N),
                           dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        rc = lib.sos_cascade_bwd_launch(b.data_ptr(), a.data_ptr(),
                                        g.data_ptr(), partials.data_ptr(),
                                        M, N, K, P, cb,
                                        k4b_tap_parts(cb, K, P),
                                        *_phase_args(nfft, bin_offset),
                                        _stream(b))
    _k4_check(rc, "sos_cascade_bwd_kernel")
    LAUNCHES["sos_cascade_bwd"] += 1
    s = torch.sum(partials, dim=0)
    return s[0], s[1]


def _k5_result(partials, M: int, D_bar, bt, at, G_bar, nfft: int,
               bin_offset, fuse_taps: bool):
    """K5's (loss, D_bar, bt_bar, at_bar, U_bar, b_bar, c_bar) from its
    blocks' partials rows [U_bar, b_bar, c_bar, loss, tap sums (part, p,
    k, n)], summed here; without ``fuse_taps`` the tap sums come from K4b
    on the Gam-cotangent rows G_bar."""
    P, K, N = bt.shape
    s = torch.sum(partials, dim=0)
    nv0 = N * N + 2 * N + 1
    if fuse_taps:
        bt_bar, at_bar = s[nv0:].reshape(2, P, K, N)
    else:
        bt_bar, at_bar = sos_cascade_bwd_kernel(bt, at, G_bar, nfft,
                                                bin_offset)
    return (s[nv0 - 1] / M, D_bar, bt_bar, at_bar, s[:N * N].reshape(N, N),
            s[N * N:N * N + N], s[N * N + N:N * N + 2 * N])


def fdn_sos_tf_mse_loop_kernel(D, bt, at, U, b, c, X, t, nfft: int,
                               with_dbar: bool = False, pivot: bool = False,
                               fuse_taps: bool = True, bin_offset=None):
    """K5 looped (any N up to :func:`loop_tf_mse_max_n` of its K and P):
    (loss, D_bar or None, bt_bar, at_bar, U_bar, b_bar, c_bar).  On the
    card fdn_reg.cu's register-resident kernel where it takes the size
    (:func:`reg_tf_mse_bins`), else fdn_loop.cu's shared-memory one
    (:func:`fdn_sos_tf_mse_loop_smem_kernel`).  Each block writes one row
    of partials, summed here; ``fuse_taps=False`` emits the masked
    Gam-cotangent rows and launches K4b on them."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)], cplx_rows=[("X", X)],
                  real_rows=[("t", t)])
    P, K, _ = _check_taps(bt, at, N)
    if not _on_cuda(D, bt, at, U, b, c, X, t):
        return fdn_sos_tf_mse_plain(D, bt, at, U, b, c, X, t, nfft,
                                    with_dbar, pivot, fuse_taps, bin_offset)
    if not reg_tf_mse_bins(N, K, P, fuse_taps):
        return fdn_sos_tf_mse_loop_smem_kernel(D, bt, at, U, b, c, X, t,
                                               nfft, with_dbar, pivot,
                                               fuse_taps, bin_offset)
    return _k5_loop("fl_reg_sos_tf_mse", "fdn_sos_tf_mse_loop", D, bt, at,
                    U, b, c, X, t, nfft, with_dbar, pivot, fuse_taps,
                    bin_offset)


def fdn_sos_tf_mse_loop_smem_kernel(D, bt, at, U, b, c, X, t, nfft: int,
                                    with_dbar: bool = False,
                                    pivot: bool = False,
                                    fuse_taps: bool = True, bin_offset=None):
    """K5 on fdn_loop.cu's shared-memory core (one warp a bin, any N up to
    :func:`loop_tf_mse_max_n` of its K and P), as
    :func:`fdn_sos_tf_mse_loop_kernel`."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)], cplx_rows=[("X", X)],
                  real_rows=[("t", t)])
    P, K, _ = _check_taps(bt, at, N)
    if not _on_cuda(D, bt, at, U, b, c, X, t):
        return fdn_sos_tf_mse_plain(D, bt, at, U, b, c, X, t, nfft,
                                    with_dbar, pivot, fuse_taps, bin_offset)
    check_loop_tf_mse(N, K, P, fuse_taps)
    return _k5_loop("fl_sos_tf_mse", "fdn_sos_tf_mse_loop_smem", D, bt, at,
                    U, b, c, X, t, nfft, with_dbar, pivot, fuse_taps,
                    bin_offset)


def _k5_loop(prefix: str, key: str, D, bt, at, U, b, c, X, t, nfft: int,
             with_dbar: bool, pivot: bool, fuse_taps: bool, bin_offset):
    """Launch the looped library's K5 through its C entry points
    ``<prefix>_grid`` and ``<prefix>_launch``, and count it under
    ``key``."""
    M, N = D.shape
    P, K, _ = bt.shape
    lib = cuda_build.load(1, LOOP_LIB)
    D, bt, at, U, b, c, X, t = (x.contiguous()
                                for x in (D, bt, at, U, b, c, X, t))
    D_bar = torch.empty_like(D) if with_dbar else None
    G_bar = None if fuse_taps else torch.empty_like(D)
    what = f"{prefix}_launch"
    # the shared-memory kernel's block depends on D_bar (a template flag
    # there), fdn_reg.cu's does not
    flags = ((int(pivot), int(fuse_taps)) if prefix == "fl_reg_sos_tf_mse"
             else (int(pivot), int(with_dbar), int(fuse_taps)))
    with torch.cuda.device(D.device):
        blocks = loop_grid(getattr(lib, f"{prefix}_grid")(*flags, N, K, P, M),
                           what)
        partials = torch.empty(
            (blocks, N * N + 2 * N + 1 + (2 * P * K * N if fuse_taps else 0)),
            dtype=torch.float32, device=D.device)
        rc = getattr(lib, what)(
            N, int(pivot), int(with_dbar), int(fuse_taps), D.data_ptr(),
            bt.data_ptr(), at.data_ptr(), U.data_ptr(), b.data_ptr(),
            c.data_ptr(), X.data_ptr(), t.data_ptr(),
            None if D_bar is None else D_bar.data_ptr(),
            None if G_bar is None else G_bar.data_ptr(),
            partials.data_ptr(), 2.0 / M, M, K, P,
            *_phase_args(nfft, bin_offset), blocks, _stream(D))
    _loop_check(rc, what)
    LAUNCHES[key] += 1
    return _k5_result(partials, M, D_bar, bt, at, G_bar, nfft, bin_offset,
                      fuse_taps)


def fdn_sos_tf_mse_kernel(D, bt, at, U, b, c, X, t, nfft: int,
                          with_dbar: bool = False, pivot: bool = False,
                          fuse_taps: bool = True, bin_offset=None):
    """K5 wrapper: (loss, D_bar or None, bt_bar, at_bar, U_bar, b_bar,
    c_bar); on the card the looped kernel above MAX_N channels.
    ``fuse_taps=False`` emits the masked Gam-cotangent rows and launches
    K4b on them."""
    M, N = _check(D, U, vecs=[("b", b), ("c", c)], cplx_rows=[("X", X)],
                  real_rows=[("t", t)])
    P, K, _ = _check_taps(bt, at, N)
    if not _on_cuda(D, bt, at, U, b, c, X, t):
        return fdn_sos_tf_mse_plain(D, bt, at, U, b, c, X, t, nfft,
                                    with_dbar, pivot, fuse_taps, bin_offset)
    if N > MAX_N:
        return fdn_sos_tf_mse_loop_kernel(D, bt, at, U, b, c, X, t, nfft,
                                          with_dbar, pivot, fuse_taps,
                                          bin_offset)
    nv = N * N + 2 * N + 1 + (2 * P * K * N if fuse_taps else 0)
    need = tf_mse_smem_bytes(N, K, P, fuse_taps)
    if need > _MAX_SMEM:
        raise ValueError(f"kernel K5 needs {need} bytes of shared memory "
                         f"per block at N = {N}, K = {K}, P = {P}, "
                         f"fuse_taps={fuse_taps}; a block has {_MAX_SMEM} "
                         "(227 KB)")
    lib = cuda_build.load(N, "sos_kernels")
    threads = cuda_build.threads_per_block(N, "sos_kernels")
    D, bt, at, U, b, c, X, t = (x.contiguous()
                                for x in (D, bt, at, U, b, c, X, t))
    D_bar = torch.empty_like(D) if with_dbar else None
    G_bar = None if fuse_taps else torch.empty_like(D)
    n_blocks = -(-M // threads)
    partials = torch.empty((n_blocks, nv), dtype=torch.float32,
                           device=D.device)
    with torch.cuda.device(D.device):
        rc = lib.fdn_sos_tf_mse_launch(
            N, int(pivot), int(with_dbar), int(fuse_taps), D.data_ptr(),
            bt.data_ptr(), at.data_ptr(), U.data_ptr(), b.data_ptr(),
            c.data_ptr(), X.data_ptr(), t.data_ptr(),
            None if D_bar is None else D_bar.data_ptr(),
            None if G_bar is None else G_bar.data_ptr(),
            partials.data_ptr(), 2.0 / M, M, K, P,
            *_phase_args(nfft, bin_offset), _stream(D))
    cuda_build.check(rc, "fdn_sos_tf_mse_kernel", N, "sos_kernels")
    LAUNCHES["fdn_sos_tf_mse"] += 1
    return _k5_result(partials, M, D_bar, bt, at, G_bar, nfft, bin_offset,
                      fuse_taps)


# ---------------------------------------------------------------------------
# differentiable public functions
# ---------------------------------------------------------------------------
class _SosCascade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, a, nfft, bin_offset):
        ctx.save_for_backward(b, a)
        ctx.nfft, ctx.bin_offset = nfft, bin_offset
        return sos_cascade_fwd_kernel(b, a, nfft, bin_offset)

    @staticmethod
    def backward(ctx, H_bar):
        b, a = ctx.saved_tensors
        b_bar, a_bar = sos_cascade_bwd_kernel(
            b, a, torch.conj_physical(H_bar), ctx.nfft, ctx.bin_offset)
        return b_bar, a_bar, None, None


class _FdnSosTfMse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, bt, at, U, b, c, X, t, nfft, with_dbar, pivot,
                fuse_taps, bin_offset):
        loss, D_bar, *grads = fdn_sos_tf_mse_kernel(
            D, bt, at, U, b, c, X, t, nfft, with_dbar, pivot, fuse_taps,
            bin_offset)
        if D_bar is not None:
            D_bar = torch.conj_physical(D_bar)
        ctx.save_for_backward(D_bar, *grads)
        return loss

    @staticmethod
    def backward(ctx, g):
        D_bar, *grads = ctx.saved_tensors
        return (None if D_bar is None else g * D_bar,
                *(g * x for x in grads), None, None, None, None, None,
                None, None)


def sos_cascade(b, a, nfft: int, bin_offset=None):
    """Guarded SOS-cascade frequency response (K4f; gradient K4b):
    ``H_n(z_m) = prod_k B_kn(z_m) / prod_k A_kn(z_m)`` from (P, K, N)
    taps (any envelope applied), (nfft//2+1, N) complex64."""
    return _SosCascade.apply(b, a, nfft, bin_offset)


def fdn_sos_tf_mse(D, bt, at, U, b, c, X, t, nfft: int,
                   with_dbar: bool = False, pivot: bool = False,
                   fuse_taps: bool = True, bin_offset=None):
    """Fused attenuated-FDN training-step kernel (K5): the scalar
    ``L = (1/M) sum_m (|tf_m X_m| - t_m)^2`` with
    ``tf_m = c^T (I - diag(D_m Gam_m) U)^{-1} diag(D_m) b`` and
    ``Gam = sos_cascade(bt, at)``, whose gradients in bt, at, U, b, c
    (and D with ``with_dbar``) come from the same pass.  X and t get no
    gradient; with ``with_dbar=False`` neither does D.  ``pivot=False``
    reuses the forward L/U factors for the adjoint (stable loops).
    ``fuse_taps=False`` takes the tap gradients from a second launch,
    K4b, on the Gam-cotangent rows that K5 writes out."""
    return _FdnSosTfMse.apply(D, bt, at, U, b, c, X, t, nfft, with_dbar,
                              pivot, fuse_taps, bin_offset)
