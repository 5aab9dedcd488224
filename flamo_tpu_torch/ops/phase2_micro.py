"""The phase-2 micro-benchmark kernels K10 (counterpart of the Pallas
kernel of ``scripts/bench_phase2_micro.py``): wrappers around the four
hand-written CUDA kernels of ``flamo_tpu_torch/csrc/phase2_micro.cu`` and
their plain PyTorch version.

K10 isolates the tap-cotangent phase of K5 (``fdn_sos_tf_mse``): per bin
``i`` of ``t`` (2, M) float32, ``z_i = e^{-j w_i}`` with the float32
phase ``w_i = float32(2 pi / nfft) * i`` and ``tn_i = t[0, i] + j t[1, i]``.
Section pass ``s`` (``0 <= s < S = 2 K N``) takes the taps
``c[:, s % K, s % N]`` of ``c`` (P, K, N) float32: ``sec = sum_p c[p] z^p``
(Horner from the top tap), ``q = tn conj(sec) / |sec|^2`` (0 where
``|sec|^2 = 0``).  ``s % K, s % N`` is the TPU kernel's indexing, kept as
it is: where ``gcd(K, N) > 1`` it visits only some (k, n) pairs, each
several times.  Every variant projects q on ``z^0, z^1, z^2``, as the
TPU kernel does whatever P, and returns the (3,) vector that the JAX
script's ``(grid, 1, 3)`` output sums to, over every bin of ``t`` and
every pass:

* ``full``: ``[sum Re q, sum Re q z, sum Re q z^2]``;
* ``noreduce``: ``[sum Re q, sum Re q z + sum Re q z^2, 0]``;
* ``lanered``: ``[T, T, T]`` with ``T`` the sum of ``full``'s three;
* ``ps``: per channel n the prefix and suffix products of its K sections
  (taps ``c[:, k, n]``, every (k, n) pair), one guarded quotient
  ``tp = tn conj(Pi) / |Pi|^2`` of the product ``Pi``, and for two passes
  over k ``q = tp pre_k suf_{k+1}``, summed as ``full``.

The TPU kernel sums ``full`` and ``ps`` with reductions a pass, and
``lanered`` with one; ``noreduce`` keeps per-bin sums.  The CUDA kernels
of ``noreduce`` and ``lanered`` keep those structures as the benchmark's
measure of them (per-bin running sums with one block sum at the end; one
warp tree a pass with the cross-warp sum deferred).  All four run each
distinct pass once: :func:`pass_plan` gives the passes each runs and the
factor its sums are scaled by, since the passes of ``full``,
``noreduce`` and ``lanered`` repeat with period ``lcm(K, N)`` and
``ps``'s second pass over k repeats its first.

:func:`phase2_micro` launches the variant's CUDA kernel for CUDA tensors
(and counts the launch in :data:`LAUNCHES`) and runs
:func:`phase2_micro_plain` for CPU tensors; it never falls back from one
to the other.  The kernels take ``2 <= P <= MAX_P`` taps and
``K <= MAX_K`` sections (``MAX_K_PS`` for ``ps``, which keeps its
products in registers).
"""

from __future__ import annotations

import ctypes
import math

import torch

from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops.fdn_kernels import _on_cuda, _stream

VARIANTS = ("full", "noreduce", "lanered", "ps")
# the kernels' limits (sos_common.cuh: kMaxP, kMaxK; phase2_micro.cu: kRegK)
MAX_P = 8
MAX_K = 64
MAX_K_PS = 16
_LIB = "phase2_micro"

# launches of each variant's CUDA kernel since the last reset (plain CPU
# runs do not count)
LAUNCHES = dict.fromkeys(VARIANTS, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(variant: str, t, c) -> tuple[int, int, int]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the variants are "
                         f"{', '.join(VARIANTS)}")
    if t.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"t and c must be float32, got {t.dtype} and "
                        f"{c.dtype}")
    if t.ndim != 2 or t.shape[0] != 2 or t.shape[1] < 1:
        raise ValueError(f"t must be (2, M) with M >= 1, got "
                         f"{tuple(t.shape)}")
    if c.ndim != 3:
        raise ValueError(f"c must be (P, K, N) taps, got {tuple(c.shape)}")
    P, K, N = c.shape
    if not 2 <= P <= MAX_P:
        raise ValueError(f"P = {P} taps per section; the kernels take "
                         f"2..{MAX_P}")
    max_k = MAX_K_PS if variant == "ps" else MAX_K
    if not 1 <= K <= max_k:
        raise ValueError(f"K = {K} sections; the {variant!r} kernel takes "
                         f"1..{max_k}")
    if N < 1:
        raise ValueError(f"N = {N} channels; the kernels take 1 or more")
    return P, K, N


def pass_plan(variant: str, K: int, N: int) -> tuple[int, int]:
    """(passes, scale): the section passes a variant's CUDA kernel runs and
    the factor it scales its sums by, ``passes * scale`` being the 2 K N
    passes of the function.  Pass s of ``full``, ``noreduce`` and
    ``lanered`` takes the pair (s % K, s % N), which repeats with period
    L = lcm(K, N), so they run the L distinct pairs once and scale by
    2 K N / L = 2 gcd(K, N); ``ps`` runs one of its two identical passes
    over k and scales by 2."""
    if variant == "ps":
        return 1, 2
    L = math.lcm(K, N)
    return L, 2 * K * N // L


# ---------------------------------------------------------------------------
# plain version: re/im float32 pairs, as the TPU kernel's arithmetic
# ---------------------------------------------------------------------------
def _cmul(x, y):
    return (x[0] * y[0] - x[1] * y[1], x[0] * y[1] + x[1] * y[0])


def _horner(c, k: int, n: int, z):
    P = c.shape[0]
    out = (c[P - 1, k, n] + torch.zeros_like(z[0]), torch.zeros_like(z[0]))
    for p in range(P - 2, -1, -1):
        out = _cmul(out, z)
        out = (out[0] + c[p, k, n], out[1])
    return out


def _quotient(tn, sec):
    """tn conj(sec) / |sec|^2, 0 where |sec|^2 = 0."""
    d = sec[0] * sec[0] + sec[1] * sec[1]
    ok = d > 0.0
    inv = 1.0 / torch.where(ok, d, 1.0)
    return (torch.where(ok, (tn[0] * sec[0] + tn[1] * sec[1]) * inv, 0.0),
            torch.where(ok, (tn[1] * sec[0] - tn[0] * sec[1]) * inv, 0.0))


def phase2_micro_plain(variant: str, t, c, nfft: int,
                       magnitude: bool = False):
    """A variant's function, vectorised over bins with a Python loop over
    section passes, in float32 with the kernels' phase.  With
    ``magnitude`` each result is the sum of its terms' magnitudes (the
    scale that float32 rounding of the sum is measured against)."""
    _, K, N = _check(variant, t, c)
    M = t.shape[1]
    red = torch.abs if magnitude else (lambda x: x)
    w = (torch.tensor(2.0 * math.pi / nfft, dtype=torch.float32)
         * torch.arange(M, dtype=torch.float32)).to(t.device)
    z = (torch.cos(w), -torch.sin(w))
    zs = [z, _cmul(z, z)]
    tn = (t[0], t[1])

    def projections(q):
        return [red(q[0] * zp[0] - q[1] * zp[1]) for zp in zs]

    rows = []
    if variant == "ps":
        one = (torch.ones_like(z[0]), torch.zeros_like(z[0]))
        for n in range(N):
            pres = [one]
            for k in range(K):
                pres.append(_cmul(pres[-1], _horner(c, k, n, z)))
            sufs = [one]
            for k in range(K - 1, -1, -1):
                sufs.append(_cmul(sufs[-1], _horner(c, k, n, z)))
            sufs = sufs[::-1]
            tp = _quotient(tn, pres[-1])
            for _ in range(2):  # the b-tap and a-tap passes
                for k in range(K):
                    q = _cmul(tp, _cmul(pres[k], sufs[k + 1]))
                    rows.append(torch.stack([torch.sum(red(q[0]))] + [
                        torch.sum(v) for v in projections(q)]))
        return torch.sum(torch.stack(rows), dim=0)

    accr = acci = torch.zeros_like(z[0])  # noreduce's per-bin sums
    for s in range(2 * K * N):
        q = _quotient(tn, _horner(c, s % K, s % N, z))
        re, proj = red(q[0]), projections(q)
        if variant == "full":
            rows.append(torch.stack([torch.sum(re)]
                                    + [torch.sum(v) for v in proj]))
        elif variant == "noreduce":
            accr = accr + re
            for v in proj:
                acci = acci + v
        else:  # lanered
            rows.append(torch.sum(re + sum(proj)))
    if variant == "full":
        return torch.sum(torch.stack(rows), dim=0)
    if variant == "noreduce":
        return torch.stack([torch.sum(accr), torch.sum(acci),
                            torch.zeros((), device=t.device)])
    return torch.sum(torch.stack(rows)).expand(3).clone()


# ---------------------------------------------------------------------------
# kernel wrapper: CUDA tensors -> the kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------
def phase2_micro(variant: str, t, c, nfft: int):
    """K10: a variant's (3,) sums over every bin of ``t`` (2, M) and
    every section pass of the taps ``c`` (P, K, N), float32."""
    P, K, N = _check(variant, t, c)
    if not _on_cuda(t, c):
        return phase2_micro_plain(variant, t, c, nfft)
    M = t.shape[1]
    lib = cuda_build.load(1, _LIB)
    t, c = t.contiguous(), c.contiguous()
    passes, scale = pass_plan(variant, K, N)
    v = VARIANTS.index(variant)
    rows = lib.p2_rows(v, M, P, K, N, passes, scale)
    if rows < 0:
        cuda_build.check(rows, f"phase2_micro({variant!r})", 1, _LIB)
    partials = torch.empty((rows, 3), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        rc = lib.p2_launch(v, t.data_ptr(), c.data_ptr(),
                           partials.data_ptr(), M, P, K, N, passes, scale,
                           2.0 * math.pi / nfft, _stream(t))
    cuda_build.check(rc, f"phase2_micro({variant!r})", 1, _LIB)
    LAUNCHES[variant] += 1
    return torch.sum(partials, dim=0)


def kernel_attributes(variant: str, P: int) -> tuple[int, int]:
    """(registers a thread, local bytes a thread: spills) of the CUDA
    kernel that ``variant`` launches at P taps, read from the card."""
    lib = cuda_build.load(1, _LIB)
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = lib.p2_attributes(VARIANTS.index(variant), P, ctypes.byref(regs),
                           ctypes.byref(local))
    cuda_build.check(rc, f"kernel_attributes({variant!r}, {P})", 1, _LIB)
    return regs.value, local.value
