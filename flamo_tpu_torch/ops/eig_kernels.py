"""The Durand-Kerner root kernel K7 (counterpart of
``flamo_tpu/ops/pallas_eig.py``): the wrapper around the hand-written CUDA
kernel of ``flamo_tpu_torch/csrc/eig_kernels.cu``, its plain PyTorch
version, and the complex-batch layout.

* :func:`dk_roots_rows` (K7): real coefficient rows ``cr``/``ci`` (N, B)
  float32 of the monic ``z^N + c[0] z^{N-1} + ... + c[N-1]`` -> real root
  rows ``(zr, zi)`` (N, B), as ``pallas_dk_roots_rows``;
* :func:`dk_roots`: complex64 coefficients (..., N) -> roots (..., N), as
  ``pallas_dk_roots``.

The wrapper launches the CUDA kernel for CUDA tensors (and counts the
launch in :data:`LAUNCHES`) and runs the plain version,
:func:`flamo_tpu_torch.functional._dk_iterate_rows`, for CPU tensors; it
never falls back from one to the other.  On the card it takes degrees
1..8 (``EIG_DK_MAX_N``, one library per degree) and float32 only, and
raises otherwise.  The differentiable functions are
:func:`flamo_tpu_torch.functional.poly_roots` and ``poly_roots_rows``,
whose pullback is plain PyTorch: the TPU kernel has no backward either.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.functional import EIG_DK_MAX_N, _dk_iterate_rows
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops.fdn_kernels import _on_cuda, _stream

LIB = "eig_kernels"

# launches of the CUDA kernel since the last reset (plain CPU runs do not
# count)
LAUNCHES = {"dk_roots": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dk_roots_rows_plain(cr, ci, iters: int = 96):
    """K7's function: root rows ``(zr, zi)`` (N, B) of the coefficient rows
    (N, B)."""
    return _dk_iterate_rows(cr, ci, iters)


def _check_rows(cr, ci):
    if (cr.ndim != 2 or tuple(cr.shape) != tuple(ci.shape)
            or cr.dtype != torch.float32 or ci.dtype != torch.float32):
        raise TypeError(f"cr and ci must be (N, B) float32 rows of one "
                        f"shape, got {tuple(cr.shape)} {cr.dtype} and "
                        f"{tuple(ci.shape)} {ci.dtype}")
    N, B = cr.shape
    if not 1 <= N <= EIG_DK_MAX_N:
        raise ValueError(f"degree N = {N}; kernel K7 takes 1..{EIG_DK_MAX_N} "
                         "(EIG_DK_MAX_N)")
    if B == 0:
        raise ValueError("no polynomials (B = 0)")
    return N, B


def dk_roots_rows(cr, ci, iters: int = 96):
    """K7 wrapper: ``iters`` Durand-Kerner iterations on the coefficient
    rows ``cr``/``ci`` (N, B) float32 -> root rows ``(zr, zi)`` (N, B)."""
    N, B = _check_rows(cr, ci)
    if not _on_cuda(cr, ci):
        return dk_roots_rows_plain(cr, ci, iters)
    lib = cuda_build.load(N, LIB)
    cr, ci = cr.contiguous(), ci.contiguous()
    zr, zi = torch.empty_like(cr), torch.empty_like(ci)
    with torch.cuda.device(cr.device):
        rc = lib.dk_roots_launch(N, cr.data_ptr(), ci.data_ptr(),
                                 zr.data_ptr(), zi.data_ptr(), B, int(iters),
                                 _stream(cr))
    cuda_build.check(rc, "dk_roots_rows", N, LIB)
    LAUNCHES["dk_roots"] += 1
    return zr, zi


def dk_roots(c, iters: int = 96):
    """All roots of the complex64 monic polynomial(s) ``c`` (..., N) by
    K7: the batch folds onto the kernel's columns.  Same iteration and
    root order as :func:`flamo_tpu_torch.functional._dk_iterate`."""
    if c.dtype != torch.complex64:
        raise TypeError(f"dk_roots takes complex64 coefficients, got "
                        f"{c.dtype}")
    batch, N = c.shape[:-1], c.shape[-1]
    c2 = c.reshape(-1, N).T
    zr, zi = dk_roots_rows(torch.real(c2).contiguous(),
                           torch.imag(c2).contiguous(), iters)
    return torch.complex(zr, zi).T.reshape(batch + (N,))
