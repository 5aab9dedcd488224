"""Batched nonsymmetric eigenvalues by Hessenberg reduction and shifted QR
(counterpart of ``flamo_tpu/ops/qr_eig.py``).

The JAX package runs this solver on backends that have no general
``eig``; the port keeps ``torch.linalg.eigvals`` for
:func:`~flamo_tpu_torch.functional.get_eigenvalues` and
:func:`~flamo_tpu_torch.functional.eigvals`, as the JAX package's
LAPACK route does, and offers this one beside it with the same
algorithm and schedule:

1. the matrix is spectrum-centred and Frobenius-scaled;
2. a two-sided Householder reduction to upper Hessenberg form
   (:func:`_hessenberg` up to ``_HESS_STATIC_MAX_N``, the mask-based
   :func:`_hessenberg_dyn` above, as in the JAX package);
3. ``sweeps * (N - 1)`` Wilkinson-shifted QR sweeps (Givens rotations on
   rows, then on columns) with a fixed deflation schedule: the active
   block shrinks from N to 2 every ``sweeps`` sweeps, and every 6th
   sweep takes Francis' exceptional shift.  The batch marches in
   lockstep.  Eigenvalues are the final diagonal.

The JAX package keeps its loop carries as re/im pairs for a TPU backend
limit; here they are complex tensors.  PyTorch runs eagerly, so the
rotations that the JAX schedule forces to the identity (outside the
active block) are not run at all, and a sweep's rotation chain carries
one pending row (column) instead of writing row pairs back.

:func:`eigvals_qr_grad` adds the closed-form eigenvalue pullback with
eigenvectors recovered by inverse iteration (:func:`_right_eigvecs`).
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.ops.solve import gauss_solve, gauss_solve_loop

__all__ = ["eigvals_qr", "eigvals_qr_grad", "EIG_QR_MAX_N"]

#: the largest N at which the JAX package verified the solver's accuracy
#: against LAPACK; not a limit: any N runs
EIG_QR_MAX_N = 128

#: up to this N the Hessenberg reduction works on shrinking windows
#: (:func:`_hessenberg`), above it on full-size masked updates
#: (:func:`_hessenberg_dyn`), as in the JAX package
_HESS_STATIC_MAX_N = 64


def _as_complex(A: torch.Tensor) -> torch.Tensor:
    if A.is_complex():
        return A
    return A.to(torch.complex128 if A.dtype == torch.float64
                else torch.complex64)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def _reflector(x: torch.Tensor, e1: torch.Tensor, x0: torch.Tensor):
    """Unit Householder vector v (zero where x is zero) that maps x to a
    multiple of ``e1``; ``x0`` is x's entry at e1."""
    normx = torch.sqrt(_abs2(x).sum(-1))
    ax0 = torch.abs(x0)
    nz = ax0 > 0.0
    phase = torch.where(nz, x0 / torch.where(nz, ax0, 1.0).to(x0.dtype),
                        torch.ones_like(x0))
    alpha = -phase * normx.to(x.dtype)
    u = x - alpha[:, None] * e1
    unorm = torch.sqrt(_abs2(u).sum(-1))
    ok = unorm > 0.0
    v = u / torch.where(ok, unorm, 1.0).to(u.dtype)[:, None]
    return torch.where(ok[:, None], v, torch.zeros_like(v))


def _hessenberg(H: torch.Tensor) -> torch.Tensor:
    """Two-sided Householder reduction of (B, N, N) complex matrices to
    upper Hessenberg form, on the shrinking trailing window."""
    B, N, _ = H.shape
    H = H.clone()
    for k in range(N - 2):
        x = H[:, k + 1:, k]
        e1 = torch.zeros(N - k - 1, dtype=H.dtype, device=H.device)
        e1[0] = 1.0
        v = _reflector(x, e1, x[:, 0])
        # rows: H[k+1:, :] -= 2 v (v^H H[k+1:, :])
        w = (torch.conj(v)[:, :, None] * H[:, k + 1:, :]).sum(1)
        H[:, k + 1:, :] -= 2.0 * v[:, :, None] * w[:, None, :]
        # cols: H[:, k+1:] -= 2 (H[:, k+1:] v) v^H
        w2 = (H[:, :, k + 1:] * v[:, None, :]).sum(2)
        H[:, :, k + 1:] -= 2.0 * w2[:, :, None] * torch.conj(v)[:, None, :]
    return H


def _hessenberg_dyn(H: torch.Tensor) -> torch.Tensor:
    """The same reduction with full-size updates masked to the rows and
    columns past k: the JAX package's form for large N (one compiled loop
    body there).  The reflector is zero on rows <= k, so it touches what
    :func:`_hessenberg` touches."""
    B, N, _ = H.shape
    idx = torch.arange(N, device=H.device)
    for k in range(N - 2):
        col = H[:, :, k]
        x = torch.where((idx > k)[None, :], col, torch.zeros_like(col))
        e1 = (idx == k + 1).to(H.dtype)
        v = _reflector(x, e1, col[:, k + 1])
        w = (torch.conj(v)[:, :, None] * H).sum(1)
        H = H - 2.0 * v[:, :, None] * w[:, None, :]
        w2 = (H * v[:, None, :]).sum(2)
        H = H - 2.0 * w2[:, :, None] * torch.conj(v)[:, None, :]
    return H


def _wilkinson_shift(blk: torch.Tensor) -> torch.Tensor:
    """Shift from a (B, 2, 2) trailing block: the 2x2 eigenvalue closer
    to the bottom-right entry, by the cancellation-free formula."""
    x, y = blk[:, 0, 0], blk[:, 0, 1]
    z, w = blk[:, 1, 0], blk[:, 1, 1]
    d = (x - w) * 0.5
    sq = torch.sqrt(d * d + y * z)
    s1, s2 = d + sq, d - sq
    den = torch.where(torch.abs(s1) >= torch.abs(s2), s1, s2)
    ok = torch.abs(den) > 0.0
    return w - torch.where(ok, (y * z) / torch.where(ok, den, 1.0),
                           torch.zeros_like(w))


def _qr_sweep(H: torch.Tensor, mu: torch.Tensor, m: int) -> torch.Tensor:
    """One shifted QR sweep on the leading m x m active block:
    ``H <- G^H (H - mu I) G + mu I`` with ``G = diag(Q, I)``, Q the
    product of the Givens rotations that triangularize the shifted
    block.  Rotation j acts on rows (j, j+1), then on columns (j, j+1)."""
    diag = torch.arange(m, device=H.device)
    H = H.clone()
    H[:, diag, diag] -= mu[:, None]
    # G_j = [[ca, cb], [-conj(cb), conj(ca)]]: c holds its first row and
    # d its second; e0 is the identity's first row, sgn turns flipped c
    # into the second
    e0 = torch.tensor([1.0, 0.0], dtype=H.dtype, device=H.device)
    sgn = torch.tensor([-1.0, 1.0], dtype=H.dtype, device=H.device)
    # rows: the chain carries the pending row j (rotated by j - 1)
    pend = H[:, 0, :]
    rows, cs, ds = [], [], []
    for j in range(m - 1):
        pair = torch.stack((pend, H[:, j + 1, :]), 1)  # (B, 2, N)
        ab = pair[:, :, j]
        r = torch.linalg.vector_norm(ab, dim=-1, keepdim=True)
        ok = r > 0.0
        c = torch.where(ok, torch.conj(ab) / torch.where(ok, r, 1.0), e0)
        d = torch.conj(c.flip(-1)) * sgn
        rows.append((c[:, :, None] * pair).sum(1))
        pend = (d[:, :, None] * pair).sum(1)
        cs.append(c)
        ds.append(d)
    rows.append(pend)
    H = torch.cat([torch.stack(rows, 1), H[:, m:, :]], 1)
    # columns: right-multiply by G_j^H, the pending column likewise
    pend = H[:, :, 0]
    cols = []
    for j in range(m - 1):
        pair = torch.stack((pend, H[:, :, j + 1]), -1)  # (B, N, 2)
        cols.append((pair * torch.conj(cs[j])[:, None, :]).sum(-1))
        pend = (pair * torch.conj(ds[j])[:, None, :]).sum(-1)
    cols.append(pend)
    H = torch.cat([torch.stack(cols, 2), H[:, :, m:]], 2)
    H[:, diag, diag] += mu[:, None]
    return H


@torch.no_grad()
def eigvals_qr(A: torch.Tensor, sweeps: int = 14) -> torch.Tensor:
    """Eigenvalues of (..., N, N) real or complex matrices by batched
    Hessenberg + shifted QR (``sweeps`` Wilkinson-shifted sweeps a
    deflation stage).  Analysis only: no gradient (see
    :func:`eigvals_qr_grad`).  The order is arbitrary: compare as a
    set."""
    A = _as_complex(torch.as_tensor(A))
    batch, N = A.shape[:-2], A.shape[-1]
    A = A.reshape(-1, N, N)
    if N == 1:
        return A[:, 0, 0].reshape(batch + (1,))
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    mu0 = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / N
    H = A - mu0[:, None, None] * eye
    s = torch.clamp(torch.sqrt(_abs2(H).sum((-2, -1)) / N), min=1e-30)
    H = H / s[:, None, None].to(A.dtype)
    H = _hessenberg(H) if N <= _HESS_STATIC_MAX_N else _hessenberg_dyn(H)
    for i in range(sweeps * (N - 1)):
        m = N - i // sweeps  # the active block, N .. 2
        blk = H[:, m - 2:m, m - 2:m]
        if i % 6 == 5:
            # Francis' exceptional shift: breaks the cycles (a circulant
            # block) where the Wilkinson shift sits between two
            # eigenvalues
            mu = blk[:, 1, 1] + 0.75 * torch.abs(blk[:, 1, 0]).to(H.dtype)
        else:
            mu = _wilkinson_shift(blk)
        H = _qr_sweep(H, mu, m)
    z = torch.diagonal(H, dim1=-2, dim2=-1)
    return (z * s[:, None].to(z.dtype) + mu0[:, None]).reshape(batch + (N,))


def _right_eigvecs(A: torch.Tensor, lam: torch.Tensor,
                   iters: int = 2) -> torch.Tensor:
    """Right eigenvectors of (B, N, N) ``A`` by inverse iteration from
    the eigenvalues ``lam`` (B, N), each shift moved by
    ``1e-6 ||A||_F / sqrt(N)`` off the eigenvalue, ``iters`` normalized
    solves from a fixed golden-angle start vector.  Returns V with
    ``V[..., :, k]`` the k-th eigenvector.  The shifted systems are a
    (B, N, N, N) stack; N <= 32 solves with :func:`gauss_solve`, larger N
    with :func:`gauss_solve_loop`, as in the JAX package."""
    B, N, _ = A.shape
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    s = torch.clamp(torch.sqrt(_abs2(A).sum((-2, -1)) / N), min=1e-30)
    shift = lam + (1e-6 * s[:, None]).to(lam.dtype)
    Ms = A[:, None, :, :] - shift[:, :, None, None] * eye
    ang = 2.399963 * torch.arange(N, dtype=torch.float32, device=A.device)
    b0 = torch.complex(torch.cos(ang), torch.sin(0.5 * ang + 0.25))
    b0 = (b0 / torch.sqrt(_abs2(b0).sum())).to(A.dtype)
    x = b0.expand(B, N, N)
    solve = gauss_solve if N <= 32 else gauss_solve_loop
    for _ in range(iters):
        x = solve(Ms, x)
        nrm = torch.sqrt(_abs2(x).sum(-1, keepdim=True))
        x = x / torch.clamp(nrm, min=1e-30).to(x.dtype)
    return x.transpose(-1, -2)


class _EigvalsQrGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, sweeps, iters):
        N = A.shape[-1]
        Acf = _as_complex(A).reshape(-1, N, N)
        lam = eigvals_qr(Acf, sweeps)
        ctx.save_for_backward(Acf, lam)
        ctx.iters, ctx.in_complex = iters, A.is_complex()
        ctx.in_dtype, ctx.in_shape = A.dtype, A.shape
        return lam.reshape(A.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        Acf, lam = ctx.saved_tensors
        N = Acf.shape[-1]
        # PyTorch's gradient of a complex tensor is the conjugate of JAX's
        # cotangent: conjugate in, apply JAX's pullback, conjugate out
        wb = torch.conj_physical(g).reshape(-1, N).to(Acf.dtype)
        V = _right_eigvecs(Acf, lam, ctx.iters)
        eyeb = torch.eye(N, dtype=V.dtype, device=V.device).expand(V.shape)
        Vinv = (gauss_solve if N <= 32 else gauss_solve_loop)(V, eyeb)
        A_bar = torch.conj_physical(
            (V @ (wb[:, :, None] * Vinv)).transpose(-1, -2))
        if not ctx.in_complex:
            A_bar = A_bar.real
        return A_bar.to(ctx.in_dtype).reshape(ctx.in_shape), None, None


def eigvals_qr_grad(A: torch.Tensor, sweeps: int = 14,
                    iters: int = 2) -> torch.Tensor:
    """Differentiable :func:`eigvals_qr`: the eigenvalues of the QR
    iteration, and the closed-form pullback
    ``A_bar = (V diag(w_bar) V^-1)^T`` (JAX's cotangent convention) with V
    from :func:`_right_eigvecs`.  Exact for simple spectra; a real input
    gets a real gradient.  The order is arbitrary: consume the
    eigenvalues as a set (sorted, or through symmetric functions)."""
    return _EigvalsQrGrad.apply(A, sweeps, iters)

