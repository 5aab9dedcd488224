"""Per-bin closed-loop solves (counterpart of ``flamo_tpu/ops/solve.py``).

For every frequency bin solve ``A y = B`` with tiny N and a huge bin
batch.  Gaussian elimination is unrolled over the static N and every
scalar step is a tensor over the bins, as in the JAX package (where it is
XLA code, so plain vectorised PyTorch is its faithful port).  Pivoting
selects rows with ``torch.where`` chains: no gathers.

Gradients use the closed form instead of differentiating through the
elimination.  In JAX's convention (unconjugated transposes)
``B_bar = A^{-T} Y_bar`` and ``A_bar = -B_bar Y^T``.  PyTorch hands a
backward the conjugate of JAX's cotangent for a complex tensor, so each
backward here conjugates the incoming gradient, applies the JAX formula,
and conjugates what it returns.
"""

from __future__ import annotations

import torch


def _gauss_solve_raw(A: torch.Tensor, B: torch.Tensor,
                     pivot: bool = True) -> torch.Tensor:
    """Solve ``A x = B`` batched over leading dims; B is (..., N) or
    (..., N, K).  ``pivot=False`` skips the pivot search: only safe when
    the leading pivots stay away from zero."""
    N = A.shape[-1]
    vector_rhs = B.ndim == A.ndim - 1
    if vector_rhs:
        B = B[..., None]
    if N == 1:
        x = B / A[..., 0:1, :]
        return x[..., 0] if vector_rhs else x

    arows = [A[..., i, :] for i in range(N)]
    brows = [B[..., i, :] for i in range(N)]
    for k in range(N):
        if pivot:
            mags = torch.stack([torch.abs(arows[i][..., k])
                                for i in range(k, N)], dim=-1)
            piv = torch.argmax(mags, dim=-1)
            pa = arows[k]
            pb = brows[k]
            for i in range(k + 1, N):
                sel = (piv == (i - k))[..., None]
                pa = torch.where(sel, arows[i], pa)
                pb = torch.where(sel, brows[i], pb)
            # the row that provided the pivot receives old row k
            for i in range(k + 1, N):
                is_piv = (piv == (i - k))[..., None]
                arows[i] = torch.where(is_piv, arows[k], arows[i])
                brows[i] = torch.where(is_piv, brows[k], brows[i])
            arows[k], brows[k] = pa, pb

        inv_pivot = 1.0 / arows[k][..., k]
        for i in range(k + 1, N):
            factor = (arows[i][..., k] * inv_pivot)[..., None]
            arows[i] = arows[i] - factor * arows[k]
            brows[i] = brows[i] - factor * brows[k]

    xrows = [None] * N
    for i in range(N - 1, -1, -1):
        acc = brows[i]
        for j in range(i + 1, N):
            acc = acc - arows[i][..., j][..., None] * xrows[j]
        xrows[i] = acc / arows[i][..., i][..., None]
    x = torch.stack(xrows, dim=-2)
    return x[..., 0] if vector_rhs else x


def _outer_cotangent(B_bar, Y, vector_rhs: bool):
    """JAX-convention A_bar = -B_bar Y^T."""
    if vector_rhs:
        return -B_bar[..., :, None] * Y[..., None, :]
    return -torch.einsum("...ik,...jk->...ij", B_bar, Y)


def _conj(x: torch.Tensor) -> torch.Tensor:
    """``conj_physical``, in the calls that ``torch.func.vmap`` batches
    (it has no batching rule for ``conj_physical``)."""
    return torch.conj(x).resolve_conj()


class _GaussSolve(torch.autograd.Function):
    # batched by torch.func.vmap (the multi-seed ensemble) through the
    # generated rule: the forward and backward are plain tensor code
    generate_vmap_rule = True

    @staticmethod
    def forward(A, B, pivot):
        return _gauss_solve_raw(A, B, pivot)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _, pivot = inputs
        ctx.save_for_backward(A, output)
        ctx.pivot = pivot

    @staticmethod
    def backward(ctx, Y_bar):
        A, Y = ctx.saved_tensors
        B_bar = _gauss_solve_raw(A.transpose(-1, -2), _conj(Y_bar),
                                 ctx.pivot)
        A_bar = _outer_cotangent(B_bar, Y, Y.ndim == A.ndim - 1)
        return _conj(A_bar), _conj(B_bar), None


def gauss_solve(A: torch.Tensor, B: torch.Tensor,
                pivot: bool = True) -> torch.Tensor:
    """:func:`_gauss_solve_raw` with the closed-form solve gradient."""
    return _GaussSolve.apply(A, B, pivot)


def gauss_solve_loop(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pivoted solve for any N with the closed-form gradient: the
    counterpart of the JAX package's ``gauss_solve_loop``, its rolled
    variant for N > 32.  That variant exists because XLA compiles the
    unrolled elimination in O(N^2) statements; PyTorch runs eagerly, so
    the port keeps one elimination (:func:`_gauss_solve_raw`, the same
    pivot choice, first maximum on ties) and this is
    :func:`gauss_solve` with ``pivot=True``.  Its backward solves with
    A^T (:class:`_GaussSolve`), never through the elimination."""
    return _GaussSolve.apply(A, B, True)


def _ge_nopivot_factor(A, B):
    """No-pivot elimination that also returns the U rows and the L
    multipliers (column-major by k)."""
    N = A.shape[-1]
    arows = [A[..., i, :] for i in range(N)]
    brows = [B[..., i, :] for i in range(N)]
    factors = []
    for k in range(N):
        inv = 1.0 / arows[k][..., k]
        for i in range(k + 1, N):
            f = arows[i][..., k] * inv
            factors.append(f)
            arows[i] = arows[i] - f[..., None] * arows[k]
            brows[i] = brows[i] - f[..., None] * brows[k]
    xrows = [None] * N
    for i in range(N - 1, -1, -1):
        acc = brows[i]
        for j in range(i + 1, N):
            acc = acc - arows[i][..., j][..., None] * xrows[j]
        xrows[i] = acc / arows[i][..., i][..., None]
    return torch.stack(xrows, dim=-2), arows, factors


def _lu_transpose_solve(arows, factors, R):
    """Solve ``A^T X = R`` (R is (..., N, K)) from the U rows and the L
    multipliers of :func:`_ge_nopivot_factor` with ``A = L U``: first
    ``U^T W = R`` forward, then ``L^T X = W`` backward."""
    N = len(arows)
    L = [[None] * N for _ in range(N)]
    it = iter(factors)
    for k in range(N):
        for i in range(k + 1, N):
            L[i][k] = next(it)
    w = [None] * N
    for i in range(N):
        acc = R[..., i, :]
        for j in range(i):
            acc = acc - arows[j][..., i][..., None] * w[j]
        w[i] = acc / arows[i][..., i][..., None]
    x = [None] * N
    for i in range(N - 1, -1, -1):
        acc = w[i]
        for j in range(i + 1, N):
            acc = acc - L[j][i][..., None] * x[j]
        x[i] = acc
    return torch.stack(x, dim=-2)


class _GaussSolveCached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        vec = B.ndim == A.ndim - 1
        Y, arows, factors = _ge_nopivot_factor(A, B[..., None] if vec else B)
        ctx.vec = vec
        ctx.n = len(arows)
        ctx.save_for_backward(Y, *arows, *factors)
        return Y[..., 0] if vec else Y

    @staticmethod
    def backward(ctx, Y_bar):
        N = ctx.n
        saved = ctx.saved_tensors
        Y, arows, factors = saved[0], saved[1:1 + N], saved[1 + N:]
        Y_bar = torch.conj_physical(Y_bar)
        if ctx.vec:
            Y_bar = Y_bar[..., None]
        B_bar = _lu_transpose_solve(arows, factors, Y_bar)
        A_bar = -torch.einsum("...ik,...jk->...ij", B_bar, Y)
        if ctx.vec:
            B_bar = B_bar[..., 0]
        return torch.conj_physical(A_bar), torch.conj_physical(B_bar)


def gauss_solve_cached(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """No-pivot solve whose gradient reuses the forward LU factors (two
    triangular passes instead of a second elimination)."""
    return _GaussSolveCached.apply(A, B)


def gauss_solve_mat(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """No-pivot elimination in matrix form: one rank-1 update of the whole
    (..., N, N) panel per column, then back substitution.  Differentiated
    by autograd through the elimination, as in the JAX package, where it
    is kept as a correct reference point that loses to the row form on
    bandwidth; ``closed_loop_solve(method='ge_mat')``."""
    N = A.shape[-1]
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    below = (torch.arange(N, device=A.device)[:, None]
             > torch.arange(N, device=A.device)[None, :])  # [i, k]: i > k
    for k in range(N):
        col = A[..., :, k]
        factor = torch.where(below[:, k], col / col[..., k:k + 1],
                             torch.zeros((), dtype=col.dtype,
                                         device=col.device))[..., None]
        A = A - factor * A[..., k:k + 1, :]
        B = B - factor * B[..., k:k + 1, :]
    xrows = [torch.zeros_like(B[..., 0, :])] * N
    for i in range(N - 1, -1, -1):
        dot = torch.einsum("...j,...jk->...k", A[..., i, :],
                           torch.stack(xrows, dim=-2))
        xrows[i] = (B[..., i, :] - dot) / A[..., i, i:i + 1]
    X = torch.stack(xrows, dim=-2)
    return X[..., 0] if vec else X


def closed_loop_solve(A: torch.Tensor, B: torch.Tensor,
                      method: str = "ge") -> torch.Tensor:
    """Dispatch for the Recursion solve.

    method: 'ge' (pivoted elimination, any N: the JAX package's rolled
    variant for N > 32 computes the same elimination), 'ge_nopivot',
    'ge_cached' (no pivot, factor-reusing gradient), 'ge_mat' (no pivot,
    rank-1 panel updates: :func:`gauss_solve_mat`), 'lu'
    (``torch.linalg.solve``) or 'pallas'.  A vector-rhs 'pallas' solve is
    the dense per-bin kernel K6 (:func:`~flamo_tpu_torch.ops.fdn_kernels.
    dense_solve`: the CUDA kernel for CUDA tensors, unrolled up to 16
    channels and looped above, its plain version for CPU tensors at any
    N); a matrix rhs goes to the pivoted 'ge',
    as in the JAX package.  Unlike the JAX package, an unknown method
    raises instead of falling back to 'ge'."""
    if method == "pallas":
        if B.ndim == A.ndim - 1:
            # imported here: fdn_kernels builds its plain versions on this
            # module
            from flamo_tpu_torch.ops.fdn_kernels import dense_solve

            return dense_solve(A, B)
        return gauss_solve(A, B)
    if method == "ge":
        return gauss_solve(A, B)
    if method == "ge_nopivot":
        return gauss_solve(A, B, pivot=False)
    if method == "ge_cached":
        return gauss_solve_cached(A, B)
    if method == "ge_mat":
        return gauss_solve_mat(A, B)
    if method == "lu":
        if B.ndim == A.ndim - 1:
            return torch.linalg.solve(A, B[..., None])[..., 0]
        return torch.linalg.solve(A, B)
    raise ValueError(f"unknown solve method {method!r}")
