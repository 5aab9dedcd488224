"""Paraunitary scattering matrices for FDNs (counterpart of the matching
subset of ``flamo_tpu/auxiliary/scattering.py``; Schlecht & Habets,
'Scattering in Feedback Delay Networks').

The random shifts are drawn once at construction and kept static, as in
the JAX package: every stage is a fixed-shape shift and an order-0 x
order-L polynomial product, i.e. a matmul over the channel axis per tap.
``torch.Generator``s draw other numbers than JAX's PRNG from the same
seed, so a model carried over from JAX copies the shifts and the m_L/m_R
offsets (:func:`flamo_tpu_torch.convert.load_jax_scattering`).

The helpers :func:`hadamard_matrix`, :func:`shift_mat_distribute`,
:func:`poly_matrix_conv` (FFT-domain, as in the JAX package) and
:func:`cascaded_paraunit_matrix` (the functional twin of
:class:`ScatteringMapping`) are the JAX package's, with draws from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from flamo_tpu_torch.utils import next_key, to_complex


def hadamard_matrix(N: int) -> np.ndarray:
    """Normalized Hadamard matrix (numpy, float64) by Kronecker doubling
    up to the first power of two >= N."""
    X = np.array([[1.0]])
    while X.shape[0] < N:
        X = np.kron(X, np.array([[1.0, 1.0], [1.0, -1.0]])) / np.sqrt(2)
    return X


def shift_mat_distribute(X, sparsity: int, pulse_size: int,
                         generator=None) -> np.ndarray:
    """Non-overlapping random shifts for one stage of the (N, ...) matrix
    X: ``floor(sparsity (n + 0.99 u_n)) pulse_size`` with u drawn from
    ``generator``, an int numpy array (N,)."""
    N = np.asarray(X).shape[0]
    rand = torch.rand((N,), generator=next_key(generator)).numpy()
    rand_shift = np.floor(sparsity * (np.arange(N) + rand * 0.99))
    return (rand_shift * pulse_size).astype(np.int64)


def get_random_shifts(N: int, sparsity_vect, pulse_size: int = 1,
                      generator=None) -> np.ndarray:
    """Random non-overlapping integer shifts per stage, an int numpy array
    (n_stages, N): static by design."""
    generator = next_key(generator)
    sparsity_vect = np.asarray(sparsity_vect, dtype=np.float64)
    n_stages = sparsity_vect.shape[0]
    rand = torch.rand((n_stages, N), generator=generator).numpy()
    shifts = np.zeros((n_stages, N), dtype=np.int64)
    ps = float(pulse_size)
    for k in range(n_stages):
        temp = np.floor(sparsity_vect[k] * (np.arange(N) + rand[k] * 0.99))
        shifts[k, :] = (temp * ps).astype(np.int64)
        ps = ps * N * sparsity_vect[k]
    return shifts


def shift_matrix_static(X: torch.Tensor, shift,
                        direction: str = "left") -> torch.Tensor:
    """Delay the rows (left) or columns (right) of a polynomial matrix
    (N, N, T) by static integer shifts, zero-padded to length
    T + max(shift)."""
    shift = [int(s) for s in np.asarray(shift).reshape(-1)]
    if X.ndim == 2:
        X = X[:, :, None]
    extra = max(shift)
    if direction.lower() == "left":
        return torch.stack([torch.nn.functional.pad(X[i], (s, extra - s))
                            for i, s in enumerate(shift)], dim=0)
    return torch.stack([torch.nn.functional.pad(X[:, j], (s, extra - s))
                        for j, s in enumerate(shift)], dim=1)


# the JAX package's alias of the same function
shift_matrix = shift_matrix_static


def poly_matrix_conv(A, B) -> torch.Tensor:
    """Polynomial matrix product C(z) = A(z) B(z) by FFT-domain matmuls.

    A: (Na, K, Ta) or (Na, K); B: (K, Nb, Tb) or (K, Nb).  Returns
    (Na, Nb, Ta + Tb - 1) real, on A's device."""
    A = torch.as_tensor(A)
    B = torch.as_tensor(B, device=A.device)
    if A.ndim == 2:
        A = A[:, :, None]
    if B.ndim == 2:
        B = B[:, :, None]
    if A.shape[1] != B.shape[0]:
        raise ValueError("Invalid matrix dimension.")
    Tc = A.shape[2] + B.shape[2] - 1
    nfft = 1 << max(1, (Tc - 1).bit_length())
    Af = torch.fft.rfft(A, n=nfft, dim=2)  # (Na, K, F)
    Bf = torch.fft.rfft(B, n=nfft, dim=2)  # (K, Nb, F)
    Cf = torch.einsum("ikf,kjf->ijf", Af, Bf)
    return torch.fft.irfft(Cf, n=nfft, dim=2)[..., :Tc]


class ScatteringMapping:
    """Orthogonal -> paraunitary map via sparse scattering: U (K+1, N, N)
    orthogonal stages -> V (T, N, N) FIR filter matrix.  Per stage
    ``V <- (U_k diag(g^shift)) * shift(V)`` with the static shifts, then
    the final m_L (rows) and m_R (columns) shifts."""

    def __init__(self, N: int, n_stages: int = 3, sparsity: int = 3,
                 gain_per_sample: float = 0.9999, pulse_size: int = 1,
                 m_L=None, m_R=None, dtype: torch.dtype = torch.float32,
                 generator=None):
        self.N = N
        self.n_stages = n_stages
        self.sparsity = sparsity
        self.gain_per_sample = float(gain_per_sample)
        self.pulse_size = pulse_size
        self.dtype = dtype
        zeros = np.zeros(N, dtype=np.int64)
        self.m_L = tuple(int(v) for v in (zeros if m_L is None else m_L))
        self.m_R = tuple(int(v) for v in (zeros if m_R is None else m_R))
        sparsity_vect = np.ones(n_stages)
        if n_stages > 0:
            sparsity_vect[0] = sparsity
        shifts = get_random_shifts(N, sparsity_vect, pulse_size,
                                   generator=generator)
        self.shifts = tuple(tuple(int(v) for v in row) for row in shifts)

    @property
    def output_length(self) -> int:
        """Total FIR length."""
        total = 0
        if self.shifts:
            total = int(np.asarray(self.shifts).sum(axis=0).max())
        return total + 1 + max(self.m_L) + max(self.m_R)

    def __call__(self, U: torch.Tensor) -> torch.Tensor:
        """U (K+1, N, N) -> V (T, N, N)."""
        K = self.n_stages + 1
        if U.shape[0] != K:
            raise AssertionError(
                "The input matrix must have n_stages+1 stages")
        if U.shape[1] != U.shape[2]:
            raise AssertionError("The input matrix must be square")
        V = U[0][:, :, None]  # (N, N, 1)
        for k in range(1, K):
            shift = self.shifts[k - 1]
            g = torch.tensor(self.gain_per_sample ** np.asarray(shift),
                             dtype=self.dtype, device=U.device)
            R = U[k] * g[None, :]  # U_k diag(g^shift)
            V = shift_matrix_static(V, shift, direction="left")
            # order-0 polynomial product: a matmul over channels per tap
            V = torch.einsum("ik,kjt->ijt", R, V)
        V = shift_matrix_static(V, self.m_L, direction="left")
        V = shift_matrix_static(V, self.m_R, direction="right")
        return V.permute(2, 0, 1)  # (T, N, N)


def cascaded_paraunit_matrix(U: torch.Tensor, n_stages: int = 3,
                             gain_per_sample: float = 0.9999,
                             sparsity: int = 3, pulse_size: int = 1,
                             m_L=None, m_R=None,
                             dtype: torch.dtype = torch.float32,
                             generator=None) -> torch.Tensor:
    """Functional twin of :class:`ScatteringMapping`: the paraunitary
    (T, N, N) FIR matrix of the (n_stages + 1, N, N) orthogonal stages U,
    complex, its shifts drawn from ``generator``."""
    mapping = ScatteringMapping(U.shape[-1], n_stages=n_stages,
                                sparsity=sparsity,
                                gain_per_sample=gain_per_sample,
                                pulse_size=pulse_size, m_L=m_L, m_R=m_R,
                                dtype=dtype, generator=generator)
    return to_complex(mapping(U))
