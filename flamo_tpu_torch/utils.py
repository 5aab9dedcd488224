"""Small utilities (counterpart of ``flamo_tpu/utils.py``).

Devices are explicit: every entry point takes ``device=``, and the default
is the CUDA card.  Without one the default raises instead of silently
running on the CPU; pass ``device="cpu"`` to run there on purpose.

Randomness is an explicit ``torch.Generator``.  :func:`set_seed` /
:func:`next_key` keep the JAX package's convenience of a seeded global
stream: a constructor given no generator draws from the global one.
Parameters are always drawn on the CPU and then moved, so a seed gives
the same weights on every device.

WAV files are written and read by :func:`save_audio` / :func:`load_audio`.
"""

from __future__ import annotations

import itertools
import os
import wave

import numpy as np
import torch

_GLOBAL_GENERATOR = [torch.Generator().manual_seed(0)]


def default_device() -> str:
    """``"cuda"`` when a CUDA card is visible; raises otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flamo_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly.")
    return "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return torch.device(default_device() if device is None else device)


def set_seed(seed: int) -> None:
    """Seed the global generator (counterpart of ``flamo_tpu.set_seed``)."""
    _GLOBAL_GENERATOR[0] = torch.Generator().manual_seed(int(seed))


def next_key(generator: torch.Generator | None = None) -> torch.Generator:
    """Return ``generator`` if given, else the global seeded generator."""
    return generator if generator is not None else _GLOBAL_GENERATOR[0]


def complex_dtype_for(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def to_complex(x: torch.Tensor) -> torch.Tensor:
    """Real -> complex with zero imaginary part."""
    if x.is_complex():
        return x
    return x.to(complex_dtype_for(x.dtype))


def get_frequency_samples(num: int, rho: float = 1.0,
                          dtype: torch.dtype = torch.float32,
                          device=None) -> torch.Tensor:
    """Points on the circle of radius ``rho``, angles in [0, pi]."""
    angle = torch.linspace(0.0, 1.0, num, dtype=dtype,
                           device=resolve_device(device))
    return rho * torch.exp(1j * angle * torch.pi)


# ----------------------------------------------------------------------
# differentiable regular-grid interpolation
# ----------------------------------------------------------------------
class RegularGridInterpolator:
    """Multilinear interpolation on a regular grid, differentiable in the
    values: ``points`` is one increasing 1-D grid per dimension and
    ``values`` (*grid, *batch) their samples, any trailing dimensions
    interpolated together.  A query point is bracketed by
    ``searchsorted(side="right")`` and blended from its corners; a point
    on a grid node takes that node's value."""

    def __init__(self, points, values):
        if not isinstance(points, (tuple, list)):
            raise AssertionError("points must be a tuple or a list")
        self.values = torch.as_tensor(values)
        self.points = [torch.as_tensor(p, device=self.values.device)
                       for p in points]
        self.n = len(self.points)
        if self.values.ndim < self.n:
            raise AssertionError("values have fewer dimensions than points")
        for i, p in enumerate(self.points):
            if p.shape[0] != self.values.shape[i]:
                raise AssertionError(f"grid {i} has {p.shape[0]} points, "
                                     f"values {self.values.shape[i]}")

    def __call__(self, points_to_interp):
        if len(points_to_interp) != self.n:
            raise AssertionError(f"{self.n} coordinates needed, got "
                                 f"{len(points_to_interp)}")
        idxs, dists, overalls = [], [], []
        for p, x in zip(self.points, points_to_interp):
            x = torch.as_tensor(x, device=p.device)
            last = p.shape[0] - 1
            idx_right = torch.clamp(
                torch.searchsorted(p, x.contiguous(), right=True), 0, last)
            idx_left = torch.clamp(idx_right - 1, 0, last)
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            dist_left = torch.maximum(x - p[idx_left], zero)
            dist_right = torch.maximum(p[idx_right] - x, zero)
            # a node that brackets itself: both distances 1, so that the
            # blend takes its value and the division has a gradient
            both_zero = (dist_left == 0) & (dist_right == 0)
            dist_left = torch.where(both_zero, 1.0, dist_left)
            dist_right = torch.where(both_zero, 1.0, dist_right)
            idxs.append((idx_left, idx_right))
            dists.append((dist_left, dist_right))
            overalls.append(dist_left + dist_right)
        batch = (1,) * (self.values.ndim - self.n)

        def col(w):  # a weight against the trailing batch dimensions
            return w.reshape(w.shape + batch)

        numerator = 0.0
        for corner in itertools.product([0, 1], repeat=self.n):
            at = tuple(idx[c] for c, idx in zip(corner, idxs))
            weight = torch.prod(torch.stack(
                [dist[1 - c] for c, dist in zip(corner, dists)]), dim=0)
            numerator = numerator + self.values[at] * col(weight)
        return numerator / col(torch.prod(torch.stack(overalls), dim=0))


# ----------------------------------------------------------------------
# audio IO: the standard library's ``wave`` for 24-bit PCM, scipy for the
# rest (no soundfile)
# ----------------------------------------------------------------------
def save_audio(filepath: str, x, fs: int = 48000,
               subtype: str = "PCM_24") -> None:
    """Write a WAV file.  ``subtype`` 'PCM_16'/'PCM_24'/'PCM_32' write
    integer samples ('PCM_24' as 3-byte little-endian frames), scaled down
    to a peak of 1 where it is above; 'FLOAT' writes float32 samples.  A
    tensor is copied to the host first."""
    from scipy.io import wavfile

    folder = os.path.dirname(filepath)
    if folder:
        os.makedirs(folder, exist_ok=True)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if subtype == "FLOAT":
        wavfile.write(filepath, int(fs), x.astype(np.float32))
        return
    peak = np.max(np.abs(x)) if x.size else 1.0
    if peak > 1.0:
        x = x / peak
    if subtype == "PCM_16":
        wavfile.write(filepath, int(fs), (x * (2**15 - 1)).astype(np.int16))
    elif subtype == "PCM_32":
        wavfile.write(filepath, int(fs), (x * (2**31 - 1)).astype(np.int32))
    elif subtype == "PCM_24":
        if x.ndim == 1:
            x = x[:, None]
        q = np.clip(np.round(x * (2**23 - 1)), -(2**23), 2**23 - 1)
        # the 3 low bytes of each little-endian int32 sample, interleaved
        b = np.frombuffer(q.astype("<i4").tobytes(),
                          dtype=np.uint8).reshape(-1, 4)[:, :3]
        with wave.open(filepath, "wb") as w:
            w.setnchannels(x.shape[1])
            w.setsampwidth(3)
            w.setframerate(int(fs))
            w.writeframes(b.tobytes())
    else:
        raise ValueError(f"unknown subtype {subtype!r}")


def load_audio(filepath: str):
    """Read a WAV file -> (float32 array in [-1, 1] of shape (T, C), fs).
    24-bit PCM is read with ``wave``, every other format with scipy."""
    try:
        with wave.open(filepath, "rb") as w:
            if w.getsampwidth() == 3:
                C = w.getnchannels()
                fs = w.getframerate()
                b = np.frombuffer(w.readframes(w.getnframes()),
                                  dtype=np.uint8).reshape(-1, 3)
                val = (b[:, 0].astype(np.int32)
                       | (b[:, 1].astype(np.int32) << 8)
                       | (b[:, 2].astype(np.int32) << 16))
                val = np.where(val >= 2**23, val - 2**24, val)
                return (val.astype(np.float32) / 2**23).reshape(-1, C), fs
    except wave.Error:
        pass  # float or compressed WAVs: scipy below
    from scipy.io import wavfile

    fs, data = wavfile.read(filepath)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 2**15
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2**31
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return data, fs
