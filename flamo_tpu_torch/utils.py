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
