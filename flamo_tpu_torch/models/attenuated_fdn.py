"""The attenuated-FDN workload (counterpart of
``flamo_tpu/models/attenuated_fdn.py``; the reference's e8_fdn
room-matching reverberator): delays feed forward, Series(orthogonal
mixing, per-delay-line GEQ attenuation) feeds back.

Beside the module-graph path this file wires the fused step kernel K5
(:func:`flamo_tpu_torch.ops.sos_kernels.fdn_sos_tf_mse`): the GEQ band
design ((K, N) scalars) runs in PyTorch every step, and the cascade, the
loop solve, the loss and every cotangent run in one kernel pass.
Training mutates the model in place, as in ``colorless_fdn``.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch

from flamo_tpu_torch.core import TopologyMismatch, masked_optimizer
from flamo_tpu_torch.models.colorless_fdn import siso_fdn_operands
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.sos_kernels import fdn_sos_tf_mse
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import next_key, resolve_device

DEFAULT_DELAYS = (887, 911, 941, 1699, 1951, 2053)


def _sigmoid_db_map(p):
    """Command-gain map of the attenuation GEQ: raw param -> sigmoid in
    (0, 1) -> dB (always attenuating)."""
    return 20 * torch.log10(torch.sigmoid(p))


def build_attenuated_fdn(nfft: int = 96000, delays=DEFAULT_DELAYS,
                         octave_interval: int = 1,
                         alias_decay_db: float = 0.0,
                         dtype: torch.dtype = torch.float32,
                         solve_method: str = "ge",
                         cascade_backend: str = "xla",
                         cache_delays: bool = False, generator=None,
                         device=None) -> system.Shell:
    """Shell(FFT -> [Gain(N,1), Recursion(parallelDelay,
    Series(orthogonal Matrix, sigmoid-mapped parallelGEQ)), Gain(1,N)]) on
    ``device`` (default: the CUDA card).

    ``cache_delays=True`` wraps the frozen delay lines in
    :class:`dsp.CachedResponse`; ``solve_method='pallas'`` sends the loop
    solve to kernel K2 (the GEQ diagonal folds into D) and
    ``cascade_backend='pallas'`` the GEQ cascade to kernel K4."""
    device = resolve_device(device)
    generator = next_key(generator)
    N = len(delays)
    common = dict(nfft=nfft, alias_decay_db=alias_decay_db, dtype=dtype,
                  generator=generator, device=device)
    dl = dsp.parallelDelay(size=(N,), max_len=int(max(delays)), isint=True,
                           requires_grad=False, **common)
    dl.assign_value(dl.sample2s(torch.tensor(delays, dtype=dtype)))
    if cache_delays:
        dl = dsp.CachedResponse(dl)
    mix = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                     requires_grad=True, **common)
    att = dsp.parallelGEQ(size=(N,), octave_interval=octave_interval,
                          fs=48000, map=_sigmoid_db_map, requires_grad=True,
                          cascade_backend=cascade_backend, **common)
    fb = system.Series(OrderedDict(
        {"mixing_matrix": mix, "attenuation": att}))
    loop = system.Recursion(fF=dl, fB=fb, solve_method=solve_method)
    core = system.Series(OrderedDict({
        "input_gain": dsp.Gain(size=(N, 1), requires_grad=True, **common),
        "feedback_loop": loop,
        "output_gain": dsp.Gain(size=(1, N), requires_grad=True, **common),
    }))
    return system.Shell(core=core, input_layer=dsp.FFT(nfft, dtype=dtype))


def attenuated_loss(model, inputs, targets):
    """Magnitude MSE through the module graph."""
    return torch.mean((torch.abs(model(inputs)) - targets) ** 2)


def extract_attenuated_operands(model):
    """(D (M, N) complex, bt, at (3, K, N), U (N, N), b (N,), c (N,)) of
    a Shell whose core is Series(Gain(N,1), Recursion(diagonal
    feedforward, Series(mixing_matrix Matrix, attenuation parallelGEQ)),
    Gain(1,N)), for :func:`fdn_sos_tf_mse`.  bt/at are the GEQ taps with
    the alias envelope folded in, so gradients reach the command gains
    through the band design by ordinary autograd.  Raises
    :class:`TopologyMismatch` for any other structure."""
    fn = "extract_attenuated_operands"
    loop, D, b, c = siso_fdn_operands(model, fn)
    N = D.shape[-1]
    fb = loop.feedback
    if not (isinstance(fb, system.Series)
            and fb.keys == ("mixing_matrix", "attenuation")
            and isinstance(fb.attenuation, dsp.parallelGEQ)):
        raise TopologyMismatch(
            f"{fn} needs a feedback Series(mixing_matrix, attenuation "
            "(a parallelGEQ))")
    rU = system._matrix_response_of(fb.mixing_matrix)
    if rU is None or rU[0] != linop.FLAT or tuple(rU[1].shape) != (N, N):
        raise TopologyMismatch(f"{fn} needs a frequency-flat ({N}, {N}) "
                               "mixing matrix")
    att = fb.attenuation
    bt, at = att.sos_taps(att.map(att.param))
    return D, bt, at, torch.real(rU[1]), b, c


def attenuated_loss_fused_step(model, inputs, targets, pivot: bool = False):
    """:func:`attenuated_loss` through the fused step kernel K5: the
    cascade, the loop solve, |tf X|, the loss and all cotangents in one
    pass; only the GEQ band design and the parameter maps (expm, sigmoid)
    stay outside.  Needs inputs (1, T, 1) and targets (1, M, 1)."""
    if (inputs.shape[0] != 1 or inputs.shape[-1] != 1
            or targets.shape[0] != 1 or targets.shape[-1] != 1):
        raise ValueError("fused_step needs batch == channels == 1, got "
                         f"inputs {tuple(inputs.shape)}, targets "
                         f"{tuple(targets.shape)}")
    D, bt, at, U, b, c = extract_attenuated_operands(model)
    X = torch.fft.rfft(inputs[0, :, 0], n=model.nfft)
    loop = model.get_core().feedback_loop
    ff_trainable = bool(getattr(loop.feedforward, "trainable", False))
    return fdn_sos_tf_mse(D.contiguous(), bt, at, U, b, c, X,
                          targets[0, :, 0], nfft=model.nfft,
                          with_dbar=ff_trainable, pivot=pivot)


def attenuated_train_step(model, lr: float = 1e-4, fused_step: bool = False,
                          step_pivot: bool = False):
    """Build ``(step, optimizer)``: ``step(inputs, targets)`` takes one
    Adam step on the trainable parameters of ``model`` (in place) and
    returns the loss before it.  ``fused_step=True`` swaps the forward for
    :func:`attenuated_loss_fused_step` (``step_pivot`` picks its pivoted
    variant)."""
    opt = masked_optimizer(model, lr=lr)
    loss_fn = (functools.partial(attenuated_loss_fused_step,
                                 pivot=step_pivot)
               if fused_step else attenuated_loss)

    def step(inputs, targets):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, inputs, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt
