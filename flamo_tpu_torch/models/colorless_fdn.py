"""The colorless-FDN workload (counterpart of
``flamo_tpu/models/colorless_fdn.py``; arXiv:2402.11216 'Optimizing Tiny
Colorless Feedback Delay Networks').

N = 6 FDN, delays (887, 911, 941, 1699, 1951, 2053), 30 dB alias decay,
learnable orthogonal feedback, trained so that the magnitude response is
flat (mse against ones + 0.2 x sparsity of the mixing matrix).

Training mutates the model in place (``nn.Module`` parameters and a
``torch.optim.Adam``) where the JAX package returns new pytrees.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch

from flamo_tpu_torch.core import TopologyMismatch, masked_optimizer
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.fdn_kernels import fdn_tf, fdn_tf_mse
from flamo_tpu_torch.optimize.loss import mse_loss, sparsity_loss
from flamo_tpu_torch.optimize.utils import run_in_chunks
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import next_key, resolve_device

DEFAULT_DELAYS = (887, 911, 941, 1699, 1951, 2053)


def build_colorless_fdn(nfft: int = 96000, delays=DEFAULT_DELAYS,
                        alias_decay_db: float = 30.0,
                        dtype: torch.dtype = torch.float32,
                        cache_delays: bool = False,
                        solve_method: str = "ge", generator=None,
                        device=None) -> system.Shell:
    """Shell(FFT -> [Gain(N,1), Recursion(parallelDelay, orthogonal
    Matrix), Gain(1,N)] -> abs) on ``device`` (default: the CUDA card).

    ``cache_delays=True`` wraps the frozen delay lines in
    :class:`dsp.CachedResponse`; ``solve_method='pallas'`` sends the loop
    solve to the fused FDN kernel K2."""
    device = resolve_device(device)
    generator = next_key(generator)
    N = len(delays)
    common = dict(nfft=nfft, alias_decay_db=alias_decay_db, dtype=dtype,
                  generator=generator, device=device)
    input_gain = dsp.Gain(size=(N, 1), requires_grad=True, **common)
    output_gain = dsp.Gain(size=(1, N), requires_grad=True, **common)
    delay_mod = dsp.parallelDelay(size=(N,), max_len=int(max(delays)),
                                  isint=True, requires_grad=False, **common)
    delay_mod.assign_value(
        delay_mod.sample2s(torch.tensor(delays, dtype=dtype)))
    if cache_delays:
        delay_mod = dsp.CachedResponse(delay_mod)
    feedback = dsp.Matrix(size=(N, N), matrix_type="orthogonal",
                          requires_grad=True, **common)
    feedback_loop = system.Recursion(fF=delay_mod, fB=feedback,
                                     solve_method=solve_method)
    core = system.Series(OrderedDict({
        "input_gain": input_gain,
        "feedback_loop": feedback_loop,
        "output_gain": output_gain,
    }))
    return system.Shell(core=core, input_layer=dsp.FFT(nfft, dtype=dtype),
                        output_layer=dsp.Transform(torch.abs, dtype=dtype))


_MSE = mse_loss()
_SPARSITY = sparsity_loss()


def colorless_loss(model, inputs, targets, sparsity_weight: float = 0.2):
    """mse + 0.2 * sparsity through the module graph."""
    est = model(inputs)
    return _MSE(est, targets) + sparsity_weight * _SPARSITY(est, targets,
                                                           model)


def siso_fdn_operands(model, fn: str):
    """(loop, D (M, N) complex, b (N,) real, c (N,) real) of a Shell whose
    core is Series(input_gain Gain(N, 1), feedback_loop Recursion with a
    diagonal feedforward, output_gain Gain(1, N)), the part that the fused
    FDN objectives share.  Raises :class:`TopologyMismatch`, naming
    ``fn``, for any other structure."""
    core = model.get_core() if isinstance(model, system.Shell) else None
    if not (isinstance(core, system.Series)
            and core.keys == ("input_gain", "feedback_loop", "output_gain")
            and isinstance(core.feedback_loop, system.Recursion)):
        raise TopologyMismatch(
            f"{fn} needs a Shell whose core is Series(input_gain, "
            "feedback_loop (a Recursion), output_gain)")
    loop = core.feedback_loop
    rD = system._matrix_response_of(loop.feedforward)
    if rD is None or rD[0] != linop.DIAG:
        raise TopologyMismatch(
            f"{fn} needs a diagonal feedforward, got matrix_response kind "
            f"{None if rD is None else rD[0]!r}")
    N = rD[1].shape[-1]
    rb = system._matrix_response_of(core.input_gain)
    rc = system._matrix_response_of(core.output_gain)
    if (rb is None or rc is None or rb[0] != linop.FLAT
            or rc[0] != linop.FLAT or tuple(rb[1].shape) != (N, 1)
            or tuple(rc[1].shape) != (1, N)):
        raise TopologyMismatch(
            f"{fn} needs frequency-flat gains ({N}, 1) in and (1, {N}) out")
    D = rD[1].expand(model.nfft // 2 + 1, N)
    return loop, D, torch.real(rb[1])[:, 0], torch.real(rc[1])[0, :]


def extract_siso_tf_operands(model):
    """(D (M, N) complex, U (N, N) real, b (N,), c (N,)) of a Shell whose
    core is Series(Gain(N,1), Recursion(diagonal feedforward, frequency-
    flat (N, N) feedback), Gain(1,N)), such that
    tf = c^T (I - diag(D) U)^{-1} diag(D) b.  Raises
    :class:`TopologyMismatch` for any other structure."""
    loop, D, b, c = siso_fdn_operands(model, "extract_siso_tf_operands")
    N = D.shape[-1]
    rU = system._matrix_response_of(loop.feedback)
    if rU is None or rU[0] != linop.FLAT or tuple(rU[1].shape) != (N, N):
        raise TopologyMismatch(
            "extract_siso_tf_operands needs a frequency-flat (N, N) "
            f"feedback, got matrix_response kind "
            f"{None if rU is None else rU[0]!r}")
    return D, torch.real(rU[1]), b, c


def colorless_freq_response_fused(model):
    """``Shell.get_freq_response`` of the SISO FDN through the fused
    transfer-function kernel K3f, then the alias-undo round trip
    (irfft -> gamma^{-n} -> rfft).  Returns (1, M, 1) complex."""
    tf = fdn_tf(*extract_siso_tf_operands(model))
    env = dsp._alias_envelope(model.nfft, float(model.alias_decay_db),
                              tf.real.dtype, device=tf.device)
    h = torch.fft.irfft(tf, n=model.nfft) * env
    return torch.fft.rfft(h, n=model.nfft)[None, :, None]


def colorless_loss_fused_tf(model, inputs, targets,
                            sparsity_weight: float = 0.2):
    """:func:`colorless_loss` through the transfer-function kernel (K3f
    forward, K3b gradient)."""
    tf = fdn_tf(*extract_siso_tf_operands(model))
    if (inputs.shape[0] == 1 and inputs.shape[-1] == 1
            and targets.shape[0] == 1 and targets.shape[-1] == 1):
        X = torch.fft.rfft(inputs[0, :, 0], n=model.nfft)
        est = torch.abs(tf * X)
        mse = torch.mean((est - targets[0, :, 0]) ** 2)
    else:
        X = torch.fft.rfft(inputs, n=model.nfft, dim=1)
        est = torch.abs(tf[None, :, None] * X)
        mse = _MSE(est, targets)
    return mse + sparsity_weight * _SPARSITY(est, targets, model)


def colorless_loss_fused_step(model, inputs, targets,
                              sparsity_weight: float = 0.2,
                              pivot: bool = True):
    """:func:`colorless_loss` through the fused step kernel K1: the mse
    and its U/b/c (and D, for trainable delays) cotangents in one pass;
    only the sparsity term stays outside.  Needs inputs (1, T, 1) and
    targets (1, M, 1)."""
    if (inputs.shape[0] != 1 or inputs.shape[-1] != 1
            or targets.shape[0] != 1 or targets.shape[-1] != 1):
        raise ValueError("fused_step needs batch == channels == 1, got "
                         f"inputs {tuple(inputs.shape)}, targets "
                         f"{tuple(targets.shape)}")
    D, U, b, c = extract_siso_tf_operands(model)
    X = torch.fft.rfft(inputs[0, :, 0], n=model.nfft)
    loop = model.get_core().feedback_loop
    ff_trainable = bool(getattr(loop.feedforward, "trainable", False))
    mse = fdn_tf_mse(D.contiguous(), U, b, c, X, targets[0, :, 0],
                     with_dbar=ff_trainable, pivot=pivot)
    return mse + sparsity_weight * _SPARSITY(None, None, model)


def colorless_train_step(model, lr: float = 1e-3, fused_tf: bool = False,
                         fused_step: bool = False, step_pivot: bool = True):
    """Build ``(step, optimizer)``: ``step(inputs, targets)`` takes one
    Adam step on the trainable parameters of ``model`` (in place) and
    returns the loss before it.

    ``fused_tf`` swaps the forward for :func:`colorless_loss_fused_tf`,
    ``fused_step`` for :func:`colorless_loss_fused_step` (with
    ``step_pivot=False`` the no-pivot, factor-reusing variant)."""
    opt = masked_optimizer(model, lr=lr)
    loss_fn = colorless_loss
    if fused_step:
        loss_fn = functools.partial(colorless_loss_fused_step,
                                    pivot=step_pivot)
    elif fused_tf:
        loss_fn = colorless_loss_fused_tf

    def step(inputs, targets):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, inputs, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


def colorless_fit(model, n_steps: int, lr: float = 1e-3,
                  fused_step: bool = True, step_pivot: bool = False,
                  steps_per_call: int = 400):
    """Train ``n_steps`` Adam steps of the colorless objective on the
    canonical impulse -> flat-magnitude pair, through the fused step
    kernel by default.  The steps run in chunks of ``steps_per_call``, the
    JAX package's ``lax.scan`` length: a chunk's losses stay on the device
    and reach the host once, at its end, and exactly ``n_steps`` steps
    run.  ``steps_per_call`` changes only how often the host syncs, not
    the result.  Returns ``(model, per-step loss history as numpy)``."""
    step, _ = colorless_train_step(model, lr=lr, fused_step=fused_step,
                                   step_pivot=step_pivot)
    inputs, targets = impulse_pair(model)
    history = run_in_chunks(lambda i: step(inputs, targets), n_steps,
                            steps_per_call)
    return model, history


def impulse_pair(model):
    """The canonical (1, M, 1) impulse input and flat target on the
    model's device."""
    M = model.nfft // 2 + 1
    inputs = torch.zeros((1, M, 1), device=model.device)
    inputs[:, 0, :] = 1.0
    return inputs, torch.ones((1, M, 1), device=model.device)
