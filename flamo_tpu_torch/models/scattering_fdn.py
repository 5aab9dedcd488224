"""The scattering-FDN workload (counterpart of
``flamo_tpu/models/scattering_fdn.py``; the reference's
e8_colorless_sfdn): a colorless FDN whose feedback is a learnable
paraunitary ScatteringMatrix (Schlecht & Habets, 'Scattering in Feedback
Delay Networks') instead of a frequency-flat orthogonal matrix.

The scenario: N = 6, delays (997, 1153, 1327, 1559, 1801, 2099),
nfft = 96000, 30 dB alias decay, feedback ScatteringMatrix(size=(4, N, N),
gain_per_sample=1, sparsity=3, random m_L/m_R in [1, min(delays)//2)),
trained with masked_mse(n_samples=2000, n_sets=1, regenerate_mask=True)
+ 0.2 sparsity.

The feedback's response is a full (M, N, N) complex matrix per bin, so
the closed loop is a dense per-bin solve: with ``solve_method='pallas'``
the dense kernel K6 (:func:`flamo_tpu_torch.ops.fdn_kernels.dense_solve`).
The masked step assembles and solves the loop only at the step's masked
bins.  Training mutates the model in place, as in ``colorless_fdn``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.models.colorless_fdn import impulse_pair
from flamo_tpu_torch.ops.solve import closed_loop_solve
from flamo_tpu_torch.optimize.loss import masked_mse_loss, sparsity_loss
from flamo_tpu_torch.optimize.utils import run_in_chunks
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import next_key, resolve_device

DEFAULT_SFDN_DELAYS = (997, 1153, 1327, 1559, 1801, 2099)


def build_colorless_sfdn(nfft: int = 96000, delays=DEFAULT_SFDN_DELAYS,
                         n_stages: int = 3, sparsity: int = 3,
                         gain_per_sample: float = 1.0,
                         alias_decay_db: float = 30.0,
                         dtype: torch.dtype = torch.float32,
                         solve_method: str = "ge", generator=None,
                         device=None) -> system.Shell:
    """Shell(FFT -> [Gain(N,1), Recursion(parallelDelay, ScatteringMatrix),
    Gain(1,N)] -> abs) on ``device`` (default: the CUDA card).  m_L and m_R
    are drawn from ``generator`` in [1, min(delays)//2)."""
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
    m_hi = max(2, int(min(delays)) // 2)
    m_L = torch.randint(1, m_hi, (N,), generator=generator).numpy()
    m_R = torch.randint(1, m_hi, (N,), generator=generator).numpy()
    feedback = dsp.ScatteringMatrix(
        size=(n_stages + 1, N, N), sparsity=sparsity,
        gain_per_sample=gain_per_sample, m_L=m_L, m_R=m_R,
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


_SPARSITY = sparsity_loss()


def _masks(model, n_samples: int, generator):
    return masked_mse_loss(nfft=model.nfft, n_samples=n_samples, n_sets=1,
                           regenerate_mask=True, generator=generator,
                           device=model.device)


def sfdn_train_step(model, lr: float = 1e-3, n_samples: int = 2000,
                    sparsity_weight: float = 0.2, generator=None):
    """Build ``(step, optimizer)`` for the objective masked_mse(n_samples,
    n_sets=1, regenerate_mask=True) + 0.2 sparsity through the module
    graph (the loop solved at every bin).  ``step(inputs, targets, i)``
    takes one Adam step in place and returns the loss before it; ``i``,
    the step index, selects the mask."""
    opt = masked_optimizer(model, lr=lr)
    ml = _masks(model, n_samples, generator)

    def step(inputs, targets, i):
        opt.zero_grad(set_to_none=True)
        est = model(inputs)
        loss = (ml(est, targets, step=i)
                + sparsity_weight * _SPARSITY(est, targets, model))
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


def sfdn_masked_loss(m, X, targets, mask, sparsity_weight: float = 0.2,
                     solve_method: str = "ge_cached"):
    """The sfdn objective evaluated only at the masked bins: masked_mse
    reads ``n_samples`` of the M bins per step and sparsity reads the
    scattering parameters, so the loop is solved at the (P,) bins ``mask``
    only (:func:`sfdn_masked_est`).  ``X`` is the input spectrum
    ``input_layer(inputs)`` (B, M, C)."""
    est = sfdn_masked_est(m, X, mask, solve_method=solve_method)
    mse = torch.mean((est - targets[:, mask, 0]) ** 2)
    return mse + sparsity_weight * _SPARSITY(None, None, m)


def sfdn_masked_est(m, X, mask, solve_method: str = "ge_cached"):
    """``abs(model(inputs))[:, mask, 0]`` computed only at the masked bins,
    for a SISO Shell whose loop is diagonal delays x a full
    frequency-dependent feedback.  The scattering response comes from the
    exact-phase DFT contraction and the delays from their closed-form
    phasor (``response_at``): no (M, ...) array is made.  Returns (B, P)."""
    core = m.get_core()
    loop = core.feedback_loop
    S = loop.feedback.response_at(mask)           # (P, N, N) complex
    D = loop.feedforward.response_at(mask)        # (P, N) complex diagonal
    gi = core.input_gain.response()               # (N, 1) complex
    go = core.output_gain.response()              # (1, N) complex
    N = D.shape[-1]
    eye = torch.eye(N, dtype=S.dtype, device=S.device)
    A = eye - D[:, :, None] * S                   # (P, N, N)
    Xm = X[:, mask, 0]                            # (B, P)
    rhs = D[None] * (gi[None, None, :, 0] * Xm[:, :, None])   # (B, P, N)
    Ab = A[None].expand((rhs.shape[0],) + A.shape)
    y = closed_loop_solve(Ab, rhs, method=solve_method)
    return torch.abs(torch.einsum("n,bpn->bp", go[0], y))     # (B, P)


def sfdn_masked_train_step(model, lr: float = 1e-3, n_samples: int = 2000,
                           sparsity_weight: float = 0.2, generator=None,
                           solve_method: str = "ge_cached"):
    """The masked-bin counterpart of :func:`sfdn_train_step`: the same
    objective and mask schedule (the same ``generator`` gives the same
    masks), with the loop assembled and solved only at the step's
    ``n_samples`` masked bins.  ``solve_method='pallas'`` solves them with
    K6.  Same step signature ``step(inputs, targets, i)``."""
    opt = masked_optimizer(model, lr=lr)
    ml = _masks(model, n_samples, generator)

    def step(inputs, targets, i):
        i = int(i)
        mask = ml.masks_for_cycle(i // ml.n_masks)[i % ml.n_masks]
        X = model.input_layer(inputs)
        opt.zero_grad(set_to_none=True)
        loss = sfdn_masked_loss(model, X, targets, mask,
                                sparsity_weight=sparsity_weight,
                                solve_method=solve_method)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


def sfdn_fit(model, n_steps: int, lr: float = 1e-3, n_samples: int = 2000,
             steps_per_call: int = 100, generator=None, masked: bool = False,
             solve_method: str = "ge_cached"):
    """Train the scattering FDN on the canonical impulse -> flat pair.
    Returns ``(model, per-step loss history as numpy)``.

    ``masked=True`` goes through :func:`sfdn_masked_train_step` (the loop
    solved at each step's masked bins with ``solve_method``), else through
    :func:`sfdn_train_step` (the model's own solve).  The steps run in
    chunks of ``steps_per_call``, the JAX package's ``lax.scan`` length: a
    chunk's losses reach the host once, at its end, and exactly
    ``n_steps`` steps run.  ``steps_per_call`` changes only how often the
    host syncs, not the result."""
    if masked:
        step, _ = sfdn_masked_train_step(model, lr=lr, n_samples=n_samples,
                                         generator=generator,
                                         solve_method=solve_method)
    else:
        step, _ = sfdn_train_step(model, lr=lr, n_samples=n_samples,
                                  generator=generator)
    inputs, targets = impulse_pair(model)
    history = run_in_chunks(lambda i: step(inputs, targets, i), n_steps,
                            steps_per_call)
    return model, history
