"""Trainer-level fused-kernel dispatch (counterpart of
``flamo_tpu/models/dispatch.py``).

A user who builds a recognised FDN topology and trains it with
:class:`flamo_tpu_torch.optimize.Trainer` reaches the fused step kernels
that ``models.colorless_fit`` runs, without naming them.  This module is
the recognition half: map (model topology, registered criteria) onto the
fused objectives that compute the same loss.  The Trainer does the other
half, a one-time parity test of each candidate's first loss against the
module graph's (``Trainer._maybe_gate_fused``).

Recognised combinations (criterion order does not matter):

* ``mse_loss`` [+ ``sparsity_loss``] on a SISO FDN Shell whose loop is
  diagonal delays x a frequency-flat mixing matrix ->
  ``colorless_fused_step``: :func:`extract_siso_tf_operands`, then
  :func:`~flamo_tpu_torch.ops.fdn_kernels.fdn_tf_mse` (K1), no pivot;
* ``mse_loss`` on the attenuated-FDN topology (loop feedback =
  Series(mixing matrix, parallelGEQ)) -> ``attenuated_fused_step``:
  :func:`extract_attenuated_operands`, then
  :func:`~flamo_tpu_torch.ops.sos_kernels.fdn_sos_tf_mse` (K5), no pivot;
* ``masked_mse_loss`` [+ ``sparsity_loss``] on a SISO Shell whose loop is
  diagonal delays x a full frequency-dependent feedback (the scattering
  FDN) -> ``sfdn_masked_step``: :func:`sfdn_masked_est` on the step's
  masked bins with the pivoted ``ge_cached`` solve, plain PyTorch, so it
  is worth taking on the CPU too (``cpu_ok``).

The kernels run without pivoting, as in the JAX package: their loop
matrices are ``diag(D) U`` with unit-modulus or attenuated delays and an
orthogonal U, so ``||A||_2 <= 1`` and no leading pivot of ``I - A`` can
vanish unless the pivoted solve is singular too.  The Trainer watchdogs
the fused path all the same (``Trainer._check_fused_finite``).

Unlike the JAX package, recognition refuses a topology only on the
:class:`~flamo_tpu_torch.core.TopologyMismatch` that the ``extract_*``
functions raise, and catches nothing else: an error of a kernel's build
or launch propagates instead of silently training on the graph path.
"""

from __future__ import annotations

import torch

from flamo_tpu_torch.core import TopologyMismatch
from flamo_tpu_torch.models.attenuated_fdn import extract_attenuated_operands
from flamo_tpu_torch.models.colorless_fdn import (extract_siso_tf_operands,
                                                  siso_fdn_operands)
from flamo_tpu_torch.models.scattering_fdn import sfdn_masked_est
from flamo_tpu_torch.ops.fdn_kernels import fdn_tf_mse
from flamo_tpu_torch.ops.sos_kernels import fdn_sos_tf_mse
from flamo_tpu_torch.optimize.loss import (masked_mse_loss, mse_loss,
                                           sparsity_loss)
from flamo_tpu_torch.processor import dsp


def single_pair(inputs, targets) -> bool:
    """Whether a batch is the one (1, T, 1) -> (1, M, 1) pair that the
    fused objectives take."""
    return (inputs.shape[0] == 1 and inputs.shape[-1] == 1
            and targets.shape[0] == 1 and targets.shape[-1] == 1)


def _check_masked_topology(model) -> None:
    """Raise :class:`TopologyMismatch` unless ``model`` is a SISO FDN whose
    feedforward is a diagonal delay and whose feedback is a full
    (M, N, N) response that :func:`sfdn_masked_est` can evaluate at a set
    of bins."""
    fn = "the masked sfdn step"
    loop, D, _, _ = siso_fdn_operands(model, fn)
    M, N = D.shape
    ff, fb = loop.feedforward, loop.feedback
    if not isinstance(ff, dsp.Delay) or not isinstance(fb, dsp.Filter):
        raise TopologyMismatch(
            f"{fn} needs a Delay feedforward and a Filter feedback that "
            f"respond at single bins, got {type(ff).__name__} and "
            f"{type(fb).__name__}")
    with torch.no_grad():
        shape = tuple(fb.response().shape)
    if shape != (M, N, N):
        raise TopologyMismatch(f"{fn} needs a full ({M}, {N}, {N}) "
                               f"feedback response, got {shape}")


def recognize_fused(model, criterion, alpha, requires_model):
    """The fused-objective candidates ``(name, loss_fn, cpu_ok)`` for the
    Trainer's registered criteria, best first; empty if nothing matches.
    ``cpu_ok`` marks candidates worth taking on the CPU (plain PyTorch;
    the kernels' plain versions lose to the graph path there).

    ``loss_fn(model, inputs, targets, step, loss_state) -> (total, per)``
    mirrors ``Trainer._total_loss`` (``per`` in criterion order), so the
    Trainer can swap it in without touching its logs or early stop."""
    kinds = []
    for c, rm in zip(criterion, requires_model):
        if isinstance(c, mse_loss) and not rm:
            kinds.append("mse")
        elif isinstance(c, masked_mse_loss) and not rm:
            kinds.append("masked_mse")
        elif isinstance(c, sparsity_loss) and rm:
            kinds.append("sparsity")
        else:
            # an unknown criterion, or a known one registered with another
            # requires_model flag than the fused objectives' call shapes
            kinds.append(None)
    n_fit = kinds.count("mse") + kinds.count("masked_mse")
    if n_fit != 1 or None in kinds or kinds.count("sparsity") > 1:
        return []
    masked = "masked_mse" in kinds
    i_mse = kinds.index("masked_mse" if masked else "mse")
    a_mse = alpha[i_mse]
    i_sp = kinds.index("sparsity") if "sparsity" in kinds else None
    a_sp = alpha[i_sp] if i_sp is not None else 0.0
    sp_crit = criterion[i_sp] if i_sp is not None else None
    n = len(kinds)

    def finish(mse, model):
        """(total, per) from the fit term and the sparsity term."""
        per = [torch.zeros((), dtype=mse.dtype, device=mse.device)] * n
        per[i_mse] = mse
        total = a_mse * mse
        if i_sp is not None:
            sp = sp_crit(None, None, model)
            per[i_sp] = sp
            total = total + a_sp * sp
        return total, per

    if masked:
        try:
            _check_masked_topology(model)
        except TopologyMismatch:
            return []
        mm_crit = criterion[i_mse]
        # the index of masked_mse among the stateful criteria
        # (Trainer._gather_loss_state's order)
        si_mm = sum(1 for c in criterion[:i_mse]
                    if getattr(c, "stateful", False))

        def sfdn_loss_fn(model, inputs, targets, step, loss_state):
            if not single_pair(inputs, targets):
                raise ValueError("the masked sfdn step needs batch == "
                                 "channels == 1")
            # the mask of masked_mse_loss.__call__ at this step, so that
            # the schedule is the graph path's
            step = int(step)
            if mm_crit.regenerate_mask:
                mask = mm_crit.masks_for_cycle(
                    step // mm_crit.n_masks)[step % mm_crit.n_masks]
            else:
                masks = (mm_crit.mask_indices if loss_state is None
                         else loss_state[si_mm])
                mask = masks[step % masks.shape[0]]
            mask = mask.to(inputs.device)
            est = sfdn_masked_est(model, model.input_layer(inputs), mask)
            return finish(torch.mean((est - targets[:, mask, 0]) ** 2), model)

        return [("sfdn_masked_step", sfdn_loss_fn, True)]

    def make_loss(extract, kernel_mse):
        """``extract(model)`` pulls the kernel's operands, ``kernel_mse(
        operands, X, target, ff_trainable, model)`` runs the fused step
        kernel for the mse term."""

        def loss_fn(model, inputs, targets, step, loss_state):
            if not single_pair(inputs, targets):
                raise ValueError("the fused step needs batch == channels "
                                 "== 1")
            operands = extract(model)
            X = torch.fft.rfft(inputs[0, :, 0], n=model.nfft)
            loop = model.get_core().feedback_loop
            ff_tr = bool(getattr(loop.feedforward, "trainable", False))
            return finish(kernel_mse(operands, X, targets[0, :, 0], ff_tr,
                                     model), model)

        return loss_fn

    def colorless_mse(operands, X, target, ff_tr, model):
        D, U, b, c = operands
        return fdn_tf_mse(D.contiguous(), U, b, c, X, target,
                          with_dbar=ff_tr, pivot=False)

    def attenuated_mse(operands, X, target, ff_tr, model):
        D, bt, at, U, b, c = operands
        return fdn_sos_tf_mse(D.contiguous(), bt, at, U, b, c, X, target,
                              nfft=model.nfft, with_dbar=ff_tr, pivot=False)

    candidates = []
    for name, extract, kernel_mse in (
            ("colorless_fused_step", extract_siso_tf_operands, colorless_mse),
            ("attenuated_fused_step", extract_attenuated_operands,
             attenuated_mse)):
        try:
            with torch.no_grad():
                extract(model)
        except TopologyMismatch:
            continue
        candidates.append((name, make_loss(extract, kernel_mse), False))
    return candidates
