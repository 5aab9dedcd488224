"""The fused step kernels under bin sharding (counterpart of
``flamo_tpu/parallel/fused.py``).

Each rank runs a fused kernel on its own block of bins
(:func:`~flamo_tpu_torch.parallel.mesh.shard_block`): K1
(``fdn_tf_mse``) for the colorless FDN, K5 (``fdn_sos_tf_mse``) for the
attenuated FDN, K9 (``aa_taps_tf_mse``) for the active-acoustics
magnitude loss, K7 (``dk_roots_rows``, through ``poly_roots_rows``) for
its eigenvalue loss, and the dense solve (K6 on ``solve_method='pallas'``)
for the scattering FDN's masked loss.  Zero-padded bins are exact no-ops
(a zero delay row makes the loop the identity, against a zero target).

Kernels that make their phasor from the bin index (K5's cascade, K9's
DFT) take the block's first global bin as ``bin_offset``; the others take
explicit per-bin operands and need none.

How JAX's ``shard_map`` becomes torch here: a ``*_loss`` function
returns this rank's share of the loss, the kernel's local mean scaled by
``local bins / M`` as JAX scales it before its ``psum``, so the shares
of the axis sum to the loss.  A term that every rank holds whole (the
sparsity penalty) joins the share of the axis's first rank only, so it
enters the sum, and the gradient, once.  The ``make_*_step`` functions
differentiate the share, sum the replicated parameters' gradients over
the axis (:func:`~flamo_tpu_torch.parallel.mesh.allreduce_grads`), step
Adam (identical gradients keep the parameters identical on every rank)
and report the loss all-reduced, detached.  Each step returns
``(step, optimizer)`` and trains the model in place, as the port's
unsharded steps do.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.functional import poly_roots_rows
from flamo_tpu_torch.models.active_acoustics import (_charpoly_rows,
                                                     _mixer_taps,
                                                     _sort_rows,
                                                     aa_dft_basis,
                                                     aa_fused_operands)
from flamo_tpu_torch.models.attenuated_fdn import extract_attenuated_operands
from flamo_tpu_torch.models.colorless_fdn import (_SPARSITY,
                                                  extract_siso_tf_operands)
from flamo_tpu_torch.models.scattering_fdn import _masks
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.aa_kernels import aa_taps_tf_mse
from flamo_tpu_torch.ops.fdn_kernels import fdn_tf_mse
from flamo_tpu_torch.ops.solve import closed_loop_solve
from flamo_tpu_torch.ops.sos_kernels import fdn_sos_tf_mse
from flamo_tpu_torch.optimize.utils import generate_partitions
from flamo_tpu_torch.parallel.mesh import (allreduce_grads,
                                           axis_index, axis_size,
                                           replicate, same_on_axis,
                                           shard_block, take_block)

__all__ = ["bins_sharded_fused_loss", "make_bins_sharded_fused_step",
           "bins_sharded_attenuated_loss",
           "make_bins_sharded_attenuated_step",
           "make_bins_sharded_aa_taps_step",
           "make_bins_sharded_evs_step",
           "seed_bins_sharded_fused_loss",
           "make_seed_bins_sharded_fused_step",
           "masked_sharded_sfdn_loss",
           "make_masked_sharded_sfdn_step"]


def axis_sum(share: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The sum over the axis of a detached copy of ``share``."""
    total = share.detach().clone()
    dist.all_reduce(total, group=mesh.get_group(axis_name))
    return total


def _sharded_step(model, mesh, axis_name: str, lr: float, share_fn):
    """``(step, optimizer)``: ``step(*args)`` differentiates
    ``share_fn(*args)``, sums the gradients over the axis, takes an Adam
    step on the trainable parameters and returns the loss (the shares'
    sum, detached)."""
    replicate(model, mesh)
    opt = masked_optimizer(model, lr=lr)
    params = [p for g in opt.param_groups for p in g["params"]]

    def step(*args):
        opt.zero_grad(set_to_none=True)
        share = share_fn(*args)
        share.backward()
        allreduce_grads(params, mesh, axis_name)
        opt.step()
        return axis_sum(share, mesh, axis_name)

    return step, opt


def _blocks(mesh, axis_name: str, M: int, *rows, dim: int = 0):
    """``(offset, count, blocks)``: this rank's block of each of ``rows``
    (their bin axis ``dim`` of length M), zero-padded and contiguous."""
    offset, count = shard_block(M, mesh, axis_name)
    return offset, count, [take_block(r, offset, count, dim).contiguous()
                           for r in rows]


def _spectrum_pair(model, inputs, targets):
    """The canonical (1, T, 1) impulse's spectrum and the (1, M, 1)
    target as (M,) rows."""
    return (torch.fft.rfft(inputs[0, :, 0], n=model.nfft),
            targets[0, :, 0])


# ---------------------------------------------------------------------------
# the colorless FDN on K1
# ---------------------------------------------------------------------------
def bins_sharded_fused_loss(model, X, t, mesh, axis_name: str = "bins",
                            pivot: bool = True,
                            sparsity_weight: float = 0.2):
    """This rank's share of the colorless fused-step loss (mse through
    K1 on its block of bins, plus the sparsity term on the axis's first
    rank).  ``X``/``t`` are the (M,) input spectrum and target magnitude.
    The shares of the axis sum to
    :func:`~flamo_tpu_torch.models.colorless_fdn.colorless_loss_fused_step`
    up to float32 summation order."""
    D, U, b, c = extract_siso_tf_operands(model)
    M = D.shape[0]
    _, count, (Dl, Xl, tl) = _blocks(mesh, axis_name, M, D, X, t)
    share = fdn_tf_mse(Dl, U, b, c, Xl, tl, with_dbar=False,
                       pivot=pivot) * (count / M)
    if axis_index(mesh, axis_name) == 0:
        share = share + sparsity_weight * _SPARSITY(None, None, model)
    return share


def make_bins_sharded_fused_step(model, mesh, lr: float = 1e-3,
                                 axis_name: str = "bins",
                                 pivot: bool = True,
                                 sparsity_weight: float = 0.2):
    """``(step, optimizer)`` of the colorless workload with K1 on each
    rank's block of bins: ``step(inputs, targets)`` takes the canonical
    (1, T, 1) impulse and (1, M, 1) target, trains ``model`` in place and
    returns the loss before the step."""
    def share(inputs, targets):
        X, t = _spectrum_pair(model, inputs, targets)
        return bins_sharded_fused_loss(model, X, t, mesh, axis_name, pivot,
                                       sparsity_weight)

    return _sharded_step(model, mesh, axis_name, lr, share)


# ---------------------------------------------------------------------------
# the attenuated FDN on K5
# ---------------------------------------------------------------------------
def bins_sharded_attenuated_loss(model, X, t, mesh, axis_name: str = "bins",
                                 pivot: bool = False):
    """This rank's share of the attenuated-FDN fused-step loss (K5 on its
    block of bins, with the block's first global bin as ``bin_offset``:
    the kernel makes its cascade phasor from the bin index).  The shares
    sum to :func:`~flamo_tpu_torch.models.attenuated_fdn.
    attenuated_loss_fused_step` up to float32 summation order."""
    D, bt, at, U, b, c = extract_attenuated_operands(model)
    M = D.shape[0]
    offset, count, (Dl, Xl, tl) = _blocks(mesh, axis_name, M, D, X, t)
    loop = model.get_core().feedback_loop
    ff_trainable = bool(getattr(loop.feedforward, "trainable", False))
    return fdn_sos_tf_mse(Dl, bt, at, U, b, c, Xl, tl, nfft=model.nfft,
                          with_dbar=ff_trainable, pivot=pivot,
                          bin_offset=offset) * (count / M)


def make_bins_sharded_attenuated_step(model, mesh, lr: float = 1e-4,
                                      axis_name: str = "bins",
                                      pivot: bool = False):
    """``(step, optimizer)`` of the attenuated workload with K5 on each
    rank's block of bins; ``step(inputs, targets)`` as in
    :func:`make_bins_sharded_fused_step`."""
    def share(inputs, targets):
        X, t = _spectrum_pair(model, inputs, targets)
        return bins_sharded_attenuated_loss(model, X, t, mesh, axis_name,
                                            pivot)

    return _sharded_step(model, mesh, axis_name, lr, share)


# ---------------------------------------------------------------------------
# active acoustics: the magnitude loss on K9, the eigenvalue loss on K7
# ---------------------------------------------------------------------------
def make_bins_sharded_aa_taps_step(model, mesh, inputs, targets,
                                   lr: float = 1e-3, axis_name: str = "bins",
                                   pivot: bool = False,
                                   precision: str = "high"):
    """``(step, optimizer)`` of the active-acoustics magnitude loss with
    K9 on each rank's block of bins: the frozen rows of
    :func:`~flamo_tpu_torch.models.active_acoustics.aa_fused_operands`
    are computed once and cut to the block, and K9 takes the block's first
    global bin as ``bin_offset`` (a whole number; it makes its DFT basis
    from the bin index).  ``step()`` trains the mixer in place and returns
    the loss before the step, as
    :func:`~flamo_tpu_torch.models.active_acoustics.aa_fused_taps_step`
    does unsharded."""
    o = aa_fused_operands(model, inputs, targets)
    M = o["nfft"] // 2 + 1
    offset, count, rows = _blocks(mesh, axis_name, M,
                                  *(o[k] for k in ("hr", "hi", "rr", "ri",
                                                   "t")), dim=1)
    fb = model.get_core().feedback

    def share():
        return aa_taps_tf_mse(*rows[:2], _mixer_taps(fb), *rows[2:],
                              N=o["N"], L=o["L"], nfft=o["nfft"],
                              pivot=pivot, precision=precision,
                              bin_offset=offset) * (count / M)

    return _sharded_step(model, mesh, axis_name, lr, share)


def make_bins_sharded_evs_step(aa, target_evs, mesh, lr: float = 1e-3,
                               iter_num: int = 30, masks=None,
                               axis_name: str = "bins", generator=None):
    """``(step, optimizer)`` of the active-acoustics eigenvalue loss
    (:func:`~flamo_tpu_torch.models.active_acoustics.aa_evs_train_step`)
    with each partition's bins sharded over the axis: every rank keeps its
    block of every partition (so no step crosses a rank), builds the loop
    matrices of its block, and solves their characteristic polynomials
    with one K7 launch a step.  Padded bins get a benign diagonal
    spectrum diag(1, 2, ..., n_M) (a zero loop matrix would hand K7
    z^N, whose root pullback divides by zero) and are masked out of the
    loss, a squared-error sum over the true bins divided by their global
    count.

    ``masks`` and ``generator`` as in ``aa_evs_train_step``; every rank
    must hold the same partitions (checked).  ``step(i)`` takes one Adam
    step at global step i (partition ``i % n_parts``) and returns the loss
    before it; ``step.multi(step0, k)`` takes k steps from step0 and
    returns their (k,) losses."""
    model = aa.F_MM
    core = model.get_core()
    U = core["U"]
    nfft = model.nfft
    M = nfft // 2 + 1
    order, n_L, n_M = U.param.shape
    dev = U.param.device
    if masks is None:
        masks = generate_partitions(torch.arange(M), math.ceil(M / iter_num),
                                    1, generator=generator)
    masks = torch.as_tensor(masks).cpu().to(torch.int64)
    same_on_axis(masks, mesh, axis_name, "partitions")
    n_parts, n_samples = masks.shape
    offset, count = shard_block(n_samples, mesh, axis_name)
    local = masks[:, offset:offset + count]  # (n_parts, vc) true bins
    vc = local.shape[1]
    perm = local.reshape(-1)
    er, ei = (torch.from_numpy(b[:, perm.numpy()]).to(dev)
              for b in aa_dft_basis(order, nfft))
    perm = perm.to(dev)
    with torch.no_grad():
        kH, H = core["H_LM"].matrix_response()
        H = linop.materialize(kH, H, M, n_M, n_L)
        kR, R = core["R"].matrix_response()
        kG, G = core["G"].matrix_response()
        if kR != linop.DIAG or kG != linop.DIAG:
            raise ValueError("R and G must be diagonal (parallel) modules")
        rg = torch.broadcast_to(R * G, (M, n_L))
        Hrg = (H * rg[:, None, :]).permute(1, 2, 0).reshape(
            n_M * n_L, M)[:, perm]
        hr_all = torch.real(Hrg).contiguous()
        hi_all = torch.imag(Hrg).contiguous()
        tg = torch.as_tensor(target_evs, dtype=torch.float32, device=dev)
        tg_all = torch.sort(tg, dim=-1).values.T[:, perm]  # (n_M, ...)
    eyeb = torch.eye(n_M, dtype=torch.float32, device=dev)[..., None]
    # padded bins: the loop matrix diag(1, 2, ..., n_M) and no loss
    pad = count - vc
    safe = (eyeb * torch.arange(1, n_M + 1, dtype=torch.float32,
                                device=dev)[:, None, None]).expand(
        n_M, n_M, pad)
    valid = torch.cat([torch.ones(vc, device=dev),
                       torch.zeros(pad, device=dev)])

    def share(i: int):
        p = i % n_parts
        win = slice(p * vc, (p + 1) * vc)
        hr = hr_all[:, win].reshape(n_M, 1, n_L, vc)
        hi = hi_all[:, win].reshape(n_M, 1, n_L, vc)
        taps = _mixer_taps(U)
        ur = taps.T @ er[:, win]
        ui = taps.T @ ei[:, win]
        urt = ur.reshape(n_L, n_M, vc).permute(1, 0, 2)[None]
        uit = ui.reshape(n_L, n_M, vc).permute(1, 0, 2)[None]
        fr = torch.cat([(hr * urt - hi * uit).sum(dim=2), safe], -1)
        fi = torch.cat([(hr * uit + hi * urt).sum(dim=2),
                        torch.zeros_like(safe)], -1)
        mur = (fr * eyeb).sum((0, 1)) / n_M
        mui = (fi * eyeb).sum((0, 1)) / n_M
        br = fr - eyeb * mur
        bi = fi - eyeb * mui
        s = torch.clamp(torch.sqrt((br * br + bi * bi).sum((0, 1)) / n_M),
                        min=1e-30)
        cr, ci = _charpoly_rows(br / s, bi / s, n_M)
        zr, zi = poly_roots_rows(cr.contiguous(), ci.contiguous())
        evr = zr * s + mur
        evi = zi * s + mui
        mag = _sort_rows(torch.sqrt(evr * evr + evi * evi))
        tgw = take_block(tg_all[:, win], 0, count, dim=1)
        return (((mag - tgw) ** 2) * valid).sum() / (n_M * n_samples)

    step, opt = _sharded_step(model, mesh, axis_name, lr,
                              lambda i: share(int(i)))

    def multi(step0: int, k: int) -> torch.Tensor:
        return torch.stack([step(step0 + j) for j in range(k)])

    step.multi = multi
    return step, opt


# ---------------------------------------------------------------------------
# seeds x bins: an ensemble of colorless FDNs on a 2-D mesh
# ---------------------------------------------------------------------------
def local_members(members, mesh, seed_axis: str = "seed") -> list:
    """This rank's share of ``members`` (S models): the members of its
    row of the seed axis, ``S / n_seed`` of them."""
    n = axis_size(mesh, seed_axis)
    if len(members) % n:
        raise ValueError(f"{len(members)} members not divisible by mesh "
                         f"axis '{seed_axis}' of size {n}")
    per = len(members) // n
    i = axis_index(mesh, seed_axis)
    return list(members[i * per:(i + 1) * per])


def seed_bins_sharded_fused_loss(members, X, t, mesh, seed_axis: str = "seed",
                                 bins_axis: str = "bins", pivot: bool = True,
                                 sparsity_weight: float = 0.2) -> list:
    """This rank's shares of the colorless fused-step losses of its
    members (a list of models: the rank's row of the seed axis, see
    :func:`local_members`), each on the rank's block of bins: a share
    sums over ``bins_axis`` only; nothing crosses ``seed_axis``."""
    return [bins_sharded_fused_loss(m, X, t, mesh, bins_axis, pivot,
                                    sparsity_weight) for m in members]


def make_seed_bins_sharded_fused_step(members, mesh, lr: float = 1e-3,
                                      seed_axis: str = "seed",
                                      bins_axis: str = "bins",
                                      pivot: bool = True):
    """``(step, optimizers)`` of multi-seed colorless training through K1
    on a 2-D ``seed x bins`` mesh.  ``members`` is the whole ensemble (S
    models, the same on every rank); this rank trains its share
    (:func:`local_members`) on its block of bins, one Adam a member, its
    gradients summed over ``bins_axis``.  ``step(inputs, targets)``
    returns the (S,) losses before the step, on every rank."""
    S = len(members)
    mine = local_members(members, mesh, seed_axis)
    first = axis_index(mesh, seed_axis) * len(mine)
    for m in mine:
        replicate(m, mesh, bins_axis)
    opts = [masked_optimizer(m, lr=lr) for m in mine]
    params = [p for o in opts for g in o.param_groups for p in g["params"]]

    def step(inputs, targets):
        for o in opts:
            o.zero_grad(set_to_none=True)
        X, t = _spectrum_pair(mine[0], inputs, targets)
        shares = seed_bins_sharded_fused_loss(mine, X, t, mesh, seed_axis,
                                              bins_axis, pivot)
        torch.stack(shares).sum().backward()
        allreduce_grads(params, mesh, bins_axis)
        for o in opts:
            o.step()
        losses = torch.zeros(S, device=shares[0].device)
        losses[first:first + len(mine)] = axis_sum(torch.stack(shares),
                                                   mesh, bins_axis)
        dist.all_reduce(losses, group=mesh.get_group(seed_axis))
        return losses

    return step, opts


# ---------------------------------------------------------------------------
# the scattering FDN's masked loss
# ---------------------------------------------------------------------------
def masked_sharded_sfdn_loss(model, X, targets, mask, mesh,
                             axis_name: str = "bins",
                             sparsity_weight: float = 0.2,
                             solve_method: str = "ge_cached"):
    """This rank's share of the scattering FDN's masked objective
    (:func:`~flamo_tpu_torch.models.scattering_fdn.sfdn_masked_loss`)
    with the step's masked bins sharded over the axis: the rank evaluates
    the responses at its block of ``mask``, assembles and solves its loops
    (K6 on ``solve_method='pallas'``) and sums its squared errors over
    the mask's global size.  The sparsity term joins the axis's first
    rank's share.

    Reads batch 0 of ``X`` and ``targets``, as the JAX package's does, so
    a batch other than 1 raises ``ValueError``."""
    if X.shape[0] != 1 or targets.shape[0] != 1:
        raise ValueError(
            "masked_sharded_sfdn_loss reads batch 0 only; got a batch of "
            f"{X.shape[0]} (X) and {targets.shape[0]} (targets): pass one "
            "example")
    P_total = mask.shape[0]
    offset, count = shard_block(P_total, mesh, axis_name)
    mloc = mask[offset:offset + count]
    core = model.get_core()
    loop = core.feedback_loop
    S = take_block(loop.feedback.response_at(mloc), 0, count)
    D = take_block(loop.feedforward.response_at(mloc), 0, count)
    gi = core.input_gain.response()
    go = core.output_gain.response()
    Xm = take_block(X[0, mloc, 0], 0, count)
    tm = take_block(targets[0, mloc, 0], 0, count)
    N = D.shape[-1]
    A = torch.eye(N, dtype=S.dtype, device=S.device) - D[:, :, None] * S
    rhs = D * (gi[None, :, 0] * Xm[:, None])
    y = closed_loop_solve(A, rhs, method=solve_method)
    est = torch.abs(torch.einsum("n,pn->p", go[0], y))
    share = torch.sum((est - tm) ** 2) / P_total
    if axis_index(mesh, axis_name) == 0:
        share = share + sparsity_weight * _SPARSITY(None, None, model)
    return share


def make_masked_sharded_sfdn_step(model, mesh, lr: float = 1e-3,
                                  n_samples: int = 2000,
                                  sparsity_weight: float = 0.2,
                                  axis_name: str = "bins", generator=None,
                                  solve_method: str = "ge_cached",
                                  masks=None):
    """``(step, optimizer)`` of the scattering FDN with each step's masked
    bins sharded over the axis (:func:`masked_sharded_sfdn_loss`), the
    step signature and mask schedule of
    :func:`~flamo_tpu_torch.models.scattering_fdn.sfdn_masked_train_step`:
    ``step(inputs, targets, i)``, the same ``generator`` giving the same
    masks.  ``masks`` (n_masks, n_samples) bin indices replace that
    schedule (the JAX package's, say, so that both walk the same masks):
    step i then reads ``masks[i % n_masks]``.  Every rank must hold the
    same masks (checked)."""
    if masks is None:
        ml = _masks(model, n_samples, generator)
        same_on_axis(ml.masks_for_cycle(0), mesh, axis_name, "masks")

        def mask_at(i):
            return ml.masks_for_cycle(i // ml.n_masks)[i % ml.n_masks]
    else:
        masks = torch.as_tensor(masks, dtype=torch.int64,
                                device=model.device)
        same_on_axis(masks, mesh, axis_name, "masks")

        def mask_at(i):
            return masks[i % masks.shape[0]]

    def share(inputs, targets, i):
        return masked_sharded_sfdn_loss(model, model.input_layer(inputs),
                                        targets, mask_at(int(i)), mesh,
                                        axis_name, sparsity_weight,
                                        solve_method)

    return _sharded_step(model, mesh, axis_name, lr, share)
