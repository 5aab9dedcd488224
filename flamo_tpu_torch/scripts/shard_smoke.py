"""Rank workers for the multi-device layer: each sharded step of
``flamo_tpu_torch.parallel`` in lockstep with the port's unsharded step of
the same model from the same seed, on every rank of a group that
:func:`flamo_tpu_torch.parallel.launch.spawn` starts.

    python -m flamo_tpu_torch.scripts.shard_smoke [--device cpu]
        [--nfft N] [--gain G] [--out results.json]

runs the two-rank families (``run_families``) and the four-rank seed x
bins family, holds them to the gates (``check_families``) and writes
every rank's results as JSON.  ``chip_smoke.py``'s
phase 4k runs them at full width on one card (every rank on ``cuda:0``,
a ``gloo`` group); the tests run them on the CPU at a small nfft.

A family returns, per rank, the sharded and unsharded losses of each
step, their largest relative gap, the largest gap of each trainable
parameter after the steps relative to its largest entry, the largest
spread of the parameters across the ranks (0: bit-identical), the launch
counts of every hand-written kernel in each sharded step (counted only
on the card: the wrappers run their plain versions on CPU tensors), the
rank's block of bins and, with ``time_steps``, the ms a step of the
sharded and the unsharded step (CUDA events on the card; the ranks share
it, so these are not scaling figures).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.models import (ActiveAcoustics, aa_evs_train_step,
                                    aa_fused_taps_step, attenuated_train_step,
                                    build_active_acoustics,
                                    build_attenuated_fdn, build_colorless_fdn,
                                    build_colorless_sfdn, colorless_loss,
                                    colorless_train_step, sfdn_masked_loss,
                                    sfdn_masked_train_step)
from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import eig_kernels as ek
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.optimize.utils import generate_partitions
from flamo_tpu_torch.parallel import (MultiSeedEnsemble, bin_sharded_forward,
                                      get_mesh, get_mesh_2d,
                                      make_bins_sharded_aa_taps_step,
                                      make_bins_sharded_attenuated_step,
                                      make_bins_sharded_evs_step,
                                      make_bins_sharded_fused_step,
                                      make_dp_train_step,
                                      make_masked_sharded_sfdn_step,
                                      make_seed_bins_sharded_fused_step,
                                      shard_spectrum)
from flamo_tpu_torch.parallel.launch import spawn
from flamo_tpu_torch.parallel.mesh import axis_index, shard_block

DELAYS = (887, 911, 941, 1699, 1951, 2053)

#: the published sizes (chip_smoke.py phases 3-4d): the colorless and
#: attenuated N = 6 FDNs, the 4 x 13 active-acoustics rig (15000-tap
#: rooms, a 100-tap mixer, 1601-bin eigenvalue partitions), the
#: scattering FDN's 2000-bin masked step on K6.  The magnitude rig's
#: lockstep runs at aa_lr = 1e-4: at 1e-3 its first steps overshoot (the
#: loss 41 -> 30 -> 46 on the H100), and two float32 orders of the same
#: sums, 4.5e-7 of the gradient's max apart at the first step, part by
#: 3.5e-4 of the loss at the third, with K9 'high' and 'highest' alike
FULL = dict(nfft=96000, device="cuda", seed=0, steps=3, time_steps=20,
            warm=3, delays=DELAYS, lr=1e-3, att_lr=1e-4, aa_lr=1e-4,
            dp_batch=4,
            aa=dict(n_mics=4, n_loudspeakers=13, rir_length=15000,
                    fir_order=100, t60=0.5),
            evs=dict(n_M=4, n_L=13, FIR_order=100, rir_length=15000,
                     wgn_RT=1.0, room_t60=0.5, iter_num=30, target=0.3,
                     gain=None),
            sfdn=dict(n_samples=2000, solve_method="pallas", masks=None),
            ens=dict(n_seeds=4, steps=10, lr=1e-2, vmap=True),
            params=None, arrays=False)

# the JAX package's elementwise bound on the data-parallel and masked
# steps' parameters (tests/test_parallel.py: assert_allclose(rtol=1e-4,
# atol=1e-6))
RTOL, ATOL = 1e-4, 1e-6

TWO_RANK_FAMILIES = ("colorless", "attenuated", "aa_taps", "evs", "masked",
                     "ensemble")


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def reset_counts() -> None:
    for mod in (fk, sk, ak, ek):
        mod.reset_launch_counts()


def counts() -> dict:
    """The nonzero launch counts of every hand-written kernel."""
    return {k: v for mod in (fk, sk, ak, ek) for k, v in mod.LAUNCHES.items()
            if v}


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def trainable(model) -> dict:
    """Name -> detached trainable parameter."""
    return {k: p.detach() for k, p in model.named_parameters()
            if p.requires_grad}


def compare_params(model, ref) -> dict:
    """``param_gap``: the largest gap of a trainable parameter from
    ``ref``'s over that parameter's largest entry; ``allclose_ratio``: the
    largest ``|a - b| / (ATOL + RTOL |b|)``, at most 1 where numpy's
    ``allclose(rtol=RTOL, atol=ATOL)`` holds."""
    pr = trainable(ref)
    pm = trainable(model)
    return dict(
        param_gap=max(rel(p, pr[k]) for k, p in pm.items()),
        allclose_ratio=max(
            float(((p - pr[k]).abs() / (ATOL + RTOL * pr[k].abs())).max())
            for k, p in pm.items()))


def replica_spread(model, group) -> float:
    """max - min over the ranks of ``group`` of every trainable entry:
    0.0 when the replicas are bit-identical."""
    flat = torch.cat([torch.view_as_real(p.detach()).reshape(-1)
                      if p.is_complex() else p.detach().reshape(-1)
                      for p in trainable(model).values()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return float((hi - lo).abs().max())


def step_ms(run, device, n: int, warm: int):
    """ms a call of ``run()`` over n calls after ``warm``: CUDA events on
    the card, the host clock on the CPU; None for n = 0."""
    if n <= 0:
        return None
    for _ in range(warm):
        run()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    return (time.perf_counter() - t0) * 1e3 / n


def grad_gap(model, ref) -> float:
    """The largest gap of a trainable parameter's gradient from ``ref``'s,
    over that gradient's largest entry."""
    gr = {k: p.grad for k, p in ref.named_parameters() if p.requires_grad}
    return max(rel(p.grad, gr[k]) for k, p in model.named_parameters()
               if p.requires_grad)


def lockstep(step_s, step_r, args, steps: int, models) -> dict:
    """``steps`` steps of the sharded ``step_s(*args(i))`` beside the
    unsharded ``step_r``: their losses, the largest relative gap, the
    kernel launches of each sharded step and, from the first step (both
    models at the same weights), the gradients' gap (``models``: the
    sharded and the unsharded model)."""
    ls, lr, per_step = [], [], []
    for i in range(steps):
        a = args(i)
        reset_counts()
        ls.append(step_s(*a).detach().cpu())
        per_step.append(counts())
        lr.append(step_r(*a).detach().cpu())
        if i == 0:
            first = grad_gap(*models)
    ls, lr = torch.stack(ls), torch.stack(lr)
    return dict(losses=ls.tolist(), ref=lr.tolist(), loss_rel=rel(ls, lr),
                counts=per_step, grad_gap=first)


def timing(cfg, step_s, step_r, args) -> dict:
    """ms a step of the sharded and the unsharded step (the ranks run
    both at once, on one card)."""
    n, w, dev = cfg["time_steps"], cfg["warm"], cfg["device"]
    a = args(0)
    return dict(ms=step_ms(lambda: step_s(*a), dev, n, w),
                ref_ms=step_ms(lambda: step_r(*a), dev, n, w))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _impulse(rows: int, channels: int, device) -> torch.Tensor:
    x = torch.zeros((1, rows, channels), device=device)
    x[:, 0, :] = 1.0
    return x


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------
def _colorless(cfg, **kw):
    m = build_colorless_fdn(nfft=cfg["nfft"], delays=cfg["delays"],
                            device=cfg["device"], generator=_gen(cfg["seed"]),
                            **kw)
    if cfg.get("params") is not None:
        load_jax_params(m, cfg["params"])
    return m


def family_colorless(rank, world, cfg) -> dict:
    """K1's bins-sharded step, ``bin_sharded_forward`` on 'pallas' (K2),
    ``shard_spectrum`` and ``make_dp_train_step`` (a batch of
    ``dp_batch``)."""
    nfft, dev = cfg["nfft"], cfg["device"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "bins")
    group = mesh.get_group("bins")
    ms, mr = _colorless(cfg), _colorless(cfg)
    x, t = _impulse(nfft, 1, dev), torch.ones((1, M, 1), device=dev)
    step_s, _ = make_bins_sharded_fused_step(ms, mesh, lr=cfg["lr"])
    step_r, _ = colorless_train_step(mr, lr=cfg["lr"], fused_step=True,
                                     step_pivot=True)
    fused = lockstep(step_s, step_r, lambda i: (x, t), cfg["steps"],
                     (ms, mr))
    fused.update(**compare_params(ms, mr),
                 spread=replica_spread(ms, group),
                 block=shard_block(M, mesh, "bins"))
    fused.update(timing(cfg, step_s, step_r, lambda i: (x, t)))

    mf = _colorless(cfg, solve_method="pallas")
    fwd = bin_sharded_forward(mf, mesh)
    with torch.no_grad():
        reset_counts()
        y = fwd(x)
        fwd_counts = counts()
        y_ref = mf(x)
        forward = dict(rel=rel(y, y_ref), counts=fwd_counts,
                       ms=step_ms(lambda: fwd(x), dev, cfg["time_steps"],
                                  cfg["warm"]),
                       ref_ms=step_ms(lambda: mf(x), dev, cfg["time_steps"],
                                      cfg["warm"]))
        h = mf.input_layer(x)
        block = shard_spectrum(h, mesh)
        offset, count = shard_block(M, mesh, "bins")
        whole = torch.cat([h, h.new_zeros((1, world * count - M, 1))], 1)
        forward["spectrum_equal"] = bool(torch.equal(
            block, whole[:, offset:offset + count]))
    if cfg.get("arrays"):
        forward["y"] = y.cpu().numpy()
    return dict(fused=fused, forward=forward, dp=_dp(cfg, world))


def _dp(cfg, world) -> dict:
    """make_dp_train_step against one process's step on the whole batch
    (the JAX test's pair: impulses against targets 0.8 .. 1.2)."""
    nfft, dev, B = cfg["nfft"], cfg["device"], cfg["dp_batch"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "batch")
    x = torch.zeros((B, M, 1), device=dev)
    x[:, 0, :] = 1.0
    t = torch.ones((B, M, 1), device=dev) * torch.linspace(
        0.8, 1.2, B, device=dev)[:, None, None]

    def loss_fn(m, x, t):
        return torch.mean((m(x) - t) ** 2)

    md, mr = _colorless(cfg), _colorless(cfg)
    step, init = make_dp_train_step(
        loss_fn, lambda m: masked_optimizer(m, lr=1e-2), mesh, "batch")
    opt = init(md)
    opt_r = masked_optimizer(mr, lr=1e-2)

    def step_r(x, t):
        opt_r.zero_grad(set_to_none=True)
        loss = loss_fn(mr, x, t)
        loss.backward()
        opt_r.step()
        return loss.detach()

    out = lockstep(lambda x, t: step(md, opt, x, t), step_r,
                   lambda i: (x, t), cfg["steps"], (md, mr))
    out.update(compare_params(md, mr), block=shard_block(B, mesh, "batch"))
    out["spread"] = replica_spread(md, mesh.get_group("batch"))
    try:
        step(md, opt, x[:B - 1], t[:B - 1])
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    if cfg.get("arrays"):  # under the JAX package's key paths
        out["params"] = {k: v.detach().cpu().numpy()
                         for k, v in jax_named_tensors(md).items()}
    return out


def family_attenuated(rank, world, cfg) -> dict:
    """K5's bins-sharded step (``bin_offset`` the block's first bin)
    against ``attenuated_train_step(fused_step=True)``."""
    nfft, dev = cfg["nfft"], cfg["device"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "bins")

    def build():
        return build_attenuated_fdn(nfft=nfft, delays=cfg["delays"],
                                    octave_interval=1, cache_delays=True,
                                    device=dev, generator=_gen(cfg["seed"]))

    ms, mr = build(), build()
    x, t = _impulse(nfft, 1, dev), torch.ones((1, M, 1), device=dev)
    step_s, _ = make_bins_sharded_attenuated_step(ms, mesh, lr=cfg["att_lr"])
    step_r, _ = attenuated_train_step(mr, lr=cfg["att_lr"], fused_step=True)
    out = lockstep(step_s, step_r, lambda i: (x, t), cfg["steps"],
                   (ms, mr))
    out.update(**compare_params(ms, mr),
               spread=replica_spread(ms, mesh.get_group("bins")),
               block=shard_block(M, mesh, "bins"))
    out.update(timing(cfg, step_s, step_r, lambda i: (x, t)))
    return out


def family_aa_taps(rank, world, cfg) -> dict:
    """K9's bins-sharded step at precision 'high' (``bin_offset`` the
    block's first bin) against ``aa_fused_taps_step``."""
    nfft, dev, a = cfg["nfft"], cfg["device"], cfg["aa"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "bins")

    def build():
        return build_active_acoustics(
            n_mics=a["n_mics"], n_loudspeakers=a["n_loudspeakers"],
            rir_length=a["rir_length"], fir_order=a["fir_order"], nfft=nfft,
            t60=a["t60"], solve_method="ge_cached", device=dev,
            generator=_gen(cfg["seed"]))

    ms, mr = build(), build()
    x = _impulse(nfft, a["n_loudspeakers"], dev)
    t = torch.ones((1, M, a["n_mics"]), device=dev)
    step_s, _ = make_bins_sharded_aa_taps_step(ms, mesh, x, t,
                                               lr=cfg["aa_lr"])
    step_r, _ = aa_fused_taps_step(mr, x, t, lr=cfg["aa_lr"])
    out = lockstep(step_s, step_r, lambda i: (), cfg["steps"],
                   (ms, mr))
    out.update(**compare_params(ms, mr),
               spread=replica_spread(ms, mesh.get_group("bins")),
               block=shard_block(M, mesh, "bins"))
    out.update(timing(cfg, step_s, step_r, lambda i: ()))
    return out


def evs_partitions(cfg) -> torch.Tensor:
    """The eigenvalue step's partitions: the given ones (the JAX
    package's, in the tests) or ``ceil(M / iter_num)``-bin partitions
    drawn from the seed."""
    e = cfg["evs"]
    if e.get("masks") is not None:
        return torch.as_tensor(np.asarray(e["masks"]), dtype=torch.int64)
    M = cfg["nfft"] // 2 + 1
    return generate_partitions(torch.arange(M), math.ceil(M / e["iter_num"]),
                               1, generator=_gen(cfg["seed"]))


def family_evs(rank, world, cfg) -> dict:
    """K7's bins-sharded eigenvalue step (``.multi``) against
    ``aa_evs_train_step`` on the same partitions."""
    nfft, dev, e = cfg["nfft"], cfg["device"], cfg["evs"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "bins")

    def build(gain):
        return ActiveAcoustics(
            n_S=1, n_M=e["n_M"], n_L=e["n_L"], n_A=1, nfft=nfft,
            FIR_order=e["FIR_order"], rir_length=e["rir_length"],
            wgn_RT=e["wgn_RT"], room_t60=e["room_t60"], device=dev,
            generator=_gen(cfg["seed"]), gain=gain)

    # the gain before instability (an eigvals at every bin) once at most
    aa_s = build(e.get("gain"))
    aa_r = build(float(aa_s.G.param[0]))
    masks = evs_partitions(cfg)
    tg = torch.full((M, e["n_M"]), e["target"], device=dev)
    step_s, _ = make_bins_sharded_evs_step(aa_s, tg, mesh, lr=cfg["lr"],
                                           masks=masks)
    step_r, _ = aa_evs_train_step(aa_r, tg, lr=cfg["lr"], masks=masks)
    out = lockstep(step_s, step_r, lambda i: (i,), cfg["steps"],
                   (aa_s.F_MM, aa_r.F_MM))
    out.update(**compare_params(aa_s.F_MM, aa_r.F_MM),
               spread=replica_spread(aa_s.F_MM, mesh.get_group("bins")),
               block=shard_block(masks.shape[1], mesh, "bins"),
               partitions=list(masks.shape))
    reset_counts()
    multi = step_s.multi(cfg["steps"], 2)
    multi_counts = counts()
    ref = torch.stack([step_r(cfg["steps"] + j) for j in range(2)])
    out["multi"] = dict(losses=multi.tolist(), counts=multi_counts,
                        loss_rel=rel(multi.cpu(), ref.cpu()))
    out.update(timing(cfg, step_s, step_r, lambda i: (i,)))
    return out


def family_masked(rank, world, cfg) -> dict:
    """The scattering FDN's masked sharded step (K6 both ways on
    'pallas') against the unsharded masked step on the same masks."""
    nfft, dev, f = cfg["nfft"], cfg["device"], cfg["sfdn"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "bins")

    def build():
        return build_colorless_sfdn(nfft=nfft, device=dev,
                                    generator=_gen(cfg["seed"]))

    ms, mr = build(), build()
    x, t = _impulse(M, 1, dev), torch.ones((1, M, 1), device=dev)
    method = f["solve_method"]
    if f.get("masks") is None:
        step_s, _ = make_masked_sharded_sfdn_step(
            ms, mesh, lr=cfg["lr"], n_samples=f["n_samples"],
            generator=_gen(cfg["seed"] + 1), solve_method=method)
        step_r, _ = sfdn_masked_train_step(
            mr, lr=cfg["lr"], n_samples=f["n_samples"],
            generator=_gen(cfg["seed"] + 1), solve_method=method)
    else:
        masks = torch.as_tensor(np.asarray(f["masks"]), dtype=torch.int64,
                                device=dev)
        step_s, _ = make_masked_sharded_sfdn_step(
            ms, mesh, lr=cfg["lr"], solve_method=method, masks=masks)
        opt = masked_optimizer(mr, lr=cfg["lr"])

        def step_r(x, t, i):
            opt.zero_grad(set_to_none=True)
            loss = sfdn_masked_loss(mr, mr.input_layer(x), t,
                                    masks[i % masks.shape[0]],
                                    solve_method=method)
            loss.backward()
            opt.step()
            return loss.detach()

    out = lockstep(step_s, step_r, lambda i: (x, t, i), cfg["steps"],
                   (ms, mr))
    out.update(**compare_params(ms, mr),
               spread=replica_spread(ms, mesh.get_group("bins")),
               block=shard_block(f["n_samples"], mesh, "bins"))
    out.update(timing(cfg, step_s, step_r, lambda i: (x, t, i)))
    return out


def family_ensemble(rank, world, cfg) -> dict:
    """A MultiSeedEnsemble of colorless FDNs ('ge', vmapped) on a 'seed'
    mesh against each member trained alone."""
    nfft, dev, e = cfg["nfft"], cfg["device"], cfg["ens"]
    M = nfft // 2 + 1
    mesh = get_mesh(world, "seed")

    def model_fn(g):
        return build_colorless_fdn(nfft=nfft, delays=cfg["delays"],
                                   device=dev, generator=g)

    x, t = _impulse(nfft, 1, dev), torch.ones((1, M, 1), device=dev)
    ens = MultiSeedEnsemble(model_fn, e["n_seeds"], mesh=mesh,
                            base_seed=cfg["seed"], vmap=e["vmap"])
    t0 = time.perf_counter()
    losses = ens.fit(colorless_loss, x, t, n_steps=e["steps"], lr=e["lr"])
    seconds = time.perf_counter() - t0
    member_rel, member_gap = [], []
    for j, m in enumerate(ens.members):
        ref = model_fn(_gen(cfg["seed"] + ens.first + j))
        step, _ = colorless_train_step(ref, lr=e["lr"])
        hist = torch.stack([step(x, t) for _ in range(e["steps"])])
        member_rel.append(rel(losses[:, ens.first + j], hist))
        member_gap.append(compare_params(m, ref)["param_gap"])
    best = ens.best_model()
    with torch.no_grad():
        y = best(x)
    return dict(losses=losses.cpu().tolist(), member_rel=member_rel,
                member_gap=member_gap, first=ens.first,
                best_finite=bool(torch.isfinite(y).all()),
                best_index=int(torch.argmin(losses[-1])),
                fit_seconds=seconds)


def family_seed_bins(rank, world, cfg) -> dict:
    """K1 on a 2 x (world / 2) seed x bins mesh: two colorless members,
    each against its own unsharded fused step."""
    nfft, dev = cfg["nfft"], cfg["device"]
    M = nfft // 2 + 1
    mesh = get_mesh_2d(2, world // 2)
    seeds = [cfg["seed"] + s for s in range(2)]

    def build(s):
        return build_colorless_fdn(nfft=nfft, delays=cfg["delays"],
                                   device=dev, generator=_gen(s))

    members = [build(s) for s in seeds]
    x, t = _impulse(nfft, 1, dev), torch.ones((1, M, 1), device=dev)
    step_s, _ = make_seed_bins_sharded_fused_step(members, mesh, lr=cfg["lr"])
    i = axis_index(mesh, "seed")
    ref = build(seeds[i])
    step_r, _ = colorless_train_step(ref, lr=cfg["lr"], fused_step=True,
                                     step_pivot=True)
    vectors = []

    def sharded(x, t):
        losses = step_s(x, t)
        vectors.append(losses.cpu().tolist())
        return losses[i]

    out = lockstep(sharded, step_r, lambda k: (x, t), cfg["steps"],
                   (members[i], ref))
    out.update(member=i, all_members=vectors,
               **compare_params(members[i], ref),
               spread=replica_spread(members[i], mesh.get_group("bins")),
               block=shard_block(M, mesh, "bins"))
    return out


FAMILIES = {"colorless": family_colorless, "attenuated": family_attenuated,
            "aa_taps": family_aa_taps, "evs": family_evs,
            "masked": family_masked, "ensemble": family_ensemble,
            "seed_bins": family_seed_bins}


def run_families(rank, world, names, cfg) -> dict:
    """Run the families ``names`` in turn on this rank; each result also
    carries its seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = FAMILIES[name](rank, world, cfg)
        if torch.device(cfg["device"]).type == "cuda":
            torch.cuda.synchronize()
        out[name]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the gates: the JAX package's tests/test_parallel.py tolerances
# ---------------------------------------------------------------------------
LOSS_TOL = {"evs": 1e-4}  # relative, per step; 1e-5 for the others
# each trainable parameter after the steps, and its gradient at the first
# step (both models at the same weights, as tests/test_parallel.py:253-287
# holds K1's), relative to its largest entry; the ALLCLOSE steps are held
# on their parameters only, as there
PARAM_TOL = {"colorless": 1e-5, "seed_bins": 1e-5, "attenuated": 1e-4,
             "aa_taps": 1e-4, "evs": 1e-4}
ALLCLOSE = ("dp", "masked")  # held elementwise (RTOL, ATOL) instead
FORWARD_TOL = ENSEMBLE_TOL = 1e-5
# each sharded step's launches, a rank and a step, on the card (the masked
# step's K6 both ways on 'pallas' only)
PER_STEP = {"colorless": {"fdn_tf_mse": 1}, "dp": {},
            "attenuated": {"fdn_sos_tf_mse": 1},
            "aa_taps": {"aa_taps_tf_mse_tc_high": 1},
            "evs": {"dk_roots": 1},
            "masked": {"dense_solve": 1, "dense_solve_transposed": 1},
            "seed_bins": {"fdn_tf_mse": 1}}
# the families whose kernel takes the block's first bin as bin_offset
OFFSET = ("attenuated", "aa_taps")


def _steps(res: dict):
    """(family, lockstep result) pairs of one rank's results."""
    for fam, r in res.items():
        if fam == "colorless":
            yield "colorless", r["fused"]
            yield "dp", r["dp"]
        elif fam != "ensemble":
            yield fam, r


def check_families(ranks: list, cfg, on_card: bool) -> dict:
    """Hold each rank's results (``run_families``) to the gates; raise
    ``AssertionError`` naming the first that fails.  On the card also the
    launches of every sharded step.  Returns the launch totals over the
    ranks, kernel -> count."""
    totals = {}

    def need(cond, msg):
        if not cond:
            raise AssertionError(msg)

    def add(c):
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v

    for rank, res in enumerate(ranks):
        for fam, r in _steps(res):
            where = f"rank {rank} {fam}"
            need(r["loss_rel"] < LOSS_TOL.get(fam, 1e-5),
                 f"{where}: loss {r['loss_rel']:.3e} from the unsharded step")
            if fam in ALLCLOSE:
                need(r["allclose_ratio"] <= 1.0, f"{where}: parameters "
                     f"{r['allclose_ratio']:.3f} x allclose({RTOL}, {ATOL})")
            else:
                need(r["param_gap"] < PARAM_TOL[fam], f"{where}: parameters "
                     f"{r['param_gap']:.3e} of the max from the unsharded")
                need(r["grad_gap"] < PARAM_TOL[fam], f"{where}: first "
                     f"gradients {r['grad_gap']:.3e} of the max from the "
                     "unsharded")
            need(r["spread"] == 0.0, f"{where}: parameters differ across "
                 f"ranks by {r['spread']:.3e}")
            want = PER_STEP[fam]
            if fam == "masked" and cfg["sfdn"]["solve_method"] != "pallas":
                want = {}
            if on_card:
                need(all(c == want for c in r["counts"]), f"{where}: "
                     f"launches {r['counts']} a step, not {want}")
            for c in r["counts"]:
                add(c)
            if fam in OFFSET and rank > 0:
                need(r["block"][0] > 0, f"{where}: bin_offset 0")
        if "colorless" in res:
            f, d = res["colorless"]["forward"], res["colorless"]["dp"]
            need(f["rel"] < FORWARD_TOL, f"rank {rank} bin_sharded_forward: "
                 f"{f['rel']:.3e} of the max from the unsharded forward")
            need(f["spectrum_equal"], f"rank {rank} shard_spectrum's block")
            if on_card:
                need(f["counts"] == {"fdn_solve": 1}, f"rank {rank} "
                     f"bin_sharded_forward launched {f['counts']}")
            add(f["counts"])
            need(d["ragged"] is not None and "not divisible" in d["ragged"],
                 f"rank {rank} dp: a ragged batch was not refused")
        if "evs" in res:
            m = res["evs"]["multi"]
            need(m["loss_rel"] < LOSS_TOL["evs"], f"rank {rank} evs multi:"
                 f" loss {m['loss_rel']:.3e} from the unsharded step")
            if on_card:
                need(m["counts"] == {"dk_roots": len(m["losses"])},
                     f"rank {rank} evs multi launched {m['counts']}")
            add(m["counts"])
        if "ensemble" in res:
            e = res["ensemble"]
            first, last = np.mean(e["losses"][0]), np.mean(e["losses"][-1])
            need(last < first, f"rank {rank} ensemble: mean loss {first:.6g}"
                 f" -> {last:.6g} did not fall")
            need(max(e["member_rel"]) < ENSEMBLE_TOL, f"rank {rank} ensemble:"
                 f" members {e['member_rel']} from their single runs")
            need(e["best_finite"], f"rank {rank} ensemble: best model's "
                 "output is not finite")
    return totals


def libraries(cfg) -> list:
    """The (library, N) pairs of the families' kernels: K1, K2 and K6 at
    the FDNs' six channels, K5 likewise, K9 at the rig's microphones and
    K7 at the eigenvalue rig's."""
    n = len(cfg["delays"])
    return [("fdn_kernels", n), ("sos_kernels", n),
            ("aa_kernels", cfg["aa"]["n_mics"]),
            ("eig_kernels", cfg["evs"]["n_M"])]


def run_all(cfg, timeout_s: float, collective_s: float) -> dict:
    """Both groups: the two-rank families and the four-rank seed x bins
    family.  Returns ``{"two": [rank results], "four": [...]}``."""
    if torch.device(cfg["device"]).type == "cuda":
        # built once here (a no-op where they are): the ranks only load them
        cuda_build.build(libraries(cfg))
    out = {}
    for key, world, names in (("two", 2, TWO_RANK_FAMILIES),
                              ("four", 4, ("seed_bins",))):
        t0 = time.perf_counter()
        out[key] = spawn(run_families, world, "gloo", names, cfg,
                         timeout_s=timeout_s, collective_s=collective_s)
        out[f"{key}_seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nfft", type=int, default=FULL["nfft"])
    ap.add_argument("--gain", type=float, default=None,
                    help="the eigenvalue rig's known gain before "
                         "instability (skips its eigvals at every bin)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a group may take")
    ap.add_argument("--collective-timeout", type=float, default=60.0,
                    help="seconds a collective may wait for a peer")
    ap.add_argument("--out", default=None,
                    help="write the results here as JSON (else stdout)")
    args = ap.parse_args(argv)
    cfg = {**FULL, "nfft": args.nfft, "device": args.device,
           "evs": {**FULL["evs"], "gain": args.gain}}
    out = run_all(cfg, args.timeout, args.collective_timeout)
    check_families(out["two"] + out["four"], cfg,
                   on_card=torch.device(args.device).type == "cuda")
    text = json.dumps(out, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
