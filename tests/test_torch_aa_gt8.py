"""The active-acoustics steps past 8 microphones, held against flamo_tpu on
the CPU: K8's and K9's plain versions (what their wrappers take for CPU
tensors, at any microphone count) against JAX's dense formula under
``jax.value_and_grad`` and, at 9 microphones, against JAX's K8 run through
the Pallas interpreter; the fused trainers at 12 microphones from a JAX
rig, in lockstep with JAX's graph training; and the wrappers' dispatch on
the card (the unrolled library up to 8 microphones, the looped one above,
a raise naming the limit past it), with the card and the library loader
patched.  The kernels themselves against their plain versions:
``tests/test_torch_cuda.py`` (``-k aa_loop``), on the card.

Tolerances, as tests/test_torch_active_acoustics.py: the loss 1e-5
relative and the gradients 5e-3 of the max against the dense formula
(a float32 solve against JAX's LU), K9 'default' (one TF32 pass) at
TAPS_TOL's 1.5e-6 and 5e-4; JAX's kernel 1e-5 on the loss and 1e-4 of the
max on the gradients; the trainers 1e-4 on the first loss and 1e-3 after
three Adam steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flamo_tpu
from flamo_tpu.core import masked_optimizer as jax_masked_optimizer
from flamo_tpu.models import build_active_acoustics as jax_build_aa
from flamo_tpu_torch.convert import load_jax_params
from flamo_tpu_torch.models import (aa_fused_step, aa_fused_taps_step,
                                    build_active_acoustics)
from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import cuda_build

L, MB, NFFT_ROWS, OFF = 3, 301, 1024, 100
TAPS_TOL = {"highest": (1e-5, 5e-3), "high": (1e-5, 5e-3),
            "default": (1.5e-6, 5e-4)}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _rows(seed: int, N: int, order: int = 12):
    """Random rows of N microphones and L loudspeakers at MB bins: a room
    H, a mixer response G and taps tw scaled so that |H G| stays near 0.2,
    the rhs r = H X and targets t; with the complex (MB, ...) arrays."""
    rng = np.random.default_rng(seed)
    H = (rng.normal(size=(MB, N, L)) + 1j * rng.normal(size=(MB, N, L))
         ).astype(np.complex64)
    g = 0.2 / np.sqrt(N * L)
    G = (g * (rng.normal(size=(MB, L, N)) + 1j * rng.normal(
        size=(MB, L, N)))).astype(np.complex64)
    tw = (g / np.sqrt(order) * rng.normal(size=(order, L * N))).astype(
        np.float32)
    X = (rng.normal(size=(MB, L)) + 1j * rng.normal(size=(MB, L))).astype(
        np.complex64)
    t = rng.uniform(size=(MB, N)).astype(np.float32)
    hrows = H.transpose(1, 2, 0).reshape(N * L, MB)
    grows = G.transpose(1, 2, 0).reshape(L * N, MB)
    rhs = np.einsum("mil,ml->im", H, X)
    return dict(H=H, tt=t, tw=tw, hr=hrows.real.copy(), hi=hrows.imag.copy(),
                gr=grows.real.copy(), gi=grows.imag.copy(),
                rr=rhs.real.copy(), ri=rhs.imag.copy(), t=t.T.copy())


def _tf32(x):
    """float32 values rounded to TF32, as ``aa_kernels.tf32_round``."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & -0x2000).view(np.float32)


def _tf32_jax(x):
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jax.lax.bitcast_convert_type((b + 0x1000) & -0x2000, jnp.float32)


def _dense_loss(o, N: int, G):
    """JAX's mean (|y| - t)^2 with y = (I - H G)^{-1} r, G (MB, L, N)."""
    A = jnp.eye(N, dtype=jnp.complex64)[None] - jnp.einsum(
        "mil,mlk->mik", o["H"], G)
    y = jnp.linalg.solve(A, jnp.asarray(o["rr"] + 1j * o["ri"]).T[
        ..., None])[..., 0]
    return jnp.mean((jnp.abs(y) - o["tt"]) ** 2)


@pytest.mark.parametrize("N", [9, 16, 32])
@pytest.mark.parametrize("pivot", [True, False])
def test_plain_k8_past_8_matches_dense_formula(N, pivot):
    """K8's plain version (the wrapper on CPU tensors) at 9, 16 and 32
    microphones: loss 1e-5, response-row gradients 5e-3 of the max."""
    o = _rows(N, N)

    def loss_ref(gr, gi):
        return _dense_loss(o, N, (gr + 1j * gi).reshape(L, N, MB).transpose(
            2, 0, 1))

    lr, gref = jax.jit(jax.value_and_grad(loss_ref, argnums=(0, 1)))(
        o["gr"], o["gi"])
    gr, gi = (_t(o[k]).requires_grad_() for k in ("gr", "gi"))
    loss = ak.aa_tf_mse(_t(o["hr"]), _t(o["hi"]), gr, gi,
                        *[_t(o[k]) for k in ("rr", "ri", "t")], N=N, L=L,
                        pivot=pivot)
    loss.backward()
    assert abs(float(loss) - float(lr)) / float(lr) < 1e-5
    assert _rel(gr.grad.numpy(), gref[0]) < 5e-3
    assert _rel(gi.grad.numpy(), gref[1]) < 5e-3


@pytest.mark.parametrize("N", [9, 16, 32])
@pytest.mark.parametrize("precision", ak.PRECISIONS)
def test_plain_k9_past_8_matches_dense_formula(N, precision):
    """K9's plain version at 9, 16 and 32 microphones, each precision,
    both pivot modes, on bins OFF.. of an nfft of NFFT_ROWS (the exact
    integer DFT phases): the loss and tap gradient against the dense
    formula at TAPS_TOL; for 'default' the formula's synthesis takes the
    taps and the powers rounded to TF32, as its one pass does (at this
    loop gain the loss moves by ~1e-5 of itself with that rounding, so
    the FP32 formula would test the rounding and not the kernel's
    function), and its tap gradient's own rounding of S is what the
    5e-4 admits."""
    o = _rows(100 + N, N)
    m = np.arange(MB, dtype=np.int64) + OFF
    tt = np.arange(o["tw"].shape[0], dtype=np.int64)
    ph = -2.0 * np.pi * ((tt[:, None] * m[None, :]) % NFFT_ROWS) / NFFT_ROWS
    E = np.exp(1j * ph).astype(np.complex64)  # (order, MB)
    if precision == "default":  # its one pass: tw and the powers in TF32
        E = (_tf32(E.real) + 1j * _tf32(E.imag)).astype(np.complex64)

    def loss_ref(tw):
        if precision == "default":  # rounded, its gradient passed through
            tw = tw + jax.lax.stop_gradient(_tf32_jax(tw) - tw)
        G = jnp.einsum("tc,tm->mc", tw.astype(jnp.complex64), E)
        return _dense_loss(o, N, G.reshape(MB, L, N))

    lr, gref = jax.jit(jax.value_and_grad(loss_ref))(o["tw"])
    loss_tol, grad_tol = TAPS_TOL[precision]
    for pivot in (True, False):
        tw = _t(o["tw"]).requires_grad_()
        loss = ak.aa_taps_tf_mse(
            _t(o["hr"]), _t(o["hi"]), tw,
            *[_t(o[k]) for k in ("rr", "ri", "t")], N=N, L=L, nfft=NFFT_ROWS,
            pivot=pivot, precision=precision, bin_offset=OFF)
        loss.backward()
        assert abs(float(loss) - float(lr)) / float(lr) < loss_tol, pivot
        assert _rel(tw.grad.numpy(), gref) < grad_tol, pivot


def test_plain_k8_at_9_matches_jax_kernel():
    """K8's plain version at 9 microphones against JAX's
    ``pallas_aa_tf_mse`` (no pivot: its pivoted variant takes minutes in
    the interpreter), run through the Pallas interpreter with TILE = 256,
    as JAX's own tests run it on the CPU: loss 1e-5,
    gradients 1e-4 of the max."""
    import flamo_tpu.ops.pallas_solve as ps
    from jax.experimental import pallas as pl

    N = 9
    o = _rows(9, N)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps.pl, "pallas_call", partial(pl.pallas_call,
                                                 interpret=True))
        mp.setattr(ps, "TILE", 256)
        jl, jg = jax.value_and_grad(
            lambda gr, gi: ps.pallas_aa_tf_mse(
                o["hr"], o["hi"], gr, gi, o["rr"], o["ri"], o["t"], N=N, L=L,
                pivot=False), argnums=(0, 1))(o["gr"], o["gi"])
    gr, gi = (_t(o[k]).requires_grad_() for k in ("gr", "gi"))
    loss = ak.aa_tf_mse(_t(o["hr"]), _t(o["hi"]), gr, gi,
                        *[_t(o[k]) for k in ("rr", "ri", "t")], N=N, L=L)
    loss.backward()
    assert abs(float(loss) - float(jl)) / float(jl) < 1e-5
    assert _rel(gr.grad.numpy(), jg[0]) < 1e-4
    assert _rel(gi.grad.numpy(), jg[1]) < 1e-4


def _keyed(tree, prefix: str = "") -> dict:
    return {prefix + jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_fused_steps_at_12_mics_lockstep_with_jax_graph():
    """aa_fused_step (K8) and aa_fused_taps_step (K9, each precision) at
    12 microphones on the CPU, weights carried from a JAX rig by
    load_jax_params: the first loss within 1e-4 of JAX's graph loss and
    the fourth (after three Adam steps) within 1e-3 of JAX's graph
    training; the loss falls.  Before the repair of the wrappers' limit
    these raised past 8 microphones even on the CPU."""
    n_mics, n_ls, nfft = 12, 3, 512
    flamo_tpu.set_seed(130297)
    jm = jax_build_aa(n_mics=n_mics, n_loudspeakers=n_ls, rir_length=200,
                      fir_order=16, nfft=nfft, fs=48000, t60=0.2,
                      solve_method="ge_cached")
    pm = build_active_acoustics(n_mics=n_mics, n_loudspeakers=n_ls,
                                rir_length=200, fir_order=16, nfft=nfft,
                                t60=0.2, solve_method="ge_cached",
                                device="cpu",
                                generator=torch.Generator().manual_seed(0))
    load_jax_params(pm, _keyed(jm))
    x = np.zeros((1, nfft, n_ls), np.float32)
    x[:, 0, :] = 1.0
    t = np.ones((1, nfft // 2 + 1, n_mics), np.float32)
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    tx = jax_masked_optimizer(optax.adam(1e-3), jm)

    @jax.jit
    def adam_step(mm, o):
        loss, g = jax.value_and_grad(
            lambda m: jnp.mean((jnp.abs(m(xj)) - tj) ** 2))(mm)
        up, o = tx.update(g, o, mm)
        return optax.apply_updates(mm, up), o, loss

    o, mm, jlosses = tx.init(jm), jm, []
    for _ in range(4):
        mm, o, loss = adam_step(mm, o)
        jlosses.append(float(loss))
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    builds = [aa_fused_step] + [
        partial(aa_fused_taps_step, precision=p) for p in ak.PRECISIONS]
    for build in builds:
        pm.load_state_dict(state)
        step, _ = build(pm, torch.tensor(x), torch.tensor(t), lr=1e-3)
        losses = [float(step()) for _ in range(4)]
        assert abs(losses[0] - jlosses[0]) / jlosses[0] < 1e-4, build
        assert abs(losses[3] - jlosses[3]) / jlosses[3] < 1e-3, build
        assert losses[3] < losses[0], build
    pm.load_state_dict(state)


@pytest.fixture()
def card_patched(monkeypatch):
    """The wrappers' device test says CUDA and the library loader records
    what was asked for, then refuses: the dispatch up to the load runs on
    CPU tensors."""
    loads = []

    def no_load(n, lib="fdn_kernels"):
        loads.append((lib, n))
        raise RuntimeError("no library here")

    monkeypatch.setattr(ak, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_build, "load", no_load)
    return loads


def _wrapper_calls(N: int, order: int = 100):
    o = {k: torch.zeros((n, 5)) for k, n in (("h", N * L), ("g", L * N),
                                             ("r", N))}
    tw = torch.zeros((order, L * N))
    return (lambda: ak.aa_tf_mse_kernel(o["h"], o["h"], o["g"], o["g"],
                                        o["r"], o["r"], o["r"], N, L),
            *(partial(lambda p: ak.aa_taps_tf_mse_kernel(
                o["h"], o["h"], tw, o["r"], o["r"], o["r"], N, L, 64,
                precision=p), p) for p in ak.PRECISIONS))


@pytest.mark.parametrize("N", [1, 8, 9, 16, 32, 49])
def test_dispatch_on_the_card(card_patched, N):
    """On CUDA tensors K8 and K9 ask for the unrolled library at N
    microphones up to 8 and for the looped library (built once, as N =
    1) from 9 to its limit (49 for K9 at 100 taps and 3 loudspeakers
    here, 'high' and 'default'; more for K8)."""
    want = ("aa_kernels", N) if N <= ak.MAX_N else ("aa_loop", 1)
    for call in _wrapper_calls(N):
        with pytest.raises(RuntimeError, match="no library here"):
            call()
    assert card_patched == [want] * 4


def loop_fits(precision: str, N: int, order: int = 100) -> bool:
    return ak.loop_taps_plan(ak.PASSES[precision], order, N, L)[1] > 0


def test_past_the_looped_limit_raises_naming_it(card_patched):
    """Past the looped limit each wrapper raises ValueError naming the
    largest microphone count it takes at those sizes, before any library
    loads; the plain version is never run instead."""
    top8 = ak.loop_max_n(L)
    assert ak.loop_tf_mse_warps(top8, L) >= 1
    assert ak.loop_tf_mse_warps(top8 + 1, L) == 0
    with pytest.raises(ValueError, match=rf"K8 .* takes 1\.\.{top8} "):
        _wrapper_calls(top8 + 1)[0]()
    for i, precision in enumerate(ak.PRECISIONS):
        top = ak.loop_max_n(L, 100, precision)
        assert loop_fits(precision, top) and not loop_fits(precision, top + 1)
        with pytest.raises(ValueError, match=rf"K9 .*{precision}.* takes "
                           rf"1\.\.{top} microphones"):
            _wrapper_calls(top + 1)[1 + i]()
    assert card_patched == []
    # the rig's 13 loudspeakers and 100 taps
    assert ak.loop_max_n(13) == 155
    assert [ak.loop_max_n(13, 100, p) for p in ak.PRECISIONS] == [49, 49, 50]
    # N = 16 on tiles of 64 bins, eight solver warps; N = 32 on 32, six
    assert ak.loop_taps_plan(3, 100, 16, 13) == (64, 8)
    assert ak.loop_taps_plan(3, 100, 32, 13) == (32, 6)
    assert ak.loop_taps_plan(0, 100, 32, 13) == (32, 6)


@pytest.fixture()
def looped_counted(monkeypatch):
    """K8's and K9's wrappers counting each call under its looped kernel's
    key (the calls here are past 8 microphones), as the card's launches
    would count."""
    def spy(attr, key_of):
        fn = getattr(ak, attr)

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            ak.LAUNCHES[key_of(args, kwargs)] += 1
            return out
        monkeypatch.setattr(ak, attr, run)

    def k9_key(args, kwargs):
        p = kwargs.get("precision", args[10] if len(args) > 10 else "high")
        return (f"aa_taps_tf_mse_tc_{p}" if ak.PASSES[p]
                else "aa_taps_tf_mse") + "_loop"

    spy("aa_tf_mse_kernel", lambda args, kwargs: "aa_tf_mse_loop")
    spy("aa_taps_tf_mse_kernel", k9_key)


def test_phases_4n_5n_on_cpu(looped_counted):
    """chip_smoke.py's phases 4n and 5n on the CPU at nfft 512 with
    200-tap rooms: 12 microphones through every run (first losses
    against the graph and the plain versions, falling losses, one launch
    a step), the bin-offset call, the report's launches by row, and the
    kernel checks at 9 microphones and against the unrolled kernels at 8
    (the plain versions on both sides here)."""
    import chip_smoke as cs

    paths = cs.aa_loop_paths(nfft=512, device="cpu", ns=(12,),
                             rir_length=200, offset=64)
    (r,) = paths
    assert set(r["runs"]) == {"aa_taps_tf_mse_tc_high_loop",
                              "aa_taps_tf_mse_tc_default_loop",
                              "aa_taps_tf_mse_loop", "aa_tf_mse_loop"}
    assert r["offset_err"] == 0.0
    launches = cs.aa_loop_report(paths)
    assert launches == {f"{k}@N12": cs.AA_LOOP_STEPS for k in r["runs"]}
    errs = cs.aa_loop_kernel_checks(9, nfft=512, device="cpu",
                                    rir_length=200)
    assert set(errs) == {f"{k}@N9" for k in r["runs"]}
    gaps = cs.aa_loop_versus_unrolled(nfft=512, device="cpu", rir_length=200)
    assert set(gaps) == {"K8", "K9 default", "K9 high", "K9 highest"}


def test_bins_sharded_aa_taps_step_at_12_mics():
    """make_bins_sharded_aa_taps_step at 12 microphones on two gloo ranks
    of the CPU (shard_smoke's aa_taps family, 2 x 3 loudspeakers' rig of
    tests/test_torch_parallel.py with 12 microphones): its steps in
    lockstep with the unsharded aa_fused_taps_step at shard_smoke's gates,
    rank 1's K9 call at its block's first bin.  Before F6's repair it
    raised past 8 microphones."""
    from flamo_tpu_torch.parallel.launch import spawn
    from flamo_tpu_torch.scripts import shard_smoke as S

    nfft = 512
    cfg = {**S.FULL, "nfft": nfft, "device": "cpu", "time_steps": 0,
           "aa": dict(n_mics=12, n_loudspeakers=3, rir_length=64,
                      fir_order=8, t60=0.5)}
    ranks = spawn(S.run_families, 2, "gloo", ("aa_taps",), cfg,
                  timeout_s=60, threads=2)
    S.check_families(ranks, cfg, on_card=False)
    M = nfft // 2 + 1
    assert [r["aa_taps"]["block"][0] for r in ranks] == [0, -(-M // 2)]
