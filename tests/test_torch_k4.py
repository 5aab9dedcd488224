"""The redesigned K4 (the SOS cascade K4f and its tap VJP K4b) on the CPU,
held against flamo_tpu.

K4 now takes any channel count on the card (one library, the channels in
blocks of at most ``K4_MAX_CB``), so the plain versions that stand in for
the kernels here are held to the JAX Pallas kernel ``pallas_sos_cascade``
(in interpret mode, TILE patched to 256, as tests/test_ops.py does) at
more than 16 channels, through a full 5 x 5 GEQ, and along the path that
launches K4 on the card: the attenuated FDN's graph train step on the
'pallas'/'pallas' route (K4f + K2 forward, K4b + K2 transposed backward),
in lockstep with JAX's ``attenuated_train_step(fused_step=False)`` on the
same route.  The host-side plans (channel blocks, runs of bins) and the
bounds in chip_smoke.py are pinned.  Tolerances: K4's values 1e-5 of the
max and tap gradients 1e-4 of the max (the JAX kernel tests'); the
lockstep those of test_torch_attenuated.py's lockstep (the loss history
to 1e-4 relative, the parameters to 1e-5 of their max).  The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
import flamo_tpu.models as jm
from flamo_tpu.models import attenuated_fdn as jatt
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.models import attenuated_train_step, build_attenuated_fdn
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.processor import dsp

REPO = Path(__file__).resolve().parents[1]
NFFT = 512
M = NFFT // 2 + 1
DELAYS = (89, 97, 107)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _patch_interpret(monkeypatch):
    import flamo_tpu.ops.pallas_solve as ps
    from jax.experimental import pallas as pl

    monkeypatch.setattr(ps.pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(ps, "TILE", 256)
    return ps


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The JAX Pallas kernels through the interpreter, TILE = 256."""
    return _patch_interpret(monkeypatch)


# ---------------------------------------------------------------------------
# the host-side plans and the bounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,cb", [(1, 1), (6, 6), (8, 8), (9, 5), (16, 8),
                                  (17, 6), (25, 7), (40, 8), (1000, 8)])
def test_k4_channel_block_plan(N, cb):
    """N splits into the fewest channel blocks of at most K4_MAX_CB, as
    even as they come: every block but the last holds cb channels, and
    the last at least cb - (blocks - 1)."""
    assert sk.k4_channel_block(N) == cb
    blocks = -(-N // cb)
    assert blocks == -(-N // sk.K4_MAX_CB)
    assert 0 < N - (blocks - 1) * cb <= cb
    assert N - (blocks - 1) * cb >= cb - (blocks - 1)


def _cost(S: int, parts: int) -> int:
    """Bin visits of the busiest thread: S sections x parts runs over 128
    threads, each run 128 / parts bins."""
    return -(-S * parts // 128) * (128 // parts)


def test_k4b_tap_parts_plan():
    """The runs of K4b's tap sums: a power of two within the 48 KB a block
    gets without opting in, the fewest bin visits for the busiest thread
    (ties to fewer runs), checked against every choice at every size."""
    assert sk.k4b_tap_parts(6, 12, 3) == 8  # the main path: 144 sections
    assert sk.k4b_smem_floats(6, 12, 3, 8) == 432 + 256 * 7 + 8 * 432
    for cb in range(1, sk.K4_MAX_CB + 1):
        for K in (1, 2, 5, 12, 31, 64):
            for P in range(1, sk.MAX_P + 1):
                parts = sk.k4b_tap_parts(cb, K, P)
                assert parts & (parts - 1) == 0 and 1 <= parts <= 128
                assert sk.k4b_smem_floats(cb, K, P, parts) <= 12288
                fits = [p for p in (1, 2, 4, 8, 16, 32, 64, 128)
                        if p == 1 or sk.k4b_smem_floats(cb, K, P, p) <= 12288]
                best = min(_cost(2 * K * cb, p) for p in fits)
                assert _cost(2 * K * cb, parts) == best
                assert parts == min(p for p in fits
                                    if _cost(2 * K * cb, p) == best)


def test_k4_source_mirrors_the_plans():
    """The wrapper's plans and the kernel's checks are one rule:
    sos_cascade.cu holds the same channel block, the same shared-memory
    count and the same 48 KB."""
    src = (cuda_build.CSRC / "sos_cascade.cu").read_text()
    assert f"constexpr int kMaxCB = {sk.K4_MAX_CB};" in src
    assert "constexpr int kThreads = 128;" in src
    assert ("return taps + 2 * kThreads * (cb + 1) + "
            "(parts > 1 ? parts * taps : 0);") in src
    assert "constexpr int kMaxSharedFloats = 48 * 1024 / 4;" in src
    assert sk._K4_SMEM_FLOATS == 48 * 1024 // 4


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,want", [("sos_cascade_fwd", 0.002118),
                                       ("sos_cascade_bwd", 0.005548)])
def test_k4_bounds_are_the_same_work(smoke, name, want):
    """The yardsticks of the redesigned K4f and K4b do not move: the
    function's work at the attenuated FDN's size, whatever implements
    it."""
    ms, by = smoke.bound(name, 48001, 6)
    assert round(ms, 6) == want
    assert by == "operations"


# ---------------------------------------------------------------------------
# K4 at more than 16 channels
# ---------------------------------------------------------------------------
def _stable_taps(rng, P, K, N):
    """Denominators with poles inside the unit circle, random numerators."""
    r = 0.6 * rng.uniform(0.2, 0.99, (K, N))
    th = rng.uniform(0, np.pi, (K, N))
    a = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    b = rng.normal(size=(P, K, N))
    return b.astype(np.float32), a.astype(np.float32)


def _jax_cascade_and_grads(ps, b, a, G, nfft):
    def loss(b, a):
        H = ps.pallas_sos_cascade(b, a, nfft)
        return jnp.sum(jnp.real(H * G)), H

    (_, H), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True))(jnp.asarray(b),
                                                          jnp.asarray(a))
    return np.asarray(H), g


@pytest.mark.parametrize("N", [17, 25])
def test_sos_cascade_many_channels_matches_pallas(pallas_interpret, N):
    """K4 (plain here) at 17 and 25 channels, more than one of K4's
    channel blocks and more than the per-N libraries' 16, against the
    Pallas kernel: values and the tap gradients of Re sum H G.  Two
    sections a channel: the interpreter's time grows with K N."""
    nfft = 128
    rng = np.random.default_rng(N)
    b, a = _stable_taps(rng, 3, 2, N)
    G = (rng.normal(size=(nfft // 2 + 1, N))
         + 1j * rng.normal(size=(nfft // 2 + 1, N))).astype(np.complex64)
    Hj, gj = _jax_cascade_and_grads(pallas_interpret, b, a, jnp.asarray(G),
                                    nfft)
    bt, at = (torch.tensor(x, requires_grad=True) for x in (b, a))
    H = sk.sos_cascade(bt, at, nfft)
    assert H.shape == (nfft // 2 + 1, N)
    assert _rel(H.detach().numpy(), Hj) < 1e-5
    torch.sum(torch.real(H * torch.tensor(G))).backward()
    assert _rel(bt.grad.numpy(), gj[0]) < 1e-4
    assert _rel(at.grad.numpy(), gj[1]) < 1e-4


def test_geq_5x5_pallas_matches_jax():
    """A full GEQ of 5 x 5 channels on the 'pallas' backend (its 25
    channels fold into K4's channel axis; plain K4 here) against JAX's
    GEQ from the same command gains: the response and the gradient of
    sum |H|^2 in the gains.  The reference is JAX's 'xla' backend, the
    function its Pallas kernel computes (interpreting that kernel at 13
    sections x 25 channels takes minutes), and the bounds are the JAX
    package's for its two GEQ backends (test_ops.py), 5e-3 of the max on
    values and 1e-3 on gradients, as test_parallel_geq_response_matches_jax
    holds the port's: the design's taps agree to 2e-7, but the 13-section
    float32 cascade is ill-conditioned near DC and puts the two 1e-3
    apart (9.8e-4 at this size)."""
    from flamo_tpu.processor import dsp as jdsp

    nfft = 64
    flamo_tpu.set_seed(5)
    gj = jdsp.GEQ(size=(5, 5), nfft=nfft, requires_grad=True)

    def loss_j(p):
        H = gj.assign_value(p).response()
        return jnp.sum(jnp.abs(H) ** 2), H

    (_, Hj), grad_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        gj.param)
    gt = dsp.GEQ(size=(5, 5), nfft=nfft, requires_grad=True,
                 cascade_backend="pallas", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    gt.assign_value(np.array(gj.param))
    Ht = gt.response()
    assert Ht.shape == (nfft // 2 + 1, 5, 5)
    assert _rel(Ht.detach().numpy(), np.asarray(Hj)) < 5e-3
    torch.sum(torch.abs(Ht) ** 2).backward()
    assert _rel(gt.param.grad.numpy(), np.asarray(grad_j)) < 1e-3


# ---------------------------------------------------------------------------
# the graph train step that launches K4 on the card
# ---------------------------------------------------------------------------
def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


@pytest.fixture(scope="module")
def jax_graph_steps():
    """Five Adam steps of JAX's attenuated_train_step(fused_step=False) on
    its 'pallas'/'pallas' route (K4 and K2 interpreted), lr 1e-4, from
    flamo_tpu.set_seed(13): the initial parameters, the loss history and
    the final parameters."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_interpret(mp)
        flamo_tpu.set_seed(13)
        mj = jm.build_attenuated_fdn(nfft=NFFT, delays=DELAYS,
                                     solve_method="pallas",
                                     cascade_backend="pallas")
        p0 = _jax_params(mj)
        step, opt = jatt.attenuated_train_step(mj, lr=1e-4, fused_step=False)
        step = jax.jit(step)
        x = jnp.zeros((1, NFFT, 1)).at[:, 0, :].set(1.0)
        t = jnp.ones((1, M, 1))
        hist = []
        for _ in range(5):
            mj, opt, loss = step(mj, opt, x, t)
            hist.append(float(loss))
    return p0, hist, _jax_params(mj)


def test_graph_train_step_lockstep_with_jax(jax_graph_steps):
    """The port's graph step on the 'pallas'/'pallas' route (plain K4 and
    K2 here, the kernels on the card) in lockstep with JAX's on the same
    route for five Adam steps: the loss history to 1e-4 relative, the
    parameters to 1e-5 of their max."""
    p0, hist_j, pj = jax_graph_steps
    mt = build_attenuated_fdn(nfft=NFFT, delays=DELAYS, solve_method="pallas",
                              cascade_backend="pallas", device="cpu")
    load_jax_params(mt, p0)
    step, _ = attenuated_train_step(mt, lr=1e-4)
    x = torch.zeros((1, NFFT, 1))
    x[:, 0, :] = 1.0
    t = torch.ones((1, M, 1))
    hist_t = [float(step(x, t)) for _ in range(5)]
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    assert hist_t[-1] < hist_t[0]
    named = jax_named_tensors(mt)
    assert sorted(named) == sorted(pj)
    for k in pj:
        assert _rel(named[k].detach().numpy(), pj[k]) < 1e-5, k
