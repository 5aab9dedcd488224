"""The port's scattering FDN, its modules and the dense solve kernel K6,
held against flamo_tpu on the CPU.

K6 is held against JAX's ``pallas_gauss_solve`` run through the Pallas
interpreter (TILE = 256, as tests/test_ops.py does); the port runs K6's
plain version, which is what its wrapper takes for CPU tensors.  The
interpreter takes seconds per eager call at N = 6 and minutes to compile
inside a jit, so the N = 6 kernel case is one eager forward, and the slice
tests solve the JAX model's loop with its pivoted 'ge' elimination, which
tests/test_ops.py holds K6 to; the port's model solves through K6.

The JAX model is built once (``flamo_tpu.set_seed(42)``, nfft=2048,
delays (197, 229, 253, 307, 331, 389)); its weights and its scattering
shifts are carried into the port with ``load_jax_params`` and
``load_jax_scattering``.  JAX's graph and masked steps are each compiled
once and run four steps, and the slice tests read their losses, the
first step's gradients and the final weights.  The port draws other masks
than JAX (another PRNG), so the slice tests hand JAX's masks to the port.
PyTorch's gradient of a complex tensor is the conjugate of JAX's
cotangent: complex gradients are compared with conj(jax.grad).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
import flamo_tpu.models as jm
from flamo_tpu.models import scattering_fdn as jsf
from flamo_tpu.optimize.loss import masked_mse_loss as jax_masked_mse_loss
from flamo_tpu.functional import expm_skew as jax_expm_skew
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch.auxiliary.scattering import ScatteringMapping
from flamo_tpu_torch.convert import (jax_named_tensors, load_jax_params,
                                     load_jax_scattering)
from flamo_tpu_torch.functional import expm_skew
from flamo_tpu_torch.models import (build_colorless_sfdn, sfdn_fit,
                                    sfdn_masked_est, sfdn_masked_loss,
                                    sfdn_masked_train_step, sfdn_train_step)
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.optimize import (generate_partitions, masked_mse_loss,
                                      sparsity_loss)
from flamo_tpu_torch.processor import dsp

NFFT = 2048
M = NFFT // 2 + 1
DELAYS = (197, 229, 253, 307, 331, 389)
N_SAMPLES = 128
TRAINABLE = (".core.modules[0].param", ".core.modules[1].feedback.param",
             ".core.modules[2].param")


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _grad_np(x):
    return x.grad.detach().resolve_conj().numpy()


@pytest.fixture(scope="module")
def ps():
    """flamo_tpu's Pallas kernels through the interpreter, TILE = 256."""
    import flamo_tpu.ops.pallas_solve as pallas_solve
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_solve.pl, "pallas_call",
                   partial(pl.pallas_call, interpret=True))
        mp.setattr(pallas_solve, "TILE", 256)
        yield pallas_solve


@pytest.fixture(scope="module")
def sfdn():
    """The JAX model, its leaves, its scattering state, JAX's masks of
    cycle 0 and the impulse -> flat pair."""
    flamo_tpu.set_seed(42)
    mj = jm.build_colorless_sfdn(nfft=NFFT, delays=DELAYS)
    mf = mj.core.modules[1].feedback.map_filter
    ml = jax_masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES, n_sets=1,
                             regenerate_mask=True, key=jax.random.PRNGKey(7))
    return dict(model=mj, params=_jax_params(mj),
                state=(mf.shifts, mf.m_L, mf.m_R),
                masks=np.asarray(ml.masks_for_cycle(0)),
                xj=jnp.zeros((1, M, 1)).at[:, 0, :].set(1.0),
                tj=jnp.ones((1, M, 1)))


def _port(sfdn, solve_method="pallas"):
    mt = build_colorless_sfdn(nfft=NFFT, delays=DELAYS, device="cpu",
                              solve_method=solve_method)
    load_jax_params(mt, sfdn["params"])
    return load_jax_scattering(mt, *sfdn["state"])


def _io_torch():
    x = torch.zeros((1, M, 1))
    x[:, 0, :] = 1.0
    return x, torch.ones((1, M, 1))


def _adam_first_grads(opt_state) -> dict:
    """The gradients of an optax Adam's first step, read from its first
    moment: from a zero start mu = (1 - b1) g, b1 = 0.9."""
    return {jax.tree_util.keystr(path).split(".mu", 1)[1]:
            np.asarray(leaf) / (1 - 0.9)
            for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state)
            if ".mu." in jax.tree_util.keystr(path)}


@pytest.fixture(scope="module")
def jax_steps(sfdn):
    """Four steps of JAX's graph step (masked=False) and of its masked
    step (masked=True, the loop solved with 'ge'), each jitted once:
    {masked: (losses, gradients of step 0, weights after step 3)}."""
    mj, xj, tj = sfdn["model"], sfdn["xj"], sfdn["tj"]
    out = {}
    for masked in (False, True):
        make = (partial(jsf.sfdn_masked_train_step, solve_method="ge")
                if masked else jsf.sfdn_train_step)
        sj, oj = make(mj, n_samples=N_SAMPLES, key=jax.random.PRNGKey(7))
        sj = jax.jit(sj)
        m_j, losses = mj, []
        for i in range(4):
            m_j, oj, loss = sj(m_j, oj, xj, tj, jnp.asarray(i))
            losses.append(float(loss))
            if i == 0:
                grads = _adam_first_grads(oj)
        out[masked] = (losses, grads, _jax_params(m_j))
    return out


@pytest.fixture()
def jax_masks(sfdn, monkeypatch):
    """The port's masked_mse_loss draws JAX's masks (cycle 0)."""
    masks = torch.tensor(sfdn["masks"], dtype=torch.int64)
    monkeypatch.setattr(masked_mse_loss, "masks_for_cycle",
                        lambda self, cycle: masks)
    return masks


# ---------------------------------------------------------------------------
# K6: the public function (plain version on the CPU) vs pallas_gauss_solve
# ---------------------------------------------------------------------------
def _system(seed: int, shape_a, shape_b, N: int):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=shape_a + (N, N))
         + 1j * rng.normal(size=shape_a + (N, N))).astype(np.complex64)
    A += (3.0 * np.eye(N)).astype(np.complex64)
    B = (rng.normal(size=shape_b + (N,))
         + 1j * rng.normal(size=shape_b + (N,))).astype(np.complex64)
    return A, B


@pytest.mark.parametrize("N", [3, 6])
def test_dense_solve_matches_pallas(ps, N):
    """A broadcast A (M, N, N) against a batched B (2, M, N), M = 37 (no
    tile multiple): the forward to 1e-4 absolute (tests/test_ops.py), and
    at N = 3 the gradients of sum |y|^2 in A (summed over B's batch) and B
    to 1e-3 of the max.  N = 6 (interpreted eagerly: no jit) checks the
    forward; its gradients are held by the slice tests."""
    A, B = _system(N + 2, (37,), (2, 37), N)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    y = fk.dense_solve(At, Bt)
    assert y.shape == Bt.shape
    if N != 3:
        yj = np.asarray(ps.pallas_gauss_solve(Aj, Bj))
        assert float(np.abs(y.detach().numpy() - yj).max()) < 1e-4
        return

    def loss_j(A, B):
        y = ps.pallas_gauss_solve(A, B)
        return jnp.sum(jnp.abs(y) ** 2), y

    (_, yj), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(Aj, Bj)
    assert float(np.abs(y.detach().numpy() - np.asarray(yj)).max()) < 1e-4
    torch.sum(torch.abs(y) ** 2).backward()
    assert At.grad.shape == At.shape
    assert _rel(_grad_np(At), np.conj(np.asarray(gj[0]))) < 1e-3
    assert _rel(_grad_np(Bt), np.conj(np.asarray(gj[1]))) < 1e-3


def test_dense_solve_plain_transposed_and_limits():
    """The transposed plain version solves A^T y = B (1e-5 of the max
    against torch.linalg.solve); the wrapper takes any channel count on
    the CPU (on the card 1..16 unrolled, then looped up to its named
    limit) and checks its operands."""
    A, B = _system(5, (64,), (64,), 5)
    At, Bt = torch.tensor(A), torch.tensor(B)
    y = fk.dense_solve_plain(At, Bt, transpose=True)
    ref = torch.linalg.solve(At.transpose(-1, -2), Bt[..., None])[..., 0]
    assert _rel(y.numpy(), ref.numpy()) < 1e-5
    assert torch.equal(fk.dense_solve_kernel(At, Bt, transpose=True), y)
    A17, B17 = (torch.tensor(x) for x in _system(6, (8,), (8,), 17))
    assert torch.equal(fk.dense_solve_kernel(A17, B17),
                       fk.dense_solve_plain(A17, B17))
    with pytest.raises(ValueError, match="channels"):
        fk.dense_solve_kernel(torch.zeros((4, 0, 0), dtype=torch.complex64),
                              torch.zeros((4, 0), dtype=torch.complex64))
    N = fk.LOOP_MAX_N["dense_solve"] + 1
    with pytest.raises(ValueError, match=f"N = {N} channels"):
        fk.check_loop_n("dense_solve", N)
    with pytest.raises(TypeError, match="complex64"):
        fk.dense_solve_kernel(At.to(torch.complex128), Bt)


# ---------------------------------------------------------------------------
# the modules of the slice
# ---------------------------------------------------------------------------
def test_bins_prod_mod_matches_jax():
    """The port's exact int64 product mod nfft gives the JAX package's
    int32 hi/lo indices, up to nfft = 96000."""
    rng = np.random.default_rng(0)
    for nfft in (2048, 96000):
        b = rng.integers(0, nfft // 2 + 1, size=(300, 1))
        m = rng.integers(0, 10 * nfft, size=(1, 40))
        ref = np.asarray(jdsp._bins_prod_mod(jnp.asarray(b, jnp.int32),
                                             jnp.asarray(m, jnp.int32), nfft))
        got = dsp._bins_prod_mod(torch.tensor(b), torch.tensor(m), nfft)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(ref, (b * m) % nfft)


def test_scattering_mapping_and_response_at_match_jax(sfdn):
    """The scattering map with carried shifts equals JAX's FIR matrix
    (1e-6); the exact-phase ``response_at`` equals JAX's and the port's
    own ``response()[bins]`` (test_dsp.py's 2e-4 / 2e-5); ``response``
    equals JAX's to 1e-5 of the max."""
    mj, mt = sfdn["model"], _port(sfdn)
    fj, ft = mj.core.modules[1].feedback, mt.core.feedback_loop.feedback
    assert ft.map_filter.output_length == fj.map_filter.output_length
    X = np.random.default_rng(1).normal(size=(4, 6, 6)).astype(np.float32)
    bins = np.array([0, 1, 7, 100, 311, 777, M - 1])
    Vj, Haj, Hj = (np.asarray(v) for v in jax.jit(lambda: (
        fj.map_filter(jax_expm_skew(jnp.asarray(X))),
        fj.response_at(jnp.asarray(bins)), fj.response()))())
    Vt = ft.map_filter(expm_skew(torch.tensor(X)))
    assert Vt.shape == Vj.shape == (fj.map_filter.output_length, 6, 6)
    assert float(np.abs(Vt.numpy() - Vj).max()) < 1e-6

    with torch.no_grad():
        Ht = ft.response().numpy()
        Hat = ft.response_at(torch.tensor(bins)).numpy()
    np.testing.assert_allclose(Hat, Haj, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Hat, Ht[bins], rtol=2e-4, atol=2e-5)
    assert _rel(Ht, Hj) < 1e-5


def test_filter_response_at_truncates_and_falls_back():
    """A FIR longer than nfft is truncated as rfft(n=nfft) does; a GEQ
    (which redefines ``response``) takes the base gather."""
    g = torch.Generator().manual_seed(3)
    f = dsp.Filter(size=(40, 2, 3), nfft=32, alias_decay_db=10.0,
                   generator=g, device="cpu")
    bins = torch.tensor([0, 3, 16])
    with torch.no_grad():
        np.testing.assert_allclose(f.response_at(bins).numpy(),
                                   f.response()[bins].numpy(),
                                   rtol=2e-4, atol=2e-5)
        geq = dsp.GEQ(size=(1, 1), nfft=256, generator=g, device="cpu")
        assert torch.equal(geq.response_at(bins), geq.response()[bins])


def test_delay_response_at_matches_jax():
    """Fractional and integer delay lines: values against JAX's
    response_at and the port's ``response()[bins]`` (test_dsp.py's
    bounds); a trainable (softplus) Delay's gradient against JAX's
    (1e-3 / 1e-4).  torch's and XLA's softplus differ by an ulp or two of
    m, which moves the phase by up to pi * 2 ulp(m) ~ 2e-4 at the Nyquist
    bin, so the trainable Delay's values are held to the port's own
    ``response()`` only."""
    bins = np.array([0, 3, 97, 410, 1024])
    flamo_tpu.set_seed(12)
    dj = jdsp.Delay(size=(2, 3), max_len=150, nfft=NFFT, requires_grad=True)
    fj = jdsp.Delay(size=(3, 2), max_len=150, nfft=NFFT, alias_decay_db=30.0)
    lj = jdsp.parallelDelay(size=(4,), max_len=400, nfft=NFFT, isint=True,
                            alias_decay_db=30.0)
    g = torch.Generator().manual_seed(0)
    dt = dsp.Delay(size=(2, 3), max_len=150, nfft=NFFT, requires_grad=True,
                   generator=g, device="cpu")
    ft = dsp.Delay(size=(3, 2), max_len=150, nfft=NFFT, alias_decay_db=30.0,
                   generator=g, device="cpu")
    lt = dsp.parallelDelay(size=(4,), max_len=400, nfft=NFFT, isint=True,
                           alias_decay_db=30.0, generator=g, device="cpu")
    for mod_t, mod_j in ((dt, dj), (ft, fj), (lt, lj)):
        mod_t.assign_value(np.array(mod_j.param))
    b = torch.tensor(bins)

    def loss_j(p):
        r = dj.response_at(jnp.asarray(bins), ext_param=p)
        return jnp.sum(jnp.abs(r) ** 2) + jnp.sum(r.real)

    # one compile for every JAX value
    ref_f, ref_l, grad_j = jax.jit(lambda: (
        fj.response_at(bins), lj.response_at(bins),
        jax.grad(loss_j)(dj.param)))()
    for mod_t, ref in ((dt, None), (ft, ref_f), (lt, ref_l)):
        with torch.no_grad():
            got = mod_t.response_at(b).numpy()
            full = mod_t.response()[b].numpy()
        np.testing.assert_allclose(got, full, rtol=1e-4, atol=2e-5)
        if ref is not None:
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                       atol=2e-5)
    r = dt.response_at(b)
    (torch.sum(torch.abs(r) ** 2) + torch.sum(r.real)).backward()
    np.testing.assert_allclose(dt.param.grad.numpy(), np.asarray(grad_j),
                               rtol=1e-3, atol=1e-4)


def test_masks_are_disjoint_partitions_and_pure():
    """generate_partitions gives disjoint equal parts; a cycle's masks are
    a pure function of (seed, cycle), whatever was drawn before."""
    parts = generate_partitions(torch.arange(1025), 128, 2, seed=5)
    assert parts.shape == (16, 128)
    for s in (parts[:8], parts[8:]):
        assert len(torch.unique(s)) == 8 * 128
    ml = masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES,
                         generator=torch.Generator().manual_seed(7),
                         device="cpu")
    same = masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES,
                           generator=torch.Generator().manual_seed(7),
                           device="cpu")
    other = masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES,
                            generator=torch.Generator().manual_seed(8),
                            device="cpu")
    assert ml.n_masks == 8 and ml.mask_indices.shape == (8, N_SAMPLES)
    c3 = ml.masks_for_cycle(3).clone()
    assert torch.equal(ml.masks_for_cycle(0), same.masks_for_cycle(0))
    assert torch.equal(same.masks_for_cycle(3), c3)
    assert torch.equal(ml.masks_for_cycle(3), c3)
    assert not torch.equal(c3, ml.masks_for_cycle(0))
    assert not torch.equal(other.masks_for_cycle(3), c3)
    y, t = torch.rand((1, M, 1)), torch.zeros((1, M, 1))
    assert torch.equal(ml(y, t, step=8 * 3 + 5),
                       torch.mean(y[:, c3[5]] ** 2))


def test_masked_mse_loss_defaults_to_the_card(monkeypatch):
    """Without ``device`` the masks go to the CUDA card, as every entry
    point's default: where there is none, it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES)
    ml = masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES, device="cpu")
    assert ml.mask_indices.device.type == "cpu"


# ---------------------------------------------------------------------------
# the slice: graph step through K6, masked step, lockstep with JAX
# ---------------------------------------------------------------------------
def test_sfdn_conversion_keys(sfdn):
    assert sorted(sfdn["params"]) == sorted(
        TRAINABLE + (".core.modules[1].feedforward.param",))
    mt = _port(sfdn)
    for k, v in jax_named_tensors(mt).items():
        np.testing.assert_array_equal(v.detach().numpy(), sfdn["params"][k])
    shifts, m_L, _ = sfdn["state"]
    with pytest.raises(ValueError, match="shapes"):
        load_jax_scattering(mt, shifts, m_L[:2], m_L)


def test_sfdn_graph_loss_and_grads_match_jax(sfdn, jax_steps, jax_masks):
    """The graph objective at JAX's mask of step 0 (JAX's first graph
    step), the port's loop through K6: the loss to rtol 1e-5, gradients
    to 1e-4 of the max."""
    losses, gj, _ = jax_steps[False]
    lj = losses[0]
    mt = _port(sfdn)
    ml_t = masked_mse_loss(nfft=NFFT, n_samples=N_SAMPLES, device="cpu")
    x, t = _io_torch()
    est = mt(x)
    lt = ml_t(est, t, step=0) + 0.2 * sparsity_loss()(est, t, mt)
    lt.backward()
    assert abs(float(lt.detach()) - lj) / lj < 1e-5
    named = jax_named_tensors(mt)
    for k in TRAINABLE:
        assert _rel(named[k].grad.numpy(), gj[k]) < 1e-4, k


def test_sfdn_masked_loss_matches_jax_and_graph(sfdn, jax_steps, jax_masks):
    """The masked objective at JAX's mask of step 0, through K6
    ('pallas') and 'ge_cached', against JAX's sfdn_masked_loss there (the
    first loss of its masked step; rtol 1e-5), and the masked estimate
    against the graph estimate at the same bins: 1e-4 of the max, since
    the feedback's exact-phase DFT contraction and its rfft agree to
    rounding only (test_dsp.py's 2e-4 / 2e-5 on the responses; ~2e-5 on
    the estimates here)."""
    mask = jax_masks[0]
    lj = jax_steps[True][0][0]
    mt = _port(sfdn)
    x, t = _io_torch()
    X = mt.input_layer(x)
    with torch.no_grad():
        for method in ("pallas", "ge_cached"):
            lt = float(sfdn_masked_loss(mt, X, t, mask, solve_method=method))
            assert abs(lt - lj) / lj < 1e-5, method
        est = sfdn_masked_est(mt, X, mask, solve_method="pallas")
        assert est.shape == (1, N_SAMPLES)
        assert _rel(est.numpy(), mt(x)[:, mask, 0].numpy()) < 1e-4


def test_sfdn_steps_lockstep_with_jax(sfdn, jax_steps, jax_masks):
    """Four Adam steps of the port's graph step and masked step (both
    through K6) against JAX's, with JAX's masks: losses to rtol 1e-5,
    parameters to rtol 1e-4 / atol 1e-6 (tests/test_models.py)."""
    x, t = _io_torch()
    for masked in (False, True):
        mt = _port(sfdn)
        st, _ = (sfdn_masked_train_step(mt, n_samples=N_SAMPLES,
                                        solve_method="pallas") if masked
                 else sfdn_train_step(mt, n_samples=N_SAMPLES))
        hist_j, _, pj = jax_steps[masked]
        hist_t = [float(st(x, t, i)) for i in range(4)]
        np.testing.assert_allclose(hist_t, hist_j, rtol=1e-5)
        named = jax_named_tensors(mt)
        for k in pj:
            np.testing.assert_allclose(named[k].detach().numpy(), pj[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_sfdn_masked_fit_decreases():
    """sfdn_fit(masked=True) through K6 trains the masked objective down
    (tests/test_models.py's scenario)."""
    mt = build_colorless_sfdn(nfft=1024, delays=(97, 113, 127, 149),
                              n_stages=2, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    _, hist = sfdn_fit(mt, n_steps=30, lr=1e-2, n_samples=64, masked=True,
                       solve_method="pallas",
                       generator=torch.Generator().manual_seed(4))
    assert hist.shape == (30,)
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0]
