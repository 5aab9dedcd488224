"""The port's Trainer path held against flamo_tpu's on the CPU.

Models are built at nfft=512 with delays (89, 97, 107, 113) (the
scattering FDN at nfft=1024, as the JAX package's dispatch test) and the
JAX model's weights are carried into the port with ``load_jax_params``.
The JAX side runs its own Trainer; the port's kernels run as their plain
versions.  Tolerances are stated where they are used: the graph lockstep
at the colorless lockstep's 1e-4 (tests/test_torch_colorless.py), the
masked step at the masked lockstep's 1e-5 (tests/test_torch_scattering.py).
The fused kernels' dispatch against JAX's is in test_torch_trainer_fused.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flamo_tpu
import flamo_tpu.models as jm
import flamo_tpu.optimize as jopt
from flamo_tpu.optimize import loss as jloss
from flamo_tpu.optimize import trainer as jtrainer
from flamo_tpu_torch.convert import (jax_named_tensors, load_jax_params,
                                     load_jax_scattering)
from flamo_tpu_torch.models import (build_colorless_fdn, build_colorless_sfdn,
                                    colorless_fit)
from flamo_tpu_torch.models.dispatch import recognize_fused
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.optimize import (Dataset, Trainer, load_dataset,
                                      masked_mse_loss, sparsity_loss)
from flamo_tpu_torch.optimize import loss as tloss
from flamo_tpu_torch.optimize import trainer as ttrainer

NFFT = 512
M = NFFT // 2 + 1
DELAYS = (89, 97, 107, 113)


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _io(m: int = M):
    xj = jnp.zeros((1, m, 1)).at[:, 0, :].set(1.0)
    x = torch.zeros((1, m, 1))
    x[:, 0, :] = 1.0
    return (xj, jnp.ones((1, m, 1))), (x, torch.ones((1, m, 1)))


def _colorless_pair(seed: int = 7, **kw):
    flamo_tpu.set_seed(seed)
    mj = jm.build_colorless_fdn(nfft=NFFT, delays=DELAYS)
    mt = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu", **kw)
    return mj, load_jax_params(mt, _jax_params(mj))


def _colorless_criteria(tr, mod, sparsity: bool = True):
    """mse [+ 0.2 sparsity] of ``mod``, the JAX or the port's loss module."""
    tr.register_criterion(mod.mse_loss(nfft=NFFT), 1)
    if sparsity:
        tr.register_criterion(mod.sparsity_loss(), 0.2, requires_model=True)


def _port_trainer(mt, fused="off", **kw):
    tr = Trainer(mt, lr=1e-2, log=False, fused=fused, **kw)
    _colorless_criteria(tr, tloss)
    return tr


def _assert_params_close(mt, mj, rtol, atol):
    named = jax_named_tensors(mt)
    for k, v in _jax_params(mj).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v, rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# lockstep with the JAX Trainer
# ---------------------------------------------------------------------------
def test_graph_fit_scan_lockstep_with_jax():
    """fused='off', fit_scan(10, steps_per_call=4) with a schedule that
    decays twice in the run (step_size 3, factor 0.5): losses at rtol 1e-4
    and the weights at 1e-4 of their scale, the colorless lockstep's
    bounds (tests/test_torch_colorless.py)."""
    mj, mt = _colorless_pair()
    (xj, tj), (x, t) = _io()
    trj = jopt.Trainer(mj, lr=1e-2, log=False, fused="off", step_size=3,
                       step_factor=0.5)
    _colorless_criteria(trj, jloss)
    hist_j = trj.fit_scan(xj, tj, n_steps=10, steps_per_call=4)
    tr = _port_trainer(mt, step_size=3, step_factor=0.5)
    hist_t = tr.fit_scan(x, t, n_steps=10, steps_per_call=4)
    assert tr.fused_path is None and tr._step_count == 10
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    assert hist_t[-1] < hist_t[0]
    _assert_params_close(mt, trj.net, rtol=1e-4, atol=1e-6)


def test_auto_on_cpu_keeps_the_graph_for_the_colorless_fdn():
    _, mt = _colorless_pair()
    _, (x, t) = _io()
    tr = _port_trainer(mt, fused="auto")
    fk.reset_launch_counts()
    hist = tr.fit_scan(x, t, n_steps=2, steps_per_call=2)
    assert tr.fused_path is None and hist.shape == (2,)
    assert [c[0] for c in recognize_fused(
        mt, tr.criterion, tr.alpha, tr.requires_model)] == [
        "colorless_fused_step"]


def test_auto_takes_the_masked_step_for_the_scattering_fdn(monkeypatch):
    """fused='auto' on the CPU takes sfdn_masked_step (plain PyTorch,
    cpu_ok) and, fed JAX's masks, trains in lockstep with JAX's Trainer on
    its own sfdn_masked_step: losses at rtol 1e-5 and weights at rtol
    1e-4 / atol 1e-6, the masked lockstep's bounds
    (tests/test_torch_scattering.py)."""
    nfft, delays = 1024, (97, 113, 127, 149)
    (xj, tj), (x, t) = _io(nfft // 2 + 1)
    flamo_tpu.set_seed(11)
    mj = jm.build_colorless_sfdn(nfft=nfft, delays=delays, n_stages=2)
    mt = build_colorless_sfdn(nfft=nfft, delays=delays, n_stages=2,
                              device="cpu")
    load_jax_params(mt, _jax_params(mj))
    mf = mj.core.modules[1].feedback.map_filter
    load_jax_scattering(mt, mf.shifts, mf.m_L, mf.m_R)
    trj = jopt.Trainer(mj, lr=1e-2, log=False)
    mm_j = jloss.masked_mse_loss(nfft=nfft, n_samples=64,
                                 key=jax.random.PRNGKey(5))
    trj.register_criterion(mm_j, 1)
    trj.register_criterion(jloss.sparsity_loss(), 0.2, requires_model=True)
    hist_j = trj.fit_scan(xj, tj, n_steps=6, steps_per_call=3)
    assert trj.fused_path == "sfdn_masked_step"

    monkeypatch.setattr(
        masked_mse_loss, "masks_for_cycle", lambda self, cycle: torch.tensor(
            np.asarray(mm_j.masks_for_cycle(cycle)), dtype=torch.int64))
    tr = Trainer(mt, lr=1e-2, log=False)
    tr.register_criterion(masked_mse_loss(nfft=nfft, n_samples=64,
                                          device="cpu"), 1)
    tr.register_criterion(sparsity_loss(), 0.2, requires_model=True)
    hist_t = tr.fit_scan(x, t, n_steps=6, steps_per_call=3)
    assert tr.fused_path == "sfdn_masked_step"
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-5)
    _assert_params_close(mt, trj.net, rtol=1e-4, atol=1e-6)


def test_mse_evs_through_the_trainer_matches_aa_evs_fit():
    """The Trainer route of mse_evs on ActiveAcoustics.F_MM (the graph:
    torch.linalg.eigvals and its gradient) trains U as aa_evs_fit (the
    char-poly rows and K7's plain version) does over the same partitions:
    its first loss at 1e-4 (the eigenvalue step's bound against mse_evs,
    tests/test_torch_active_acoustics.py) and U at 1e-5 of its scale
    after 8 steps."""
    from flamo_tpu_torch.models import ActiveAcoustics, aa_evs_fit
    from flamo_tpu_torch.optimize import DatasetColorless, mse_evs

    def rig():
        return ActiveAcoustics(n_S=1, n_M=2, n_L=3, n_A=1, nfft=NFFT,
                               FIR_order=16, wgn_RT=0.1, room_t60=0.1,
                               device="cpu",
                               generator=torch.Generator().manual_seed(2))

    tl, vl = load_dataset(DatasetColorless((1, M, 2), (1, M, 2), expand=5,
                                           device="cpu"),
                          batch_size=1, split=0.8, shuffle=False)
    crit = mse_evs(iter_num=len(tl), freq_points=M, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    aa = rig()
    _, hist = aa_evs_fit(aa, torch.ones(M, 2), n_steps=8, lr=1e-2,
                         iter_num=len(tl), masks=crit.mask_indices)
    ab = rig()
    tr = Trainer(ab.F_MM, max_epochs=2, lr=1e-2, log=False)
    tr.register_criterion(crit, 1)
    tr.train(tl, vl)
    assert tr._step_count == 8 and tr.fused_path is None
    first = tr.train_loss_log["mse_evs"][0]
    assert abs(first - hist[0]) <= 1e-4 * hist[0]
    u, ub = aa.U.param.detach(), ab.U.param.detach()
    assert float((u - ub).abs().max()) <= 1e-5 * float(u.abs().max())


def test_masked_mse_on_the_colorless_fdn_never_dispatches():
    _, mt = _colorless_pair()
    _, (x, t) = _io()
    tr = Trainer(mt, lr=1e-2, log=False, fused="force")
    tr.register_criterion(masked_mse_loss(nfft=NFFT, n_samples=64,
                                          device="cpu"), 1)
    assert recognize_fused(mt, tr.criterion, tr.alpha,
                           tr.requires_model) == []
    tr.fit_scan(x, t, n_steps=2, steps_per_call=2)
    assert tr.fused_path is None


def test_a_raising_kernel_surfaces_through_the_trainer(monkeypatch):
    """The gate catches no kernel error: K1's wrapper raising (as a
    failed build or launch would) stops fused='force', instead of a quiet
    fallback to the graph path."""
    def broken(*args, **kwargs):
        raise RuntimeError("fdn_tf_mse_kernel: nvcc failed")

    monkeypatch.setattr(fk, "fdn_tf_mse_kernel", broken)
    _, mt = _colorless_pair()
    _, (x, t) = _io()
    tr = _port_trainer(mt, fused="force")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tr.fit_scan(x, t, n_steps=2)
    assert tr.fused_path is None


def test_batches_the_fused_step_cannot_take_stay_on_the_graph(capsys):
    _, mt = _colorless_pair()
    ds = Dataset(input=_io()[1][0], target=_io()[1][1], expand=4,
                 device="cpu")
    tl, _ = load_dataset(ds, batch_size=2, split=1.0, seed=0)
    tr = _port_trainer(mt, fused="force")
    tr.train_step(next(iter(tl)))
    assert tr.fused_path is None
    assert "refused ['colorless_fused_step']" in capsys.readouterr().out


def test_unported_options_raise():
    _, mt = _colorless_pair()
    # profile_dir is ported (tests/test_torch_profile_aliases.py traces
    # with it): the Trainer keeps it, as the JAX package's does
    assert Trainer(mt, log=False, profile_dir="trace").profile_dir == "trace"
    with pytest.raises(ValueError, match="fused"):
        Trainer(mt, log=False, fused="on")
    with pytest.raises(ValueError, match="train_dir"):
        Trainer(mt, log=True, train_dir=None)


def test_watchdog_raises_on_nonfinite():
    _, mt = _colorless_pair()
    tr = _port_trainer(mt)
    tr._check_fused_finite(float("nan"))  # the graph path passes NaNs on
    tr.fused_path = "colorless_fused_step"
    with pytest.raises(RuntimeError, match="fused.*non-finite"):
        tr._check_fused_finite(float("nan"))
    with pytest.raises(RuntimeError, match="fused.*non-finite"):
        tr._check_fused_finite(np.array([1.0, np.inf]))
    tr._check_fused_finite(np.array([1.0, 2.0]))


def test_fit_scan_runs_exactly_n_steps():
    """160 steps at steps_per_call 50 are 160 losses (3 x 50 + 10), one
    host copy a chunk; 0 steps give an empty history."""
    _, mt = _colorless_pair()
    _, (x, t) = _io()
    tr = _port_trainer(mt)
    chunks = []
    tr._check_fused_finite = lambda losses: chunks.append(len(losses))
    hist = tr.fit_scan(x, t, n_steps=160, steps_per_call=50)
    assert hist.shape == (160,) and hist.dtype == np.float32
    assert chunks == [50, 50, 50, 10] and tr._step_count == 160
    assert tr.fit_scan(x, t, n_steps=0).shape == (0,)
    with pytest.raises(ValueError, match="steps_per_call"):
        tr.fit_scan(x, t, n_steps=3, steps_per_call=0)


def test_train_scan_equals_train_and_jax():
    """train(scan=True) equals train(scan=False) at the JAX package's
    rtol 1e-5 (tests/test_trainer.py's scan lockstep; the two sum the
    epoch's losses in other precisions), and both follow JAX's epoch loop
    at the graph lockstep's 1e-4."""
    (xj, tj), (x, t) = _io()

    def run_jax():
        mj, _ = _colorless_pair(seed=5)
        tl, vl = jopt.load_dataset(jopt.Dataset(input=xj, target=tj,
                                                expand=8),
                                   batch_size=2, split=0.75, shuffle=False)
        tr = jopt.Trainer(mj, max_epochs=2, lr=1e-2, log=False, fused="off")
        _colorless_criteria(tr, jloss)
        tr.train(tl, vl)
        return tr.train_loss, tr.valid_loss

    def run(scan):
        _, mt = _colorless_pair(seed=5)
        tl, vl = load_dataset(Dataset(input=x, target=t, expand=8,
                                      device="cpu"),
                              batch_size=2, split=0.75, shuffle=False)
        tr = Trainer(mt, max_epochs=2, lr=1e-2, log=False)
        _colorless_criteria(tr, tloss)
        tr.train(tl, vl, scan=scan)
        assert len(tr.train_loss_log["mse_loss"]) == 6
        assert len(tr.valid_loss_log["sparsity_loss"]) == 2
        return tr.train_loss, tr.valid_loss

    loop_tl, loop_vl = run(False)
    scan_tl, scan_vl = run(True)
    np.testing.assert_allclose(scan_tl, loop_tl, rtol=1e-5)
    np.testing.assert_allclose(scan_vl, loop_vl, rtol=1e-5)
    jax_tl, jax_vl = run_jax()
    np.testing.assert_allclose(loop_tl, jax_tl, rtol=1e-4)
    np.testing.assert_allclose(loop_vl, jax_vl, rtol=1e-4)


def test_early_stop_follows_jax():
    """The same scripted validation losses stop both Trainers at the same
    epoch."""
    seq = [1.0, 0.95, 0.93, 0.5, 0.45, 0.46, 0.44, 0.3]
    flamo_tpu.set_seed(0)
    trj = jopt.Trainer(jm.build_colorless_fdn(nfft=NFFT, delays=DELAYS),
                       patience=2, patience_delta=0.1, log=False)
    tr = Trainer(build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu"),
                 patience=2, patience_delta=0.1, log=False)
    got_j, got_t = [], []
    for v in seq:
        trj.valid_loss.append(v)
        tr.valid_loss.append(v)
        got_j.append(trj.early_stop())
        got_t.append(tr.early_stop())
    assert got_t == got_j and any(got_t)
    assert (tr.counter, tr.min_val_loss) == (trj.counter, trj.min_val_loss)


def test_learning_rate_follows_optax_staircase():
    """The learning rate of update s is lr * factor ** (s // (step_size *
    steps_per_epoch)), optax's exponential_decay(staircase=True), to
    float32 rounding (rtol 1e-6)."""
    _, mt = _colorless_pair()
    _, (x, t) = _io()
    tr = _port_trainer(mt, step_size=2, step_factor=0.3)
    tr._build_step(steps_per_epoch=3)
    schedule = optax.exponential_decay(init_value=1e-2, transition_steps=6,
                                       decay_rate=0.3, staircase=True)
    lrs = []
    for _ in range(20):
        lrs.append(tr._opt.param_groups[0]["lr"])
        tr.fit_scan(x, t, n_steps=1)
    np.testing.assert_allclose(lrs, [float(schedule(s)) for s in range(20)],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint written by flamo_tpu's save_model_state restores into
    a fresh port model whose response then equals the JAX model's at 1e-6
    of its max; the port's own checkpoint carries the same fingerprint
    and restores into JAX."""
    mj, _ = _colorless_pair(seed=3)
    path = str(tmp_path / "jax.pkl")
    jtrainer.save_model_state(mj, path)
    mt = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu",
                             generator=torch.Generator().manual_seed(99))
    assert ttrainer.load_model_state(mt, path) is mt
    H_j = np.asarray(mj.get_freq_response(fs=48000))
    H_t = mt.get_freq_response(fs=48000).numpy()
    assert np.abs(H_t - H_j).max() <= 1e-6 * np.abs(H_j).max()

    ours = str(tmp_path / "port.pkl")
    ttrainer.save_model_state(mt, ours)
    import pickle

    with open(path, "rb") as f, open(ours, "rb") as g:
        assert pickle.load(f)["fingerprint"] == pickle.load(g)["fingerprint"]
    back = jtrainer.load_model_state(
        jm.build_colorless_fdn(nfft=NFFT, delays=DELAYS), ours)
    for k, v in _jax_params(back).items():
        np.testing.assert_array_equal(v, _jax_params(mj)[k])


def test_checkpoint_mismatch_raises_naming_the_leaf(tmp_path):
    _, mt = _colorless_pair(seed=3)
    path = str(tmp_path / "ckpt.pkl")
    ttrainer.save_model_state(mt, path)
    import pickle

    with open(path, "rb") as f:
        payload = pickle.load(f)
    leaf = ".core.modules[1].feedback.param"

    def write(p):
        bad = str(tmp_path / "bad.pkl")
        with open(bad, "wb") as f:
            pickle.dump(p, f)
        return bad

    fresh = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu")
    missing = {**payload, "leaves": {k: v for k, v in
                                     payload["leaves"].items() if k != leaf}}
    with pytest.raises(ValueError, match=r"missing leaves \['\.core\.modules"
                       r"\[1\]\.feedback\.param'\]"):
        ttrainer.load_model_state(fresh, write(missing))
    shape = {**payload, "leaves": {**payload["leaves"],
                                   leaf: payload["leaves"][leaf][:2]}}
    with pytest.raises(ValueError, match=r"feedback\.param has shape"):
        ttrainer.load_model_state(fresh, write(shape))
    corrupt = {**payload, "leaves": {**payload["leaves"],
                                     leaf: payload["leaves"][leaf] + 1}}
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        ttrainer.load_model_state(fresh, write(corrupt))
    ttrainer.load_model_state(fresh, path)
    for k, v in jax_named_tensors(fresh).items():
        assert torch.equal(v, jax_named_tensors(mt)[k]), k


# ---------------------------------------------------------------------------
# the fits' chunks
# ---------------------------------------------------------------------------
def test_colorless_fit_history_does_not_depend_on_the_chunks():
    n = 9
    hists = []
    for spc in (1, 7, n):
        mt = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
        _, h = colorless_fit(mt, n_steps=n, lr=1e-2, steps_per_call=spc)
        hists.append(h)
    assert hists[0].shape == (n,)
    for h in hists[1:]:
        np.testing.assert_array_equal(h, hists[0])
