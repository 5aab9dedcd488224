"""The loss surfaces against flamo_tpu on the CPU: ``optimize/surface.py``
(``LossProfile``, ``LossSurface``) on an N=4 ``HomogeneousFDN`` at
nfft=512 carried from JAX's weights, and the e9 example.  Without a
perturbation both packages scan the same models: the losses agree to 1e-5
of the largest, and ``compute_accuracy`` of one loss array is equal.  The
port writes the scanned parameters in place; its perturbations come from
a ``torch.Generator`` (another PRNG than JAX's), so a perturbed scan is
held to itself (the same seed, the same losses).  Last, chip_smoke.py's
phase 4j (the reverb domain) at small sizes, the kernels' wrappers
counted."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import flamo_tpu
from flamo_tpu.auxiliary import config as jcfg
from flamo_tpu.auxiliary import reverb as jrev
from flamo_tpu.optimize import loss as jloss
from flamo_tpu.optimize import surface as jsurf
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch.convert import load_jax_params
from flamo_tpu_torch.examples import e9_loss_profile as e9
from flamo_tpu_torch.examples._common import setup
from flamo_tpu_torch.optimize import loss as tloss
from flamo_tpu_torch.optimize import surface as tsurf

NFFT = 512
N = 4
ATT = e9.ATTENUATION
LOSS_TOL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


@pytest.fixture
def models():
    """(JAX model, the port's model from JAX's weights, the port's input
    and target, JAX's): e9's FDN at NFFT, an rfft input layer and an |.|
    output layer."""
    flamo_tpu.set_seed(0)
    fj = jrev.HomogeneousFDN(jcfg.HomogeneousFDNConfig(
        N=N, nfft=NFFT, delays=list(e9.DELAYS), alias_decay_db=0))
    mj = (fj.model.set_outputLayer(jdsp.Transform(lambda z: jnp.abs(z)))
          .set_inputLayer(jdsp.FFT(NFFT)))
    mt = e9.build_model(NFFT, "xla", "cpu", seed=0)
    load_jax_params(mt, _jax_params(fj.model))
    x = np.zeros((1, NFFT, 1), np.float32)
    x[0, 0, 0] = 1.0
    t = np.ones((1, NFFT // 2 + 1, 1), np.float32)
    return mj, mt, (torch.tensor(x), torch.tensor(t)), (jnp.asarray(x),
                                                         jnp.asarray(t))


def _configs(pkg, lib, ones, out=None, **extra):
    """A profile's and a surface's LossConfig of e9's scans in package
    ``pkg``, without a perturbation."""
    crit = [lib.mse_loss(nfft=NFFT)]
    profile = pkg.LossConfig(
        criteria=crit, n_runs=1, output_dir=out,
        param_config=[pkg.ParameterConfig(
            key=ATT, lower_bound=-3.0, upper_bound=6.0, n_steps=9,
            param_map=lambda v: v * ones((N,)), target_value=1.5,
            **extra)])
    surface = pkg.LossConfig(
        criteria=crit, n_runs=1, output_dir=out,
        param_config=[
            pkg.ParameterConfig(key=ATT, lower_bound=-2.0, upper_bound=4.0,
                                n_steps=3, target_value=0.0,
                                param_map=lambda v: v * ones((N,))),
            pkg.ParameterConfig(key="input_gain", lower_bound=0.1,
                                upper_bound=1.0, n_steps=4, scale="log",
                                target_value=0.3,
                                param_map=lambda v: v * ones((N, 1)))])
    return profile, surface


def test_profile_and_surface_match_jax(models, tmp_path):
    """The steps (linear and log), the losses of both scans at 1e-5,
    compute_accuracy of JAX's losses equal in both packages, the module
    keys, the .mat files and plot_loss's tables."""
    mj, mt, (x, t), (xj, tj) = models
    pj, sj = _configs(jsurf, jloss, jnp.ones)
    pt, st = _configs(tsurf, tloss, torch.ones, out=str(tmp_path))
    lpj, lpt = jsurf.LossProfile(mj, pj), tsurf.LossProfile(mt, pt)
    assert _rel(lpt.steps, lpj.steps) < 1e-6
    assert lpt.get_modules_keys(mt.get_core()) == lpj.get_modules_keys(
        mj.get_core())
    lj, lt = lpj.compute_loss(xj, tj), lpt.compute_loss(x, t)
    assert lt.shape == lj.shape == (1, 9, 1)
    assert _rel(lt, lj) < LOSS_TOL
    np.testing.assert_array_equal(lpt.compute_accuracy(lj),
                                  lpj.compute_accuracy(lj))
    lsj, lst = jsurf.LossSurface(mj, sj), tsurf.LossSurface(mt, st)
    assert _rel(lst.steps_1, lsj.steps_1) < 1e-6
    l2j, l2t = lsj.compute_loss(xj, tj), lst.compute_loss(x, t)
    assert l2t.shape == l2j.shape == (1, 3, 4, 1)
    assert _rel(l2t, l2j) < LOSS_TOL
    np.testing.assert_array_equal(lst.compute_accuracy(l2j),
                                  lsj.compute_accuracy(l2j))
    saved = scipy.io.loadmat(str(tmp_path / "partial_loss_run_1.mat"))
    np.testing.assert_array_equal(saved["loss"], lt[0])
    assert (tmp_path / "surface_run_1.mat").exists()
    out = lpt.plot_loss(lt)
    assert out["mean"].shape == (9, 1)
    with np.load(tmp_path / f"{ATT}.npz") as f:
        np.testing.assert_array_equal(f["mean"], lt.mean(0))
    assert "min" in (tmp_path / f"{ATT}.txt").read_text()
    lst.plot_loss(l2t)
    assert (tmp_path / "loss_surface.txt").exists()


def test_interpolated_bounds_and_in_place_writes(models):
    """List bounds interpolate between two parameter vectors, as JAX's;
    set_raw_parameter writes the module's tensor in place, also at an
    index."""
    mj, mt, (x, t), (xj, tj) = models
    lo, hi = [1.0, 2.0, -1.0, 0.5], [4.0, -2.0, 3.0, 2.0]
    pj, _ = _configs(jsurf, jloss, jnp.ones)
    pt, _ = _configs(tsurf, tloss, torch.ones)
    for cfg in (pj, pt):
        pc = cfg.param_config[0]
        pc.lower_bound, pc.upper_bound, pc.n_steps = lo, hi, 5
        pc.param_map = (lambda v: v)
    lj = jsurf.LossProfile(mj, pj).compute_loss(xj, tj)
    prof = tsurf.LossProfile(mt, pt)
    att = mt.get_core().feedback_loop.feedforward.attenuation
    ptr = att.param.data_ptr()
    lt = prof.compute_loss(x, t)
    assert _rel(lt, lj) < LOSS_TOL
    assert att.param.data_ptr() == ptr
    np.testing.assert_array_equal(att.param.detach().numpy(),
                                  np.float32(hi))
    prof.set_raw_parameter("input_gain", torch.tensor(7.0), indx=(2, 0))
    assert float(mt.get_core().input_gain.param[2, 0]) == 7.0
    with pytest.raises(ValueError, match="linear' or 'log"):
        prof.get_steps(0.1, 1.0, 3, "db")


def test_perturbed_runs_repeat_from_a_seed(models):
    """perturb_param redraws the input gains at the start of each run
    (gaussian with the current gains' mean and population std): finite,
    the runs differ, and the same seed gives the same losses."""
    _, mt, (x, t), _ = models
    pt, _ = _configs(tsurf, tloss, torch.ones)
    pt.n_runs, pt.perturb_param = 2, "input_gain"
    gains = mt.get_core().input_gain.param.detach().clone()
    runs = []
    for _ in range(2):
        mt.get_core().input_gain.assign_value(gains)
        prof = tsurf.LossProfile(mt, pt,
                                 generator=torch.Generator().manual_seed(3))
        runs.append(prof.compute_loss(x, t))
    assert np.isfinite(runs[0]).all()
    assert not np.array_equal(runs[0][0], runs[0][1])
    np.testing.assert_array_equal(runs[0], runs[1])
    ref = torch.tensor([[1.0], [2.0], [3.0], [6.0]])
    draw = prof.sample_rand_param(ref, torch.Generator().manual_seed(1))
    want = (torch.randn((4, 1), generator=torch.Generator().manual_seed(1))
            * torch.std(ref, correction=0) + torch.mean(ref))
    assert torch.equal(draw, want)


def test_e9_example_on_cpu(tmp_path, capsys):
    """e9 through the 'pallas' route's plain K2 beside 'ge' (the routes'
    check), its files written."""
    args = setup(e9.parser().parse_args([
        "--device", "cpu", "--nfft", str(NFFT), "--backend", "pallas",
        "--train_dir", str(tmp_path)]))
    loss, loss2 = e9.main(args)
    assert loss.shape == (2, 9, 1) and loss2.shape == (1, 4, 4, 1)
    assert "backend=pallas" in capsys.readouterr().out
    for name in ("partial_loss_run_2.mat", "surface_run_1.mat",
                 f"{ATT}.npz", "loss_surface.npz"):
        assert os.path.exists(tmp_path / name), name


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 4j on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture()
def counted_kernels(monkeypatch):
    """K2's and K4's wrappers counting their calls as launches, K2's
    transposed ones also apart, as the kernels count on the card."""
    from flamo_tpu_torch.ops import fdn_kernels as fk
    from flamo_tpu_torch.ops import sos_kernels as sk

    def spy(mod, attr, name, at=None):
        fn = getattr(mod, attr)

        def run(*args, **kwargs):
            mod.LAUNCHES[name] += 1
            if at is not None and kwargs.get("transpose", len(args) > at
                                             and args[at]):
                fk.K2_TRANSPOSED[0] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, attr, run)

    spy(sk, "sos_cascade_fwd_kernel", "sos_cascade_fwd")
    spy(sk, "sos_cascade_bwd_kernel", "sos_cascade_bwd")
    spy(fk, "fdn_solve_kernel", "fdn_solve", 3)


def test_phase_reverb_on_cpu(counted_kernels):
    """phase 4j's scenarios at small nfft, each gating its counts and its
    route gap inside: HomogeneousFDN (K2 three times), e8_fdn's
    accurate_geq (K4f twice, K2 once), delay_scaled with the accurate GEQ
    (K4f twice a step: it sits in the loop's feedforward) and the shelf
    (K2 only), e9's 34 scanned points, the 1/3-octave accurate GEQ."""
    import chip_smoke as cs

    assert cs.homogeneous_scenario(nfft=NFFT, device="cpu")["counts"] == {
        "fdn_solve": 3}
    assert cs.accurate_fdn_scenario(nfft=1024, device="cpu")["counts"] == {
        "fdn_solve": 1, "sos_cascade_fwd": 2}
    for att in ("accurate_geq", "shelving"):
        r = cs.delay_scaled_scenario(att, nfft=NFFT, device="cpu")
        S = len(r["hist"])
        want = {"fdn_solve": 2 * S, "fdn_solve transposed": S}
        if att == "accurate_geq":
            want["sos_cascade_fwd"] = 2 * S
        assert r["counts"] == want and r["rel"] < cs.DS_LOSS_TOL
    assert cs.e9_scenario(nfft=NFFT, device="cpu")["counts"] == {
        "fdn_solve": 34}
    third = cs.third_octave_scenario(nfft=NFFT, device="cpu")
    assert third[3]["sections"] == 30 and third[1]["sections"] == 12
    assert all(r["f64"]["plain"] < cs.GEQ_VAL_TOL for r in third.values())
