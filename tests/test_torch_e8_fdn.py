"""The e8_fdn slice end to end against flamo_tpu on the CPU: the ``fdn``
and ``direct`` models at nfft=4096, built by JAX's own
``examples/e8_fdn.py:_build_reference_fdn`` (loaded with importlib, the
'xla' backend) and carried into the port with ``load_jax_params``; the
first loss (mss_loss(256, 512, 1024) + sparsity_loss against JAX's WGN
target) at 1e-5 and its gradients at 1e-4 of each leaf's max; 3 Adam
steps of each package's ``Trainer.fit_scan`` in lockstep at 1e-5; the
port's 'pallas'/'pallas' route (K4 and K2 through their plain versions)
against its 'xla'/'ge' route; and the port's example, its backend pick
and its clip map."""

from __future__ import annotations

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu import optimize as jopt
from flamo_tpu.optimize import loss as jloss
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.examples import e8_fdn
from flamo_tpu_torch.examples._common import setup
from flamo_tpu_torch.models.dispatch import recognize_fused
from flamo_tpu_torch.optimize import Trainer, mss_loss, sparsity_loss
from flamo_tpu_torch.utils import load_audio

NFFT = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = types.SimpleNamespace(nfft=NFFT, samplerate=48000, rir=None)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_e8_fdn", os.path.join(ROOT, "examples", "e8_fdn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def jex():
    return _jax_example()


@pytest.fixture(scope="module", params=["fdn", "direct"])
def pair(request, jex):
    """(scenario, JAX model, port model, JAX target, port target)."""
    direct = request.param == "direct"
    flamo_tpu.set_seed(0)
    tj = jex._target_rir(ARGS, NFFT)
    mj = jex._build_reference_fdn(ARGS, 6, e8_fdn.DELAYS, 30, direct=direct,
                                  backend="xla")
    mt = e8_fdn._build_reference_fdn(ARGS, 6, e8_fdn.DELAYS, 30,
                                     direct=direct, backend="xla",
                                     device="cpu")
    load_jax_params(mt, _jax_params(mj))
    return request.param, mj, mt, tj, torch.tensor(np.asarray(tj))


def _impulses():
    xj = jnp.zeros((1, NFFT, 1)).at[:, 0, :].set(1.0)
    x = torch.zeros((1, NFFT, 1))
    x[:, 0, :] = 1.0
    return xj, x


def _port_grads(model, target):
    model.zero_grad(set_to_none=True)
    loss = e8_fdn.first_loss(model, target)
    loss.backward()
    return float(loss), {k: v.grad.clone() for k, v in
                         jax_named_tensors(model).items() if v.requires_grad}


@pytest.fixture(scope="module")
def jax_first(pair):
    """JAX's first loss, its gradients, and the model's output on the
    impulse and its rendered IR, from one jit a scenario."""
    _, mj, _, tj, _ = pair
    xj, _ = _impulses()

    def total(m):
        est = m(xj)
        loss = (jloss.mss_loss(nfft=e8_fdn.MSS_NFFT)(est, tj)
                + jloss.sparsity_loss()(est, tj, m))
        return loss, (est, m.get_time_response())

    (lj, (yj, irj)), gj = jax.jit(jax.value_and_grad(total, has_aux=True))(
        mj)
    return float(lj), _jax_params(gj), np.asarray(yj), np.asarray(irj)


def test_first_loss_and_gradients_match_jax(pair, jax_first):
    """The e8 objective at JAX's initial weights: loss 1e-5, gradients of
    every trainable leaf 1e-4 of its max."""
    name, _, mt, _, tt = pair
    lj, gj, _, _ = jax_first
    lt, gt = _port_grads(mt, tt)
    assert abs(lt - lj) / abs(lj) < 1e-5
    assert len(gt) == (5 if name == "direct" else 4)
    for k, g in gt.items():
        assert _rel(g.numpy(), gj[k]) < 1e-4, k


def test_impulse_response_matches_jax_at_30db(pair, jax_first):
    """The model's output on the impulse (through iFFTAntiAlias, whose
    envelope scales the tail by up to 10^(30/20)) and its rendered IR
    (get_time_response) against JAX's, 1e-5 of the max."""
    _, _, mt, _, _ = pair
    _, _, yj, irj = jax_first
    _, x = _impulses()
    with torch.no_grad():
        y = mt(x).numpy()
        ir = mt.get_time_response().numpy()
    assert y.shape == ir.shape == (1, NFFT, 1)
    assert _rel(y, yj) < 1e-5 and _rel(ir, irj) < 1e-5


def test_three_adam_steps_in_lockstep_with_jax(pair):
    """Three steps of each package's Trainer.fit_scan on (impulse, JAX's
    target) from the same weights: the losses at 1e-5, the weights after
    at 1e-4.  The port's gate recognises no fused objective for MSS."""
    name, mj, mt, tj, tt = pair
    xj, x = _impulses()
    trj = jopt.Trainer(mj, lr=1e-3, log=False)
    trj.register_criterion(jloss.mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    trj.register_criterion(jloss.sparsity_loss(), 1, requires_model=True)
    hj = np.asarray(trj.fit_scan(xj, tj, n_steps=3, steps_per_call=3))
    trt = Trainer(mt, lr=1e-3, log=False)
    trt.register_criterion(mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    trt.register_criterion(sparsity_loss(), 1, requires_model=True)
    assert recognize_fused(mt, trt.criterion, trt.alpha,
                           trt.requires_model) == []
    ht = trt.fit_scan(x, tt, n_steps=3, steps_per_call=3)
    assert trt.fused_path is None
    np.testing.assert_allclose(ht, hj, rtol=1e-5)
    assert ht[-1] < ht[0]
    named = jax_named_tensors(trt.net)
    for k, v in _jax_params(trj.net).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_pallas_route_matches_xla_route(pair):
    """The port's 'pallas'/'pallas' build (the GEQ cascade through K4's
    plain version, the loop through K2's) from the same weights as its
    'xla'/'ge' build: loss 1e-5, gradients 1e-4."""
    name, _, mt, _, tt = pair
    mk = e8_fdn._build_reference_fdn(ARGS, 6, e8_fdn.DELAYS, 30,
                                     direct=name == "direct",
                                     backend="pallas", device="cpu")
    mk.load_state_dict(mt.state_dict())
    loop = (mk.core.branchA if name == "direct" else mk.core).feedback_loop
    assert loop.solve_method == "pallas"
    assert loop.feedback.attenuation.cascade_backend == "pallas"
    lx, gx = _port_grads(mt, tt)
    lk, gk = _port_grads(mk, tt)
    assert abs(lk - lx) / abs(lx) < 1e-5
    for k in gx:
        assert _rel(gk[k].numpy(), gx[k].numpy()) < 1e-4, k


@pytest.mark.parametrize("value", [1.0, -1.0, 0.5])
def test_direct_gain_clip_map_gradient_matches_jnp_clip(value):
    """The direct gain's clip map at and inside the boundary: jnp.clip's
    gradient (1/2 at +-1; torch.clamp would give 1)."""
    g = torch.tensor([[value]], requires_grad=True)
    e8_fdn._clip_unit(g).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, -1.0, 1.0).sum())(
        jnp.asarray([[value]]))
    assert float(g.grad) == float(want[0, 0])


def test_example_main_on_cpu(tmp_path, capsys):
    """The port's example, all four scenarios on the CPU at nfft=2048
    through the 'pallas' route (both builds and the routes' check, then
    Trainer.train for the trained ones): WAVs written and finite, the
    accurate GEQ's RT within its gate; no scenario is left unported."""
    args = setup(e8_fdn.parser().parse_args([
        "--device", "cpu", "--nfft", "2048", "--num", "4",
        "--max_epochs", "1", "--backend", "pallas",
        "--train_dir", str(tmp_path)]))
    results = e8_fdn.main(args)
    out = capsys.readouterr().out
    assert out.count("backend=pallas") == 4 and "final loss" in out
    assert len(results) == 4 and list(e8_fdn.SCENARIOS) == [
        "fdn", "accurate_geq", "direct", "delay_scaled"]
    assert results[1]["rt_mse"] < e8_fdn.RT_MSE_TOL
    for tag in ("fdn", "direct"):
        for kind in ("init", "optim"):
            ir, fs = load_audio(str(tmp_path / f"ir_{kind}_{tag}.wav"))
            assert fs == 48000 and np.isfinite(ir).all()
            assert 0 < np.abs(ir).max() <= 1
    ir, _ = load_audio(str(tmp_path / "ir_accurate_geq.wav"))
    assert np.isfinite(ir).all()
    assert np.isfinite(results[3].train_loss).all()


@pytest.mark.parametrize("backend,gap", [("auto", 0.0), ("auto", 1.0),
                                         ("pallas", 1.0)])
def test_pick_backend_falls_back_only_on_parity(monkeypatch, capsys,
                                                backend, gap):
    """On the card 'auto' is 'pallas': it keeps the 'pallas' model when
    the first losses agree and raises, as 'pallas' does, when they do
    not; nothing falls back to 'xla'.  (On the CPU 'auto' builds 'xla'
    alone, so the CPU stands in for the card here through a device of
    type 'cuda'.)"""
    built = []

    def build(be):
        built.append(be)
        return types.SimpleNamespace(backend=be)

    monkeypatch.setattr(e8_fdn, "first_loss", lambda m, t, sr: torch.tensor(
        1.0 + (gap if m.backend == "pallas" else 0.0)))
    args = types.SimpleNamespace(backend=backend, seed=0, samplerate=48000)
    card = types.SimpleNamespace(type="cuda")
    if gap:
        with pytest.raises(RuntimeError, match="parity gate failed"):
            e8_fdn._pick_backend(args, build, None, card)
        assert built == ["xla", "pallas"]
        return
    model, be = e8_fdn._pick_backend(args, build, None, card)
    assert built == ["xla", "pallas"]
    assert be == model.backend == "pallas"
    assert "backend=pallas" in capsys.readouterr().out


def test_target_rir_from_a_wav_matches_jax(tmp_path, jex):
    """``--rir``: the measured RIR's first channel, peak-normalised and cut
    from find_onset's sample, zero-padded to nfft, as JAX's example cuts
    it from the same WAV."""
    from flamo_tpu_torch.utils import save_audio

    rng = np.random.default_rng(7)
    rir = np.zeros((3000, 2))
    rir[700:] = (rng.normal(size=(2300, 2))
                 * np.exp(-np.arange(2300) / 300.0)[:, None])
    path = str(tmp_path / "rir.wav")
    save_audio(path, 0.5 * rir / np.abs(rir).max(), fs=48000)
    args = types.SimpleNamespace(nfft=NFFT, samplerate=48000, rir=path)
    got = e8_fdn._target_rir(args, NFFT, torch.device("cpu"))
    want = np.asarray(jex._target_rir(args, NFFT))
    assert got.shape == want.shape == (1, NFFT, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert float(got.abs().max()) == 1.0
