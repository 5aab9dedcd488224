"""The port's e7_biquad_nn, e10_probe and e4_recursion examples against
flamo_tpu's on the CPU, the e7 examples' outputs, and chip_smoke.py's
phase 4h helpers.

* the 'svf'-design PEQ scenarios in float64 and e7_biquad's fixed demo,
  in lockstep as tests/test_torch_e7.py holds the other e7 scenarios
  (its helpers);
* e7_biquad_nn: the JAX example's MLP weights, five Adam steps through
  ``ext_param`` in lockstep (torch.optim.Adam against optax.adam);
* e10_probe and e4_recursion: the JAX models' weights carried by
  ``convert``, the three response paths and the open-loop spectral
  radius against JAX's, and each port ``main`` at a small nfft;
* each e7 example's ``main`` writes its losses and magnitudes;
* phase 4h's helpers on the CPU, K4's wrappers (their plain versions
  here) counted as the card counts them.

Tolerances: the targets and first losses 1e-5 relative; the later step
losses and the trained weights 1e-4 (Adam steps a weight by up to lr
whatever the size of its gradient); the response paths 1e-4 of the max
(a loop solve per bin)."""

from __future__ import annotations

import os
import types
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flamo_tpu
from flamo_tpu import functional as jf
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.convert import load_jax_params
from flamo_tpu_torch.examples import (_common, e4_recursion, e7_biquad,
                                      e7_biquad_nn, e7_peq, e7_svf,
                                      e10_probe)
from flamo_tpu_torch.ops import sos_kernels as sk
from test_torch_e7 import _args, _held_in_lockstep, _jax_train

NFFT = 256
M = NFFT // 2 + 1
FS = 48000
SEED = 130709
FIRST_TOL = 1e-5
STEP_TOL = 1e-4
PATH_TOL = 1e-4


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def test_e7_examples_write_their_outputs(tmp_path):
    """Each e7 example's main at a small size: the losses and the
    magnitudes of every scenario land in train_dir."""
    for mod, argv in ((e7_biquad, []), (e7_svf, []),
                      (e7_peq, ["--scenario", "parallel_peq"])):
        args = _common.setup(mod.parser().parse_args(
            ["--device", "cpu", "--nfft", "128", "--num", "4",
             "--max_epochs", "1", "--train_dir", str(tmp_path)] + argv))
        mod.main(args)
    names = set(os.listdir(tmp_path))
    for tag in ("biquad", "parallel_biquad", "svf", "parallel_svf",
                "lowshelf", "parallel_peq_biquad", "parallel_peq_svf"):
        assert f"magnitude_response_{tag}.npz" in names
        assert f"losses_{tag}.txt" in names
    mags = np.load(tmp_path / "magnitude_response_svf.npz")
    assert mags["target"].shape == mags["estimation"].shape == (65, 2)
    assert "e7_biquad_mag.npz" in names


@pytest.mark.parametrize("name", ["peq_svf"])
def test_e7_peq_svf_in_lockstep_with_jax_in_float64(name, tmp_path):
    """The 'svf'-design PEQ scenario in float64: the same filter, target
    and Trainers, three steps in lockstep at the bounds above (the
    parallel PEQ shares the design and the code path)."""
    scenario, design = name.rsplit("_", 1)
    args = _args(1e-2, tmp_path)
    with jax.enable_x64(True):
        cls = "PEQ" if scenario == "peq" else "parallelPEQ"
        size, in_ch = ((2, 1), 1) if scenario == "peq" else ((2,), 2)
        kw = dict(size=size, n_bands=e7_peq.N_BANDS, design=design,
                  nfft=NFFT, fs=FS)
        flamo_tpu.set_seed(args.seed)
        src = getattr(jdsp, cls)(**kw, dtype=jnp.float64)
        jfilt = getattr(jdsp, cls)(**kw, dtype=jnp.float64,
                                   requires_grad=True)
        H = src.response()
        jtarget = jnp.abs(jnp.sum(H, axis=-1) if scenario == "peq"
                          else H)[None]
        filt = getattr(e7_peq.dsp, cls)(**kw, dtype=torch.float64,
                                        requires_grad=True, device="cpu")
        filt.assign_value(np.asarray(jfilt.param))
        tr, tl, vl = _common.filter_trainer(
            args, filt, torch.tensor(np.asarray(jtarget)), in_ch, log=False)
        tr.train(tl, vl)
        jmodel = jsystem.Shell(
            core=jfilt, input_layer=jdsp.FFT(NFFT, dtype=jnp.float64),
            output_layer=jdsp.Transform(jnp.abs, dtype=jnp.float64))
        x = jf.signal_gallery(1, n_samples=NFFT, n=in_ch,
                              signal_type="impulse", dtype=jnp.float64)
        jtr = _jax_train(jmodel, x, jtarget, args, tmp_path, step_size=25,
                         patience_delta=1e-5)
        _held_in_lockstep(tr, jtr, filt, jfilt)


def test_e7_fixed_in_lockstep_with_jax(tmp_path):
    """e7_biquad's fixed demo: the port's target equals JAX's, and the
    Trainer (its own schedule and patience) steps in lockstep."""
    args = _args(1e-2, tmp_path)
    flamo_tpu.set_seed(args.seed)
    jfilt = jdsp.Biquad(size=(1, 2), n_sections=2, filter_type="highpass",
                        nfft=NFFT, fs=FS, requires_grad=True)
    b1, a1 = jf.highpass_filter(fc=4000.0, gain=4.0, fs=FS)
    b2, a2 = jf.highpass_filter(fc=8000.0, gain=-2.0, fs=FS)
    jtarget = jnp.abs(jf.biquad2tf(b1, a1, NFFT)
                      * jf.biquad2tf(b2, a2, NFFT))[None, :, None]
    filt, target, x = e7_biquad.scenario_fixed(args, "cpu")
    assert _rel(target.numpy(), jtarget) < FIRST_TOL
    assert tuple(x.shape) == (1, M, 2)
    filt.assign_value(np.asarray(jfilt.param))
    tr, tl, vl = e7_biquad.fixed_trainer(args, filt, target, x, log=False)
    tr.train(tl, vl)
    jmodel = jsystem.Shell(core=jfilt, input_layer=jdsp.FFT(NFFT),
                           output_layer=jdsp.Transform(jnp.abs))
    jtr = _jax_train(jmodel, jf.signal_gallery(1, M, 2, "impulse"),
                     jtarget, args, tmp_path)
    _held_in_lockstep(tr, jtr, filt, jfilt)


# ---------------------------------------------------------------------------
# e7_biquad_nn: ext_param from an MLP
# ---------------------------------------------------------------------------
def test_e7_biquad_nn_in_lockstep_with_jax():
    """The JAX example's MLP (its init from PRNGKey(seed)) predicts the
    Biquad's raw params through ext_param; five Adam steps of each."""
    K = e7_biquad_nn.K
    flamo_tpu.set_seed(SEED)
    jfilt = jdsp.Biquad(size=(1, 1), n_sections=K, filter_type="highpass",
                        nfft=NFFT, fs=FS)
    jshell = jsystem.Shell(core=jsystem.Series({"bq": jfilt}),
                           input_layer=jdsp.FFT(NFFT),
                           output_layer=jdsp.Transform(jnp.abs))
    b, a = jf.highpass_filter(fc=6000.0, gain=0.0, fs=FS)
    jtarget = jnp.abs(jf.biquad2tf(b, a, NFFT))[None, :, None]
    jx = jf.signal_gallery(1, NFFT, 1, "impulse")
    key, params = jax.random.PRNGKey(SEED), []
    for i, (n_in, n_out) in enumerate(((1, 32), (32, 2 * K))):
        key, k1 = jax.random.split(key)
        params.append((jax.random.normal(k1, (n_in, n_out)) * 0.3,
                       jnp.zeros(n_out)))

    def predict(p, c):
        h = c
        for i, (W, bb) in enumerate(p):
            h = h @ W + bb
            if i < len(p) - 1:
                h = jax.nn.tanh(h)
        raw = h.reshape(K, 2, 1, 1)
        return jnp.concatenate([jax.nn.sigmoid(raw[:, 0:1]),
                                jnp.exp(raw[:, 1:2])], axis=1)

    cond = jnp.asarray([[0.5]])

    def loss_fn(p):
        est = jshell(jx, ext_param={"bq": predict(p, cond)})
        return jnp.mean((est - jtarget) ** 2)

    tx = optax.adam(5e-3)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s)
        return optax.apply_updates(p, u), s, loss

    tparams = [(torch.tensor(np.asarray(W), requires_grad=True),
                torch.tensor(np.asarray(bb), requires_grad=True))
               for W, bb in params]
    state, jlosses = tx.init(params), []
    for _ in range(5):
        params, state, loss = step(params, state)
        jlosses.append(float(loss))
    shell, x, target = e7_biquad_nn.build(
        types.SimpleNamespace(nfft=NFFT, samplerate=FS), "cpu")
    assert _rel(target.numpy(), jtarget) < FIRST_TOL
    losses = e7_biquad_nn.fit(shell, x, target, tparams,
                              torch.tensor([[0.5]]), steps=5)
    assert abs(losses[0] - jlosses[0]) / jlosses[0] < FIRST_TOL
    assert _rel(losses, jlosses) < STEP_TOL and losses[-1] < losses[0]
    for (W, bb), (jW, jb) in zip(tparams, params):
        assert _rel(W.detach().numpy(), jW) < STEP_TOL
    # the Biquad's own param stays frozen and untouched
    assert not shell.core.bq.param.requires_grad


# ---------------------------------------------------------------------------
# e10_probe and e4_recursion
# ---------------------------------------------------------------------------
def _jax_e10(nfft):
    """The JAX example's model, as its main builds it."""
    flamo_tpu.set_seed(SEED)
    dl = jdsp.parallelDelay(size=(3,), max_len=108, nfft=nfft, isint=True)
    dl = dl.assign_value(dl.sample2s(jnp.asarray((89, 97, 107),
                                                 jnp.float32)))
    att = jdsp.parallelGain(size=(3,), nfft=nfft).assign_value(
        0.8 * jnp.ones(3))
    loop = jsystem.Recursion(
        fF=jsystem.Series(OrderedDict({"d": dl, "a": att})),
        fB=jdsp.Matrix(size=(3, 3), nfft=nfft, matrix_type="orthogonal"))
    core = jsystem.Series(OrderedDict({
        "i": jdsp.Gain(size=(3, 1), nfft=nfft), "l": loop,
        "o": jdsp.Gain(size=(1, 3), nfft=nfft)}))
    return jsystem.Shell(core=core, input_layer=jdsp.FFT(nfft),
                         output_layer=jdsp.iFFT(nfft))


def test_e10_paths_match_jax(tmp_path):
    """The port's three response paths on the JAX model's weights against
    JAX's own three, each within 5e-3 of the others, and main passes."""
    jmodel = _jax_e10(NFFT)
    model, core = e10_probe.build(NFFT, "cpu")
    load_jax_params(model, _jax_params(jmodel))
    paths = e10_probe.response_paths(model, core, FS)
    zs = jnp.exp(1j * 2 * jnp.pi * jnp.arange(M) / NFFT)
    jpaths = (np.asarray(jax.jit(lambda m: m.get_freq_response(fs=FS))(
                  jmodel))[0, :, 0],
              np.asarray(jax.jit(jax.vmap(
                  lambda z: jmodel.probe(z)[0, 0]))(zs)),
              np.asarray(jax.jit(lambda m: m.core(jnp.ones(
                  (1, M, 1), jnp.complex64)))(jmodel))[0, :, 0])
    for got, ref in zip(paths, jpaths):
        assert _rel(got, ref) < PATH_TOL
    assert max(e10_probe.path_errors(*paths).values()) < e10_probe.TOL
    e10_probe.main(_common.setup(types.SimpleNamespace(
        nfft=NFFT, samplerate=FS, device="cpu", seed=SEED,
        train_dir=str(tmp_path))))
    assert np.load(tmp_path / "e10_responses.npz")["probe"].shape == (M,)


def test_e4_recursion_matches_jax(tmp_path):
    """The open-loop spectral radius over every 64th bin on the JAX
    model's weights against JAX's, the input-free IRs against JAX's, and
    main passes its assert (radius < 1)."""
    nfft = 1024
    flamo_tpu.set_seed(SEED)
    delays = jdsp.parallelDelay(size=(3,), max_len=300, isint=True,
                                nfft=nfft)
    atten = jdsp.parallelGain(size=(3,), nfft=nfft).assign_value(
        0.6 * jnp.ones(3))
    loop = jsystem.Recursion(
        fF=jsystem.Series(OrderedDict({"delays": delays,
                                       "attenuation": atten})),
        fB=jdsp.Matrix(size=(3, 3), nfft=nfft, matrix_type="orthogonal"))
    jmodel = jsystem.Shell(core=loop, input_layer=jdsp.FFT(nfft),
                           output_layer=jdsp.iFFT(nfft))
    model, tloop = e4_recursion.build(nfft, "cpu")
    load_jax_params(model, _jax_params(jmodel))
    z = jnp.exp(1j * 2 * jnp.pi * jnp.arange(0, nfft // 2, 64) / nfft)
    P = jax.jit(jax.vmap(loop.probe_recursion))(z)
    jrho = float(jnp.abs(jf.get_eigenvalues(jnp.eye(3) - P)).max())
    rho = e4_recursion.open_loop_radius(tloop, nfft)
    assert abs(rho - jrho) < FIRST_TOL and rho < 1
    ir = model.get_time_response(fs=FS, identity=True)
    jir = jax.jit(lambda m: m.get_time_response(fs=FS, identity=True))(
        jmodel)
    assert _rel(ir.numpy(), jir) < PATH_TOL
    assert e4_recursion.main(_common.setup(types.SimpleNamespace(
        nfft=512, samplerate=FS, device="cpu", seed=SEED,
        train_dir=str(tmp_path)))) < 1


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 4h on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture()
def counted_k4(monkeypatch):
    """K4's wrappers counting their calls as the card's launches."""
    fwd, bwd = sk.sos_cascade_fwd_kernel, sk.sos_cascade_bwd_kernel

    def spy(name, fn):
        def run(*args, **kwargs):
            sk.LAUNCHES[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(sk, "sos_cascade_fwd_kernel",
                        spy("sos_cascade_fwd", fwd))
    monkeypatch.setattr(sk, "sos_cascade_bwd_kernel",
                        spy("sos_cascade_bwd", bwd))


@pytest.mark.parametrize("name", ["biquad", "peq_svf", "parallel_svf"])
def test_phase_zoo_scenario_on_cpu(name, counted_k4):
    """zoo_scenario at nfft 512: the two routes from one seed, the exact
    K4f/K4b counts of the first loss, one epoch and the fit_scan steps,
    the falling losses (each checked inside)."""
    import chip_smoke as cs

    r = cs.zoo_scenario(name, nfft=512, device="cpu")
    assert (r["f64"] is not None) == (name in cs.ZOO_ILL)
    assert (r["n_train"], r["n_valid"]) == (6, 2)
    assert r["epoch_counts"] == {"sos_cascade_fwd": 8, "sos_cascade_bwd": 6}
    assert r["trainer"].fused_path is None


def test_phase_zoo_nn_and_e10_on_cpu(counted_k4):
    import chip_smoke as cs

    losses, counts = cs.zoo_nn(nfft=512, device="cpu", steps=5)
    assert counts == {"sos_cascade_fwd": 5, "sos_cascade_bwd": 5}
    errors = e10_probe.path_errors(*e10_probe.response_paths(
        *cs.e10_paths_model(512, "cpu"), FS))
    assert max(errors.values()) < e10_probe.TOL
    assert set(cs.ZOO) == {"biquad", "parallel_biquad", "peq_biquad",
                           "peq_svf", "parallel_peq_biquad",
                           "parallel_peq_svf", "svf", "parallel_svf"}
