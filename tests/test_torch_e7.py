"""The port's e7 filter-matching scenarios against flamo_tpu's on the
CPU: every scenario (e7_biquad's three, e7_svf's three, e7_peq's two in
both designs), the port's scenario filter holding the JAX filter's
weights (``assign_value``) and JAX's target, trained by the port's e7
Trainer in lockstep with JAX's Trainer on the JAX example's model for one
epoch of three train and one valid steps.  (The 'svf'-design PEQ
scenarios in float64, the fixed demo, e7_biquad_nn, e10, e4 and phase
4h's helpers: tests/test_torch_e7_nn_probe.py, which shares this file's
helpers.)

Tolerances: the targets and first losses 1e-5 relative; the later step
losses and the trained weights 1e-4 (each Adam step moves a weight by up
to lr whatever the size of its gradient, so gradient rounding at 1e-5 of
the max shows in the weights at ~1e-4 of them after a few steps).  The
PEQ's 'svf'
design is ill-conditioned in float32 (tests/test_torch_filters.py: its
20 Hz shelf puts a double pole within 1.3e-3 of z = 1, where one
rounding step of a tap moves the response by ~1e-3 of its max), and Adam
turns the rounding of its smallest gradients into whole steps of lr: in
float32 its first loss is held to 2e-3, and its lockstep runs in float64,
at the bounds above."""

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
from flamo_tpu import functional as jf
from flamo_tpu import optimize as jopt
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.examples import _common, e7_biquad, e7_peq, e7_svf

NFFT = 256
M = NFFT // 2 + 1
FS = 48000
SEED = 130709
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_TOL = 1e-5
STEP_TOL = 1e-4
ILL_TOL = 2e-3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(lr: float, tmp_path) -> types.SimpleNamespace:
    """Each example's arguments at NFFT: 8 items, batches of 2, split
    0.75 (three train and one valid step), one epoch."""
    return types.SimpleNamespace(nfft=NFFT, samplerate=FS, seed=SEED, num=8,
                                 batch_size=2, split=0.75, max_epochs=1,
                                 lr=lr, train_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the e7 scenarios in lockstep
# ---------------------------------------------------------------------------
def _jax_scenario(name, args):
    """The JAX example's (filter, target magnitude, input channels) of
    ``name``, as its example_* functions build them."""
    bq, sv = _jax_example("e7_biquad"), _jax_example("e7_svf")
    key = jax.random.PRNGKey(args.seed)
    key1 = jax.random.PRNGKey(args.seed + 1)
    common = dict(nfft=args.nfft, fs=args.samplerate, requires_grad=True)
    flamo_tpu.set_seed(args.seed)
    if name == "biquad":
        t = bq._impulse_target(args, bq._random_highpass_target(
            args, key, (2, 2, 1)), 1, mimo=True)
        return jdsp.Biquad(size=(2, 1), n_sections=2, filter_type="highpass",
                           alias_decay_db=30, **common), t, 1
    if name == "parallel_biquad":
        t = bq._impulse_target(args, bq._random_highpass_target(
            args, key1, (2, 2)), 2, mimo=False)
        return jdsp.parallelBiquad(size=(2,), n_sections=2,
                                   filter_type="highpass", alias_decay_db=30,
                                   **common), t, 2
    if name == "svf":
        t = sv._impulse_target(args, sv._random_svf_target(
            args, key, (4, 2, 1)), 1, mimo=True)
        return jdsp.SVF(size=(2, 1), n_sections=4, filter_type=None,
                        alias_decay_db=0, **common), t, 1
    if name == "parallel_svf":
        t = sv._impulse_target(args, sv._random_svf_target(
            args, key1, (4, 2)), 2, mimo=False)
        return jdsp.parallelSVF(size=(2,), n_sections=4, filter_type=None,
                                alias_decay_db=0, **common), t, 2
    if name == "lowshelf":
        b, a = jf.svf(jnp.asarray(800.0), jnp.asarray(1.0),
                      G=jnp.asarray(10 ** (-6 / 20)), filter_type="lowshelf",
                      fs=args.samplerate)
        t = jnp.abs(jf.biquad2tf(b, a, args.nfft))[None, :, None]
        return jdsp.SVF(size=(1, 1), n_sections=2, filter_type="lowshelf",
                        **common), t, 1
    scenario, design = name.rsplit("_", 1)
    del common["requires_grad"]
    if scenario == "peq":
        src = jdsp.PEQ(size=(2, 1), n_bands=6, design=design, **common)
        t = jnp.abs(jnp.sum(src.response(), axis=-1))[None]
        return jdsp.PEQ(size=(2, 1), n_bands=6, design=design,
                        requires_grad=True, **common), t, 1
    src = jdsp.parallelPEQ(size=(2,), n_bands=6, design=design, **common)
    t = jnp.abs(src.response())[None]
    return jdsp.parallelPEQ(size=(2,), n_bands=6, design=design,
                            requires_grad=True, **common), t, 2


# name: (the port's scenario function, its arguments, the example's lr)
SCENARIOS = {
    "biquad": (e7_biquad.scenario_biquad, {}, 1e-2),
    "parallel_biquad": (e7_biquad.scenario_parallel_biquad, {}, 1e-2),
    "svf": (e7_svf.scenario_svf, {}, 5e-2),
    "parallel_svf": (e7_svf.scenario_parallel_svf, {}, 5e-2),
    "lowshelf": (e7_svf.scenario_lowshelf, {}, 5e-2),
    **{f"{s}_{d}": (getattr(e7_peq, f"scenario_{s}"), {"design": d}, 1e-2)
       for s in ("peq", "parallel_peq") for d in ("biquad", "svf")},
}


def _jax_train(model, x, target, args, tmp_path, **trainer_kw):
    ds = jopt.Dataset(input=x, target=target, expand=args.num)
    tl, vl = jopt.load_dataset(ds, batch_size=args.batch_size,
                               split=args.split)
    tr = jopt.Trainer(model, max_epochs=args.max_epochs, lr=args.lr,
                      train_dir=str(tmp_path), **trainer_kw)
    tr.register_criterion(_jax_example("_common").PlainMSE(), 1)
    tr.train(tl, vl)
    return tr


def _held_in_lockstep(tr, jtr, filt, jfilt, ill: bool = False):
    (steps,), (jsteps,) = (list(t.train_loss_log.values())
                           for t in (tr, jtr))
    assert len(steps) == len(jsteps) == 3
    assert steps[-1] < steps[0] and jsteps[-1] < jsteps[0]
    if ill:
        assert abs(steps[0] - jsteps[0]) / jsteps[0] < ILL_TOL
        return
    assert abs(steps[0] - jsteps[0]) / jsteps[0] < FIRST_TOL
    assert _rel(steps, jsteps) < STEP_TOL
    assert _rel(tr.valid_loss, jtr.valid_loss) < STEP_TOL
    assert _rel(filt.param.detach().numpy(), jtr.net.core.param) < STEP_TOL


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_e7_scenario_in_lockstep_with_jax(name, tmp_path):
    make, kw, lr = SCENARIOS[name]
    args = _args(lr, tmp_path)
    jfilt, jtarget, in_ch = _jax_scenario(name, args)
    filt, _, port_in_ch, _ = make(args, "cpu", **kw)
    assert port_in_ch == in_ch
    filt.assign_value(np.asarray(jfilt.param))
    tr, tl, vl = _common.filter_trainer(
        args, filt, torch.tensor(np.asarray(jtarget)), in_ch, log=False)
    tr.train(tl, vl)
    jmodel = jsystem.Shell(core=jfilt, input_layer=jdsp.FFT(args.nfft),
                           output_layer=jdsp.Transform(jnp.abs))
    x = jf.signal_gallery(1, n_samples=args.nfft, n=in_ch,
                          signal_type="impulse", fs=args.samplerate)
    jtr = _jax_train(jmodel, x, jtarget, args, tmp_path, step_size=25,
                     patience_delta=1e-5)
    _held_in_lockstep(tr, jtr, filt, jfilt, ill=name.endswith("peq_svf"))
