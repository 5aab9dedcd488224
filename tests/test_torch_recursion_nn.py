"""e4_recursion_nn's comb_nn against flamo_tpu on the CPU: the port's
comb renders JAX's targets from JAX's raw draws, its LossyBiquad map is
JAX's, and its loss and MLP gradients from JAX's MLP weights and targets
equal JAX's on both routes ('xla'/'ge' and 'pallas', the kernels' plain
versions).  JAX's side is compiled once in a module fixture (the
targets, the loss and the gradients in one jit).

Tolerances: the loss and the targets 1e-5 relative, the MLP gradients
1e-4 of the max (float32 through a 4 x 4 loop solve whose gain reaches
-0.1 dB, and an MLP of ~130k weights)."""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu import functional as jf
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.examples import e4_recursion_nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
CPU = torch.device("cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COMB_NFFT, COMB_BATCH = 512, 4


@pytest.fixture(scope="module")
def jax_comb():
    """JAX's comb (examples/e4_recursion_nn.py's LossyBiquad and MLP
    stack), four targets rendered by it, its MLP weights, and its loss
    and MLP gradients on them (jitted)."""
    jm = _jax_example("e4_recursion_nn")
    nfft, ch = COMB_NFFT, len(e4_recursion_nn.DELAYS)
    M = nfft // 2 + 1
    LossyBiquad = jm.make_lossy_biquad_class(jdsp)
    delays = jdsp.parallelDelay(size=(ch,), max_len=max(
        e4_recursion_nn.DELAYS), nfft=nfft, isint=True)
    delays = delays.assign_value(delays.sample2s(jnp.asarray(
        e4_recursion_nn.DELAYS, jnp.float32)))
    filt = LossyBiquad(size=(ch, ch), n_sections=1, filter_type="lowpass",
                       nfft=nfft, fs=FS, requires_grad=True)
    shell = jsystem.Shell(core=jsystem.Recursion(fF=delays, fB=filt),
                          input_layer=jdsp.FFT(nfft),
                          output_layer=jdsp.Transform(jnp.abs))
    imp = jf.signal_gallery(1, nfft, ch, "impulse")
    raw = jax.random.normal(jax.random.PRNGKey(3),
                            (COMB_BATCH, 1, 2, ch, ch)) * 2.0

    def render(r):
        return shell(imp, ext_param={"feedback": r})[0]

    mlp = jm.init_mlp_stack(jax.random.PRNGKey(4), in_dim=M * ch,
                            out_dim=2 * ch * ch)

    def loss_fn(p, t):
        def one(tm):
            out = jm.mlp_stack(p, tm.reshape(-1)).reshape(1, 2, ch, ch)
            return shell(imp, ext_param={"feedback": out})[0]
        return jnp.mean((jax.vmap(one)(t) - t) ** 2)

    @jax.jit
    def run(p, r):  # one compilation for the targets, loss and gradients
        t = jax.vmap(render)(r)
        return (t,) + jax.value_and_grad(loss_fn)(p, t)

    targets, loss, grads = run(mlp, raw)
    return dict(targets=np.asarray(targets), mlp=mlp, loss=float(loss),
                grads=grads)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_comb_nn_loss_and_grads_match_jax(jax_comb, backend):
    routes = e4_recursion_nn.routes(backend)
    shell, _ = e4_recursion_nn.build_comb(COMB_NFFT, FS, CPU, **routes)
    assert shell.core.solve_method == routes["solve_method"]
    params = [{k: torch.tensor(np.asarray(v), requires_grad=True)
               for k, v in layer.items()} for layer in jax_comb["mlp"]]
    targets = torch.tensor(jax_comb["targets"])
    imp = e4_recursion_nn.comb_impulse(shell)
    loss = e4_recursion_nn.comb_loss(shell, imp, params, targets)
    loss.backward()
    assert abs(float(loss.detach()) - jax_comb["loss"]) \
        <= LOSS_TOL * jax_comb["loss"]
    for layer, jlayer in zip(params, jax_comb["grads"]):
        for k, p in layer.items():
            g = np.asarray(jlayer[k])
            if not np.any(g):  # the last layer's unused LayerNorm
                assert p.grad is None
                continue
            assert _rel(p.grad, g) < GRAD_TOL, k


def test_comb_nn_targets_and_lossy_map_match_jax(jax_comb):
    """The port's comb renders JAX's targets from JAX's raw draws; the
    LossyBiquad map keeps every gain at or below -0.1 dB."""
    jm = _jax_example("e4_recursion_nn")
    raw = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                       (COMB_BATCH, 1, 2, 4, 4))) * 2.0
    shell, filt = e4_recursion_nn.build_comb(COMB_NFFT, FS, CPU)
    imp = e4_recursion_nn.comb_impulse(shell)
    with torch.no_grad():
        got = torch.stack([e4_recursion_nn.render(shell, imp, torch.tensor(
            r)) for r in raw])
        mapped = filt.map(torch.tensor(raw[0]) * 20)
    assert _rel(got, jax_comb["targets"]) < LOSS_TOL
    jfilt = jm.make_lossy_biquad_class(jdsp)(size=(4, 4), nfft=COMB_NFFT)
    assert _rel(mapped, jfilt.map(jnp.asarray(raw[0] * 20))) < 1e-6
    assert float(mapped[:, 1].max()) <= -0.1 + 1e-6
