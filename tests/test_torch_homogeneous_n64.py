"""``HomogeneousFDN`` at 64 and 32 channels on 'pallas' against flamo_tpu
on the CPU, from the same weights (``convert.load_jax_params``): the
frequency response, the forward on an impulse, the IR, the loss
``mse(model(impulse), target)`` and its first gradients in every
trainable leaf.

The port's 'pallas' route takes the FDN split of the loop to K2, whose
wrapper runs its plain version on the CPU at any N (on the card, K2
looped above 16 channels, forward and, in the gradient, transposed).
The JAX side runs without its Pallas kernels, which cannot be
interpreted at these sizes in a test's time: at N = 64 its 'ge' route,
which is ``gauss_solve_loop`` above 32 channels
(``flamo_tpu/ops/solve.py``); at N = 32 its 'lu' route
(``jnp.linalg.solve``), since its unrolled 'ge' takes ~80 s to jit there.

Tolerances, as tests/test_torch_reverb.py holds the 4-channel FDN: 1e-5
of the max on the response, the forward and the IR, 1e-5 relative on the
loss, 1e-4 of each leaf's max on the gradients.  The delays are
``coprime_delay_lengths`` from a seeded rng in HomogeneousFDNConfig's
20-50 ms range; the mixing matrix is orthogonal and the attenuation 6 dB
a second, so the loop is well conditioned.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu.auxiliary import config as jcfg
from flamo_tpu.auxiliary import reverb as jrev
from flamo_tpu.optimize import loss as jloss
from flamo_tpu_torch.auxiliary import config as tcfg
from flamo_tpu_torch.auxiliary import reverb as trev
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.optimize import mse_loss

NFFT = 512
M = NFFT // 2 + 1
VAL_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
JAX_METHOD = {64: "ge", 32: "lu"}


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _pair(N: int):
    delays = trev.coprime_delay_lengths(N, [20.0, 50.0], 48000,
                                        rng=np.random.default_rng(N))
    kw = dict(N=N, nfft=NFFT, delays=delays)
    flamo_tpu.set_seed(N)
    fj = jrev.HomogeneousFDN(jcfg.HomogeneousFDNConfig(
        **kw, solve_method=JAX_METHOD[N]))
    ft = trev.HomogeneousFDN(tcfg.HomogeneousFDNConfig(
        **kw, solve_method="pallas", device="cpu"))
    load_jax_params(ft, _jax_params(fj.model))
    return fj, ft


def _inputs():
    x = np.zeros((1, NFFT, 1), np.float32)
    x[0, 0, 0] = 1.0
    rng = np.random.default_rng(3)
    target = (rng.normal(size=(1, NFFT, 1))
              * np.exp(-np.arange(NFFT) / 100.0)[None, :, None]).astype(
        np.float32)
    return x, target


def _jax_refs(model):
    x, target = _inputs()

    def total(m):
        est = m(jnp.asarray(x))
        return jloss.mse_loss()(est, jnp.asarray(target)), est

    (loss, est), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        model)
    H, ir = jax.jit(lambda m: (m.get_freq_response(identity=False),
                               m.get_time_response()))(model)
    return (float(loss), _jax_params(grads), np.asarray(est),
            np.asarray(H), np.asarray(ir))


@pytest.mark.parametrize("N", [64, 32])
def test_homogeneous_fdn_pallas_matches_jax(N):
    fj, ft = _pair(N)
    loop = ft.model.core.feedback_loop
    assert loop.solve_method == "pallas" and ft.N == N
    lj, gj, yj, Hj, irj = _jax_refs(fj.model)
    H = ft.model.get_freq_response(identity=False)
    assert H.shape == (1, M, 1)
    assert _rel(H.detach(), Hj) < VAL_TOL
    assert _rel(ft.model.get_time_response().detach(), irj) < VAL_TOL
    x, target = _inputs()
    fk.reset_launch_counts()
    est = ft.model(torch.tensor(x))
    assert _rel(est.detach(), yj) < VAL_TOL
    loss = mse_loss()(est, torch.tensor(target))
    loss.backward()
    assert abs(float(loss.detach()) - lj) < LOSS_TOL * abs(lj)
    grads = {k: v.grad for k, v in jax_named_tensors(ft).items()
             if v.requires_grad}
    # the trainable leaves: input and output gains, the mixing matrix and
    # the attenuation (the delays are frozen)
    assert len(grads) == 4
    for k, g in grads.items():
        assert g is not None, k
        assert _rel(g, gj[k]) < GRAD_TOL, k
    assert not any(fk.LAUNCHES.values())  # the CPU launches no kernel
