"""The fused kernels' dispatch through the port's Trainer, held against
flamo_tpu's on the CPU.

fused='force' on the colorless FDN (mse + 0.2 sparsity) and on the
attenuated FDN with an |.| output layer (mse), nfft=512, delays (89, 97,
107, 113), the JAX model's weights carried into the port with
``load_jax_params``.  The JAX Trainer runs its Pallas kernels K1 and K5
through the interpreter (its own tests do so on the CPU; compiling K5's
scan that way takes most of this file's ~30 s), the port their plain
versions.  Tolerance: the JAX package's own fused-vs-graph rtol 2e-3
(tests/test_trainer.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
import flamo_tpu.models as jm
import flamo_tpu.optimize as jopt
from flamo_tpu.optimize import loss as jloss
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsys
from flamo_tpu_torch.convert import load_jax_params
from flamo_tpu_torch.models import build_attenuated_fdn, build_colorless_fdn
from flamo_tpu_torch.optimize import Trainer
from flamo_tpu_torch.optimize import loss as tloss
from flamo_tpu_torch.processor import dsp, system

NFFT = 512
M = NFFT // 2 + 1
DELAYS = (89, 97, 107, 113)


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _io():
    xj = jnp.zeros((1, M, 1)).at[:, 0, :].set(1.0)
    x = torch.zeros((1, M, 1))
    x[:, 0, :] = 1.0
    return (xj, jnp.ones((1, M, 1))), (x, torch.ones((1, M, 1)))


def _colorless_pair(seed: int = 7):
    flamo_tpu.set_seed(seed)
    mj = jm.build_colorless_fdn(nfft=NFFT, delays=DELAYS)
    mt = build_colorless_fdn(nfft=NFFT, delays=DELAYS, device="cpu")
    return mj, load_jax_params(mt, _jax_params(mj))


def _attenuated_pair(seed: int = 13):
    """The attenuated FDN with an |.| output layer, so that mse_loss is
    its magnitude objective."""
    flamo_tpu.set_seed(seed)
    aj = jm.build_attenuated_fdn(nfft=NFFT, delays=DELAYS)
    mj = jsys.Shell(core=aj.core, input_layer=aj.input_layer,
                    output_layer=jdsp.Transform(jnp.abs))
    at = build_attenuated_fdn(nfft=NFFT, delays=DELAYS, device="cpu")
    mt = system.Shell(core=at.core, input_layer=at.input_layer,
                      output_layer=dsp.Transform(torch.abs))
    return mj, load_jax_params(mt, _jax_params(mj))


def _colorless_criteria(tr, mod, sparsity: bool = True):
    """mse [+ 0.2 sparsity] of ``mod``, the JAX or the port's loss module."""
    tr.register_criterion(mod.mse_loss(nfft=NFFT), 1)
    if sparsity:
        tr.register_criterion(mod.sparsity_loss(), 0.2, requires_model=True)


@pytest.mark.parametrize("topology", ["colorless", "attenuated"])
def test_force_dispatch_matches_jax(topology):
    """fused='force' takes colorless_fused_step (K1's plain version) or
    attenuated_fused_step (K5's) and trains in lockstep with JAX's
    fused='force' (its Pallas kernels interpreted) at the JAX package's
    fused-vs-graph rtol 2e-3."""
    (xj, tj), (x, t) = _io()
    if topology == "colorless":
        mj, mt = _colorless_pair()
        name, sparsity = "colorless_fused_step", True
    else:
        mj, mt = _attenuated_pair()
        name, sparsity = "attenuated_fused_step", False
    trj = jopt.Trainer(mj, lr=1e-2, log=False, fused="force")
    _colorless_criteria(trj, jloss, sparsity)
    hist_j = trj.fit_scan(xj, tj, n_steps=6, steps_per_call=3)
    assert trj.fused_path == name
    tr = Trainer(mt, lr=1e-2, log=False, fused="force")
    _colorless_criteria(tr, tloss, sparsity)
    hist_t = tr.fit_scan(x, t, n_steps=6, steps_per_call=3)
    assert tr.fused_path == name
    np.testing.assert_allclose(hist_t, hist_j, rtol=2e-3)
    assert hist_t[-1] < hist_t[0]
