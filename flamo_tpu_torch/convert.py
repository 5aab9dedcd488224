"""Carry weights from a JAX ``flamo_tpu`` model into its port.

The weights come as a ``dict`` from ``jax.tree_util.keystr`` of each leaf
of the JAX model to a numpy array, e.g. for the colorless FDN
``.core.modules[0].param`` (N, 1), ``.core.modules[1].feedforward.param``
(N,), ``.core.modules[1].feedback.param`` (N, N) and
``.core.modules[2].param`` (1, N); for the scattering FDN the feedback
param is (K+1, N, N).  A model's static state that JAX draws at
construction (the scattering shifts) is not a pytree leaf and is copied
by :func:`load_jax_scattering`.  The port itself never imports JAX: the
caller builds the dict and passes plain integers.

A ``Parallel`` holds its branches as ``.branchA``/``.branchB``, e.g. for
the e8_fdn FDN with a direct path ``.core.branchA.modules[1].feedback.
modules[1].param`` (the GEQ, (K, N)) and ``.core.branchB.modules[0].param``
(the direct gain); a ``HouseholderMatrix`` leaf is its (N, 1) vector and a
Hadamard or rotation ``Matrix`` leaf its raw (N, N) param.

The filter zoo's leaves are each module's raw ``param``, in the JAX
layouts: a ``Biquad`` (K, P, N_out, N_in), an ``SOSFilter`` (K, 6, N_out,
N_in), an ``SVF`` (5, K, N_out, N_in), a ``PEQ`` (n_bands, 3, N_out,
N_in), a ``GainDelay`` (2, N_out, N_in), their parallel forms without
N_in; the transforms of a Shell (``FFT``, ``Transform``) hold none.

An ``AccurateGEQ`` carries its designed taps beside its target gains,
``.sos_b`` and ``.sos_a`` (3, K + 1, ...), as the JAX package's leaves.
A ``VelvetNoiseFilter``'s leaf is its drawn (T, N_out, N_in) ``param``;
its JAX PRNG ``.key`` leaf has no counterpart (the port draws from a
``torch.Generator``) and is skipped.  A ``VelvetNoiseMatrix``'s leaf is
its broadcast Hadamard ``param``, and its shifts and m_L/m_R come through
:func:`load_jax_scattering`.

A ``HomogeneousFDN`` (no module itself) carries the leaves of its
``model``, e.g. ``.core.modules[1].feedforward.modules[1].param`` (the
attenuation's raw gain).  The delay-scaled accurate GEQs
(``parallelFDNAccurateGEQ``, ``parallelGFDNAccurateGEQ``) carry their RT60
``param`` alone: the JAX package designs their ``.sos_b``/``.sos_a`` in
float32 mode, ~3e-3 of the max from its float64 design, so those leaves
are skipped and the port designs its taps from the carried RT60s
(``assign_value``, float64 on the host).

A ``Series`` built from an ``OrderedDict`` flattens like any other: its
children are ``.modules[i]`` in key order, e.g. for the active-acoustics
loop shell ``ActiveAcoustics.F_MM`` ``.core.modules[0].param`` (U),
``[1]`` (R), ``[2]`` (G) and ``.core.modules[3].H_re``/``.H_im`` (the
cached H_LM).  ``ActiveAcoustics`` itself is no pytree in the JAX package;
its modules are keyed by attribute name and the module's own path,
``H_SM.param``, ``H_SA.param``, ``H_LM.param``, ``H_LA.param``,
``U.param``, ``R.param`` and ``G.param``, and loading them recomputes the
cached rooms.
"""

from __future__ import annotations

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.reverb import (HomogeneousFDN,
                                              parallelFDNAccurateGEQ)
from flamo_tpu_torch.auxiliary.velvet import VelvetNoiseFilter
from flamo_tpu_torch.models.active_acoustics import ActiveAcoustics
from flamo_tpu_torch.processor import dsp, system

AA_MODULES = ("H_SM", "H_SA", "H_LM", "H_LA", "U", "R", "G")


def jax_named_tensors(module, prefix: str = "",
                      jax_only: set | None = None) -> dict[str, torch.Tensor]:
    """The port's parameters and buffers under the key paths that the JAX
    package's pytree gives the matching leaves.  The paths of JAX leaves
    without a counterpart (a velvet filter's PRNG key) are added to
    ``jax_only`` when it is given."""
    out = {}

    def under(sub, path):
        out.update(jax_named_tensors(sub, path, jax_only))

    if isinstance(module, HomogeneousFDN):
        under(module.model, prefix)
    elif isinstance(module, ActiveAcoustics):
        for name in AA_MODULES:
            under(getattr(module, name), f"{prefix}{name}")
    elif isinstance(module, system.Shell):
        for name in ("core", "input_layer", "output_layer"):
            under(getattr(module, name), f"{prefix}.{name}")
    elif isinstance(module, system.Series):
        for i, sub in enumerate(module):
            under(sub, f"{prefix}.modules[{i}]")
    elif isinstance(module, system.Recursion):
        for name in ("feedforward", "feedback"):
            under(getattr(module, name), f"{prefix}.{name}")
    elif isinstance(module, system.Parallel):
        for name in ("branchA", "branchB"):
            under(getattr(module, name), f"{prefix}.{name}")
    elif isinstance(module, dsp.CachedResponse):
        out[f"{prefix}.H_re"] = module.H_re
        out[f"{prefix}.H_im"] = module.H_im
    elif isinstance(module, dsp.DSP):
        out[f"{prefix}.param"] = module.param
        if isinstance(module, parallelFDNAccurateGEQ):
            if jax_only is not None:
                jax_only.update({f"{prefix}.sos_b", f"{prefix}.sos_a"})
        elif isinstance(module, dsp.AccurateGEQ):
            out[f"{prefix}.sos_b"] = module.sos_b
            out[f"{prefix}.sos_a"] = module.sos_a
        if isinstance(module, VelvetNoiseFilter) and jax_only is not None:
            jax_only.add(f"{prefix}.key")
    return out


def load_jax_params(model, params: dict[str, np.ndarray]):
    """Copy ``params`` into ``model`` in place and return it.  Raises on a
    missing or extra key and on a shape mismatch.  An ``ActiveAcoustics``
    then recomputes its cached room responses; an ``AccurateGEQ`` keeps
    the carried taps (its design is not run again), and a delay-scaled
    accurate GEQ designs its own from the carried RT60s."""
    jax_only = set()
    targets = jax_named_tensors(model, jax_only=jax_only)
    missing = sorted(set(targets) - set(params))
    extra = sorted(set(params) - set(targets) - jax_only)
    if missing or extra:
        raise KeyError(f"JAX parameters do not match the model: missing "
                       f"{missing}, extra {extra}")
    with torch.no_grad():
        for key, dst in targets.items():
            src = np.asarray(params[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: JAX shape {tuple(src.shape)} != "
                                 f"port shape {tuple(dst.shape)}")
            dst.copy_(torch.tensor(src, dtype=dst.dtype))
    if isinstance(model, ActiveAcoustics):
        model.refresh_rooms()
    root = model.model if isinstance(model, HomogeneousFDN) else model
    if isinstance(root, torch.nn.Module):
        for sub in root.modules():
            if isinstance(sub, parallelFDNAccurateGEQ):
                sub.assign_value(sub.param.detach())
    return model


def load_jax_scattering(model, shifts, m_L, m_R):
    """Copy the static state of a JAX ``ScatteringMapping`` (its
    ``map_filter``: the per-stage ``shifts`` (n_stages, N) and the
    ``m_L``/``m_R`` offsets (N,), plain integers drawn from JAX's PRNG at
    construction) into the one :class:`dsp.ScatteringMatrix` of ``model``
    (a ``VelvetNoiseMatrix`` too), in place, and return the model.  Raises
    on a shape mismatch."""
    found = [m for m in model.modules() if isinstance(m, dsp.ScatteringMatrix)]
    if len(found) != 1:
        raise ValueError(f"expected one ScatteringMatrix in the model, "
                         f"found {len(found)}")
    mapping = found[0].map_filter
    shifts = np.asarray(shifts, dtype=np.int64)
    m_L, m_R = (np.asarray(v, dtype=np.int64) for v in (m_L, m_R))
    want = (mapping.n_stages, mapping.N)
    if (shifts.shape != want or m_L.shape != (mapping.N,)
            or m_R.shape != (mapping.N,)):
        raise ValueError(f"scattering state shapes {shifts.shape}, "
                         f"{m_L.shape}, {m_R.shape} do not fit shifts {want} "
                         f"and offsets ({mapping.N},)")
    mapping.shifts = tuple(tuple(int(v) for v in row) for row in shifts)
    mapping.m_L = tuple(int(v) for v in m_L)
    mapping.m_R = tuple(int(v) for v in m_R)
    return model
