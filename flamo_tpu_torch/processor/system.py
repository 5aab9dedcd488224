"""System composition (counterpart of ``flamo_tpu/processor/system.py``):
``Series``, ``Recursion``, ``Parallel`` and ``Shell``.

Shape and attribute checks run eagerly at construction with the JAX
package's messages.  Children are registered as ``nn.Module`` submodules,
so a Series child is reachable by its key (``core.feedback_loop``).

``ext_param`` is a dict of raw parameters that replace the children's
own: a Series gives each child the entry of its key, or the entries
``'key.sub'`` as a dict ``{'sub': ...}`` (:func:`_ext_for`); a Recursion
and a Parallel do the same with their branches' names ('feedforward',
'feedback', 'branchA', 'branchB'), and a Shell hands it to its core.
"""

from __future__ import annotations

import copy
import warnings
from collections import OrderedDict

import torch

from flamo_tpu_torch.core import Module
from flamo_tpu_torch.functional import signal_gallery
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.fdn_kernels import fdn_solve
from flamo_tpu_torch.ops.solve import closed_loop_solve
from flamo_tpu_torch.processor.dsp import _alias_envelope
from flamo_tpu_torch.utils import complex_dtype_for


def _matrix_response_of(module, ext_param=None):
    """(kind, H) per-bin linear map of a module, or None if unknown."""
    fn = getattr(module, "matrix_response", None)
    if fn is None:
        return None
    try:
        return fn(ext_param) if ext_param is not None else fn()
    except NotImplementedError:
        return None


def _ext_for(ext_param, key: str):
    """A child's part of ``ext_param``: the entry of its exact key, else
    the entries ``'key.sub'`` as ``{'sub': value}``, else None."""
    if ext_param is None or not isinstance(ext_param, dict):
        return None
    if key in ext_param:
        return ext_param[key]
    sub = {k[len(key) + 1:]: v for k, v in ext_param.items()
           if k.startswith(key + ".")}
    return sub or None


# a branch of a Recursion or a Parallel picks its part as a Series child
_branch_ext = _ext_for


def _call(module, x, ext_param):
    """``module(x, ext_param)``, or ``module(x)`` without one."""
    return module(x) if ext_param is None else module(x, ext_param)


def _attr_of(module, attr):
    return getattr(module, attr, None)


def _compose_all(responses):
    """(kind, H) of a cascade of per-bin maps, applied in order."""
    out = None
    for r in responses:
        out = r if out is None else linop.compose(r[0], r[1], out[0], out[1])
    return out


def _ones_for(U):
    return torch.ones((1, U.shape[0]), dtype=U.dtype, device=U.device)


def _diag_flat_split(module, ext_param=None):
    """Factor a module's per-bin map as ``diag(d(f)) @ U`` (rows-scaled
    frequency-flat matrix).  Returns ``(split, response)``: split is
    ``(d, U)`` with d (M, N) or (1, N), or None; when it is None, response
    is the module's ``(kind, H)`` (None if unknown), for the caller's
    generic solve.

    Recognized: a FLAT module (d = 1), a Series of one FLAT stage followed
    by DIAG stages (the FDN feedback ``Series(mixing_matrix,
    attenuation)``), and a Series whose stages compose to a FLAT map.
    Each stage's response is evaluated once: PyTorch runs eagerly, so a
    response computed and not used is paid for."""
    if not isinstance(module, Series):
        r = _matrix_response_of(module, ext_param)
        if r is not None and r[0] == linop.FLAT:
            return (_ones_for(r[1]), r[1]), None
        return None, r
    responses = [_matrix_response_of(sub, _ext_for(ext_param, key))
                 for key, sub in module.named_stages()]
    if any(r is None for r in responses):
        return None, None
    U = d = None
    for kind, H in responses:
        if kind == linop.FLAT and U is None and d is None:
            U = H
        elif kind == linop.DIAG and U is not None:
            d = H if d is None else d * H
        else:  # a second flat stage, a flat after a diag, a diag first
            U = None
            break
    if U is not None:
        return ((_ones_for(U) if d is None else d), U), None
    whole = _compose_all(responses)
    if whole is not None and whole[0] == linop.FLAT:
        return (_ones_for(whole[1]), whole[1]), None
    return None, whole


# ============================= SERIES ================================


class Series(Module):
    """Cascade container.  Accepts modules, (Ordered)dicts with custom
    keys and nested Series, which are flattened with the JAX package's
    key rules."""

    def __init__(self, *args):
        super().__init__()
        items = _unpack_modules(args, [])
        self.keys = tuple(k for k, _ in items)
        for k, v in items:
            self.add_module(k, v)
        self.nfft = self.__check_attribute("nfft")
        self.alias_decay_db = self.__check_attribute("alias_decay_db")
        self.dtype = self.__check_attribute("dtype")
        self.input_channels, self.output_channels = self.__check_io()

    # -- container protocol ------------------------------------------------
    @property
    def stages(self) -> tuple:
        return tuple(self._modules[k] for k in self.keys)

    def __len__(self):
        return len(self.keys)

    def __iter__(self):
        return iter(self.stages)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        return self.stages[idx]

    def named_stages(self):
        return list(zip(self.keys, self.stages))

    # -- structure edits: each returns a new Series ---------------------------
    def prepend(self, new_module) -> "Series":
        return self.insert(0, new_module)

    def append(self, new_module) -> "Series":
        return self.insert(len(self), new_module)

    def insert(self, index: int, new_module) -> "Series":
        """A new Series with ``new_module`` (a module, a Series or a dict)
        inserted at ``index``; this one is left as it is."""
        n = len(self)
        if not (-n <= index <= n):
            raise IndexError("Index out of range.")
        if index < 0:
            index += n
        items = self.named_stages()
        for off, kv in enumerate(_unpack_modules((new_module,),
                                                 list(self.keys))):
            items.insert(index + off, kv)
        return Series(OrderedDict(items))

    # -- validation ----------------------------------------------------------
    def __check_attribute(self, attr):
        value = None
        for module in self:
            v = _attr_of(module, attr)
            if v is not None:
                value = v
                break
        if value is None:
            warnings.warn(f"Attribute {attr} not found in any of the modules.")
        else:
            for i, module in enumerate(self):
                v = _attr_of(module, attr)
                if v is not None and v != value:
                    raise ValueError(
                        f"All modules must have the same {attr} value. Module "
                        f"{type(module).__name__} at index {i} is incoherent "
                        f"with the part of the Series preceding it.")
        return value

    def __check_io(self):
        stages = self.stages
        first = next((i for i, m in enumerate(stages)
                      if getattr(m, "input_channels", None) is not None),
                     None)
        if first is None:
            return None, None
        input_channels = stages[first].input_channels
        prev_name = type(stages[first]).__name__
        prev_pos = first
        prev_out = stages[first].output_channels
        for j in range(first + 1, len(stages)):
            module = stages[j]
            if getattr(module, "input_channels", None) is not None:
                if module.input_channels != prev_out:
                    raise AssertionError(
                        f"Module {prev_name} at index {prev_pos} has "
                        f"{prev_out} output channels, but module "
                        f"{type(module).__name__} at index {j} has "
                        f"{module.input_channels} input_channels.")
                prev_name = type(module).__name__
                prev_pos = j
                prev_out = getattr(module, "output_channels", None)
        return input_channels, prev_out

    # -- forward / probe -----------------------------------------------------
    def forward(self, x, ext_param=None):
        for key, module in self.named_stages():
            x = _call(module, x, _ext_for(ext_param, key))
        return x

    def matrix_response(self, ext_param=None):
        """Composed per-bin linear map of the cascade (cheapest kind)."""
        responses = []
        for key, module in self.named_stages():
            r = _matrix_response_of(module, _ext_for(ext_param, key))
            if r is None:
                return None
            responses.append(r)
        return _compose_all(responses)

    def _probe_with(self, probe_of):
        H = None
        for module in self:
            Hi = probe_of(module)
            if Hi is not None:
                H = Hi if H is None else Hi @ H
        return H

    def probe(self, z):
        """H(z) = H_n(z) ... H_1(z); a stage that probes to None (a
        transform) is skipped."""
        return self._probe_with(lambda m: m.probe(z))

    def probe_w(self, w):
        return self._probe_with(lambda m: m.probe_w(w))


def _unpack_modules(modules, current_keys: list):
    """Flatten nested Series/dicts into (key, module) pairs."""
    out = []

    def used_keys():
        return current_keys + [k for k, _ in out]

    for module in modules:
        if isinstance(module, Series):
            out.extend(_unpack_modules(
                (OrderedDict(module.named_stages()),), used_keys()))
        elif isinstance(module, (OrderedDict, dict)):
            for k, v in module.items():
                if isinstance(v, Series):
                    out.extend(_unpack_modules(
                        (OrderedDict(v.named_stages()),), used_keys()))
                elif isinstance(v, (OrderedDict, dict)):
                    out.extend(_unpack_modules((v,), used_keys()))
                else:
                    try:
                        int(k)
                    except ValueError:
                        if k in used_keys():
                            raise ValueError(
                                f"Key {k} is already present in the Series.")
                        out.append((k, v))
                    else:
                        new_key = str(len(used_keys()))
                        if k != new_key:
                            warnings.warn(f"Key {k} is an integer, it will "
                                          f"be overwritten.")
                        out.append((new_key, v))
        elif isinstance(module, Module):
            out.append((str(len(used_keys())), module))
        elif isinstance(module, (list, tuple)):
            out.extend(_unpack_modules(tuple(module), used_keys()))
        else:
            raise ValueError("Modules must be Module, Series, or OrderedDict.")
    return out


# ============================= RECURSION ================================


class Recursion(Module):
    """Closed loop Y = (I - F B)^{-1} F X per frequency bin.

    ``solve_method`` picks the per-bin solve of
    :func:`flamo_tpu_torch.ops.solve.closed_loop_solve`; with 'pallas' an
    FDN-structured loop (diagonal feedforward, [diag-scaled] flat
    feedback) goes to the fused kernel K2 (:func:`fdn_solve`), which
    assembles ``I - diag(D) U`` per bin in registers, and any other loop
    (a frequency-dependent feedback such as the scattering matrix) to the
    dense per-bin kernel K6 on the materialized ``I - F B``."""

    def __init__(self, fF, fB, solve_method: str = "ge"):
        super().__init__()
        if isinstance(fF, (OrderedDict, dict, list, tuple)):
            fF = Series(fF)
            warnings.warn("Feedforward path has been converted to a Series "
                          "class instance.")
        if isinstance(fB, (OrderedDict, dict, list, tuple)):
            fB = Series(fB)
            warnings.warn("Feedback path has been converted to a Series "
                          "class instance.")
        self.feedforward = fF
        self.feedback = fB
        self.solve_method = solve_method
        self.nfft = self.__check_attribute("nfft")
        self.alias_decay_db = self.__check_attribute("alias_decay_db")
        self.dtype = self.__check_attribute("dtype")
        self.input_channels, self.output_channels = self.__check_io()

    def __check_attribute(self, attr):
        ff = _attr_of(self.feedforward, attr)
        fb = _attr_of(self.feedback, attr)
        if ff is None:
            warnings.warn(
                f"The feedforward pass does not possess the attribute {attr}.")
        if fb is None:
            warnings.warn(
                f"The feedback pass does not possess the attribute {attr}.")
        if ff is not None and fb is not None and ff != fb:
            raise AssertionError(
                f"The feedforward pass has {attr} = {ff} and feedback pass "
                f"has {attr} = {fb}. They must have the same value.")
        return ff if ff is not None else fb

    def __check_io(self):
        io = {}
        for branch in ("feedforward", "feedback"):
            for side in ("input_channels", "output_channels"):
                v = getattr(getattr(self, branch), side, None)
                if v is None:
                    raise ValueError(f"The {branch} pass does not possess "
                                     f"the attribute {side}.")
                io[branch, side] = v
        ff_in, ff_out = io["feedforward", "input_channels"], \
            io["feedforward", "output_channels"]
        fb_in, fb_out = io["feedback", "input_channels"], \
            io["feedback", "output_channels"]
        if ff_out != fb_in:
            raise AssertionError(
                f"Feedforward pass has {ff_out} output channels, but "
                f"feedback pass has {fb_in} input channels. They must be the "
                f"same.")
        if fb_out != ff_in:
            raise AssertionError(
                f"Feedforward pass {ff_in} input channels, but the feedback "
                f"pass has {fb_out} output channels. They must be the same.")
        return ff_in, ff_out

    def forward(self, x, ext_param=None):
        ext_ff = _branch_ext(ext_param, "feedforward")
        ext_fb = _branch_ext(ext_param, "feedback")
        B = _call(self.feedforward, x, ext_ff)
        N = self.output_channels
        M = self.nfft // 2 + 1
        cdtype = B.dtype if B.is_complex() else complex_dtype_for(B.dtype)

        rF = _matrix_response_of(self.feedforward, ext_ff)
        if (self.solve_method == "pallas" and rF is not None
                and rF[0] == linop.DIAG and B.ndim == 3):
            # the split evaluates the feedback once, and hands back its
            # response when it declines: PyTorch runs eagerly, so a second
            # evaluation would be paid for
            split, rB = _diag_flat_split(self.feedback, ext_fb)
        else:
            split, rB = None, _matrix_response_of(self.feedback, ext_fb)
        if split is not None:
            # FDN structure: per-bin diagonal stages after the mixing
            # matrix fold into D, I - diag(D_F) diag(g) U = I - diag(D_F g) U
            dB, U = split
            D = (rF[1].to(cdtype) * dB.to(cdtype)).expand(M, N)
            batch = B.shape[0]
            Df = D[None].expand(batch, M, N).reshape(-1, N)
            y = fdn_solve(Df.contiguous(), torch.real(U).contiguous(),
                          B.reshape(-1, N).contiguous())
            return y.reshape(B.shape)
        if rF is not None and rB is not None:
            kL, L = linop.compose(rF[0], rF[1], rB[0], rB[1])
            eye = torch.eye(N, dtype=cdtype, device=B.device)
            A = eye - linop.materialize(kL, L.to(cdtype), M, N, N)
            A = A[None].expand(x.shape[0], M, N, N)
        else:
            # identity feed through the branches (custom user modules)
            eye = torch.eye(N, dtype=cdtype, device=B.device)
            I = eye.expand(x.shape[0], M, N, N)
            A = I - _call(self.feedforward, _call(self.feedback, I, ext_fb),
                          ext_ff)
        return closed_loop_solve(A, B, method=self.solve_method)

    def matrix_response(self, ext_param=None):
        """Closed-loop per-bin map (I - F B)^{-1} F as a dense operator
        (pivoted 'ge' stands in for 'pallas', whose kernel takes a vector
        rhs only)."""
        rF = _matrix_response_of(self.feedforward,
                                 _branch_ext(ext_param, "feedforward"))
        rB = _matrix_response_of(self.feedback,
                                 _branch_ext(ext_param, "feedback"))
        if rF is None or rB is None:
            return None
        N_out, N_in = self.output_channels, self.input_channels
        M = self.nfft // 2 + 1
        Fm = linop.materialize(rF[0], rF[1], M, N_out, N_in)
        kL, L = linop.compose(rF[0], rF[1], rB[0], rB[1])
        A = (torch.eye(N_out, dtype=Fm.dtype, device=Fm.device)
             - linop.materialize(kL, L.to(Fm.dtype), M, N_out, N_out))
        method = "ge" if self.solve_method == "pallas" else self.solve_method
        return linop.FULL, closed_loop_solve(A, Fm, method=method)

    def _loop(self, F, Bz):
        return torch.eye(F.shape[0], dtype=F.dtype, device=F.device) - F @ Bz

    def probe(self, z):
        """H(z) = (I - F(z) B(z))^-1 F(z), one ``torch.linalg.solve``."""
        F = self.feedforward.probe(z)
        return torch.linalg.solve(self._loop(F, self.feedback.probe(z)), F)

    def probe_w(self, w):
        F = self.feedforward.probe_w(w)
        return torch.linalg.solve(self._loop(F, self.feedback.probe_w(w)), F)

    def probe_recursion(self, z, include_shell_io: bool = False, **kwargs):
        """The characteristic matrix P(z) = I - F(z) B(z)."""
        return self._loop(self.feedforward.probe(z), self.feedback.probe(z))

    def probe_recursion_w(self, w):
        return self._loop(self.feedforward.probe_w(w),
                          self.feedback.probe_w(w))


# ============================= PARALLEL ================================


class Parallel(Module):
    """Two branches over the same input, summed (``sum_output``) or
    concatenated along the channel axis."""

    def __init__(self, brA, brB, sum_output: bool = True):
        super().__init__()
        if isinstance(brA, (OrderedDict, dict, list, tuple)):
            brA = Series(brA)
            warnings.warn(
                "Branch A has been converted to a Series class instance.")
        if isinstance(brB, (OrderedDict, dict, list, tuple)):
            brB = Series(brB)
            warnings.warn(
                "Branch B has been converted to a Series class instance.")
        self.branchA = brA
        self.branchB = brB
        self.sum_output = bool(sum_output)
        self.nfft = self.__check_attribute("nfft")
        self.alias_decay_db = self.__check_attribute("alias_decay_db")
        self.dtype = self.__check_attribute("dtype")
        self.input_channels, self.output_channels = self.__check_io()

    def __check_attribute(self, attr):
        a = _attr_of(self.branchA, attr)
        b = _attr_of(self.branchB, attr)
        # the JAX package's warnings, which name the branches as passes
        if a is None:
            warnings.warn(
                f"The feedforward pass does not possess the attribute {attr}.")
        if b is None:
            warnings.warn(
                f"The feedback pass does not possess the attribute {attr}.")
        if a is not None and b is not None and a != b:
            raise AssertionError(
                f"Branch A has {attr} = {a} and branch B has {attr} = {b}. "
                f"They must have the same value.")
        return a if a is not None else b

    def __check_io(self):
        io = {}
        for name in ("A", "B"):
            branch = getattr(self, f"branch{name}")
            for side in ("input_channels", "output_channels"):
                v = getattr(branch, side, None)
                if v is None:
                    raise ValueError(f"Branch {name} does not possess the "
                                     f"attribute {side}.")
                io[name, side] = v
        a_in, a_out = io["A", "input_channels"], io["A", "output_channels"]
        b_in, b_out = io["B", "input_channels"], io["B", "output_channels"]
        if a_in != b_in:
            raise AssertionError(
                f"Branch A has {a_in} input channels, but branch B has "
                f"{b_in} input channels. They must be the same.")
        if self.sum_output:
            if a_out != b_out:
                raise AssertionError(
                    f"Branch A has {a_out} output channels, but branch B "
                    f"has {b_out} output channels. They must be the same if "
                    f"their output is being summed.")
            return a_in, a_out
        return a_in, a_out + b_out

    def forward(self, x, ext_param=None):
        YA = _call(self.branchA, x, _branch_ext(ext_param, "branchA"))
        YB = _call(self.branchB, x, _branch_ext(ext_param, "branchB"))
        if self.sum_output:
            return YA + YB
        return torch.cat((YA, YB), dim=2)

    def matrix_response(self, ext_param=None):
        """The branches' per-bin maps summed (the cheapest kind) or stacked
        by rows into a dense (M, A_out + B_out, N_in) map."""
        rA = _matrix_response_of(self.branchA,
                                 _branch_ext(ext_param, "branchA"))
        rB = _matrix_response_of(self.branchB,
                                 _branch_ext(ext_param, "branchB"))
        if rA is None or rB is None:
            return None
        M = self.nfft // 2 + 1
        if self.sum_output:
            return linop.add(rA[0], rA[1], rB[0], rB[1], M,
                             self.output_channels, self.input_channels)
        Ha = linop.materialize(rA[0], rA[1], M, self.branchA.output_channels,
                               self.input_channels)
        Hb = linop.materialize(rB[0], rB[1], M, self.branchB.output_channels,
                               self.input_channels)
        return linop.FULL, torch.cat([Ha, Hb], dim=1)

    def _join(self, HA, HB):
        return HA + HB if self.sum_output else torch.cat([HA, HB], dim=0)

    def probe(self, z):
        return self._join(self.branchA.probe(z), self.branchB.probe(z))

    def probe_w(self, w):
        return self._join(self.branchA.probe_w(w), self.branchB.probe_w(w))


# ============================= SHELL ================================


class _Identity(Module):
    def forward(self, x, ext_param=None):
        return x

    def probe(self, z):
        return None

    def probe_w(self, w):
        return None


class Shell(Module):
    """Model container: input layer -> core -> output layer."""

    def __init__(self, core, input_layer=None, output_layer=None):
        super().__init__()
        if isinstance(core, (OrderedDict, dict, list, tuple)):
            core = Series(core)
            warnings.warn("Core has been converted to a Series class instance.")
        if input_layer is None:
            input_layer = _Identity()
        elif isinstance(input_layer, (OrderedDict, dict, list, tuple)):
            input_layer = Series(input_layer)
            warnings.warn(
                "Input layer has been converted to a Series class instance.")
        if output_layer is None:
            output_layer = _Identity()
        elif isinstance(output_layer, (OrderedDict, dict, list, tuple)):
            output_layer = Series(output_layer)
            warnings.warn(
                "Output layer has been converted to a Series class instance.")
        self.core = core
        self.input_layer = input_layer
        self.output_layer = output_layer
        self.nfft = self.__check_attribute("nfft")
        self.alias_decay_db = self.__check_attribute("alias_decay_db")
        self.dtype = self.__check_attribute("dtype")
        self.input_channels, self.output_channels = self.__check_io()

    def __check_attribute(self, attr):
        core_v = _attr_of(self.core, attr)
        if core_v is None:
            raise ValueError(f"The core does not possess the attribute {attr}.")
        in_v = _attr_of(self.input_layer, attr)
        if in_v is not None and core_v != in_v:
            raise AssertionError(
                f"The input layer has {attr} = {in_v} and the core has "
                f"{attr} = {core_v}. They must have the same value.")
        out_v = _attr_of(self.output_layer, attr)
        if out_v is not None and core_v != out_v:
            raise AssertionError(
                f"The core has {attr} = {core_v} and the output layer has "
                f"{attr} = {out_v}. They must have the same value.")
        return core_v

    def __check_io(self):
        if getattr(self.core, "input_channels", None) is None:
            raise ValueError(
                "The core does not possess the attribute input_channels.")
        in_out = getattr(self.input_layer, "output_channels", None)
        if in_out is not None and self.core.input_channels != in_out:
            raise AssertionError(
                f"The core should receive {self.core.input_channels} input "
                f"channels, but {in_out} channels arrive from the input layer.")
        if getattr(self.core, "output_channels", None) is None:
            raise ValueError(
                "The core does not possess the attribute output_channels.")
        out_in = getattr(self.output_layer, "input_channels", None)
        if out_in is not None and self.core.output_channels != out_in:
            raise AssertionError(
                f"The core sends {self.core.output_channels} output channels, "
                f"but the output layer can only receive {out_in} channels.")
        in_ch = getattr(self.input_layer, "input_channels", None)
        out_ch = getattr(self.output_layer, "output_channels", None)
        return (self.core.input_channels if in_ch is None else in_ch,
                self.core.output_channels if out_ch is None else out_ch)

    def forward(self, x, ext_param=None):
        return self.output_layer(_call(self.core, self.input_layer(x),
                                       ext_param))

    def get_inputLayer(self):
        return self.input_layer

    def get_outputLayer(self):
        return self.output_layer

    def get_core(self):
        return self.core

    # -- setters: each returns a new Shell sharing the other layers --------------
    def _replace(self, **layers) -> "Shell":
        """A shallow copy with ``layers`` swapped in, unchecked (the JAX
        package's ``Module.replace``); this Shell keeps its own."""
        obj = copy.copy(self)
        obj._modules = OrderedDict(self._modules)
        for name, layer in layers.items():
            setattr(obj, name, layer)
        return obj

    def set_inputLayer(self, input_layer) -> "Shell":
        return self._replace(input_layer=input_layer)

    def set_outputLayer(self, output_layer) -> "Shell":
        return self._replace(output_layer=output_layer)

    def set_core(self, core) -> "Shell":
        return self._replace(core=core)

    # -- probing -------------------------------------------------------------
    def probe(self, z, include_shell_io: bool = False):
        """The core's H(z); with ``include_shell_io`` the layers' probes
        (None for a transform) compose around it."""
        H = self.core.probe(z)
        if include_shell_io:
            for layer, before in ((self.input_layer, True),
                                  (self.output_layer, False)):
                Hl = layer.probe(z) if hasattr(layer, "probe") else None
                if Hl is not None:
                    H = Hl if H is None else (H @ Hl if before else Hl @ H)
        return H

    # -- responses ---------------------------------------------------------------
    def get_time_response(self, fs: int = 48000, identity: bool = False):
        """Impulse response: impulse -> rfft(nfft) -> core -> irfft, with
        the alias envelope undone.  ``identity=True`` diag-embeds the
        input for input-free IRs."""
        env = _alias_envelope(self.nfft, float(self.alias_decay_db),
                              self.dtype, device=self.device)
        env = env.reshape(1, -1, 1)
        x = signal_gallery(batch_size=1, n_samples=self.nfft,
                           n=self.input_channels, signal_type="impulse",
                           fs=fs, dtype=self.dtype, device=self.device)
        if identity and self.input_channels > 1:
            x = torch.diag_embed(x)  # (1, T, N) -> (1, T, N, N)
        with torch.no_grad():
            X = torch.fft.rfft(x, n=self.nfft, dim=1)
            y = torch.fft.irfft(self.core(X), n=self.nfft, dim=1)
            return y * (env if y.ndim == 3 else env[..., None])

    def get_freq_response(self, fs: int = 48000, identity: bool = False):
        """Frequency response with the alias envelope undone:
        rfft of :meth:`get_time_response`."""
        y = self.get_time_response(fs=fs, identity=identity)
        return torch.fft.rfft(y, n=self.nfft, dim=1)
