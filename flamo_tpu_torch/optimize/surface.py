"""Loss-landscape diagnostics (counterpart of
``flamo_tpu/optimize/surface.py``): 1-D loss profiles and 2-D loss
surfaces over raw parameters, with optional perturbation runs.

The configurations are dataclasses.  A scan writes each step's raw
parameter into the model in place (``assign_value``), runs the model's
forward under ``no_grad`` and reads each criterion; with ``output_dir``
each run is saved as a ``.mat`` file (scipy.io).  ``plot_loss`` writes
the mean loss as ``.npz`` and a text table in place of the JAX package's
matplotlib figure.  The perturbation of ``perturb_param`` is drawn from a
``torch.Generator`` (another PRNG than JAX's).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from flamo_tpu_torch.processor.system import Parallel, Recursion, Series
from flamo_tpu_torch.utils import next_key


def _identity(x):
    return x


@dataclass
class ParameterConfig:
    """One scanned parameter: the dotted module ``key``, the map from a
    scanned value to the raw parameter, the bounds (scalars, or lists
    between which the scan interpolates), the target value, 'linear' or
    'log' steps and the index written (None: the whole parameter)."""

    key: Optional[str] = None
    param_map: Callable = _identity
    lower_bound: Optional[object] = None
    upper_bound: Optional[object] = None
    target_value: Optional[float] = None
    scale: str = "linear"
    n_steps: Optional[int] = None
    indx: object = None


@dataclass
class LossConfig:
    """A scan: its criteria, its parameters, the parameter perturbed at the
    start of each of ``n_runs`` runs (through ``perturb_map``) and the
    directory its results go to."""

    criteria: Optional[List[Callable]] = None
    param_config: Optional[List[ParameterConfig]] = None
    perturb_param: Optional[str] = None
    perturb_map: Callable = _identity
    n_runs: Optional[int] = None
    output_dir: Optional[str] = None


def _get_nested_module(core, key: str):
    module = core
    for k in key.split("."):
        module = getattr(module, k)
    return module


def _criterion_name(crit) -> str:
    return getattr(crit, "name", type(crit).__name__)


class LossProfile:
    """1-D loss profile over one raw parameter of ``net`` (a Shell)."""

    def __init__(self, net, loss_config: LossConfig,
                 dtype: torch.dtype = torch.float32, generator=None):
        self.net = net
        self.loss_config = loss_config
        self.param_config = loss_config.param_config[0]
        self.criteria = loss_config.criteria
        self.n_runs = loss_config.n_runs
        self.output_dir = loss_config.output_dir
        self.dtype = dtype
        self.generator = next_key(generator)
        self.register_steps()

    # -- parameter plumbing ------------------------------------------------
    def get_modules_keys(self, module, prefix: str = "") -> list:
        """The dotted keys of every module under ``module``."""
        if isinstance(module, Series):
            names = list(module.keys)
        elif isinstance(module, Recursion):
            names = ["feedforward", "feedback"]
        elif isinstance(module, Parallel):
            names = ["branchA", "branchB"]
        else:
            return []
        keys = []
        for k in names:
            full = f"{prefix}.{k}" if prefix else k
            keys.append(full)
            keys.extend(self.get_modules_keys(getattr(module, k), full))
        return keys

    def get_nested_module(self, core, key: str):
        return _get_nested_module(core, key)

    def set_raw_parameter(self, param_key: str, new_value, map=_identity,
                          indx=None):
        """Write ``map(new_value)`` into the raw parameter of the module at
        ``param_key`` of the core, in place."""
        module = _get_nested_module(self.net.get_core(), param_key)
        module.assign_value(torch.as_tensor(map(new_value), dtype=self.dtype),
                            indx)

    def sample_rand_param(self, ref_param, generator=None):
        """Gaussian draws with ``ref_param``'s mean and (population)
        standard deviation, drawn on the CPU from ``generator`` (default
        the profile's) and moved to its device."""
        ref = ref_param.detach()
        draw = torch.randn(tuple(ref.shape), dtype=ref.dtype,
                           generator=generator or self.generator)
        return (draw.to(ref.device) * torch.std(ref, correction=0)
                + torch.mean(ref))

    # -- scanning ----------------------------------------------------------
    def get_steps(self, lower, upper, n_steps: int, scale: str):
        lo, hi = (0.0, 1.0) if isinstance(lower, list) else (lower, upper)
        if scale == "linear":
            return torch.linspace(lo, hi, n_steps, dtype=self.dtype)
        if scale == "log":
            return torch.logspace(math.log10(lo), math.log10(hi), n_steps,
                                  dtype=self.dtype)
        raise ValueError("Scale must be either 'linear' or 'log'")

    def register_steps(self):
        pc = self.param_config
        self.steps = self.get_steps(pc.lower_bound, pc.upper_bound,
                                    pc.n_steps, pc.scale)

    def _perturb(self):
        cfg = self.loss_config
        if cfg.perturb_param:
            ref = _get_nested_module(self.net.get_core(),
                                     cfg.perturb_param).param
            self.set_raw_parameter(cfg.perturb_param,
                                   self.sample_rand_param(ref),
                                   cfg.perturb_map)

    def _losses(self, input, target) -> list:
        with torch.no_grad():
            pred = self.net(input)
            return [float(crit(pred, target)) for crit in self.criteria]

    def _save(self, name: str, **arrays):
        if self.output_dir:
            from scipy.io import savemat

            savemat(os.path.join(self.output_dir, name), arrays)

    def _scan_value(self, pc, s):
        if isinstance(pc.lower_bound, list):
            return ((1 - s) * torch.as_tensor(pc.lower_bound)
                    + s * torch.as_tensor(pc.upper_bound))
        return s

    def compute_loss(self, input, target) -> np.ndarray:
        """(n_runs, n_steps, n_criteria) losses."""
        steps = self.steps
        pc = self.param_config
        loss = np.empty((self.n_runs, len(steps), len(self.criteria)))
        for i_run in range(self.n_runs):
            self._perturb()
            for i_step, s in enumerate(steps):
                self.set_raw_parameter(pc.key, self._scan_value(pc, s),
                                       pc.param_map, pc.indx)
                loss[i_run, i_step] = self._losses(input, target)
            self._save(f"partial_loss_run_{i_run + 1}.mat",
                       loss=loss[i_run], steps=steps.numpy())
        return loss

    def plot_loss(self, loss: np.ndarray) -> dict:
        """The mean and spread of each criterion's loss over the runs
        against the steps, with the minimum: written as
        ``<key>.npz`` and ``<key>.txt`` into ``output_dir`` (when set) and
        returned."""
        steps = self.steps.numpy()
        out = {"steps": steps, "mean": loss.mean(0), "std": loss.std(0),
               "names": np.asarray([_criterion_name(c)
                                    for c in self.criteria])}
        if self.output_dir:
            base = os.path.join(self.output_dir, str(self.param_config.key))
            np.savez(base + ".npz", **out)
            with open(base + ".txt", "w") as f:
                f.write("step " + " ".join(
                    f"{n}_mean {n}_std" for n in out["names"]) + "\n")
                for i, s in enumerate(steps):
                    f.write(f"{s:.7g} " + " ".join(
                        f"{m:.7g} {d:.7g}" for m, d in
                        zip(out["mean"][i], out["std"][i])) + "\n")
                for j, n in enumerate(out["names"]):
                    i = int(out["mean"][:, j].argmin())
                    f.write(f"# {n}: min {out['mean'][i, j]:.7g} at step "
                            f"{steps[i]:.7g}\n")
        return out

    def compute_accuracy(self, loss: np.ndarray) -> np.ndarray:
        """Accuracy per Turian & Henry, arXiv:2012.04572: the share of runs
        in which each step's loss exceeds the loss at the target value,
        (n_steps, n_criteria)."""
        steps = self.steps.numpy()
        t = np.abs(steps - self.param_config.target_value).argmin()
        return (loss > loss[:, t:t + 1, :]).astype(float).mean(axis=0)


class LossSurface(LossProfile):
    """2-D loss surface over two raw parameters of ``net``."""

    def __init__(self, net, loss_config: LossConfig,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__(net, loss_config, dtype, generator)
        if len(loss_config.param_config) != 2:
            raise AssertionError(
                "LossSurface supports only two optimizable parameters.")
        self.param_config = loss_config.param_config

    def register_steps(self):
        pc0, pc1 = self.loss_config.param_config
        self.steps_0 = self.get_steps(pc0.lower_bound, pc0.upper_bound,
                                      pc0.n_steps, pc0.scale)
        self.steps_1 = self.get_steps(pc1.lower_bound, pc1.upper_bound,
                                      pc1.n_steps, pc1.scale)

    def compute_loss(self, input, target) -> np.ndarray:
        """(n_runs, n_steps_0, n_steps_1, n_criteria) losses."""
        pc0, pc1 = self.param_config
        s0, s1 = self.steps_0, self.steps_1
        loss = np.empty((self.n_runs, len(s0), len(s1), len(self.criteria)))
        for i_run in range(self.n_runs):
            self._perturb()
            for i0, v0 in enumerate(s0):
                self.set_raw_parameter(pc0.key, v0, pc0.param_map, pc0.indx)
                for i1, v1 in enumerate(s1):
                    self.set_raw_parameter(pc1.key, v1, pc1.param_map,
                                           pc1.indx)
                    loss[i_run, i0, i1] = self._losses(input, target)
            self._save(f"surface_run_{i_run + 1}.mat", loss=loss[i_run],
                       steps_0=s0.numpy(), steps_1=s1.numpy())
        return loss

    def compute_accuracy(self, loss: np.ndarray) -> np.ndarray:
        """2-D accuracy per Turian & Henry, arXiv:2012.04572: the share of
        runs in which each grid point's loss exceeds the loss at the
        (target_0, target_1) point, (n_steps_0, n_steps_1, n_criteria)."""
        pc0, pc1 = self.param_config
        t0 = np.abs(self.steps_0.numpy() - pc0.target_value).argmin()
        t1 = np.abs(self.steps_1.numpy() - pc1.target_value).argmin()
        ref = loss[:, t0:t0 + 1, t1:t1 + 1, :]
        return (loss > ref).astype(float).mean(axis=0)

    def plot_loss(self, loss: np.ndarray) -> dict:
        """Each criterion's mean loss over the runs on the grid, written
        as ``loss_surface.npz`` and ``loss_surface.txt`` into
        ``output_dir`` (when set) and returned."""
        out = {"steps_0": self.steps_0.numpy(),
               "steps_1": self.steps_1.numpy(), "mean": loss.mean(0),
               "names": np.asarray([_criterion_name(c)
                                    for c in self.criteria])}
        if self.output_dir:
            base = os.path.join(self.output_dir, "loss_surface")
            np.savez(base + ".npz", **out)
            with open(base + ".txt", "w") as f:
                f.write(f"# {self.param_config[0].key} (rows) x "
                        f"{self.param_config[1].key} (columns)\n")
                for j, n in enumerate(out["names"]):
                    f.write(f"# {n}\n")
                    for i, s in enumerate(out["steps_0"]):
                        f.write(f"{s:.7g} " + " ".join(
                            f"{v:.7g}" for v in out["mean"][i, :, j]) + "\n")
        return out
