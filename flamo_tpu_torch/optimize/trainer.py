"""Trainer (counterpart of ``flamo_tpu/optimize/trainer.py``).

The same control surface as the JAX package's: Adam over the trainable
parameters with a staircase learning-rate decay, weighted criteria with
``requires_model``, per-epoch checkpoints, early stopping, a one-time
gate that routes a recognised topology onto a fused step kernel
(:mod:`flamo_tpu_torch.models.dispatch`), and the multi-step
``fit_scan``/``fit_scan_epochs``.  PyTorch runs eagerly, so a step is
forward, backward and ``optimizer.step()`` on the model in place, and the
JAX package's ``lax.scan`` of ``steps_per_call`` steps is a loop whose
losses stay on the device and reach the host once a chunk.

Checkpoints are the JAX package's format 2: a pickle of ``{"format": 2,
"fingerprint": sha256, "leaves": keypath -> numpy}`` whose key paths are
``flamo_tpu_torch.convert.jax_named_tensors``'s, so each package reads
the other's.  Orbax checkpoints have no counterpart.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.models.dispatch import recognize_fused, single_pair
from flamo_tpu_torch.optimize.dataset import stack_loader
from flamo_tpu_torch.optimize.utils import run_in_chunks

# a fused candidate's first loss must be within this of the graph's
# (relative), the JAX package's gate
FUSED_PARITY = 5e-3


class Trainer:
    """The training loop of differentiable frequency-domain systems.

    Arguments mirror the JAX package's: net, max_epochs, lr, patience,
    patience_delta, step_size, step_factor, log, train_dir and ``fused``
    ('auto' routes a recognised topology onto its fused kernel behind the
    parity gate; on the CPU only the candidates marked ``cpu_ok``;
    'force' gates every candidate on the CPU too; 'off' keeps the module
    graph) and profile_dir (:meth:`train` traces epoch 1's training steps
    with ``torch.profiler`` there, the card's activity too on a CUDA
    model, as ``trace_epoch1.json``; epoch 0 warms up).  The model trains
    in place and stays on its device: batches are moved there.  Other
    keyword arguments are ignored, as in the JAX package."""

    def __init__(self, net, max_epochs: int = 10, lr: float = 1e-3,
                 patience: int = 5, patience_delta: float = 0.01,
                 step_size: int = 50, step_factor: float = 0.1,
                 log: bool = True, train_dir: Optional[str] = None,
                 fused: str = "auto", profile_dir: Optional[str] = None,
                 **kwargs):
        if fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got "
                             f"{fused!r}")
        self.net = net
        self.fused = fused
        self.fused_path = None
        self._fused_loss = None
        self._fused_gated = False
        self.max_epochs = max_epochs
        self.lr = lr
        self.patience = patience
        self.patience_delta = patience_delta
        self.step_size = step_size
        self.step_factor = step_factor
        self.min_val_loss = float("inf")
        self.counter = 0
        self.log = log
        if self.log and (train_dir is None or not os.path.isdir(train_dir)):
            raise ValueError(
                "The directory specified in train_dir does not exist.")
        self.train_dir = train_dir
        self.profile_dir = profile_dir
        self.n_loss = 0
        self.criterion, self.alpha, self.requires_model = [], [], []
        self._opt = None
        self._sched = None
        self._step_count = 0
        # usable before train() for direct train_step/fit_scan callers
        self.train_loss, self.valid_loss = [], []
        self.train_loss_log, self.valid_loss_log = {}, {}

    @property
    def device(self) -> torch.device:
        return self.net.device

    # ------------------------------------------------------------------
    def register_criterion(self, criterion, alpha: float = 1,
                           requires_model: bool = False):
        """Register a loss with weight ``alpha``."""
        self.criterion.append(criterion)
        self.alpha.append(alpha)
        self.requires_model.append(requires_model)
        self.n_loss += 1

    # ------------------------------------------------------------------
    def _loss_name(self, criterion):
        return type(criterion).__name__

    def _total_loss(self, model, inputs, targets, step, loss_state):
        if self._fused_loss is not None:
            return self._fused_loss(model, inputs, targets, step,
                                    loss_state)
        est = model(inputs)
        total = 0.0
        per_loss = []
        si = 0
        for alpha, criterion, requires_model in zip(
                self.alpha, self.criterion, self.requires_model):
            args = [est, targets]
            kwargs = {}
            if requires_model:
                args.append(model)
            if getattr(criterion, "stateful", False):
                kwargs["step"] = step
                kwargs["state"] = loss_state[si]
                si += 1
            value = criterion(*args, **kwargs)
            per_loss.append(value)
            total = total + alpha * value
        return total, per_loss

    def _maybe_gate_fused(self, inputs, targets):
        """One-time fused-kernel dispatch gate, before the first step:
        recognise a kernel-compatible (topology, criteria) combination
        (models/dispatch.py) and take the first candidate whose loss on
        this batch at the current parameters is within FUSED_PARITY of
        the module graph's.  A candidate is refused for a mismatched
        topology or batch, or for its parity, and the refusal is printed;
        an error of a kernel propagates."""
        if self._fused_gated:
            return
        self._fused_gated = True
        if self.fused == "off" or self.n_loss == 0:
            return
        candidates = recognize_fused(self.net, self.criterion, self.alpha,
                                     self.requires_model)
        if self.fused != "force" and self.device.type == "cpu":
            # the kernels' plain versions lose to the graph on the CPU;
            # plain-PyTorch candidates (cpu_ok) stay eligible
            candidates = [c for c in candidates if c[2]]
        if not candidates:
            return
        if not single_pair(inputs, targets):
            print(f"Trainer: fused dispatch refused "
                  f"{[c[0] for c in candidates]}: batch {tuple(inputs.shape)}"
                  f" -> {tuple(targets.shape)}, the fused steps take one "
                  "(1, T, 1) -> (1, M, 1) pair")
            return
        ls = self._gather_loss_state()
        with torch.no_grad():
            g = float(self._total_loss(self.net, inputs, targets,
                                       self._step_count, ls)[0])
            for name, loss_fn, _cpu_ok in candidates:
                f = float(loss_fn(self.net, inputs, targets,
                                  self._step_count, ls)[0])
                rel = abs(f - g) / max(1e-9, abs(g))
                if rel < FUSED_PARITY:
                    self._fused_loss = loss_fn
                    self.fused_path = name
                    if self.log:
                        print(f"Trainer: fused dispatch -> {name} "
                              f"(parity rel={rel:.1e})")
                    return
                print(f"Trainer: fused dispatch refused {name}: first loss "
                      f"{f:.7g} against the graph's {g:.7g}, rel {rel:.3e} "
                      f"(tol {FUSED_PARITY:g})")

    def _check_fused_finite(self, losses):
        """Watchdog of the no-pivot fused kernels: the recognised
        topologies keep ``||A||_2 <= 1`` (models/dispatch.py), so a
        non-finite loss on the fused path means an exact closed-loop
        resonance or a model that left the recognised structure; either
        way carrying NaNs on is worse than stopping.  Runs where the
        losses reach the host: each step, or each chunk."""
        if self.fused_path is not None and not np.all(np.isfinite(losses)):
            raise RuntimeError(
                f"fused step kernel '{self.fused_path}' produced a "
                "non-finite loss: the training state is corrupted from "
                "this step on. Retrain with Trainer(..., fused='off') to "
                "use the module-graph path (pivoted solve), and please "
                "report the topology: the dispatch gate judged it "
                "structurally stable.")

    def _gather_loss_state(self):
        """The stateful criteria's arrays (e.g. mask partitions)."""
        return tuple(c.mask_indices for c in self.criterion
                     if getattr(c, "stateful", False))

    def _build_step(self, steps_per_epoch: int):
        """Adam over the trainable parameters, its learning rate at update
        s ``lr * step_factor ** (s // (step_size * steps_per_epoch))``
        (optax's ``exponential_decay(staircase=True)``)."""
        self._opt = masked_optimizer(self.net, lr=self.lr)
        period = self.step_size * max(1, steps_per_epoch)
        factor = self.step_factor
        self._sched = torch.optim.lr_scheduler.LambdaLR(
            self._opt, lambda s: factor ** (s // period))

    def _step(self, inputs, targets, step):
        """One optimizer step at global step ``step``: the loss and its
        per-criterion values before the update, on the device."""
        self._opt.zero_grad(set_to_none=True)
        total, per = self._total_loss(self.net, inputs, targets, step,
                                      self._gather_loss_state())
        total.backward()
        self._opt.step()
        self._sched.step()
        return total.detach(), [torch.as_tensor(p).detach() for p in per]

    def _on_device(self, x):
        return torch.as_tensor(x).to(self.device)

    # ------------------------------------------------------------------
    def train(self, train_dataset, valid_dataset, scan: bool = False):
        """Epoch loop.  ``scan=True`` runs each epoch through
        :meth:`fit_scan_epochs` on the loaders' stacked batches (the batch
        order frozen at stacking time): the same step sequence, its losses
        copied to the host once an epoch."""
        self.train_loss, self.valid_loss = [], []
        self.train_loss_log = {self._loss_name(c): [] for c in self.criterion}
        self.valid_loss_log = {self._loss_name(c): [] for c in self.criterion}

        if scan:
            bx, bt = stack_loader(train_dataset)
            try:
                vx, vt = stack_loader(valid_dataset)
            except ValueError:  # an empty loader
                vx = vt = None
            st = time.time()
            self.fit_scan_epochs(bx, bt, n_epochs=self.max_epochs,
                                 valid_inputs=vx, valid_targets=vt)
            print("Training time: {:.3f}s".format(time.time() - st))
            return

        if self._opt is None:
            self._build_step(max(1, len(train_dataset)))

        try:
            from tqdm import trange

            epochs = trange(self.max_epochs, desc="Training")
        except ImportError:
            epochs = range(self.max_epochs)

        st = time.time()
        for epoch in epochs:
            st_epoch = time.time()
            profiler = self._start_profile() if epoch == 1 else None
            epoch_loss = 0.0
            n_steps = 0
            for inputs, targets in train_dataset:
                epoch_loss += self.train_step((inputs, targets))
                n_steps += 1
            if profiler is not None:
                self._stop_profile(profiler)
            self.train_loss.append(epoch_loss / max(1, n_steps))
            self._last_steps_per_sec = n_steps / max(1e-9,
                                                     time.time() - st_epoch)

            epoch_loss = 0.0
            n_steps = 0
            for inputs, targets in valid_dataset:
                epoch_loss += self.valid_step((inputs, targets))
                n_steps += 1
            self.valid_loss.append(epoch_loss / max(1, n_steps))

            self.print_results(epoch, time.time() - st_epoch)
            if self.log:
                self.save_model(epoch)
            if self.early_stop():
                print(f"Early stopping at epoch: {epoch}")
                break
        print("Training time: {:.3f}s".format(time.time() - st))

    def _start_profile(self):
        """A started torch.profiler over the CPU and, for a CUDA model, the
        card; None without ``profile_dir``."""
        if self.profile_dir is None:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(self.profile_dir, "trace_epoch1.json"))

    # ------------------------------------------------------------------
    def fit_scan(self, inputs, targets, n_steps: int,
                 steps_per_call: int = 50):
        """Run exactly ``n_steps`` optimizer steps on one fixed (inputs,
        targets) pair (the reference's ``Dataset.expand`` semantics) in
        chunks of ``steps_per_call``: a chunk's losses stay on the device
        and reach the host once, where the watchdog reads them.  Returns
        the (n_steps,) loss history."""
        inputs, targets = self._on_device(inputs), self._on_device(targets)
        self._maybe_gate_fused(inputs, targets)
        if self._opt is None:
            self._build_step(1)

        def step(i):
            total, _ = self._step(inputs, targets, i)
            self._step_count += 1
            return total

        return run_in_chunks(step, n_steps, steps_per_call,
                             start=self._step_count,
                             on_chunk=self._check_fused_finite)

    def fit_scan_epochs(self, batched_inputs, batched_targets,
                        n_epochs: int, valid_inputs=None,
                        valid_targets=None):
        """Multi-batch epochs on stacked batches ``(S, B, ...)`` (from
        :func:`stack_loader`), one batch a step: the step sequence of S
        :meth:`train_step` calls (step counter, loss masks, Adam and its
        schedule), with the epoch's losses and per-criterion values copied
        to the host once, at its end.  ``valid_inputs``/``valid_targets``
        may be stacked ``(Sv, B, ...)`` or a single batch ``(B, ...)``;
        validation then averages every batch, no grad, and early stopping
        reads that mean.  Returns the (n_epochs * S,) loss history (fewer
        epochs when it stops early)."""
        bx = self._on_device(batched_inputs)
        bt = self._on_device(batched_targets)
        S = bx.shape[0]
        self._maybe_gate_fused(bx[0], bt[0])
        if self._opt is None:
            self._build_step(S)
        if valid_inputs is not None:
            vx = self._on_device(valid_inputs)
            vt = self._on_device(valid_targets)
            if vx.ndim == bx.ndim - 1:
                vx, vt = vx[None], vt[None]

        history = []
        for epoch in range(n_epochs):
            totals, pers = [], []
            for s in range(S):
                total, per = self._step(bx[s], bt[s], self._step_count)
                self._step_count += 1
                totals.append(total)
                pers.append(torch.stack(per))
            history.append(torch.stack(totals).cpu().numpy())
            self._check_fused_finite(history[-1])
            per = torch.stack(pers).cpu().numpy()  # (S, n_loss)
            for j, criterion in enumerate(self.criterion):
                self.train_loss_log.setdefault(
                    self._loss_name(criterion), []).extend(
                        per[:, j].tolist())
            self.train_loss.append(float(history[-1].mean()))
            if valid_inputs is not None:
                total, vper = self._valid_mean(vx, vt)
                self.valid_loss.append(total)
                for j, criterion in enumerate(self.criterion):
                    self.valid_loss_log.setdefault(
                        self._loss_name(criterion), []).append(
                            float(vper[j]))
            if self.log:
                self.save_model(epoch)
            if valid_inputs is not None and self.early_stop():
                print(f"Early stopping at epoch: {epoch}")
                break
        return np.concatenate(history)

    def _valid_mean(self, vx, vt):
        """The mean total and per-criterion losses over the stacked
        validation batches, no grad, copied to the host once."""
        ls = self._gather_loss_state()
        totals, pers = [], []
        with torch.no_grad():
            for s in range(vx.shape[0]):
                total, per = self._total_loss(self.net, vx[s], vt[s],
                                              self._step_count, ls)
                totals.append(total)
                pers.append(torch.stack([torch.as_tensor(p) for p in per]))
        return (float(torch.stack(totals).mean()),
                torch.stack(pers).mean(dim=0).cpu().numpy())

    def train_step(self, data):
        """One optimization step; returns its loss (before the update) as
        a float.  Each criterion's value is logged, one host copy each, as
        in the JAX package."""
        inputs, targets = (self._on_device(x) for x in data)
        self._maybe_gate_fused(inputs, targets)
        if self._opt is None:
            self._build_step(1)
        for c in self.criterion:
            if hasattr(c, "pre_step"):
                c.pre_step()
        total, per = self._step(inputs, targets, self._step_count)
        self._step_count += 1
        for criterion, value in zip(self.criterion, per):
            self.train_loss_log.setdefault(
                self._loss_name(criterion), []).append(float(value))
        total = float(total)
        self._check_fused_finite(total)
        return total

    def valid_step(self, data):
        """One validation step (no grad); returns its loss as a float."""
        inputs, targets = (self._on_device(x) for x in data)
        if self._opt is None:
            self._build_step(1)
        with torch.no_grad():
            total, per = self._total_loss(self.net, inputs, targets,
                                          self._step_count,
                                          self._gather_loss_state())
        for criterion, value in zip(self.criterion, per):
            self.valid_loss_log.setdefault(
                self._loss_name(criterion), []).append(float(value))
        return float(total)

    # ------------------------------------------------------------------
    def print_results(self, e: int, e_time: float):
        msg = get_str_results(epoch=e, train_loss=self.train_loss,
                              valid_loss=self.valid_loss, time=e_time)
        sps = getattr(self, "_last_steps_per_sec", None)
        if sps is not None:
            msg += " - {:.1f} steps/s".format(sps)
        print(msg)

    def get_train_dir(self):
        if self.train_dir is None:
            self.train_dir = os.path.join("output",
                                          time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(self.train_dir, exist_ok=True)

    def save_model(self, e: int):
        """Checkpoint the model (:func:`save_model_state`) to
        ``train_dir/checkpoints/model_e{e}.pkl``."""
        dir_path = os.path.join(self.train_dir, "checkpoints")
        os.makedirs(dir_path, exist_ok=True)
        save_model_state(self.net, os.path.join(dir_path, f"model_e{e}.pkl"))

    def early_stop(self):
        """Early stopping on a validation plateau: ``patience`` epochs in a
        row within ``patience_delta`` of the best loss so far."""
        if self.valid_loss[-1] < (self.min_val_loss - self.patience_delta):
            self.min_val_loss = self.valid_loss[-1]
            self.counter = 0
        elif ((self.min_val_loss - self.patience_delta) < self.valid_loss[-1]
              and self.valid_loss[-1] < (self.min_val_loss
                                         + self.patience_delta)):
            self.counter += 1
            if self.counter >= self.patience:
                return True
        return False


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _named_arrays(model) -> dict[str, np.ndarray]:
    """Key path -> host copy of each of the model's tensors, under the
    JAX package's key paths."""
    return {k: v.detach().cpu().numpy()
            for k, v in jax_named_tensors(model).items()}


def _fingerprint(named) -> str:
    """sha256 over (key path, shape, dtype, bytes) of every leaf, in key
    order: pins the structure and detects a corrupt payload (the JAX
    package's, so both packages compute the same digest)."""
    h = hashlib.sha256()
    for k in sorted(named):
        v = np.ascontiguousarray(np.asarray(named[k]))
        h.update(f"{k}:{v.shape}:{v.dtype}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _check_restorable(named_model, named_ckpt, ckpt_fp, where: str):
    missing = sorted(set(named_model) - set(named_ckpt))
    extra = sorted(set(named_ckpt) - set(named_model))
    if missing or extra:
        raise ValueError(
            f"checkpoint {where} does not match the model structure: "
            f"missing leaves {missing[:5]}{'...' if len(missing) > 5 else ''}, "
            f"unexpected leaves {extra[:5]}{'...' if len(extra) > 5 else ''}"
        )
    for k, v in named_model.items():
        cs, ms = tuple(np.shape(named_ckpt[k])), tuple(np.shape(v))
        if cs != ms:
            raise ValueError(
                f"checkpoint {where}: leaf {k} has shape {cs}, model "
                f"expects {ms}")
    if ckpt_fp is not None and ckpt_fp != _fingerprint(
            {k: np.asarray(v) for k, v in named_ckpt.items()}):
        raise ValueError(f"checkpoint {where} is corrupt "
                         "(fingerprint mismatch)")


def save_model_state(model, path: str):
    """Checkpoint as named leaves (key path -> numpy array) plus their
    fingerprint: the JAX package's format 2, which its
    ``load_model_state`` reads too."""
    arrays = _named_arrays(model)
    payload = {"format": 2, "fingerprint": _fingerprint(arrays),
               "leaves": arrays}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_model_state(model, path: str):
    """Restore a format-2 checkpoint, written by this package or by the
    JAX package, into a structurally identical model, in place, and return
    the model.  Leaves are matched by key path; a missing or unexpected
    leaf, a leaf of another shape or a fingerprint that does not match
    the payload raises ValueError naming it.  Unpickling runs code: read
    only checkpoints this program or the JAX package wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not isinstance(payload, dict) or payload.get("format") != 2:
        raise ValueError(f"checkpoint {path} is not in format 2")
    ckpt = payload["leaves"]
    _check_restorable(_named_arrays(model), ckpt, payload.get("fingerprint"),
                      path)
    return load_jax_params(model, ckpt)


def get_str_results(epoch=None, train_loss=None, valid_loss=None, time=None):
    """Format per-epoch results."""
    to_print = ""
    if epoch is not None:
        to_print += "epoch: {:3d} ".format(epoch)
    if train_loss is not None:
        to_print += "- train_loss: {:6.4f} ".format(train_loss[-1])
    if valid_loss is not None:
        to_print += "- test_loss: {:6.4f} ".format(valid_loss[-1])
    if time is not None:
        to_print += "- time: {:6.4f} s".format(time)
    return to_print
