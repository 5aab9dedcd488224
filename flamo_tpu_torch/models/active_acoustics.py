"""The active-acoustics workload (counterpart of
``flamo_tpu/models/active_acoustics.py``; the reference's
e8_active_acoustics, Dal Santo et al., DAFx-24): a MIMO electroacoustic
feedback loop, physical room responses around a trainable mixing FIR
matrix, trained for a flat loop response or for eigenvalue magnitudes,
with gain-before-instability (GBI) analysis.

Two trainers, both plain Python loops of Adam steps (the JAX package's
jit + scan):

* magnitude MSE on ``Shell(FFT -> Recursion(room, mixer))``
  (:func:`build_active_acoustics`): :func:`aa_fused_taps_step` runs the
  whole per-bin step in kernel K9 from the mixer taps,
  :func:`aa_fused_step` in kernel K8 from the mixer response rows (the
  tap->response DFT a float32 matmul outside it), and
  :func:`aa_hoisted_room_step` through the module graph;
* eigenvalue-magnitude MSE (``optimize.mse_evs`` semantics) on the
  ``ActiveAcoustics.F_MM`` loop matrix: :func:`aa_evs_train_step` /
  :func:`aa_evs_fit`, whose Durand-Kerner roots are kernel K7.

The room is measured IRs or synthetic WGN reverb drawn from a
``torch.Generator`` (not JAX's PRNG: the same seed gives other rooms;
``flamo_tpu_torch.convert`` carries a JAX model's rooms and weights
across).  Training mutates the modules in place.  On the card the callers
keep TF32 off, so the float32 matmuls stay full precision.
"""

from __future__ import annotations

import math
import warnings
from collections import OrderedDict

import numpy as np
import torch

from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.functional import (WGN_reverb, get_eigenvalues,
                                        poly_roots_rows, spectral_radius)
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.aa_kernels import aa_taps_tf_mse, aa_tf_mse
from flamo_tpu_torch.optimize.utils import generate_partitions, run_in_chunks
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.utils import next_key, resolve_device


def build_active_acoustics(n_mics: int = 4, n_loudspeakers: int = 13,
                           rir_length: int = 15000, fir_order: int = 100,
                           nfft: int = 96000, fs: int = 48000,
                           room_irs=None, t60: float = 0.5,
                           alias_decay_db: float = 0.0,
                           cache_room: bool = True, solve_method: str = "ge",
                           generator=None, device=None) -> system.Shell:
    """Shell(FFT -> Recursion(room, mixing FIR)) on ``device`` (default:
    the CUDA card).

    ``room_irs``: a (rir_length, n_mics, n_loudspeakers) IR matrix, or None
    for a synthetic WGN-reverb room drawn from ``generator``.  The mixing
    FIR (fir_order taps, n_loudspeakers x n_mics) is the trainable DSP,
    initialized small (x 0.01) so that the loop starts stable.
    ``cache_room=True`` keeps the frozen room as its response
    (:class:`dsp.CachedResponse`)."""
    device = resolve_device(device)
    generator = next_key(generator)
    if room_irs is None:
        room_irs = WGN_reverb((n_mics, n_loudspeakers), t60=t60,
                              samplerate=fs, generator=generator,
                              device=device)[:rir_length]
    room_irs = torch.as_tensor(room_irs, dtype=torch.float32, device=device)
    room = dsp.Filter(size=tuple(room_irs.shape), nfft=nfft,
                      requires_grad=False, alias_decay_db=alias_decay_db,
                      generator=generator, device=device)
    room.assign_value(room_irs)
    if cache_room:
        room = dsp.CachedResponse(room)
    mixer = dsp.Filter(size=(fir_order, n_loudspeakers, n_mics), nfft=nfft,
                       requires_grad=True, alias_decay_db=alias_decay_db,
                       generator=generator, device=device)
    with torch.no_grad():
        mixer.param.mul_(0.01)
    loop = system.Recursion(fF=room, fB=mixer, solve_method=solve_method)
    return system.Shell(core=loop, input_layer=dsp.FFT(nfft))


def open_loop_matrix(model: system.Shell, subsample: int = 32):
    """Open-loop matrix mixer(room) per bin, every ``subsample``-th bin:
    (ceil(M / subsample), n_loudspeakers, n_loudspeakers)."""
    loop = model.get_core()
    room, mixer = loop.feedforward, loop.feedback
    rR = room.matrix_response()
    rM = mixer.matrix_response()
    kind, G = linop.compose(rM[0], rM[1], rR[0], rR[1])
    Gm = linop.materialize(kind, G, room.M, mixer.output_channels,
                           room.input_channels)
    return Gm[::subsample]


def open_loop_eigenvalues(model: system.Shell, subsample: int = 32):
    """Eigenvalues of the open-loop matrix over a bin subsample, for
    analysis (no gradient)."""
    return get_eigenvalues(open_loop_matrix(model, subsample))


def gain_before_instability(model: system.Shell, subsample: int = 32):
    """GBI in dB: how much broadband gain fits before |eig| reaches 1."""
    evs = open_loop_eigenvalues(model, subsample)
    return -20 * torch.log10(torch.max(torch.abs(evs)))


def gain_before_instability_diff(model: system.Shell, subsample: int = 32,
                                 iters: int = 64):
    """Differentiable GBI in dB from the power-iteration spectral radius
    (usable as a stability regularizer)."""
    rho = spectral_radius(open_loop_matrix(model, subsample), iters=iters)
    return -20 * torch.log10(torch.max(rho))


class ActiveAcoustics:
    """The full active-acoustics system (the reference's class ``AA``):
    the physical room (H_SM, H_SA, H_LM, H_LA filter matrices, measured or
    synthetic WGN reverb), the virtual room (trainable FIR matrix ``U``,
    fixed WGN-reverb tail ``R``, general gain ``G``), and the loop shell
    ``F_MM`` whose forward on diag-embedded unit impulses gives the loop
    matrix per bin.

    The general gain G starts at the gain before instability, as in the
    reference; ``gain`` (linear) sets it instead and skips that
    analysis (an eigenvalue solve at every bin, ~17 s at nfft = 96000 on
    the H100), for a rig whose GBI is already known.

    ``F_MM`` shares ``U``, ``R`` and ``G`` with this object, so a setter
    or a training step that changes them in place changes the loop; the
    frozen rooms enter as their cached responses (``cache_room=True``),
    computed once per room module."""

    _ROOMS = ("H_SM", "H_SA", "H_LM", "H_LA")

    def __init__(self, n_S: int, n_M: int, n_L: int, n_A: int,
                 fs: int = 48000, nfft: int = 2 ** 11, FIR_order: int = 100,
                 wgn_RT: float = 1.0, alias_decay_db: float = 0.0,
                 room_irs: dict | None = None, rir_length: int | None = None,
                 room_t60: float = 0.5, cache_room: bool = True,
                 solve_method: str = "ge", dtype: torch.dtype = torch.float32,
                 generator=None, device=None, gain=None):
        self.fs, self.nfft = fs, nfft
        self.n_S, self.n_M, self.n_L, self.n_A = n_S, n_M, n_L, n_A
        self.alias_decay_db = alias_decay_db
        self.cache_room = cache_room
        self.solve_method = solve_method
        self.dtype = dtype
        self.device = resolve_device(device)
        generator = next_key(generator)
        common = dict(nfft=nfft, alias_decay_db=alias_decay_db, dtype=dtype,
                      generator=generator, device=self.device)

        if room_irs is None:
            room_irs = {}
            for name, shape in (("H_SM", (n_M, n_S)), ("H_SA", (n_A, n_S)),
                                ("H_LM", (n_M, n_L)), ("H_LA", (n_A, n_L))):
                ir = WGN_reverb(shape, t60=room_t60, samplerate=fs,
                                generator=generator, dtype=dtype,
                                device=self.device)
                room_irs[name] = ir[:rir_length] if rir_length else ir
        for name in self._ROOMS:
            ir = torch.as_tensor(room_irs[name], dtype=dtype,
                                 device=self.device)
            f = dsp.Filter(size=tuple(ir.shape), requires_grad=False,
                           **common)
            setattr(self, name, f.assign_value(ir))

        self.G = dsp.parallelGain(size=(n_L,), **common).assign_value(
            torch.ones(n_L, dtype=dtype))
        self.U = dsp.Filter(size=(FIR_order, n_L, n_M), requires_grad=True,
                            **common)
        wgn = WGN_reverb((n_L,), t60=wgn_RT, samplerate=fs,
                         generator=generator, dtype=dtype, device=self.device)
        self.R = dsp.parallelFilter(size=tuple(wgn.shape),
                                    **common).assign_value(wgn)
        self._cached = {}
        self._rebuild_F_MM()
        if gain is None:
            self.set_G_to_GBI()
        else:
            self.set_G(gain)

    # ------------------------------------------------------------------
    def _room(self, name: str):
        """The room module ``name``, as its cached response when
        ``cache_room``; computed again only for another module object or
        after :meth:`refresh_rooms`."""
        module = getattr(self, name)
        if not self.cache_room:
            return module
        entry = self._cached.get(name)
        if entry is None or entry[0] is not module:
            entry = (module, dsp.CachedResponse(module))
            self._cached[name] = entry
        return entry[1]

    def refresh_rooms(self) -> None:
        """Recompute the cached room responses (after the rooms' IRs were
        written in place) and rebuild ``F_MM``."""
        self._cached = {}
        self._rebuild_F_MM()

    def _rebuild_F_MM(self):
        core = system.Series(OrderedDict(
            [("U", self.U), ("R", self.R), ("G", self.G),
             ("H_LM", self._room("H_LM"))]))
        eye = torch.eye(self.n_M, dtype=self.dtype, device=self.device)
        diag_embed = dsp.Transform(lambda x: x[..., None] * eye,
                                   dtype=self.dtype)
        with warnings.catch_warnings():
            # the Transform + FFT input Series carries no alias_decay_db
            warnings.simplefilter("ignore")
            self.F_MM = system.Shell(
                core=core,
                input_layer=system.Series(
                    diag_embed, dsp.FFT(self.nfft, dtype=self.dtype)))

    def __call__(self, x):
        """The loop on unit impulses (B, T, n_M): diag-embedded, they give
        the loop matrix per bin, (B, M, n_M, n_M)."""
        return self.F_MM(x)

    forward = __call__

    # -- general gain ---------------------------------------------------
    def get_G(self):
        return self.G

    def set_G(self, g) -> None:
        """Set the general gain (linear) of every loudspeaker, in place."""
        g = torch.as_tensor(g, dtype=self.dtype, device=self.device)
        self.G.assign_value(g * torch.ones(self.n_L, dtype=self.dtype,
                                           device=self.device))

    def get_current_GBI(self):
        """Gain before instability (linear), always with respect to G = 1;
        the current gain is restored."""
        g_current = self.G.param[0].detach().clone()
        self.set_G(1.0)
        max_ev = torch.max(torch.abs(self.get_F_MM_eigenvalues()))
        self.set_G(g_current)
        return 1.0 / max_ev

    def set_G_to_GBI(self) -> None:
        self.set_G(self.get_current_GBI())

    # -- virtual room ----------------------------------------------------
    def normalize_U(self, value: float = 1.0) -> None:
        """Scale U's IRs to Frobenius norm ``value``, in place."""
        p = self.U.param.detach()
        self.U.assign_value(p / torch.sqrt(torch.sum(p ** 2)) * value)

    # -- feedback-loop matrix -------------------------------------------
    def get_F_MM_eigenvalues(self):
        """Eigenvalues of the loop matrix at every bin, (1, M, n_M), by
        ``torch.linalg.eigvals``, without a gradient."""
        H = self.F_MM.get_freq_response(fs=self.fs, identity=True)
        return get_eigenvalues(H)

    # -- full system -----------------------------------------------------
    def _create_system(self):
        processor = system.Series(OrderedDict(
            [("U", self.U), ("R", self.R), ("G", self.G)]))
        feedback_loop = system.Recursion(fF=processor,
                                         fB=self._room("H_LM"),
                                         solve_method=self.solve_method)
        ea_path = system.Shell(
            core=system.Series(OrderedDict(
                [("H_SM", self._room("H_SM")),
                 ("FeedbackLoop", feedback_loop),
                 ("H_LA", self._room("H_LA"))])),
            input_layer=dsp.FFT(self.nfft, dtype=self.dtype),
            output_layer=dsp.iFFT(self.nfft, dtype=self.dtype))
        nat_path = system.Shell(
            core=self._room("H_SA"),
            input_layer=dsp.FFT(self.nfft, dtype=self.dtype),
            output_layer=dsp.iFFT(self.nfft, dtype=self.dtype))
        return nat_path, ea_path

    def system_simulation(self):
        """Full-system impulse response: natural + electroacoustic paths,
        (1, nfft, n_A)."""
        nat_path, ea_path = self._create_system()
        return (nat_path.get_time_response(fs=self.fs)
                + ea_path.get_time_response(fs=self.fs))

    # -- training interop -------------------------------------------------
    def adopt(self, trained_shell: system.Shell) -> None:
        """Take the modules of a trained ``F_MM``-shaped shell (its U, R,
        G and, when it is a plain Filter, H_LM) and rebuild ``F_MM``."""
        core = trained_shell.get_core()
        self.U, self.R, self.G = core["U"], core["R"], core["G"]
        if isinstance(core["H_LM"], dsp.Filter):
            self.H_LM = core["H_LM"]
        self._rebuild_F_MM()


# ---------------------------------------------------------------------------
# magnitude-MSE trainers
# ---------------------------------------------------------------------------
def _adam_step(opt, loss_fn):
    """One Adam step of ``loss_fn()``; returns the loss before it."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


def aa_hoisted_room_step(model: system.Shell, inputs, targets,
                         lr: float = 1e-3):
    """Build ``(step, optimizer)`` for the magnitude-MSE objective
    ``mean((|Shell(FFT -> Recursion(room, mixer))(x)| - t)^2)`` through
    the module graph, with the frozen room's response and the input
    spectrum computed once, here, instead of in every step.  ``step()``
    takes one Adam step in place and returns the loss before it."""
    opt = masked_optimizer(model, lr=lr)
    loop = model.get_core()
    room = loop.feedforward
    if not isinstance(room, dsp.CachedResponse):
        room = dsp.CachedResponse(room)
    hoisted = system.Recursion(fF=room, fB=loop.feedback,
                               solve_method=loop.solve_method)
    X = torch.fft.rfft(inputs, n=model.nfft, dim=1)
    return (lambda: _adam_step(opt, lambda: torch.mean(
        (torch.abs(hoisted(X)) - targets) ** 2))), opt


def aa_dft_basis(order: int, nfft: int):
    """The (order, M) rfft-grid DFT basis ``E[t, m] = e^{-j 2 pi t m /
    nfft}`` as a float32 numpy pair (er, ei), from float64 phases: the
    tap->response map ``G[c, m] = sum_t taps[t, c] E[t, m]`` is then one
    matmul (``rfft(pad(taps))`` of ``order`` nonzero taps)."""
    M = nfft // 2 + 1
    t = np.arange(order, dtype=np.float64)[:, None]
    m = np.arange(M, dtype=np.float64)[None, :]
    ph = -2.0 * np.pi * t * m / nfft
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


def _mixer_taps(fb):
    """The mixer's envelope-folded taps ``tw`` (order, L N),
    ``tw[t, j N + k] = gamma^t taps[t, j, k]``."""
    taps = fb.ir(fb.param)
    order = taps.shape[0]
    env = torch.tensor(fb.gamma, dtype=taps.dtype, device=taps.device) ** \
        torch.arange(order, dtype=taps.dtype, device=taps.device)
    return (taps * env[:, None, None]).reshape(order, -1)


def aa_fused_operands(model: system.Shell, inputs, targets) -> dict:
    """The frozen per-bin rows of the fused steps, computed once: the room
    response rows ``hr``/``hi`` (N L, M), the rhs ``r = H X`` as
    ``rr``/``ri`` (N, M) and the targets ``t`` (N, M), with the sizes
    ``N``, ``L`` and ``nfft``.  Batch size 1 only (the AA topology)."""
    if inputs.shape[0] != 1 or targets.shape[0] != 1:
        raise ValueError("the fused active-acoustics steps take batch size 1")
    loop = model.get_core()
    order, L, N = loop.feedback.param.shape
    nfft = model.nfft
    M = nfft // 2 + 1
    with torch.no_grad():
        kind, Hraw = loop.feedforward.matrix_response()
        H = linop.materialize(kind, Hraw, M, N, L)  # (M, N, L)
        X = torch.fft.rfft(inputs, n=nfft, dim=1)[0]  # (M, L)
        hrows = H.permute(1, 2, 0).reshape(N * L, M)
        rhs = torch.einsum("mil,ml->im", H, X.to(H.dtype))
    return dict(hr=torch.real(hrows).contiguous(),
                hi=torch.imag(hrows).contiguous(),
                rr=torch.real(rhs).contiguous(),
                ri=torch.imag(rhs).contiguous(),
                t=targets[0].T.contiguous(), N=N, L=L, nfft=nfft)


def aa_fused_taps_step(model: system.Shell, inputs, targets,
                       lr: float = 1e-3, pivot: bool = False,
                       precision: str = "high"):
    """Build ``(step, optimizer)`` for the magnitude-MSE objective on
    kernel K9 (:func:`~flamo_tpu_torch.ops.aa_kernels.aa_taps_tf_mse`):
    per step, the mixer's envelope-folded taps go into one kernel launch
    that makes the DFT powers, the mixer response, the loop solve, the
    loss and the tap cotangent; PyTorch adds the parameter map and Adam.
    The frozen rows are :func:`aa_fused_operands`.  ``step()`` takes one
    Adam step in place and returns the loss before it; the loss is the
    module graph's."""
    opt = masked_optimizer(model, lr=lr)
    o = aa_fused_operands(model, inputs, targets)
    fb = model.get_core().feedback
    return (lambda: _adam_step(opt, lambda: aa_taps_tf_mse(
        o["hr"], o["hi"], _mixer_taps(fb), o["rr"], o["ri"], o["t"],
        N=o["N"], L=o["L"], nfft=o["nfft"], pivot=pivot,
        precision=precision))), opt


def aa_fused_step(model: system.Shell, inputs, targets, lr: float = 1e-3,
                  pivot: bool = False):
    """Build ``(step, optimizer)`` for the magnitude-MSE objective on
    kernel K8 (:func:`~flamo_tpu_torch.ops.aa_kernels.aa_tf_mse`): per
    step the mixer's response rows are two float32 matmuls of its taps
    against the (order, M) DFT basis (:func:`aa_dft_basis`, kept on the
    device), and the loop solve, the loss and the response cotangent are
    one kernel launch.  ``step()`` as in :func:`aa_fused_taps_step`."""
    opt = masked_optimizer(model, lr=lr)
    o = aa_fused_operands(model, inputs, targets)
    fb = model.get_core().feedback
    dev = fb.param.device
    er, ei = (torch.from_numpy(b).to(dev)
              for b in aa_dft_basis(fb.param.shape[0], o["nfft"]))

    def loss_fn():
        tw = _mixer_taps(fb)
        return aa_tf_mse(o["hr"], o["hi"], tw.T @ er, tw.T @ ei, o["rr"],
                         o["ri"], o["t"], N=o["N"], L=o["L"], pivot=pivot)

    return (lambda: _adam_step(opt, loss_fn)), opt


# ---------------------------------------------------------------------------
# eigenvalue-MSE trainer
# ---------------------------------------------------------------------------
def _charpoly_rows(ar, ai, N: int):
    """Faddeev-LeVerrier characteristic-polynomial coefficients on rows:
    real matrix entries ``ar``/``ai`` (N, N, B), the bin axis last ->
    coefficient rows ``(cr, ci)`` (N, B) of
    ``p(z) = z^N + c[0] z^{N-1} + ... + c[N-1]``; the products are explicit
    multiply-reduces, full float32."""
    eyeb = torch.eye(N, dtype=ar.dtype, device=ar.device)[..., None]

    def tr(mr, mi):
        return (mr * eyeb).sum((0, 1)), (mi * eyeb).sum((0, 1))

    def matmul(xr, xi):
        # (A @ X)[i, j, b] = sum_l A[i, l, b] X[l, j, b]
        rr = (ar[:, :, None, :] * xr[None] - ai[:, :, None, :] * xi[None]
              ).sum(dim=1)
        ri = (ar[:, :, None, :] * xi[None] + ai[:, :, None, :] * xr[None]
              ).sum(dim=1)
        return rr, ri

    mkr, mki = ar, ai
    tr_r, tr_i = tr(mkr, mki)
    cr, ci = -tr_r, -tr_i
    crows, cirows = [cr], [ci]
    for k in range(2, N + 1):
        mkr, mki = matmul(mkr + eyeb * cr, mki + eyeb * ci)
        tr_r, tr_i = tr(mkr, mki)
        cr, ci = -tr_r / k, -tr_i / k
        crows.append(cr)
        cirows.append(ci)
    return torch.stack(crows), torch.stack(cirows)


def _sort_rows(x):
    """Ascending sort of an (N, B) array along axis 0 by odd-even
    transposition (N passes of min/max row swaps), as the JAX package
    sorts: its gradient routes through the same min/max selections."""
    N = x.shape[0]
    rows = [x[i] for i in range(N)]
    for p in range(N):
        for i in range(p % 2, N - 1, 2):
            lo = torch.minimum(rows[i], rows[i + 1])
            hi = torch.maximum(rows[i], rows[i + 1])
            rows[i], rows[i + 1] = lo, hi
    return torch.stack(rows)


def aa_evs_train_step(aa: ActiveAcoustics, target_evs, lr: float = 1e-3,
                      iter_num: int = 30, masks=None, generator=None):
    """Build ``(step, optimizer)`` for the eigenvalue-magnitude MSE over
    cycling bin partitions of the loop matrix (``optimize.mse_evs``
    semantics; the trainee is ``U``).

    Per step the partition's loop matrices
    ``F = H_LM diag(R G) U`` are composed on rows (bins last) from the
    frozen ``H_LM diag(R G)`` rows and ``U``'s response at those bins (a
    float32 matmul of its taps against the partition's DFT basis),
    centred and scaled, turned into characteristic polynomials
    (:func:`_charpoly_rows`), and solved by
    :func:`~flamo_tpu_torch.functional.poly_roots_rows`: one launch of
    kernel K7 per step on the card.  The loss is
    ``mean((sort |eig| - sort target)^2)`` over the partition.

    ``target_evs`` (M, n_M).  ``masks`` (n_parts, n_samples) bin indices
    (e.g. an ``mse_evs`` criterion's ``mask_indices``, or the JAX
    package's, so that both walk the same partitions); by default
    ``generate_partitions`` draws them from ``generator`` with
    ``ceil(M / iter_num)`` bins each.  ``step(i)`` takes one Adam step in
    place at global step ``i`` (partition ``i % n_parts``) and returns the
    loss before it."""
    model = aa.F_MM
    core = model.get_core()
    U = core["U"]
    nfft = model.nfft
    M = nfft // 2 + 1
    order, n_L, n_M = U.param.shape
    dev = U.param.device
    if masks is None:
        masks = generate_partitions(torch.arange(M), math.ceil(M / iter_num),
                                    1, generator=generator)
    masks = torch.as_tensor(masks).cpu().to(torch.int64)
    n_parts, n_samples = masks.shape
    perm = masks.reshape(-1)
    opt = masked_optimizer(model, lr=lr)
    er, ei = (torch.from_numpy(b[:, perm.numpy()]).to(dev)
              for b in aa_dft_basis(order, nfft))
    perm = perm.to(dev)
    with torch.no_grad():
        kH, H = core["H_LM"].matrix_response()
        H = linop.materialize(kH, H, M, n_M, n_L)  # (M, n_M, n_L)
        kR, R = core["R"].matrix_response()
        kG, G = core["G"].matrix_response()
        if kR != linop.DIAG or kG != linop.DIAG:
            raise ValueError("R and G must be diagonal (parallel) modules")
        rg = torch.broadcast_to(R * G, (M, n_L))
        Hrg = (H * rg[:, None, :]).permute(1, 2, 0).reshape(
            n_M * n_L, M)[:, perm]
        hr_all = torch.real(Hrg).contiguous()
        hi_all = torch.imag(Hrg).contiguous()
        tg = torch.as_tensor(target_evs, dtype=torch.float32, device=dev)
        tg_all = torch.sort(tg, dim=-1).values.T[:, perm]  # (n_M, parts)
    eyeb = torch.eye(n_M, dtype=torch.float32, device=dev)[..., None]

    def step_loss(i: int):
        win = slice((i % n_parts) * n_samples,
                    (i % n_parts + 1) * n_samples)
        hr = hr_all[:, win].reshape(n_M, 1, n_L, n_samples)
        hi = hi_all[:, win].reshape(n_M, 1, n_L, n_samples)
        taps = _mixer_taps(U)  # (order, n_L n_M)
        ur = taps.T @ er[:, win]
        ui = taps.T @ ei[:, win]
        # fm[i, j, b] = sum_l Hrg[i, l, b] U[l, j, b]
        urt = ur.reshape(n_L, n_M, n_samples).permute(1, 0, 2)[None]
        uit = ui.reshape(n_L, n_M, n_samples).permute(1, 0, 2)[None]
        fr = (hr * urt - hi * uit).sum(dim=2)  # (i, j, b)
        fi = (hr * uit + hi * urt).sum(dim=2)
        # spectrum-centre and scale (eigvals_dk semantics)
        mur = (fr * eyeb).sum((0, 1)) / n_M
        mui = (fi * eyeb).sum((0, 1)) / n_M
        br = fr - eyeb * mur
        bi = fi - eyeb * mui
        s = torch.clamp(torch.sqrt((br * br + bi * bi).sum((0, 1)) / n_M),
                        min=1e-30)
        cr, ci = _charpoly_rows(br / s, bi / s, n_M)
        zr, zi = poly_roots_rows(cr, ci)
        evr = zr * s + mur
        evi = zi * s + mui
        mag = _sort_rows(torch.sqrt(evr * evr + evi * evi))
        return torch.mean((mag - tg_all[:, win]) ** 2)

    return (lambda i: _adam_step(opt, lambda: step_loss(int(i)))), opt


def aa_evs_fit(aa: ActiveAcoustics, target_evs, n_steps: int,
               lr: float = 1e-3, iter_num: int = 30, masks=None,
               steps_per_call: int = 400, generator=None):
    """Run :func:`aa_evs_train_step` for ``n_steps`` steps from global
    step 0 and return ``(aa.F_MM, per-step loss history as numpy)``; U is
    trained in place, so ``aa`` holds the result.  The steps run in chunks
    of ``steps_per_call``, the JAX package's ``lax.scan`` length: a
    chunk's losses reach the host once, at its end, and exactly
    ``n_steps`` steps run.  ``steps_per_call`` changes only how often the
    host syncs, not the result."""
    step, _ = aa_evs_train_step(aa, target_evs, lr=lr, iter_num=iter_num,
                                masks=masks, generator=generator)
    return aa.F_MM, run_in_chunks(step, n_steps, steps_per_call)
