"""The port's active-acoustics path, its eigenvalue solvers and the kernels
K7 (Durand-Kerner roots), K8 and K9 (fused AA steps), held against
flamo_tpu on the CPU.

The port runs each kernel's plain version, which is what its wrapper takes
for CPU tensors.  They are held against JAX's Pallas kernels run eagerly
through the interpreter (TILE = 256, as tests/test_ops.py does: seconds
per call at these sizes, where a jit of them takes minutes), against the
dense formula and against JAX's module graph, with the JAX tests' bounds:
roots 1e-4 (tests/test_ops.py:950), K8's loss 1e-5 and gradients 5e-3 of
the max (:826-871), K9's loss and tap gradient 1e-5 (:1019-1024), the
fused-step lockstep 1e-4 on the first loss and 1e-3 after three Adam steps
(:904), the eigenvalue step 1e-4 (tests/test_models.py:188).

The JAX models are built once per module (their construction compiles):
the magnitude rig with ``flamo_tpu.set_seed(130297)`` and the eigenvalue
rig with ``set_seed(42)``, at nfft = 512, 2 microphones and 3
loudspeakers.  The port draws rooms, noise and partitions from another
PRNG, so the tests copy JAX's weights with ``convert.load_jax_params`` and
hand JAX's partitions to the port.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flamo_tpu
from flamo_tpu import functional as JF
from flamo_tpu.core import masked_optimizer as jax_masked_optimizer
from flamo_tpu.models import ActiveAcoustics as JaxActiveAcoustics
from flamo_tpu.models import build_active_acoustics as jax_build_aa
from flamo_tpu.models import active_acoustics as jaa
from flamo_tpu.optimize.loss import mse_evs as jax_mse_evs
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch import functional as F
from flamo_tpu_torch.convert import (AA_MODULES, jax_named_tensors,
                                     load_jax_params)
from flamo_tpu_torch.models import (ActiveAcoustics, aa_evs_fit,
                                    aa_evs_train_step, aa_fused_operands,
                                    aa_fused_step,
                                    aa_fused_taps_step, aa_hoisted_room_step,
                                    build_active_acoustics,
                                    gain_before_instability,
                                    gain_before_instability_diff,
                                    open_loop_matrix)
from flamo_tpu_torch.models.active_acoustics import _mixer_taps
from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import eig_kernels as ek
from flamo_tpu_torch.optimize import mse_evs
from flamo_tpu_torch.processor import dsp

NFFT = 512
M = NFFT // 2 + 1


def _keyed(tree, prefix: str = "") -> dict:
    return {prefix + jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def interp():
    """flamo_tpu's Pallas kernels K7-K9 through the interpreter, TILE=256."""
    import flamo_tpu.ops.pallas_eig as pallas_eig
    import flamo_tpu.ops.pallas_solve as pallas_solve
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        for mod in (pallas_solve, pallas_eig):
            mp.setattr(mod.pl, "pallas_call",
                       partial(pl.pallas_call, interpret=True))
            mp.setattr(mod, "TILE", 256)
        yield pallas_solve, pallas_eig


# ---------------------------------------------------------------------------
# K7 and the eigenvalue solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [2, 4, 6])
def test_dk_roots_match_jax_scan_and_kernel(interp, N):
    """K7's plain version runs JAX's Durand-Kerner iteration: its roots
    equal JAX's scan and JAX's kernel (interpreted) to 1e-4, in the rows
    and in the complex layout, and match numpy's root sets."""
    _, pe = interp
    rng = np.random.default_rng(7)
    B = 300
    c = (rng.normal(size=(B, N)) + 1j * rng.normal(size=(B, N))).astype(
        np.complex64)
    z_scan = np.asarray(JF._dk_iterate(jnp.asarray(c), 96))
    z_port = ek.dk_roots(torch.tensor(c)).numpy()
    assert z_port.shape == (B, N)
    assert float(np.abs(z_port - z_scan).max()) < 1e-4
    z_kernel = np.asarray(pe.pallas_dk_roots(jnp.asarray(c), iters=96))
    assert float(np.abs(z_port - z_kernel).max()) < 1e-4
    zr, zi = ek.dk_roots_rows(_t(c.real.T), _t(c.imag.T))
    np.testing.assert_array_equal(zr.numpy() + 1j * zi.numpy(), z_port.T)
    for i in range(5):
        zn = np.sort_complex(np.roots(np.concatenate(([1.0], c[i]))))
        assert float(np.abs(np.sort_complex(z_port[i]) - zn).max()) < 5e-3


def test_poly_roots_values_and_gradients_match_jax():
    """poly_roots (complex) and poly_roots_rows (rows) against JAX's
    values and implicit-function pullbacks; PyTorch's complex gradient is
    the conjugate of JAX's cotangent.  complex128 / float64 run the plain
    iteration in float64 (the dtype rule)."""
    rng = np.random.default_rng(11)
    B, N = 40, 4
    c = (rng.normal(size=(B, N)) + 1j * rng.normal(size=(B, N))).astype(
        np.complex64)
    w = (rng.normal(size=(B, N)) + 1j * rng.normal(size=(B, N))).astype(
        np.complex64)

    def jloss(c):
        z = JF.poly_roots(c)
        return jnp.sum(jnp.real(z * w)) + jnp.sum(jnp.abs(z) ** 2)

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(c))
    ct = torch.tensor(c, requires_grad=True)
    z = F.poly_roots(ct)
    val = torch.sum(torch.real(z * torch.tensor(w))) + torch.sum(
        torch.abs(z) ** 2)
    val.backward()
    assert abs(float(val.detach()) - float(jval)) / abs(float(jval)) < 1e-4
    assert _rel(ct.grad.numpy(), np.conj(np.asarray(jgrad))) < 1e-3

    cr, ci = c.real.T.copy(), c.imag.T.copy()
    wr, wi = rng.normal(size=(2, N, B)).astype(np.float32)

    def jrows(cr, ci):
        zr, zi = JF.poly_roots_rows(cr, ci)
        return jnp.sum(zr * wr + zi * wi)

    jv, (gcr, gci) = jax.jit(jax.value_and_grad(jrows, argnums=(0, 1)))(
        jnp.asarray(cr), jnp.asarray(ci))
    tcr, tci = (torch.tensor(x, requires_grad=True) for x in (cr, ci))
    zr, zi = F.poly_roots_rows(tcr, tci)
    v = torch.sum(zr * torch.tensor(wr) + zi * torch.tensor(wi))
    v.backward()
    assert abs(float(v) - float(jv)) < 1e-3
    assert _rel(tcr.grad.numpy(), gcr) < 1e-3
    assert _rel(tci.grad.numpy(), gci) < 1e-3

    z64 = F.poly_roots(torch.tensor(c.astype(np.complex128)))
    assert z64.dtype == torch.complex128
    assert float(np.abs(z64.numpy() - z.detach().numpy()).max()) < 1e-4
    zr64, _ = F.poly_roots_rows(torch.tensor(cr, dtype=torch.float64),
                                torch.tensor(ci, dtype=torch.float64))
    assert zr64.dtype == torch.float64


def test_charpoly_eigvals_and_spectral_radius_match_jax():
    """charpoly, eigvals_dk (values and gradient), eigvals,
    get_eigenvalues and spectral_radius against flamo_tpu; eigenvalues
    compared as sorted sets."""
    rng = np.random.default_rng(5)
    A = (rng.normal(size=(30, 4, 4)) + 1j * rng.normal(size=(30, 4, 4))
         ).astype(np.complex64) / 2
    assert _rel(F.charpoly(torch.tensor(A)).numpy(),
                JF.charpoly(jnp.asarray(A))) < 1e-5

    def srt(z):
        return np.sort_complex(np.asarray(z).reshape(-1, 4))

    ev_dk = F.eigvals_dk(torch.tensor(A))
    assert float(np.abs(srt(ev_dk) - srt(jax.jit(JF.eigvals_dk)(
        jnp.asarray(A)))).max()) < 1e-4
    ev = F.eigvals(torch.tensor(A))
    assert float(np.abs(srt(ev) - srt(JF.eigvals(jnp.asarray(A)))).max()) \
        < 1e-4
    assert float(np.abs(srt(F.get_eigenvalues(torch.tensor(A)))
                        - srt(ev.numpy())).max()) < 1e-6

    def jl(A):
        return jnp.sum(jnp.abs(JF.eigvals_dk(A)) ** 2)

    jg = jax.jit(jax.grad(jl))(jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    torch.sum(torch.abs(F.eigvals_dk(At)) ** 2).backward()
    assert _rel(At.grad.numpy(), np.conj(np.asarray(jg))) < 1e-3
    # the LAPACK route's gradient agrees with the Durand-Kerner one
    At2 = torch.tensor(A, requires_grad=True)
    torch.sum(torch.abs(F.eigvals(At2)) ** 2).backward()
    assert _rel(At2.grad.numpy(), At.grad.numpy()) < 1e-3

    Ar = rng.normal(size=(20, 5, 5)).astype(np.float32)
    rho = F.spectral_radius(torch.tensor(Ar)).numpy()
    assert _rel(rho, jax.jit(JF.spectral_radius)(jnp.asarray(Ar))) < 1e-4


def test_filters_and_wgn_reverb_match_jax():
    """bandpass_filter and sosfreqz against flamo_tpu; WGN_reverb's shape,
    unit column norms and decay (its noise is another PRNG's)."""
    args = (np.array([20.0, 100.0]), np.array([20000.0, 8000.0]),
            np.array([1.0, -3.0]))
    b, a = F.bandpass_filter(*(torch.tensor(x) for x in args))
    jb, ja = JF.bandpass_filter(*(jnp.asarray(x) for x in args))
    assert _rel(b.numpy(), jb) < 1e-5 and _rel(a.numpy(), ja) < 1e-5
    sos = np.concatenate([np.asarray(jb)[:, :1].T, np.asarray(ja)[:, :1].T],
                         axis=1)
    assert _rel(F.sosfreqz(torch.tensor(sos), 1024).numpy(),
                JF.sosfreqz(jnp.asarray(sos), 1024)) < 1e-4
    g = torch.Generator().manual_seed(3)
    ir = F.WGN_reverb((2, 3), t60=0.1, samplerate=16000, generator=g,
                      device="cpu")
    assert ir.shape == (2400, 2, 3)
    np.testing.assert_allclose(torch.linalg.vector_norm(ir, dim=0).numpy(),
                               1.0, rtol=1e-5)
    head = torch.sum(ir[:600] ** 2, dim=0)
    tail = torch.sum(ir[-600:] ** 2, dim=0)
    assert bool(torch.all(head > 100 * tail))


def test_parallel_filter_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(40, 3)).astype(np.float32)
    jf = jdsp.parallelFilter(size=(40, 3), nfft=NFFT,
                             alias_decay_db=20.0).assign_value(jnp.asarray(p))
    f = dsp.parallelFilter(size=(40, 3), nfft=NFFT, alias_decay_db=20.0,
                           device="cpu").assign_value(torch.tensor(p))
    assert f.matrix_response()[0] == "diag"
    assert _rel(f.response().numpy(), jf.response()) < 1e-5
    x = (rng.normal(size=(2, M, 3)) + 1j * rng.normal(size=(2, M, 3))
         ).astype(np.complex64)
    assert _rel(f(torch.tensor(x)).detach().numpy(), jf(jnp.asarray(x))) \
        < 1e-5
    with pytest.raises(AssertionError, match="Filter must be 1D"):
        dsp.parallelFilter(size=(4, 3, 3), device="cpu")


# ---------------------------------------------------------------------------
# K8 and K9
# ---------------------------------------------------------------------------
def _aa_rows(seed: int, N: int, L: int, Mb: int):
    rng = np.random.default_rng(seed)
    H = (rng.normal(size=(Mb, N, L)) + 1j * rng.normal(size=(Mb, N, L))
         ).astype(np.complex64)
    G = (0.05 * (rng.normal(size=(Mb, L, N)) + 1j * rng.normal(
        size=(Mb, L, N)))).astype(np.complex64)
    X = (rng.normal(size=(Mb, L)) + 1j * rng.normal(size=(Mb, L))).astype(
        np.complex64)
    t = rng.uniform(size=(Mb, N)).astype(np.float32)
    hrows = H.transpose(1, 2, 0).reshape(N * L, Mb)
    grows = G.transpose(1, 2, 0).reshape(L * N, Mb)
    rhs = np.einsum("mil,ml->im", H, X)
    return dict(H=H, G=G, X=X, tt=t, hr=hrows.real.copy(),
                hi=hrows.imag.copy(), gr=grows.real.copy(),
                gi=grows.imag.copy(), rr=rhs.real.copy(),
                ri=rhs.imag.copy(), t=t.T.copy())


@pytest.mark.parametrize("pivot", [True, False])
def test_aa_tf_mse_matches_dense_formula_and_jax(interp, pivot):
    """K8's plain version: its loss and response-row gradient against the
    dense formula under JAX autodiff (loss 1e-5, gradients 5e-3 of the
    max), M = 301 bins, and without pivoting against JAX's kernel
    (interpreted; its pivoted variant takes a minute there)."""
    ps, _ = interp
    N, L, Mb = 3, 5, 301
    o = _aa_rows(47, N, L, Mb)

    def loss_ref(gr, gi):
        Gc = (gr + 1j * gi).reshape(L, N, Mb).transpose(2, 0, 1)
        A = jnp.eye(N, dtype=jnp.complex64)[None] - jnp.einsum(
            "mil,mlk->mik", o["H"], Gc)
        y = jnp.linalg.solve(A, jnp.asarray(o["rr"] + 1j * o["ri"]).T[
            ..., None])[..., 0]
        return jnp.mean((jnp.abs(y) - o["tt"]) ** 2)

    lr, gref = jax.jit(jax.value_and_grad(loss_ref, argnums=(0, 1)))(
        o["gr"], o["gi"])
    rows = [_t(o[k]) for k in ("hr", "hi")]
    gr, gi = (_t(o[k]).requires_grad_() for k in ("gr", "gi"))
    loss = ak.aa_tf_mse(*rows, gr, gi, *[_t(o[k]) for k in ("rr", "ri", "t")],
                        N=N, L=L, pivot=pivot)
    loss.backward()
    assert abs(float(loss) - float(lr)) / float(lr) < 1e-5
    for got, ref in ((gr.grad, gref[0]), (gi.grad, gref[1])):
        assert _rel(got.numpy(), ref) < 5e-3

    if pivot:
        return
    jl, jg = jax.value_and_grad(
        lambda gr, gi: ps.pallas_aa_tf_mse(
            o["hr"], o["hi"], gr, gi, o["rr"], o["ri"], o["t"], N=N, L=L,
            pivot=False), argnums=(0, 1))(o["gr"], o["gi"])
    assert abs(float(loss) - float(jl)) / float(jl) < 1e-5
    assert _rel(gr.grad.numpy(), jg[0]) < 1e-4
    assert _rel(gi.grad.numpy(), jg[1]) < 1e-4


@pytest.fixture(scope="module")
def mag_rig():
    """The JAX magnitude rig (cached room) and its port, same weights."""
    flamo_tpu.set_seed(130297)
    jm = jax_build_aa(n_mics=2, n_loudspeakers=3, rir_length=200,
                      fir_order=16, nfft=NFFT, fs=48000, t60=0.2,
                      solve_method="ge_cached")
    pm = build_active_acoustics(n_mics=2, n_loudspeakers=3, rir_length=200,
                                fir_order=16, nfft=NFFT, t60=0.2,
                                solve_method="ge_cached", device="cpu",
                                generator=torch.Generator().manual_seed(0))
    load_jax_params(pm, _keyed(jm))
    x = np.zeros((1, NFFT, 3), np.float32)
    x[:, 0, :] = 1.0
    t = np.ones((1, M, 2), np.float32)
    return jm, pm, x, t


# K9's bounds against JAX's graph per precision, (loss, tap gradient):
# 'highest' (FP32) and 'high' (3 TF32 passes) at the JAX tests' 1e-5;
# 'default' (1 TF32 pass, operands rounded to 11 significant bits) measured
# 7.0e-7 on the loss and 2.2e-4 of the max on the gradient at this rig,
# held at about twice that
TAPS_TOL = {"highest": (1e-5, 1e-5), "high": (1e-5, 1e-5),
            "default": (1.5e-6, 5e-4)}


def test_aa_taps_tf_mse_matches_jax_graph_and_kernel(interp, mag_rig):
    """K9's plain version: loss and tap gradient against JAX's module
    graph at each precision's bound (TAPS_TOL), 'highest' bit for bit the
    FP32 contractions, and against JAX's kernel (interpreted), also at a
    nonzero bin_offset; a bad precision raises."""
    ps, _ = interp
    jm, pm, x, t = mag_rig

    def graph_loss(m):
        return jnp.mean((jnp.abs(m(jnp.asarray(x))) - t) ** 2)

    lg, gg = jax.jit(jax.value_and_grad(graph_loss))(jm)
    o = aa_fused_operands(pm, torch.tensor(x), torch.tensor(t))
    fb = pm.get_core().feedback
    for precision, (loss_tol, grad_tol) in TAPS_TOL.items():
        fb.param.grad = None
        loss = ak.aa_taps_tf_mse(o["hr"], o["hi"], _mixer_taps(fb), o["rr"],
                                 o["ri"], o["t"], N=2, L=3, nfft=NFFT,
                                 precision=precision)
        loss.backward()
        assert abs(float(loss) - float(lg)) / float(lg) < loss_tol, precision
        assert _rel(fb.param.grad.numpy(),
                    gg.get_core().feedback.param) < grad_tol, precision
    # 'highest' is the FP32 contractions tw^T P and Pr Sr^T - Pi Si^T
    tw = _mixer_taps(fb).detach()
    Pr, Pi = ak.dft_powers(tw.shape[0], M, NFFT)
    rows = [o[k] for k in ("hr", "hi", "rr", "ri", "t")]
    l32, Sr, Si = ak.aa_tf_mse_plain(*rows[:2], tw.T @ Pr, tw.T @ Pi,
                                     *rows[2:], 2, 3)
    lh, tbh = ak.aa_taps_tf_mse_plain(*rows[:2], tw, *rows[2:], 2, 3, NFFT,
                                      precision="highest")
    assert torch.equal(lh, l32) and torch.equal(tbh, Pr @ Sr.T - Pi @ Si.T)
    with pytest.raises(ValueError, match="precision"):
        ak.aa_taps_tf_mse(o["hr"], o["hi"], _mixer_taps(fb), o["rr"],
                          o["ri"], o["t"], N=2, L=3, nfft=NFFT,
                          precision="bf16")

    # a shard of bins 100..227 evaluated at its global bins
    off, n = 100, 128
    tw = _mixer_taps(fb).detach()
    rows = {k: o[k][:, off:off + n].contiguous()
            for k in ("hr", "hi", "rr", "ri", "t")}
    loss_s, tb_s = ak.aa_taps_tf_mse_kernel(
        rows["hr"], rows["hi"], tw, rows["rr"], rows["ri"], rows["t"], 2, 3,
        NFFT, bin_offset=off)
    jl, jtb = jax.value_and_grad(
        lambda tw: ps.pallas_aa_taps_tf_mse(
            *(rows[k].numpy() for k in ("hr", "hi")), tw,
            *(rows[k].numpy() for k in ("rr", "ri", "t")), N=2, L=3,
            nfft=NFFT, bin_offset=off))(tw.numpy())
    assert abs(float(loss_s) - float(jl)) / float(jl) < 1e-5
    assert _rel(tb_s.numpy(), jtb) < 1e-4
    # the same bins of the full-grid K8 plain version
    Pr, Pi = ak.dft_powers(tw.shape[0], M, NFFT)
    full = ak.aa_tf_mse_plain(o["hr"], o["hi"], tw.T @ Pr, tw.T @ Pi,
                              o["rr"], o["ri"], o["t"], 2, 3)
    tb_ref = (Pr[:, off:off + n] @ full[1][:, off:off + n].T
              - Pi[:, off:off + n] @ full[2][:, off:off + n].T) * (M / n)
    assert _rel(tb_s.numpy(), tb_ref.numpy()) < 1e-4
    with pytest.raises(ValueError, match="whole number"):
        ak.aa_taps_tf_mse_kernel(rows["hr"], rows["hi"], tw, rows["rr"],
                                 rows["ri"], rows["t"], 2, 3, NFFT,
                                 bin_offset=0.5)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),  # a tie above an odd ulp
    (1.0 + 2.0 ** -11 + 2.0 ** -23, 1.0 + 2.0 ** -10),  # truncation gives 1
    (2.0 - 2.0 ** -23, 2.0),  # the carry rounds into the exponent
    (-(2.0 - 2.0 ** -12), -2.0),
    (3.0 * 2.0 ** -130, 3.0 * 2.0 ** -130),  # subnormal, exact
    (2.0 ** -137, 2.0 ** -136),  # subnormal tie: away from zero
    (2.0 ** -149, 0.0),  # below half a TF32 subnormal step
    (0.0, 0.0),
    (3.4028234663852886e38, float("inf")),  # max float32 rounds up
    (float("inf"), float("inf")),
])
def test_tf32_round_is_cvt_rna(x, want):
    """tf32_round keeps 10 mantissa bits, to nearest with ties away from
    zero, as PTX cvt.rna.tf32.f32 (truncation or ties to even would bias
    'default' by ~2^-11): held to the exact rounding of the float64 value
    to 11 significant bits (subnormals to steps of 2^-136)."""
    got = float(ak.tf32_round(torch.tensor([x], dtype=torch.float32))[0])
    assert got == want
    if np.isfinite(x) and np.isfinite(want) and x != 0.0:
        step = 2.0 ** (max(np.floor(np.log2(abs(x))), -126) - 10)
        q = abs(x) / step
        assert got == np.sign(x) * np.floor(q + 0.5) * step


def test_aa_kernels_reject_unsupported_sizes(monkeypatch):
    """The wrappers raise, naming the limits: the shapes and dtypes before
    any device dispatch; the microphone count on the card's path (CPU
    tensors take the plain version at any count), past the looped
    kernel's limit, before a library loads."""
    z = torch.zeros((9 * 2, 5))
    loss, Sr, _ = ak.aa_tf_mse_kernel(z, z, z, z, z[:9], z[:9], z[:9], N=9,
                                      L=2)
    assert float(loss) == 0.0 and Sr.shape == (18, 5)
    top = ak.loop_max_n(2)
    zt = torch.zeros(((top + 1) * 2, 5))
    with monkeypatch.context() as mp:
        mp.setattr(ak, "_on_cuda", lambda *t: True)
        mp.setattr(ak.cuda_build, "load", None)  # never reached
        with pytest.raises(ValueError, match=rf"takes 1\.\.{top} "):
            ak.aa_tf_mse_kernel(zt, zt, zt, zt, *(zt[:top + 1],) * 3,
                                N=top + 1, L=2)
    with pytest.raises(TypeError, match="must be"):
        ak.aa_tf_mse_kernel(z, z, z[:4], z, z[:2], z[:2], z[:2], N=2, L=9)
    with pytest.raises(ValueError, match="EIG_DK_MAX_N"):
        ek.dk_roots_rows(torch.zeros((9, 4)), torch.zeros((9, 4)))
    with pytest.raises(TypeError, match="float32"):
        ek.dk_roots_rows(torch.zeros((4, 4), dtype=torch.float64),
                         torch.zeros((4, 4), dtype=torch.float64))
    assert ak.taps_smem_bytes(100, 52) == 4 * (132 * (100 + 52) + 100 * 52)
    assert ak.taps_tc_smem_bytes(100, 52) == 4 * 132 * (112 + 56)


# ---------------------------------------------------------------------------
# the magnitude trainers
# ---------------------------------------------------------------------------
def test_aa_fused_steps_lockstep_with_jax_graph(mag_rig):
    """aa_fused_step (K8) and aa_fused_taps_step (K9) start at JAX's graph
    loss (1e-4) and stay in lockstep with JAX's eager graph training over
    three Adam steps (1e-3); the hoisted-room graph step too."""
    jm, pm, x, t = mag_rig
    xj, tj = jnp.asarray(x), jnp.asarray(t)

    def graph_loss(m):
        return jnp.mean((jnp.abs(m(xj)) - tj) ** 2)

    tx = jax_masked_optimizer(optax.adam(1e-3), jm)

    @jax.jit
    def adam_step(mm, o):
        loss, g = jax.value_and_grad(graph_loss)(mm)
        up, o = tx.update(g, o, mm)
        return optax.apply_updates(mm, up), o, loss

    o, mm, jlosses = tx.init(jm), jm, []
    for _ in range(4):
        mm, o, loss = adam_step(mm, o)
        jlosses.append(float(loss))
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    xt, tt = torch.tensor(x), torch.tensor(t)
    for build in (aa_fused_step, aa_fused_taps_step, aa_hoisted_room_step):
        pm.load_state_dict(state)
        step, _ = build(pm, xt, tt, lr=1e-3)
        losses = [float(step()) for _ in range(4)]
        assert abs(losses[0] - jlosses[0]) / jlosses[0] < 1e-4, build
        assert abs(losses[3] - jlosses[3]) / jlosses[3] < 1e-3, build
        assert losses[3] < losses[0]
    pm.load_state_dict(state)


# ---------------------------------------------------------------------------
# ActiveAcoustics and the eigenvalue trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def evs_rig():
    """The JAX eigenvalue rig on seeded decaying-noise rooms, and its port
    with the same rooms and JAX's U, R (WGN tail) and G (set to the GBI)."""
    flamo_tpu.set_seed(42)
    rng = np.random.default_rng(42)
    env = np.exp(-np.arange(128) / 30.0)[:, None, None]
    rooms = {n: (rng.normal(size=(128,) + shape) * env).astype(np.float32)
             for n, shape in (("H_SM", (2, 1)), ("H_SA", (1, 1)),
                              ("H_LM", (2, 3)), ("H_LA", (1, 3)))}
    ja = JaxActiveAcoustics(n_S=1, n_M=2, n_L=3, n_A=1, nfft=NFFT,
                            FIR_order=8, wgn_RT=0.1, room_irs=rooms)
    pa = ActiveAcoustics(n_S=1, n_M=2, n_L=3, n_A=1, nfft=NFFT, FIR_order=8,
                         wgn_RT=0.1, room_irs=rooms, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    params = {}
    for name in AA_MODULES:
        params.update(_keyed(getattr(ja, name), name))
    load_jax_params(pa, params)
    return ja, pa


def test_convert_key_paths_match_jax_keystr(mag_rig, evs_rig):
    """jax_named_tensors names every leaf as jax.tree_util.keystr does:
    the magnitude rig's Shell (cached room), the F_MM shell of an
    OrderedDict Series, and ActiveAcoustics' modules by attribute."""
    jm, pm, _, _ = mag_rig
    ja, pa = evs_rig
    assert set(jax_named_tensors(pm)) == set(_keyed(jm)) == {
        ".core.feedforward.H_re", ".core.feedforward.H_im",
        ".core.feedback.param"}
    assert set(jax_named_tensors(pa.F_MM)) == set(_keyed(ja.F_MM)) == {
        ".core.modules[0].param", ".core.modules[1].param",
        ".core.modules[2].param", ".core.modules[3].H_re",
        ".core.modules[3].H_im"}
    keys = set()
    for name in AA_MODULES:
        keys |= set(_keyed(getattr(ja, name), name))
    assert set(jax_named_tensors(pa)) == keys
    for k, v in _keyed(ja.F_MM).items():
        assert _rel(jax_named_tensors(pa.F_MM)[k].detach().numpy(), v) \
            < 1e-5, k
    uncached = build_active_acoustics(n_mics=2, n_loudspeakers=3,
                                      rir_length=20, fir_order=4, nfft=64,
                                      cache_room=False, device="cpu")
    assert set(jax_named_tensors(uncached)) == {".core.feedforward.param",
                                                ".core.feedback.param"}


def test_active_acoustics_workflow_matches_jax(mag_rig, evs_rig):
    """The F_MM loop matrix, the GBI (JAX's constructor set G to it),
    set_G_to_GBI, normalize_U, system_simulation's shape, adopt, and the
    open-loop matrix and GBIs of the magnitude rig against flamo_tpu."""
    jm, pm, _, _ = mag_rig
    ja, pa = evs_rig
    x = np.zeros((1, NFFT, 2), np.float32)
    x[:, 0, :] = 1.0
    with torch.no_grad():
        y = pa(torch.tensor(x))
    assert y.shape == (1, M, 2, 2)
    assert _rel(y.numpy(), ja(jnp.asarray(x))) < 1e-4
    evs = pa.get_F_MM_eigenvalues()
    assert evs.shape == (1, M, 2)
    np.testing.assert_allclose(float(torch.abs(evs).max()), 1.0, rtol=1e-4)
    g = pa.G.param.detach().clone()
    gbi = float(pa.get_current_GBI())
    torch.testing.assert_close(pa.G.param.detach(), g)
    np.testing.assert_allclose(gbi, float(ja.G.param[0]), rtol=1e-4)
    sim = pa.system_simulation()
    assert sim.shape == (1, NFFT, 1)
    assert bool(torch.isfinite(sim).all()) and float(sim.abs().max()) > 0

    assert _rel(open_loop_matrix(pm).detach().numpy(),
                jaa.open_loop_matrix(jm)) < 1e-5
    assert abs(float(gain_before_instability(pm))
               - float(jaa.gain_before_instability(jm))) < 1e-3
    assert abs(float(gain_before_instability_diff(pm))
               - float(jaa.gain_before_instability_diff(jm))) < 1e-3

    u = pa.U.param.detach().clone()
    pa.normalize_U(2.0)
    np.testing.assert_allclose(float(torch.sqrt(torch.sum(
        pa.U.param.detach() ** 2))), 2.0, rtol=1e-5)
    pb = ActiveAcoustics(n_S=1, n_M=2, n_L=3, n_A=1, nfft=NFFT, FIR_order=8,
                         rir_length=64, wgn_RT=0.05, room_t60=0.05,
                         device="cpu")
    pb.adopt(pa.F_MM)
    assert pb.U is pa.U and pb.F_MM.get_core()["U"] is pa.U
    pa.U.assign_value(u)


def test_mse_evs_defaults_to_the_card(monkeypatch):
    """Without ``device`` the partitions go to the CUDA card, as every entry
    point's default: where there is none, it raises.  On the CPU they stay
    there, and a step on the CPU reads them without a copy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mse_evs(iter_num=4, freq_points=M)
    crit = mse_evs(iter_num=4, freq_points=M, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert crit.mask_indices.device.type == "cpu"
    assert crit.mask_indices.shape == (M // 65, 65)  # ceil(M / 4) bins
    y = torch.eye(2, dtype=torch.complex64).expand(1, M, 2, 2)
    loss = crit(y, torch.ones((1, M, 2)), step=1)
    assert float(loss) == 0.0


def test_aa_evs_train_step_matches_jax_mse_evs(evs_rig):
    """The rows eigenvalue step's first loss equals JAX's mse_evs on the
    F_MM graph at the same partition (1e-4), and the port's mse_evs
    (torch.linalg.eigvals) too; aa_evs_fit trains the loss down and
    launches no kernel on the CPU."""
    ja, pa = evs_rig
    x = np.zeros((1, NFFT, 2), np.float32)
    x[:, 0, :] = 1.0
    tg = np.full((M, 2), 0.3, np.float32)
    crit = jax_mse_evs(iter_num=4, freq_points=M)
    masks = np.asarray(crit.mask_indices)
    l_jax = float(crit(ja.F_MM(jnp.asarray(x)), tg[None], step=1))

    state = pa.U.param.detach().clone()
    step, _ = aa_evs_train_step(pa, tg, lr=1e-3, masks=masks)
    l_port = float(step(1))
    assert abs(l_port - l_jax) / l_jax < 1e-4
    pa.U.assign_value(state)

    pcrit = mse_evs(iter_num=4, freq_points=M, device="cpu")
    pcrit.mask_indices = torch.tensor(masks)
    with torch.no_grad():
        l_pcrit = float(pcrit(pa(torch.tensor(x)), torch.tensor(tg)[None],
                              step=1))
    assert abs(l_pcrit - l_jax) / l_jax < 1e-4

    ek.reset_launch_counts()
    _, hist = aa_evs_fit(pa, tg, n_steps=24, lr=1e-2, iter_num=4,
                         masks=masks)
    pa.U.assign_value(state)
    assert hist.shape == (24,) and np.isfinite(hist).all()
    assert np.mean(hist[-4:]) < np.mean(hist[:4])
    assert ek.LAUNCHES["dk_roots"] == 0
