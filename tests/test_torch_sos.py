"""The port's SOS-cascade kernels K4 and K5, held against flamo_tpu.

On the CPU each kernel wrapper runs its plain PyTorch version.  K4 is
compared with the JAX Pallas kernel ``pallas_sos_cascade`` in interpret
mode (TILE patched to 256, as tests/test_ops.py does); K5 with the dense
XLA reference of tests/test_ops.py's K5 test (``cascade_prods``,
``_iir_guard_prods``, ``jnp.linalg.solve``), since the interpret-mode K5
test is a slow one.  Tolerances are the JAX kernel tests': K4 values 1e-5
of the max and tap gradients 1e-4 of the max; K5 loss 1e-5 relative and
every cotangent 5e-3 of the max (the reference solves by LU and
differentiates through it, the port eliminates and takes closed-form
cotangents).  Complex gradients are compared with conj(jax.grad).

tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu_torch.ops import sos_kernels as sk

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The JAX Pallas kernels through the interpreter, TILE = 256."""
    import flamo_tpu.ops.pallas_solve as ps
    from jax.experimental import pallas as pl

    orig_call = pl.pallas_call
    monkeypatch.setattr(ps.pl, "pallas_call",
                        partial(orig_call, interpret=True))
    monkeypatch.setattr(ps, "TILE", 256)
    return ps


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _grad_np(x):
    return x.grad.detach().resolve_conj().numpy()


def _stable_taps(rng, P, K, N):
    """Denominators with poles inside the unit circle, random numerators."""
    if P == 3:
        r = 0.6 * rng.uniform(0.2, 0.99, (K, N))
        th = rng.uniform(0, np.pi, (K, N))
        a = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    else:
        a = np.concatenate([np.ones((1, K, N)),
                            0.1 * rng.normal(size=(P - 1, K, N))])
    b = rng.normal(size=(P, K, N))
    return b.astype(np.float32), a.astype(np.float32)


def _jax_cascade_and_grads(ps, b, a, G, nfft, bin_offset):
    def loss(b, a):
        H = ps.pallas_sos_cascade(b, a, nfft, bin_offset=bin_offset)
        return jnp.sum(jnp.real(H * G)), H

    (_, H), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True))(jnp.asarray(b),
                                                          jnp.asarray(a))
    return np.asarray(H), g


@pytest.mark.parametrize("P,K,N,nfft,seed,bin_offset", [
    (3, 5, 4, 600, 5, None),
    (5, 2, 2, 512, 11, None),
    (3, 2, 2, 128, 7, 37.0),
], ids=["P3K5N4", "P5K2N2", "P3K2N2-offset"])
def test_sos_cascade_matches_pallas(pallas_interpret, P, K, N, nfft, seed,
                                    bin_offset):
    """K4 plain (forward and the tap-sum backward) against the Pallas
    kernel, through the real loss sum Re(H G)."""
    rng = np.random.default_rng(seed)
    b, a = _stable_taps(rng, P, K, N)
    M = nfft // 2 + 1
    G = (rng.normal(size=(M, N)) + 1j * rng.normal(size=(M, N))).astype(
        np.complex64)
    Hj, gj = _jax_cascade_and_grads(pallas_interpret, b, a, jnp.asarray(G),
                                    nfft, bin_offset)
    bt, at = (torch.tensor(x, requires_grad=True) for x in (b, a))
    H = sk.sos_cascade(bt, at, nfft, bin_offset=bin_offset)
    assert H.shape == (M, N) and H.dtype == torch.complex64
    assert _rel(H.detach().numpy(), Hj) < 1e-5
    torch.sum(torch.real(H * torch.tensor(G))).backward()
    assert _rel(_grad_np(bt), gj[0]) < 1e-4
    assert _rel(_grad_np(at), gj[1]) < 1e-4


def _k5_operands(seed=43, N=3, K=4, P=3, nfft=600):
    """tests/test_ops.py's K5 operands (M = 301)."""
    rng = np.random.default_rng(seed)
    M = nfft // 2 + 1
    r = rng.uniform(0.2, 0.8, (K, N))
    th = rng.uniform(0, np.pi, (K, N))
    return dict(
        D=(0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))))
        .astype(np.complex64),
        at=np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
        .astype(np.float32),
        bt=(0.5 * rng.normal(size=(P, K, N)) + np.stack(
            [np.ones((K, N)), np.zeros((K, N)), np.zeros((K, N))]))
        .astype(np.float32),
        U=(0.6 * np.linalg.qr(rng.normal(size=(N, N)))[0]).astype(np.float32),
        b=rng.normal(size=N).astype(np.float32),
        c=rng.normal(size=N).astype(np.float32),
        X=(rng.normal(size=M) + 1j * rng.normal(size=M)).astype(np.complex64),
        t=rng.uniform(size=M).astype(np.float32),
    )


NAMES = ("D", "bt", "at", "U", "b", "c")


def _k5_reference(o, nfft):
    """tests/test_ops.py's dense XLA reference of K5's loss, and its
    gradients in D, bt, at, U, b, c."""
    from flamo_tpu.functional import cascade_prods
    from flamo_tpu.processor.dsp import _iir_guard_prods

    N = o["U"].shape[0]
    X, t = jnp.asarray(o["X"]), jnp.asarray(o["t"])

    def loss_ref(D, bt, at, U, b, c):
        Gam = _iir_guard_prods(*cascade_prods(bt, at, nfft))
        A = (jnp.eye(N, dtype=jnp.complex64)[None]
             - (D * Gam)[:, :, None] * U[None].astype(jnp.complex64))
        rhs = D * b.astype(jnp.complex64)
        y = jnp.linalg.solve(A, rhs[..., None])[..., 0]
        tf = jnp.sum(y * c, -1)
        return jnp.mean((jnp.abs(tf * X) - t) ** 2)

    args = [jnp.asarray(o[n]) for n in NAMES]
    lr = float(jax.jit(loss_ref)(*args))
    gr = jax.jit(jax.grad(loss_ref, argnums=tuple(range(6))))(*args)
    return lr, [np.asarray(g) for g in gr]


@pytest.fixture(scope="module")
def k5_reference():
    o = _k5_operands()
    return o, _k5_reference(o, 600)


@pytest.mark.parametrize("with_dbar", [True, False])
@pytest.mark.parametrize("pivot,fuse_taps", [(True, False), (False, False),
                                             (False, True)])
def test_fdn_sos_tf_mse_matches_dense_reference(k5_reference, pivot,
                                                fuse_taps, with_dbar):
    o, (lr, gr) = k5_reference
    leaves = [torch.tensor(o[n], requires_grad=True) for n in NAMES]
    loss = sk.fdn_sos_tf_mse(*leaves, torch.tensor(o["X"]),
                             torch.tensor(o["t"]), nfft=600,
                             with_dbar=with_dbar, pivot=pivot,
                             fuse_taps=fuse_taps)
    loss.backward()
    assert abs(float(loss.detach()) - lr) / abs(lr) < 1e-5
    D = leaves[0]
    if with_dbar:
        assert _rel(_grad_np(D), np.conj(gr[0])) < 5e-3
    else:
        assert D.grad is None
    for x, g, name in zip(leaves[1:], gr[1:], NAMES[1:]):
        assert _rel(_grad_np(x), g) < 5e-3, name


def test_fdn_sos_tf_mse_bin_offset_shifts_the_phasor():
    """Rows evaluated at bins j + off equal the unshifted call's rows
    off.. of the full grid (the bins-sharded use of K5; the loss is
    normalised by the call's own row count)."""
    o = _k5_operands(seed=3)
    full = [torch.tensor(o[n]) for n in NAMES]
    X, t = torch.tensor(o["X"]), torch.tensor(o["t"])
    off, M = 100, 301
    sl = slice(off, M)
    D_bar_full = sk.fdn_sos_tf_mse_plain(
        *full, X, t, 600, with_dbar=True, fuse_taps=True)[1]
    part = sk.fdn_sos_tf_mse_plain(
        full[0][sl], *full[1:], X[sl], t[sl], 600, with_dbar=True,
        fuse_taps=True, bin_offset=off)
    assert _rel(part[1].numpy() * (M - off) / M,
                D_bar_full[sl].numpy()) < 1e-5
    H_full = sk.sos_cascade_fwd_plain(full[1], full[2], 600)
    H_part = sk.sos_cascade_fwd_plain(full[1], full[2], 600,
                                      bin_offset=off)
    assert _rel(H_part[:M - off].numpy(), H_full[off:].numpy()) < 1e-5


def _guard_taps():
    """Taps whose channel 0 has a section with A(z = 1) = 0 exactly (the
    denominator product vanishes at bin 0) and whose channel 1 has a
    section with B(z = 1) = 0 (one zero numerator section at bin 0)."""
    rng = np.random.default_rng(2)
    b, a = _stable_taps(rng, 3, 2, 2)
    a[:, 1, 0] = (1.0, -1.0, 0.0)
    b[:, 0, 1] = (1.0, -1.0, 0.0)
    return b, a


def test_sos_guard_gives_eps_and_zero_gradient(pallas_interpret):
    """Where the denominator product is 0 the response is the real
    FLT_EPSILON with zero gradient, and a zero section adds nothing: no
    NaN anywhere, in K4 and in K5, as in the Pallas kernel."""
    b, a = _guard_taps()
    nfft, M = 64, 33
    rng = np.random.default_rng(8)
    G = (rng.normal(size=(M, 2)) + 1j * rng.normal(size=(M, 2))).astype(
        np.complex64)
    Hj, gj = _jax_cascade_and_grads(pallas_interpret, b, a, jnp.asarray(G),
                                    nfft, None)
    bt, at = (torch.tensor(x, requires_grad=True) for x in (b, a))
    H = sk.sos_cascade(bt, at, nfft).detach()
    assert complex(H[0, 0]) == complex(EPS, 0.0) == complex(Hj[0, 0])
    assert complex(H[0, 1]) == 0.0
    assert _rel(H.numpy(), Hj) < 1e-5
    torch.sum(torch.real(sk.sos_cascade(bt, at, nfft)
                         * torch.tensor(G))).backward()
    for x, g in zip((bt, at), gj):
        assert np.isfinite(_grad_np(x)).all()
        assert _rel(_grad_np(x), g) < 1e-4
    # the guarded bin alone: zero cotangent for every tap
    bt.grad = at.grad = None
    g0 = torch.zeros((M, 2), dtype=torch.complex64)
    g0[0, 0] = 1.0
    torch.sum(torch.real(sk.sos_cascade(bt, at, nfft) * g0)).backward()
    assert float(bt.grad.abs().max()) == 0.0 == float(at.grad.abs().max())

    # K5 through the same taps, and the plain graph route (double where)
    o = _k5_operands(seed=4, N=2, K=2, P=3, nfft=nfft)
    o["bt"], o["at"] = b, a
    for fuse_taps in (True, False):
        leaves = [torch.tensor(o[n], requires_grad=True) for n in NAMES]
        loss = sk.fdn_sos_tf_mse(*leaves, torch.tensor(o["X"]),
                                 torch.tensor(o["t"]), nfft=nfft,
                                 with_dbar=True, fuse_taps=fuse_taps)
        loss.backward()
        assert np.isfinite(float(loss.detach()))
        for x in leaves:
            assert np.isfinite(_grad_np(x)).all()
    bx, ax = (torch.tensor(x, requires_grad=True) for x in (b, a))
    Hx = sk.sos_cascade_fwd_plain(bx, ax, nfft)
    torch.sum(torch.abs(Hx) ** 2).backward()
    assert np.isfinite(_grad_np(bx)).all() and np.isfinite(_grad_np(ax)).all()


def test_kernel_libraries_one_per_source_and_channel_count(tmp_path,
                                                          monkeypatch):
    """Each kernel source builds one library per channel count (1..16; the
    active-acoustics and eigenvalue kernels 1..8; the SOS cascade K4, the
    phase-2 micro-benchmark and the looped eliminations one library each,
    as N = 1, for every size), named by a hash of every source file, and
    every entry point that the loader binds is defined in its sources (a
    library of several compile units: in one of them) with as many
    parameters."""
    import re
    import shutil

    from flamo_tpu_torch.ops import cuda_build as cb

    libs = tuple(cb._SIGNATURES)
    assert libs == ("fdn_kernels", "sos_kernels", "sos_cascade",
                    "aa_kernels", "eig_kernels", "fdn_loop", "aa_loop",
                    "phase2_micro")
    assert cb.LIB_MAX_N["phase2_micro"] == cb.LIB_MAX_N["sos_cascade"] == 1
    assert cb.LIB_MAX_N["fdn_loop"] == cb.LIB_MAX_N["aa_loop"] == 1
    names = {cb.library_path(n, lib).name for lib in libs
             for n in {1, min(6, cb.LIB_MAX_N[lib]), cb.LIB_MAX_N[lib]}}
    assert len(names) == 16
    for lib in libs:
        for bad in (0, cb.LIB_MAX_N[lib] + 1):
            with pytest.raises(ValueError, match="channels"):
                cb._check_target(lib, bad)
    with pytest.raises(ValueError, match="unknown"):
        cb._check_target("sos", 6)
    for lib, (prefix, sigs) in cb._SIGNATURES.items():
        src = "".join((cb.CSRC / unit[0]).read_text() for unit in
                      cb.LIB_UNITS.get(lib, ((f"{lib}.cu",),)))
        assert {f"{prefix}_channels", f"{prefix}_threads_per_block",
                f"{prefix}_error_string"} <= set(sigs)
        for name, (_, argtypes) in sigs.items():
            found = re.search(rf"^(?:int|long long|const char\*) {name}"
                              r"\(([^)]*)\)",
                              src, re.MULTILINE)
            assert found, name
            params = found.group(1).strip()
            assert len(argtypes) == (params.count(",") + 1 if params else 0), \
                name
    # an edit of any shared header renames every library
    csrc = tmp_path / "csrc"
    shutil.copytree(cb.CSRC, csrc)
    before = [cb.library_path(6, lib) for lib in libs]
    monkeypatch.setattr(cb, "CSRC", csrc)
    assert [cb.library_path(6, lib) for lib in libs] == before
    for header in ("fdn_ge.cuh", "fdn_loop.cuh", "sos_common.cuh",
                   "aa_tile.cuh"):
        with open(csrc / header, "a") as f:
            f.write("\n")
        after = [cb.library_path(6, lib) for lib in libs]
        assert all(a != b for a, b in zip(after, before)), header
        before = after


def test_sos_kernels_reject_bad_operands():
    b = torch.zeros((9, 2, 3))
    with pytest.raises(ValueError, match="taps per section"):
        sk.sos_cascade_fwd_kernel(b, b, 64)
    with pytest.raises(TypeError, match="float32"):
        sk.sos_cascade_fwd_kernel(b[:3].double(), b[:3].double(), 64)
    o = _k5_operands(N=3, K=4)
    args = [torch.tensor(o[n]) for n in NAMES]
    args[1] = args[1][..., :2]
    args[2] = args[2][..., :2]
    with pytest.raises(ValueError, match="channels"):
        sk.fdn_sos_tf_mse_kernel(*args, torch.tensor(o["X"]),
                                 torch.tensor(o["t"]), 600)
