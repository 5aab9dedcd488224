"""The port's phase-2 micro-benchmark K10 (``flamo_tpu_torch.ops.
phase2_micro`` and ``flamo_tpu_torch.scripts.bench_phase2_micro``), held
against the Pallas kernel of ``scripts/bench_phase2_micro.py`` on the CPU.

On the CPU the wrapper runs the plain version.  JAX's ``_kernel`` runs
through the Pallas interpreter, built as the script's ``run`` builds it,
with the script's NFFT, K, N and S patched on the loaded module and its
TILE left at 1024 (``_bin_phasor`` reads ``pallas_solve.TILE`` and the
BlockSpecs the script's own, so patching one would desynchronise them):
at nfft = 2048 over 2048 bins, two grid steps.  K = 3, N = 2 are coprime,
so ``s % K, s % N`` visits every (k, n) pair twice and ``full`` equals
``ps``; at K = 4, N = 2 it does not, and the two differ.

Tolerance: every result is a float32 sum of many terms of both signs, so
two float32 evaluations (another summation order, another sine and
cosine) are held to 1e-5 of the sum of the terms' magnitudes
(``phase2_micro_plain(..., magnitude=True)``), as is the plain version
against a float64 loop at the published K = 12, N = 6; the measured gaps
are 1e-7 of that scale or less.

tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card.
"""

from __future__ import annotations

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu_torch.ops import phase2_micro as pm
from flamo_tpu_torch.scripts import bench_phase2_micro as bench

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
NFFT = 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain version at the published sizes issues thousands of
    element-wise ops on 48128-bin rows, each split over torch's intra-op
    threads.  Under the test runner's six workers on eight cores those
    threads outnumber the cores, and each op waits on its slowest thread:
    the float64 comparison took 394 s for one variant with busy
    neighbours and 0.6 s alone.  On one thread a worker runs the same
    ops and the same checks; only a sum's split over threads, and so the
    order it rounds in, can change, far inside the 1e-5 of the terms'
    magnitudes that each result is held to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_phase2_micro", REPO / "scripts" / "bench_phase2_micro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_k10(mod, monkeypatch, variant, t, c, nfft):
    """The script's pallas_call in interpret mode, summed over its grid."""
    from jax.experimental import pallas as pl

    P, K, N = c.shape
    for name, value in (("NFFT", nfft), ("K", K), ("N", N),
                        ("S", 2 * K * N)):
        monkeypatch.setattr(mod, name, value)
    grid = t.shape[1] // mod.TILE
    fn = pl.pallas_call(
        partial(mod._kernel, variant),
        grid=(grid,),
        in_specs=[pl.BlockSpec((2, mod.TILE), lambda i: (0, i)),
                  pl.BlockSpec((P, K, N), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, 3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, 1, 3), jnp.float32),
        interpret=True)
    return np.asarray(jnp.sum(fn(jnp.asarray(t), jnp.asarray(c)),
                              axis=(0, 1)))


def _operands(seed, M, K, N, P=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, M)).astype(np.float32),
            rng.uniform(0.5, 1.5, (P, K, N)).astype(np.float32))


def _plain(variant, t, c, nfft, magnitude=False):
    return pm.phase2_micro_plain(variant, torch.tensor(t), torch.tensor(c),
                                 nfft, magnitude).numpy()


def _assert_close(got, ref, scale, what):
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert np.all(err <= TOL * scale), (what, got, ref, err / scale)


@pytest.mark.parametrize("K,N", [(3, 2), (4, 2)])
@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_plain_matches_jax_kernel(jax_script, monkeypatch, variant, K, N):
    t, c = _operands(K * 10 + N, NFFT, K, N)
    ref = _jax_k10(jax_script, monkeypatch, variant, t, c, NFFT)
    got = pm.phase2_micro(variant, torch.tensor(t), torch.tensor(c), NFFT)
    assert got.shape == (3,) and got.dtype == torch.float32
    _assert_close(got.numpy(), ref, _plain(variant, t, c, NFFT, True),
                  f"{variant} K={K} N={N}")


def _pairs_loop_f64(t, c, nfft, pairs):
    """sum over the (k, n) passes ``pairs`` and every bin of
    Re(tn / sec_kn z^p), p < 3, in float64 at the float32 phase."""
    P = c.shape[0]
    w = (np.float32(2 * np.pi / nfft)
         * np.arange(t.shape[1], dtype=np.float32)).astype(np.float64)
    z = np.exp(-1j * w)
    tn = t[0].astype(np.float64) + 1j * t[1]
    out = np.zeros(3)
    for k, n in pairs:
        q = tn / sum(float(c[p, k, n]) * z ** p for p in range(P))
        for p in range(3):
            out[p] += np.sum((q * z ** p).real)
    return out


def _f64_reference(variant, t, c, nfft):
    _, K, N = c.shape
    if variant == "ps":
        pairs = [(k, n) for n in range(N) for k in range(K)] * 2
    else:
        pairs = [(s % K, s % N) for s in range(2 * K * N)]
    v = _pairs_loop_f64(t, c, nfft, pairs)
    if variant == "noreduce":
        return np.array([v[0], v[1:].sum(), 0.0])
    if variant == "lanered":
        return np.full(3, v.sum())
    return v


@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_plain_matches_float64_loop_at_published_sizes(variant):
    """At the script's K = 12, N = 6, P = 3 and nfft = 96000, on its
    operands (t of ones over 48128 bins, seed-0 taps) and on a seeded
    random t: the s % K, s % N passes, in float64."""
    t1, c = (x.numpy() for x in bench.inputs("cpu"))
    tr = np.random.default_rng(5).normal(size=t1.shape).astype(np.float32)
    for t in (t1, tr):
        _assert_close(_plain(variant, t, c, bench.NFFT),
                      _f64_reference(variant, t, c, bench.NFFT),
                      _plain(variant, t, c, bench.NFFT, True), variant)


@pytest.mark.parametrize("P", [2, 5])
@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_plain_projects_on_three_powers_whatever_p(variant, P):
    """The TPU kernel projects q on z^0, z^1, z^2 (its P is 3); the port
    keeps those three sums at any P, which reaches only Horner."""
    t, c = _operands(P, NFFT, 3, 2, P)
    _assert_close(_plain(variant, t, c, NFFT),
                  _f64_reference(variant, t, c, NFFT),
                  _plain(variant, t, c, NFFT, True), f"{variant} P={P}")


def test_indexing_pins_full_against_ps():
    """s % K, s % N visits every (k, n) pair twice where gcd(K, N) = 1,
    so full equals ps; where gcd(K, N) > 1 it skips pairs, and they
    differ (as in the TPU kernel: the port keeps its indexing)."""
    for (K, N), same in (((3, 2), True), ((4, 2), False), ((12, 6), False)):
        t, c = _operands(7, NFFT, K, N)
        full, ps = _plain("full", t, c, NFFT), _plain("ps", t, c, NFFT)
        scale = _plain("full", t, c, NFFT, True)
        close = bool(np.all(np.abs(full - ps) <= TOL * scale))
        assert close == same, (K, N, full, ps)
        noreduce, lanered = (_plain(v, t, c, NFFT)
                             for v in ("noreduce", "lanered"))
        np.testing.assert_allclose(noreduce[:2], [full[0], full[1:].sum()],
                                   atol=TOL * scale.sum())
        assert noreduce[2] == 0.0
        np.testing.assert_allclose(lanered, np.full(3, full.sum()),
                                   atol=TOL * scale.sum())


def test_wrapper_checks_name_the_limits():
    t = torch.zeros((2, 64))
    c = torch.ones((3, 4, 2))
    with pytest.raises(ValueError, match="unknown variant"):
        pm.phase2_micro("fast", t, c, 128)
    with pytest.raises(TypeError, match="float32"):
        pm.phase2_micro("full", t.double(), c, 128)
    with pytest.raises(TypeError, match="float32"):
        pm.phase2_micro("full", t, c.half(), 128)
    with pytest.raises(ValueError, match=r"2\.\.8"):
        pm.phase2_micro("full", t, torch.ones((9, 4, 2)), 128)
    with pytest.raises(ValueError, match=r"2\.\.8"):
        pm.phase2_micro("ps", t, torch.ones((1, 4, 2)), 128)
    with pytest.raises(ValueError, match=r"'noreduce' kernel takes 1\.\.64"):
        pm.phase2_micro("noreduce", t, torch.ones((3, 65, 2)), 128)
    with pytest.raises(ValueError, match=r"'ps' kernel takes 1\.\.16"):
        pm.phase2_micro("ps", t, torch.ones((3, 17, 2)), 128)
    with pytest.raises(ValueError, match=r"\(2, M\)"):
        pm.phase2_micro("lanered", torch.zeros((3, 64)), c, 128)
    with pytest.raises(ValueError, match=r"\(P, K, N\)"):
        pm.phase2_micro("lanered", t, torch.ones((3, 4)), 128)
    for v in pm.VARIANTS:
        assert pm.phase2_micro(v, t, torch.ones((5, 4, 2)), 128).shape \
            == (3,)
    assert pm.phase2_micro("full", t, torch.ones((3, 64, 2)), 128).shape \
        == (3,)
    assert pm.LAUNCHES == dict.fromkeys(pm.VARIANTS, 0)


def test_bench_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run("full", k=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.inputs()


def test_bench_inputs_are_the_scripts_and_run_times_only_on_a_card():
    """inputs() builds the JAX script's operands (t of ones over its
    48128 padded bins, seed-0 taps); run() times by CUDA events and
    refuses a CPU device."""
    t, c = bench.inputs("cpu")
    assert t.shape == (2, 48128) and bool(torch.all(t == 1.0))
    np.testing.assert_array_equal(
        c.numpy(), np.random.default_rng(0).uniform(0.5, 1.5, (3, 12, 6))
        .astype(np.float32))
    value = pm.phase2_micro("ps", t, c, bench.NFFT)
    assert value.shape == (3,) and bool(torch.all(torch.isfinite(value)))
    with pytest.raises(ValueError, match="CUDA"):
        bench.run("ps", k=1, device="cpu")
