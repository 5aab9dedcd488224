"""K10 (the phase-2 micro-benchmark's kernels) after the redesign of all
four variants for the H100, on the CPU: what of them the CPU can check.

* The wrapper's pass plan (``pass_plan``): the kernels of ``full``,
  ``noreduce`` and ``lanered`` run the passes s < L = lcm(K, N) and scale
  their sums by r = 2 K N / L, which is right only if those passes are
  exactly the distinct pairs (s % K, s % N) of the 2 K N, each of which
  the function visits r = 2 gcd(K, N) times; ``ps``'s runs one pass over
  k scaled by 2.
* The kernels' arithmetic in float64: r times the sum over the plan's
  distinct passes, formed as the kernels form it (``full``: Q = tn W,
  W = sum conj(sec) / |sec|^2, projected; ``noreduce``: Re Q and
  Re Q z + Re Q z^2; ``lanered``: the sum over passes of
  Re(conj(sec) / |sec|^2 tn (1 + z + z^2)); ``ps``: tp sum_k pre_k
  suf_{k+1} a channel, the suffix products from the last section down),
  against the JAX script's ``_kernel`` in interpret mode and against the
  plain version, at nfft = 2048 over 2048 bins, within TOL = 1e-5 of the
  terms' magnitudes (tests/test_torch_phase2_micro.py's bound and setup,
  whose helpers are copied here).
* The wrapper's checks name each limit before it loads a library; the
  control (controls/phase2_micro_prev) keeps the C entry point that
  chip_smoke.Previous binds; K10's bounds in chip_smoke.kernel_work.

tests/test_torch_cuda.py holds the CUDA kernels to the plain version on
the card.
"""

from __future__ import annotations

import importlib.util
import math
import re
from collections import Counter
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import phase2_micro as pm

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
NFFT = 2048


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_script():
    return _load("jax_bench_phase2_micro",
                 REPO / "scripts" / "bench_phase2_micro.py")


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", REPO / "chip_smoke.py")


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


def _bins(t, nfft):
    w = (np.float32(2 * np.pi / nfft)
         * np.arange(t.shape[1], dtype=np.float32)).astype(np.float64)
    return np.exp(-1j * w), t[0].astype(np.float64) + 1j * t[1]


def _sec(c, k, n, z):
    return sum(float(c[p, k, n]) * z ** p for p in range(c.shape[0]))


def _project(Q, z):
    return np.array([np.sum((Q * z ** p).real) for p in range(3)])


def _plan(variant, t, c, nfft):
    """(z, tn, r, us) in float64: the bins' phasors and tn, the plan's
    scale r and, for each of the plan's passes, u = conj(sec) / |sec|^2."""
    _, K, N = c.shape
    passes, r = pm.pass_plan(variant, K, N)
    z, tn = _bins(t, nfft)
    return z, tn, r, [1.0 / _sec(c, s % K, s % N, z) for s in range(passes)]


def _full_by_plan(t, c, nfft):
    """full as its kernel forms it: Q = r tn W, W the sum of the plan's
    u, projected on z^0, z^1, z^2."""
    z, tn, r, us = _plan("full", t, c, nfft)
    return _project(r * tn * sum(us), z)


def _noreduce_by_plan(t, c, nfft):
    """noreduce as its kernel forms it: Q = r tn W as full's, then
    (Re Q, Re Q z + Re Q z^2, 0)."""
    z, tn, r, us = _plan("noreduce", t, c, nfft)
    p = _project(r * tn * sum(us), z)
    return np.array([p[0], p[1] + p[2], 0.0])


def _lanered_by_plan(t, c, nfft):
    """lanered as its kernel forms it: T = r times the sum over the plan's
    passes of the bins' sum of Re(u tz), tz = tn (1 + z + z^2), in every
    slot."""
    z, tn, r, us = _plan("lanered", t, c, nfft)
    tz = tn * (1 + z + z * z)
    return np.full(3, r * sum(np.sum((u * tz).real) for u in us))


def _ps_by_plan(t, c, nfft):
    """ps as its kernel forms it, in float64: per channel the prefix
    products, the product's quotient tp and sum_k pre_k suf_{k+1} with the
    suffix products built from the last section down, scaled by 2."""
    _, K, N = c.shape
    passes, r = pm.pass_plan("ps", K, N)
    assert passes == 1
    z, tn = _bins(t, nfft)
    Q = 0
    for n in range(N):
        sec = [_sec(c, k, n, z) for k in range(K)]
        pre = [np.ones_like(z)]
        for k in range(K):
            pre.append(pre[-1] * sec[k])
        acc, suf = 0, np.ones_like(z)
        for k in range(K - 1, -1, -1):
            acc = acc + pre[k] * suf
            suf = suf * sec[k]
        Q = Q + tn / pre[K] * acc
    return _project(r * Q, z)


def _assert_close(got, ref, scale, what):
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert np.all(err <= TOL * scale), (what, got, ref, err / scale)


@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_pass_plan_covers_every_pass_once_scaled(variant):
    """For every K in 1..64 (1..16 for ps) and N in 1..8 the passes the
    kernel runs, each counted ``scale`` times, are the function's 2 K N
    passes: the plan of full, noreduce and lanered is the L = lcm(K, N)
    distinct pairs (s % K, s % N), each visited r = 2 gcd(K, N) times,
    ps's one pass over k scaled by 2."""
    for K in range(1, (pm.MAX_K_PS if variant == "ps" else pm.MAX_K) + 1):
        for N in range(1, 9):
            passes, scale = pm.pass_plan(variant, K, N)
            if variant == "ps":
                assert (passes, scale) == (1, 2)
                continue
            visits = Counter((s % K, s % N) for s in range(2 * K * N))
            plan = Counter((s % K, s % N) for s in range(passes))
            assert visits == {pair: scale * n for pair, n in plan.items()}
            assert set(plan.values()) == {1}, (K, N)
            assert (passes, scale) == (math.lcm(K, N), 2 * math.gcd(K, N))


BY_PLAN = {"full": _full_by_plan, "noreduce": _noreduce_by_plan,
           "lanered": _lanered_by_plan, "ps": _ps_by_plan}


@pytest.mark.parametrize("variant,K,N", [
    ("full", 4, 2), ("full", 4, 6), ("full", 5, 3), ("ps", 4, 2),
    ("noreduce", 4, 6), ("noreduce", 5, 3), ("lanered", 4, 6),
    ("lanered", 5, 3)])
def test_plan_sums_match_jax_kernel_and_plain(jax_script, monkeypatch,
                                              variant, K, N):
    t, c = _operands(K * 10 + N, NFFT, K, N)
    ref = _jax_k10(jax_script, monkeypatch, variant, t, c, NFFT)
    got = BY_PLAN[variant](t, c, NFFT)
    scale = _plain(variant, t, c, NFFT, True)
    _assert_close(got, ref, scale, f"{variant} K={K} N={N} vs JAX")
    _assert_close(got, _plain(variant, t, c, NFFT), scale,
                  f"{variant} K={K} N={N} vs plain")


def test_wrapper_names_each_limit_before_loading_a_library(monkeypatch):
    """On a CUDA tensor the wrapper checks every limit, and raises naming
    it, before it loads the kernel library (here a stand-in that fails)."""
    def no_library(*_):
        raise AssertionError("loaded the library")

    monkeypatch.setattr(cuda_build, "load", no_library)
    monkeypatch.setattr(pm, "_on_cuda", lambda *_: True)
    t = torch.zeros((2, 64))
    c = torch.ones((3, 4, 2))
    cases = [
        (("fast", t, c), ValueError, "unknown variant"),
        (("full", t.double(), c), TypeError, "float32"),
        (("ps", t, c.half()), TypeError, "float32"),
        (("full", torch.zeros((3, 64)), c), ValueError, r"\(2, M\)"),
        (("full", torch.zeros((2, 0)), c), ValueError, r"M >= 1"),
        (("ps", t, torch.ones((3, 4))), ValueError, r"\(P, K, N\)"),
        (("full", t, torch.ones((9, 4, 2))), ValueError, r"2\.\.8"),
        (("ps", t, torch.ones((1, 4, 2))), ValueError, r"2\.\.8"),
        (("lanered", t, torch.ones((3, 65, 2))), ValueError,
         r"'lanered' kernel takes 1\.\.64"),
        (("ps", t, torch.ones((3, 17, 2))), ValueError,
         r"'ps' kernel takes 1\.\.16"),
        (("full", t, torch.ones((3, 4, 0))), ValueError,
         "N = 0 channels"),
    ]
    for args, err, match in cases:
        with pytest.raises(err, match=match):
            pm.phase2_micro(*args, 128)
    for v in pm.VARIANTS:
        with pytest.raises(AssertionError, match="loaded the library"):
            pm.phase2_micro(v, t, c, 128)


def _c_functions(source: str) -> dict:
    """name -> parameter count of the extern "C" functions of a source."""
    body = source[source.index('extern "C" {'):]
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r"^(?:int|const char\*) (\w+)\("
                                 r"([^)]*)\)", body, re.M | re.S)}


def test_control_and_package_entry_points_are_the_bound_ones(smoke,
                                                            monkeypatch):
    """chip_smoke.Previous binds the control's one launch entry point
    (and nothing else of it), with as many arguments as the control's
    source declares; cuda_build binds the package's entry points with
    their declared argument counts."""
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    class Proc:
        returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(smoke.ctypes, "CDLL", lambda path: Lib())
    prev = smoke.Previous({("p2", 1): Proc()})
    bound = vars(prev.libs["p2", 1])
    assert set(bound) == {"p2_launch"}
    control = _c_functions(smoke.PREVIOUS_SRC["p2"].read_text())
    assert smoke.PREVIOUS_SRC["p2"].parent.name == "phase2_micro_prev"
    assert len(bound["p2_launch"].argtypes) == control["p2_launch"] == 10
    assert ("p2", 1) in smoke.PREVIOUS_BUILDS
    package = _c_functions((cuda_build.CSRC / "phase2_micro.cu").read_text())
    _, sigs = cuda_build._SIGNATURES["phase2_micro"]
    assert set(sigs) == set(package)
    for name, (_, argtypes) in sigs.items():
        assert len(argtypes) == package[name], name


def test_k10_bounds(smoke):
    """K10's bound counts the distinct passes and, the sums being linear
    in q, the projections once a bin (full 0.000209 ms, ps 0.001838, by
    operations, at nfft = 96000, P = 3, K = 12, N = 6 over 48128 bins);
    the K5-section count, every pass a section with its own sums, is
    unchanged (0.003628 and 0.003576)."""
    for v, ms, k5 in (("full", 0.000209, 0.003628),
                      ("noreduce", 0.000209, 0.003628),
                      ("lanered", 0.000209, 0.003628),
                      ("ps", 0.001838, 0.003576)):
        got, by = smoke.bound(f"phase2_{v}", 48128, 6, K=12, P=3)
        assert (round(got, 6), by) == (ms, "operations"), v
        got, by = smoke.bound(f"phase2_{v}", 48128, 6, K=12, P=3,
                              k5_sections=True)
        assert (round(got, 6), by) == (k5, "operations"), v
