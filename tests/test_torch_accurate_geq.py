"""The accurate GEQ against flamo_tpu on the CPU: ``accurate_geq``, the
L-BFGS helpers of ``auxiliary/minimize.py``, ``AccurateGEQ`` and
``parallelAccurateGEQ`` (responses, both cascade routes, probes, matrix
responses, the design re-run by ``assign_value``), and the e7_geq
example.

The port designs in float64 on the host; the JAX package designs the
same way only with x64 enabled (in its default float32 mode its 10 dB
prototype bank is rounded to float32, which moves the command gains by
~3e-3 of the max), so its design is taken under ``jax.enable_x64``, where
the two agree to 1e-6 of the max (bit for bit on the CPU).  The
modules' responses are held at the JAX package's GEQ bounds (5e-3 of the
max on values: a 12-section cascade is ill-conditioned near DC in
float32), their taps to 1e-6.  The scipy fits agree to 1e-8."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.auxiliary import eq as jeq
from flamo_tpu.auxiliary import minimize as jmin
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch.auxiliary import eq as teq
from flamo_tpu_torch.auxiliary import minimize as tmin
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch.examples import e7_geq
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.processor import dsp

NFFT = 512
TAP_TOL = 1e-6
GEQ_VAL_TOL = 5e-3
FIT_TOL = 1e-8
CPU = dict(device="cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_design(target_db):
    """JAX's accurate design in float64 (x64 on), as numpy."""
    center, shelving = jeq.eq_freqs(interval=1)
    with jax.enable_x64(True):
        b, a = jeq.accurate_geq(target_db, np.asarray(center, np.float64),
                                np.asarray(shelving, np.float64),
                                dtype=jnp.float32)
        return np.asarray(b), np.asarray(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accurate_geq_matches_jax(seed):
    center, shelving = teq.eq_freqs(interval=1)
    target = np.random.default_rng(seed).uniform(-12, 12, len(center) + 2)
    b, a = teq.accurate_geq(target, center.numpy(), shelving.numpy())
    bj, aj = _jax_design(target)
    assert b.dtype == torch.float32 and b.shape == (3, len(center) + 3)
    assert _rel(b, bj) < TAP_TOL and _rel(a, aj) < TAP_TOL
    with pytest.raises(AssertionError, match="center frequencies"):
        teq.accurate_geq(target[:-1], center.numpy(), shelving.numpy())


def test_third_octave_module_fits_k4():
    """The 1/3-octave module: 30 sections (K4 takes at most 64), its
    'pallas' response (K4's plain version here) equal to 'xla''s.  In
    float32 its 30-section denominator product underflows in the lowest
    bins (ROADMAP queue 3, F5): both routes are non-finite at the same
    bins, and are compared where they are finite."""
    kw = dict(size=(1,), octave_interval=3, nfft=NFFT, **CPU)
    tx = dsp.parallelAccurateGEQ(**kw)
    tp = dsp.parallelAccurateGEQ(cascade_backend="pallas", **kw)
    tp.assign_value(tx.param.detach())
    assert tx.sos_b.shape[1] == len(tx.center_freq) + 3 <= 64
    assert torch.equal(tx.sos_b, tp.sos_b)
    with torch.no_grad():
        Hx, Hp = tx.response(), tp.response()
    finite = torch.isfinite(Hx)
    assert torch.equal(finite, torch.isfinite(Hp)) and finite.sum() > 200
    assert _rel(Hp[finite], Hx[finite]) < 1e-5


def test_mls_and_minimize_lbfgs_match_jax():
    rng = np.random.default_rng(4)
    G = rng.normal(size=(40, 6))
    y = rng.normal(size=40)
    x = rng.normal(size=6)
    ours, ref = tmin.MLS(G, y), jmin.MLS(G, y)
    assert abs(ours(x) - ref(x)) <= FIT_TOL * abs(ref(x))
    np.testing.assert_allclose(ours.grad(x), ref.grad(x), rtol=FIT_TOL)
    lo, hi = -np.full(6, 0.5), np.full(6, 0.5)
    got = tmin.minimize_LBFGS(G, y, lo, hi, num_freq=5)
    want = jmin.minimize_LBFGS(G, y, lo, hi, num_freq=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_TOL)
    assert np.all(got >= lo) and np.all(got <= hi)
    with pytest.raises(AssertionError, match="number of bounds"):
        tmin.minimize_LBFGS(G, y, lo[:-1], hi, num_freq=5)


def _pair(parallel: bool, alias: float = 0.0, backend: str = "xla"):
    """(JAX module, the port's module holding its weights: param, sos_b
    and sos_a carried)."""
    if parallel:
        jm = jdsp.parallelAccurateGEQ(size=(3,), nfft=NFFT,
                                      alias_decay_db=alias,
                                      key=jax.random.PRNGKey(5))
        tm = dsp.parallelAccurateGEQ(size=(3,), nfft=NFFT,
                                     alias_decay_db=alias,
                                     cascade_backend=backend, **CPU)
    else:
        jm = jdsp.AccurateGEQ(size=(2, 2), nfft=NFFT, alias_decay_db=alias,
                              key=jax.random.PRNGKey(5))
        tm = dsp.AccurateGEQ(size=(2, 2), nfft=NFFT, alias_decay_db=alias,
                             cascade_backend=backend, **CPU)
    load_jax_params(tm, {".param": np.asarray(jm.param),
                         ".sos_b": np.asarray(jm.sos_b),
                         ".sos_a": np.asarray(jm.sos_a)})
    return jm, tm


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("alias", [0.0, 30.0])
def test_module_response_matches_jax(parallel, alias):
    jm, tm = _pair(parallel, alias)
    assert set(jax_named_tensors(tm)) == {".param", ".sos_b", ".sos_a"}
    assert not tm.trainable and not tm.sos_b.requires_grad
    with torch.no_grad():
        H = tm.response()
    assert _rel(H, jm.response()) < GEQ_VAL_TOL
    kind, Hm = tm.matrix_response()
    jkind, _ = jm.matrix_response()
    assert kind == jkind == ("diag" if parallel else "full")
    assert torch.equal(Hm, H)
    z = np.exp(1j * 0.3)
    assert _rel(tm.probe(torch.tensor(z)), jm.probe(jnp.asarray(z))) \
        < GEQ_VAL_TOL
    # the response of the port's own design of JAX's gains: JAX's x64
    # design, tap for tap
    tm.assign_value(torch.tensor(np.asarray(jm.param)))
    target = np.asarray(20 * np.log10(np.abs(np.asarray(jm.param))))
    flat = target.reshape(target.shape[0], -1)
    bj = np.stack([_jax_design(flat[:, i])[0] for i in
                   range(flat.shape[1])], -1).reshape(tm.sos_b.shape)
    assert _rel(tm.sos_b, bj) < TAP_TOL


@pytest.mark.parametrize("parallel", [False, True])
def test_pallas_route_and_probe(parallel):
    """'pallas' (K4's plain version on the CPU, one launch-free call of
    its wrapper) against 'xla'; the probe on the rfft grid against the
    response; the forward through the module."""
    _, tx = _pair(parallel)
    _, tp = _pair(parallel, backend="pallas")
    calls = []
    real = sk.sos_cascade
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dsp, "sos_cascade",
                   lambda *a: calls.append(1) or real(*a))
        with torch.no_grad():
            Hp = tp.response()
    assert len(calls) == 1
    with torch.no_grad():
        Hx = tx.response()
        H3, B, A = tx.get_poly_coeff()  # JAX's three returns
    assert _rel(Hp, Hx) < 1e-5
    assert torch.equal(H3, Hx)
    assert B.shape == A.shape == (NFFT // 2 + 1,) + tuple(tx.sos_b.shape[1:])
    w = 2 * np.pi * 37 / NFFT
    assert _rel(tx.probe(torch.tensor(np.exp(1j * w))),
                (torch.diag(Hx[37]) if parallel else Hx[37])) < 1e-4
    x = torch.randn((1, NFFT // 2 + 1, 3 if parallel else 2),
                    dtype=torch.complex64)
    y = tx(x)
    ref = Hx[None] * x if parallel else torch.einsum("fmn,bfn->bfm", Hx, x)
    assert torch.allclose(y, ref)


def test_assign_value_reruns_the_design_in_place():
    tm = dsp.AccurateGEQ(size=(1, 1), nfft=NFFT, **CPU)
    before = tm.sos_b.clone()
    ptr = tm.sos_b.data_ptr()
    gains = torch.full(tm.size, 10 ** (3 / 20))
    assert tm.assign_value(gains) is tm
    assert tm.sos_b.data_ptr() == ptr and not torch.equal(tm.sos_b, before)
    b, a = teq.accurate_geq(np.full(tm.size[0], 3.0), tm.center_freq,
                            tm.shelving_crossover)
    assert torch.equal(tm.sos_b[..., 0, 0], b)
    assert torch.equal(tm.sos_a[..., 0, 0], a)
    with pytest.raises(AssertionError, match="3D"):
        dsp.AccurateGEQ(size=(2,), nfft=NFFT, **CPU)
    with pytest.raises(AssertionError, match="2D"):
        dsp.parallelAccurateGEQ(size=(2, 2), nfft=NFFT, **CPU)
    with pytest.raises(ValueError, match="cascade_backend"):
        dsp.AccurateGEQ(size=(1, 1), cascade_backend="cuda", **CPU)


def test_e7_geq_accurate_scenarios_meet_their_gate(tmp_path):
    args = e7_geq.parser().parse_args(["--nfft", "1024", "--device", "cpu",
                                       "--train_dir", str(tmp_path)])
    for parallel in (False, True):
        for backend in ("xla", "pallas"):
            filt, target, _, _ = e7_geq.scenario_accurate(
                args, torch.device("cpu"), parallel,
                cascade_backend=backend)
            err, rng, _ = e7_geq.accurate_error(filt, target)
            assert err < e7_geq.ACCURATE_TOL * max(rng, 1.0)
