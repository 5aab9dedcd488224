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
float32), their taps to 1e-6.  The scipy fits agree to 1e-8.  The
delay-scaled accurate GEQs of ``auxiliary/reverb.py`` design their taps
from the carried RT60s (``load_jax_params``); they too are held to JAX's
x64 design.

F5: the cascade's running products are rescaled by a power of two after
each section (``functional.cascade_prods_scaled``), so a 30-section
1/3-octave GEQ no longer underflows near DC; where the products stayed
normal before, the plain versions of K4f, K4b and K5 keep their bits."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flamo_tpu
from flamo_tpu.auxiliary import eq as jeq
from flamo_tpu.auxiliary import minimize as jmin
from flamo_tpu.auxiliary import reverb as jrev
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu_torch.auxiliary import eq as teq
from flamo_tpu_torch.auxiliary import minimize as tmin
from flamo_tpu_torch.auxiliary import reverb as trev
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params
from flamo_tpu_torch import functional as tfun
from flamo_tpu_torch.examples import e7_geq
from flamo_tpu_torch.models import build_attenuated_fdn
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
    'pallas' response (K4's plain version here) equal to 'xla''s and
    finite at every bin: the cascade's running products are rescaled by
    powers of two after each section, so its 30-section denominator
    product no longer underflows in the lowest bins (ROADMAP, F5)."""
    kw = dict(size=(1,), octave_interval=3, nfft=NFFT, **CPU)
    tx = dsp.parallelAccurateGEQ(**kw)
    tp = dsp.parallelAccurateGEQ(cascade_backend="pallas", **kw)
    tp.assign_value(tx.param.detach())
    assert tx.sos_b.shape[1] == len(tx.center_freq) + 3 <= 64
    assert torch.equal(tx.sos_b, tp.sos_b)
    with torch.no_grad():
        Hx, Hp = tx.response(), tp.response()
    assert bool(torch.isfinite(Hx).all()) and bool(torch.isfinite(Hp).all())
    assert _rel(Hp, Hx) < 1e-5


# ---------------------------------------------------------------------------
# F5: the cascade's running products rescaled by powers of two
# ---------------------------------------------------------------------------
def _old_chain(monkeypatch):
    """The plain versions on the chain before the rescaling: the unscaled
    ``cascade_prods`` in place of ``cascade_prods_scaled``."""
    monkeypatch.setattr(sk, "cascade_prods_scaled", tfun.cascade_prods)
    monkeypatch.setattr(dsp, "cascade_prods_scaled", tfun.cascade_prods)


def _tap_sets():
    """(name, b, a): an octave GEQ's taps (3 channels, 30 dB alias decay),
    the attenuated FDN's GEQ's at its first step and a two-section
    highpass biquad's (2 channels), each (3, K, N) as K4 takes them."""
    gen = torch.Generator().manual_seed(0)
    geq = dsp.parallelGEQ(size=(3,), nfft=NFFT, alias_decay_db=30,
                          generator=gen, **CPU)
    att = build_attenuated_fdn(nfft=NFFT, generator=gen, **CPU)
    att = att.get_core().feedback_loop.feedback.attenuation
    bq = dsp.parallelBiquad(size=(2,), n_sections=2, filter_type="highpass",
                            nfft=NFFT, generator=gen, **CPU)
    with torch.no_grad():
        return [(name, *m.sos_taps(m.map(m.param)))
                for name, m in (("geq", geq), ("attenuated", att),
                                ("biquad", bq))]


def _plain_outputs(b, a):
    """K4f's, K4b's and K5's plain versions on the taps b, a (N channels)
    with seeded operands."""
    N = b.shape[2]
    rng = np.random.default_rng(1)

    def c(*shape):
        return torch.tensor((rng.normal(size=shape) + 1j * rng.normal(
            size=shape)).astype(np.complex64))

    Mb = NFFT // 2 + 1
    g, D, X = c(Mb, N), 0.8 * c(Mb, N) / np.sqrt(2), c(Mb)
    U = torch.tensor(np.linalg.qr(rng.normal(size=(N, N)))[0] * 0.6,
                     dtype=torch.float32)
    bv, cv = (torch.tensor(rng.normal(size=N), dtype=torch.float32)
              for _ in range(2))
    t = torch.tensor(rng.uniform(size=Mb), dtype=torch.float32)
    k5 = sk.fdn_sos_tf_mse_plain(D, b, a, U, bv, cv, X, t, NFFT,
                                 with_dbar=True)
    return [sk.sos_cascade_fwd_plain(b, a, NFFT),
            *sk.sos_cascade_bwd_plain(b, a, g, NFFT), *k5]


def test_f5_rescaled_chain_equals_the_previous_bit_for_bit(monkeypatch):
    """Where the unscaled products stay normal (an octave GEQ, the
    attenuated FDN's GEQ, a zoo biquad), the plain versions of K4f, K4b
    and K5 and the 'xla' route's response and gradient equal those of
    the chain before the rescaling bit for bit."""
    sets = _tap_sets()
    new = [_plain_outputs(b, a) for _, b, a in sets]
    geq = dsp.parallelGEQ(size=(3,), nfft=NFFT, alias_decay_db=30,
                          requires_grad=True, **CPU)

    def xla_route():
        geq.param.grad = None
        H = geq.response()
        torch.sum(torch.abs(H)).backward()
        return [H.detach(), geq.param.grad.clone()]

    new.append(xla_route())
    with monkeypatch.context() as mp:
        _old_chain(mp)
        old = [_plain_outputs(b, a) for _, b, a in sets] + [xla_route()]
    for (name, _, _), got, ref in zip(sets + [("xla route",) * 3], new, old):
        for x, y in zip(got, ref):
            assert (x is None and y is None) or torch.equal(x, y), name


def test_f5_third_octave_finite_and_near_float64(monkeypatch):
    """At nfft = 4096 the 1/3-octave accurate GEQ's unscaled denominator
    product underflows float32 in its lowest bins (~0-80): the previous
    chain gave inf there.  The rescaled chain is finite at every bin and
    within the GEQ bound (5e-3 of the max) of a float64 evaluation of the
    same taps, and equals the previous chain bit for bit wherever its
    products' squared magnitudes stay normal."""
    nfft = 4096
    m = dsp.parallelAccurateGEQ(size=(1,), octave_interval=3, nfft=nfft,
                                **CPU)
    with torch.no_grad():
        b, a = m.sos_taps(None)
        H = m.response()
        ref = dsp._guarded_cascade(b.double(), a.double(), nfft)
    assert bool(torch.isfinite(H).all())
    assert _rel(H.abs(), ref.abs()) < GEQ_VAL_TOL
    pb, pa = tfun.cascade_prods(b, a, nfft)
    old = sk._iir_guard_prods(pb, pa)
    assert not bool(torch.isfinite(old).all())
    normal = torch.abs(pa) > 2.0 ** -63
    assert normal.sum() > 0.8 * len(normal)
    assert torch.equal(H[normal], old[normal])


def test_f5_jax_eps_band_is_pinned():
    """JAX's 1/3-octave accurate GEQ (its own taps, PRNGKey(0)) at nfft
    = 4096 flushes the underflowed product and returns its eps guard in
    bins 0-75, and is inaccurate just above them, where the squared
    magnitude of its unscaled product is not normal; the port, holding
    JAX's taps, differs there on purpose: it is finite and within the GEQ
    bound of a float64 evaluation of those taps at every bin (ROADMAP
    queue 3, pinned with F5's repair).  Where that squared magnitude is
    normal the two agree to the GEQ bound."""
    nfft = 4096
    jm = jdsp.parallelAccurateGEQ(size=(1,), octave_interval=3, nfft=nfft,
                                  key=jax.random.PRNGKey(0))
    jH = np.asarray(jax.jit(lambda m: m.response())(jm))[:, 0]
    band = np.flatnonzero(jH == np.finfo(np.float32).eps)
    np.testing.assert_array_equal(band, np.arange(76))
    tm = dsp.parallelAccurateGEQ(size=(1,), octave_interval=3, nfft=nfft,
                                 **CPU)
    load_jax_params(tm, {".param": np.asarray(jm.param),
                         ".sos_b": np.asarray(jm.sos_b),
                         ".sos_a": np.asarray(jm.sos_a)})
    with torch.no_grad():
        H = tm.response()[:, 0]
        b, a = tm.sos_taps(None)
        ref = dsp._guarded_cascade(b.double(), a.double(), nfft)[:, 0]
    assert bool(torch.isfinite(H).all())
    assert _rel(H.abs(), ref.abs()) < GEQ_VAL_TOL
    assert not np.any(H.numpy()[band] == np.finfo(np.float32).eps)
    normal = (torch.abs(tfun.cascade_prods(b, a, nfft)[1][:, 0])
              > 2.0 ** -63).numpy()
    assert normal.sum() > 0.8 * len(normal) and not normal[band].any()
    assert _rel(H.numpy()[normal], jH[normal]) < GEQ_VAL_TOL


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


# ---------------------------------------------------------------------------
# the delay-scaled accurate GEQs of auxiliary/reverb.py
# ---------------------------------------------------------------------------
FDN_DELAYS = (179, 251)
VAL_TOL = 1e-5


def _jax_params(model) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(model)}


def _accurate_pair(grouped: bool, backend: str = "xla"):
    """(JAX module, the port's module holding JAX's RT60s and designing
    its own taps through load_jax_params), two delay lines."""
    flamo_tpu.set_seed(4)
    common = dict(nfft=NFFT, fs=48000, delays=FDN_DELAYS,
                  alias_decay_db=30.0)
    if grouped:
        jm = jrev.parallelGFDNAccurateGEQ(n_groups=2, **common)
        tm = trev.parallelGFDNAccurateGEQ(n_groups=2, cascade_backend=backend,
                                          **common, **CPU)
    else:
        jm = jrev.parallelFDNAccurateGEQ(**common)
        tm = trev.parallelFDNAccurateGEQ(cascade_backend=backend, **common,
                                         **CPU)
    assert set(jax_named_tensors(tm)) == {".param"}
    load_jax_params(tm, _jax_params(jm))
    return jm, tm


def _jax_x64_taps(rt, delays):
    """JAX's accurate design in float64 (x64 on) of the dB targets of
    RT60s ``rt`` (G K,) on delay lines ``delays``, (3, G (K + 1), N)."""
    center, shelving = jeq.eq_freqs(interval=1)
    target = (np.asarray(jrev.rt2slope(rt, 48000))[:, None]
              * np.asarray(delays)[None, :])
    K = len(center) + 2
    taps = []
    with jax.enable_x64(True):
        for i in range(target.shape[1]):
            line = [jeq.accurate_geq(target[g * K:(g + 1) * K, i],
                                     np.asarray(center, np.float64),
                                     np.asarray(shelving, np.float64),
                                     dtype=jnp.float32)
                    for g in range(target.shape[0] // K)]
            taps.append([np.concatenate([np.asarray(d[j]) for d in line], 1)
                         for j in (0, 1)])
    return tuple(np.stack([t[j] for t in taps], -1) for j in (0, 1))


@pytest.mark.parametrize("grouped", [False, True])
def test_accurate_attenuation_matches_jax(grouped):
    """The taps (the port's design of JAX's RT60s) against JAX's x64
    design; the response against JAX's module holding that design, at the
    GEQ bound, on both cascade routes ('pallas': K4's plain version); the
    probe; assign_value designing again in place."""
    jm, tm = _accurate_pair(grouped)
    assert not tm.trainable and tm.input_channels == 2
    K = len(tm.center_freq) + 2
    sections = (2 if grouped else 1) * (K + 1)
    assert tuple(tm.sos_b.shape) == tuple(jm.sos_b.shape) == (3, sections, 2)
    bj, aj = _jax_x64_taps(np.asarray(jm.param), tm.delays)
    assert _rel(tm.sos_b, bj) < TAP_TOL and _rel(tm.sos_a, aj) < TAP_TOL
    jm.sos_b, jm.sos_a = jnp.asarray(bj), jnp.asarray(aj)
    z = np.exp(1j * 0.21)
    jH, jP = jax.jit(lambda m: (m.response(), m.probe(z)))(jm)
    with torch.no_grad():
        H = tm.response()
    assert _rel(H, jH) < GEQ_VAL_TOL
    _, tp = _accurate_pair(grouped, backend="pallas")
    with torch.no_grad():
        assert _rel(tp.response(), H) < VAL_TOL
    assert _rel(tm.probe(torch.tensor(z)), jP) < GEQ_VAL_TOL
    ptr = tm.sos_b.data_ptr()
    tm.assign_value(torch.full(tm.size, 0.9))
    assert tm.sos_b.data_ptr() == ptr
    bj, _ = _jax_x64_taps(np.full(tm.size, 0.9, np.float32), tm.delays)
    assert _rel(tm.sos_b, bj) < TAP_TOL
