"""Velvet noise and the scattering helpers against flamo_tpu on the CPU:
``VelvetNoiseFilter`` (the response from JAX's draws, the structure of a
fresh draw, ``resample`` in place), ``VelvetNoiseMatrix`` (from JAX's
shifts, not trainable, its size checks, K6's channel limit on
'pallas'), a velvet scattering loop on 'pallas' (K6's plain version)
against 'ge', the scattering helpers ``hadamard_matrix``,
``shift_mat_distribute``, ``poly_matrix_conv`` and
``cascaded_paraunit_matrix``, and the e1_vn example.

The port draws from ``torch.Generator``s, another PRNG than JAX's: its
own draws are held to their structure, and JAX's draws are carried over
(``load_jax_params``, ``load_jax_scattering``) to hold the responses.
Tolerances: the velvet filter's response 1e-6 of the max (an rfft of
+-1 taps), the velvet matrix's 1e-5 (products of Hadamard stages), the
polynomial products 1e-5, the 'pallas' loop against 'ge' 1e-5; the
velvet matrix's probe 1e-4 (complex64 powers z^-k of taps k in the
thousands, rounded differently by the two libraries)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.auxiliary import scattering as jsc
from flamo_tpu.auxiliary.velvet import VelvetNoiseFilter as JVelvet
from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.auxiliary import scattering as tsc
from flamo_tpu_torch.auxiliary.velvet import VelvetNoiseFilter
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_params, \
    load_jax_scattering
from flamo_tpu_torch.examples import e1_vn
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.processor import dsp, system

NFFT = 1024
CPU = dict(device="cpu")
VELVET_TOL = 1e-6
MATRIX_TOL = 1e-5
PROBE_TOL = 1e-4


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("alias", [0.0, 20.0])
def test_velvet_filter_response_from_jax_draws(alias):
    jv = JVelvet(size=(512, 2, 3), density=2000.0, delta=0.5, nfft=NFFT,
                 alias_decay_db=alias, key=jax.random.PRNGKey(7))
    tv = VelvetNoiseFilter(size=(512, 2, 3), density=2000.0, delta=0.5,
                           nfft=NFFT, alias_decay_db=alias, **CPU)
    jshell = jsystem.Shell(core=jv, input_layer=jdsp.FFT(NFFT))
    params = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jshell)[0]}
    assert set(params) == {".core.param", ".core.key"}
    tshell = system.Shell(core=tv, input_layer=dsp.FFT(NFFT))
    load_jax_params(tshell, params)  # the PRNG key has no counterpart
    assert set(jax_named_tensors(tshell)) == {".core.param"}
    with torch.no_grad():
        H = tv.response()
    assert _rel(H, jv.response()) < VELVET_TOL


def _check_velvet_structure(v: VelvetNoiseFilter):
    """One impulse a grid cell, the first at 0, signs +-1."""
    seq = v.param.detach().reshape(v.size[0], -1).T  # (pairs, T)
    for row in seq:
        idx = torch.nonzero(row).flatten()
        assert len(idx) == v.floor_impulses and int(idx[0]) == 0
        assert set(row[idx].tolist()) <= {-1.0, 1.0}
        cells = torch.floor(idx.double() / v.Td)
        assert torch.equal(cells, torch.arange(v.floor_impulses,
                                               dtype=torch.float64))


def test_velvet_filter_fresh_draw_and_resample():
    g = torch.Generator().manual_seed(3)
    v = VelvetNoiseFilter(size=(960, 2, 2), density=1000.0, nfft=NFFT,
                          generator=g, **CPU)
    assert not v.trainable and v.floor_impulses == 20
    _check_velvet_structure(v)
    signs = v.param[v.param != 0]
    assert (signs > 0).any() and (signs < 0).any()
    twin = VelvetNoiseFilter(size=(960, 2, 2), density=1000.0, nfft=NFFT,
                             generator=torch.Generator().manual_seed(3),
                             **CPU)
    assert torch.equal(v.param, twin.param)
    before = v.param.detach().clone()
    ptr = v.param.data_ptr()
    assert v.resample(torch.Generator().manual_seed(4)) is v
    assert v.param.data_ptr() == ptr and not torch.equal(v.param, before)
    _check_velvet_structure(v)
    with pytest.raises(ValueError, match="Delta"):
        VelvetNoiseFilter(size=(64, 1, 1), delta=0.0, **CPU)


def _velvet_matrix_pair(size=(3, 4, 4), alias=0.0):
    jm = jdsp.VelvetNoiseMatrix(size=size, nfft=NFFT, density=0.1,
                                alias_decay_db=alias,
                                key=jax.random.PRNGKey(11))
    tm = dsp.VelvetNoiseMatrix(size=size, nfft=NFFT, density=0.1,
                               alias_decay_db=alias, **CPU)
    mf = jm.map_filter
    load_jax_scattering(tm, mf.shifts, mf.m_L, mf.m_R)
    load_jax_params(tm, {".param": np.asarray(jm.param)})
    return jm, tm


@pytest.mark.parametrize("alias", [0.0, 30.0])
def test_velvet_matrix_matches_jax(alias):
    jm, tm = _velvet_matrix_pair(alias=alias)
    assert not tm.trainable
    H = np.asarray(jnp.asarray(jm.param))
    assert np.array_equal(tm.param.numpy(), H)
    with torch.no_grad():
        assert _rel(tm.response(), jm.response()) < MATRIX_TOL
        kind, Hm = tm.matrix_response()
    assert kind == "full" and Hm.shape == (NFFT // 2 + 1, 4, 4)
    # the probe sums gamma^k z^-k over taps up to k ~ 2300, whose complex64
    # powers the two libraries round differently (2e-5 of the max)
    z = np.exp(1j * 0.7)
    assert _rel(tm.probe(torch.tensor(z)), jm.probe(jnp.asarray(z))) \
        < PROBE_TOL
    with pytest.raises(AssertionError, match="powers of 2"):
        dsp.VelvetNoiseMatrix(size=(4, 6, 6), **CPU)
    with pytest.raises(AssertionError, match="square"):
        dsp.VelvetNoiseMatrix(size=(4, 8, 4), **CPU)


def test_velvet_matrix_own_shifts_do_not_overlap():
    tm = dsp.VelvetNoiseMatrix(size=(3, 4, 4), nfft=NFFT, density=0.25,
                               generator=torch.Generator().manual_seed(1),
                               **CPU)
    sparsity = tm.map_filter.sparsity
    first = np.asarray(tm.map_filter.shifts[0])
    n = np.arange(4)
    assert np.all(first >= sparsity * n)
    assert np.all(first <= np.floor(sparsity * (n + 0.99)))
    assert len(set(first.tolist())) == 4


def _velvet_loop(solve_method: str, N: int = 8, stages: int = 4):
    delays = dsp.parallelDelay(size=(N,), max_len=400, isint=True,
                               nfft=NFFT, generator=torch.Generator()
                               .manual_seed(2), **CPU)
    vm = dsp.VelvetNoiseMatrix(size=(stages, N, N), nfft=NFFT, density=0.1,
                               generator=torch.Generator().manual_seed(3),
                               **CPU)
    return system.Recursion(fF=delays, fB=vm, solve_method=solve_method)


def test_velvet_loop_pallas_matches_ge_and_names_k6_limit():
    X = torch.fft.rfft(torch.randn((1, NFFT, 8), generator=torch.Generator()
                                   .manual_seed(5)), dim=1)
    with torch.no_grad():
        yp = _velvet_loop("pallas")(X)
        yg = _velvet_loop("ge")(X)
    assert _rel(yp, yg) < 1e-5
    # past 16 channels the CPU takes K6's plain version too (on the card,
    # K6 looped), up to the looped kernel's limit, which the wrapper names
    X32 = torch.fft.rfft(torch.randn((1, NFFT, 32), generator=torch.Generator()
                                     .manual_seed(6)), dim=1)
    with torch.no_grad():
        yp = _velvet_loop("pallas", N=32, stages=2)(X32)
        yg = _velvet_loop("ge", N=32, stages=2)(X32)
    assert _rel(yp, yg) < 1e-5
    top = fk.LOOP_MAX_N["dense_solve"]
    with pytest.raises(ValueError, match=f"N = {top + 1} channels; the "
                       rf"looped kernel K6 \(dense_solve\) takes 1..{top}"):
        fk.check_loop_n("dense_solve", top + 1)


def test_hadamard_and_shift_distribution():
    for N in (1, 2, 4, 8, 5):
        H = tsc.hadamard_matrix(N)
        assert np.array_equal(H, jsc.hadamard_matrix(N))
        np.testing.assert_allclose(H @ H.T, np.eye(H.shape[0]), atol=1e-12)
    X = np.zeros((6, 6))
    s = tsc.shift_mat_distribute(X, sparsity=3, pulse_size=2,
                                 generator=torch.Generator().manual_seed(0))
    sj = jsc.shift_mat_distribute(X, sparsity=3, pulse_size=2,
                                  key=jax.random.PRNGKey(0))
    n = np.arange(6)
    for shifts in (s, sj):  # both draws in their cells, never overlapping
        assert shifts.dtype == np.int64 and shifts.shape == (6,)
        assert np.all(shifts >= 2 * 3 * n)
        assert np.all(shifts <= 2 * np.floor(3 * (n + 0.99)))
        assert np.all(np.diff(shifts) > 0)


def test_poly_matrix_conv_matches_jax_and_direct_product():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(3, 2, 5)).astype(np.float32)
    B = rng.normal(size=(2, 4, 7)).astype(np.float32)
    C = tsc.poly_matrix_conv(torch.tensor(A), torch.tensor(B))
    assert C.shape == (3, 4, 11)
    assert _rel(C, jsc.poly_matrix_conv(A, B)) < MATRIX_TOL
    direct = np.zeros((3, 4, 11))
    for i in range(3):
        for j in range(4):
            for k in range(2):
                direct[i, j] += np.convolve(A[i, k], B[k, j])
    assert _rel(C, direct) < MATRIX_TOL
    C2 = tsc.poly_matrix_conv(torch.tensor(A[:, :, 0]), torch.tensor(B))
    assert _rel(C2, np.einsum("ik,kjt->ijt", A[:, :, 0], B)) < MATRIX_TOL
    with pytest.raises(ValueError, match="dimension"):
        tsc.poly_matrix_conv(torch.tensor(A), torch.tensor(A))


def test_cascaded_paraunit_matrix_matches_jax():
    rng = np.random.default_rng(8)
    U = np.stack([np.linalg.qr(rng.normal(size=(4, 4)))[0]
                  for _ in range(4)]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    Vj = np.asarray(jsc.cascaded_paraunit_matrix(jnp.asarray(U), n_stages=3,
                                                 key=key))
    jmap = jsc.ScatteringMapping(4, n_stages=3, key=key)
    tmap = tsc.ScatteringMapping(4, n_stages=3)
    tmap.shifts = jmap.shifts
    V = tsc.to_complex(tmap(torch.tensor(U)))
    assert _rel(V, Vj) < MATRIX_TOL
    # the port's own draw: its mapping of the same generator, complex
    Vt = tsc.cascaded_paraunit_matrix(
        torch.tensor(U), n_stages=3,
        generator=torch.Generator().manual_seed(1))
    twin = tsc.ScatteringMapping(4, n_stages=3,
                                 generator=torch.Generator().manual_seed(1))
    assert Vt.is_complex() and torch.equal(Vt.real, twin(torch.tensor(U)))
    # lossless (gain 1 a sample), the matrix is paraunitary: its lag-0
    # autocorrelation sum_t V(t) V(t)^T is the identity
    V1 = tsc.cascaded_paraunit_matrix(
        torch.tensor(U), n_stages=3, gain_per_sample=1.0,
        generator=torch.Generator().manual_seed(1)).real
    E = torch.einsum("tij,tkj->ik", V1, V1)
    assert torch.allclose(E, torch.eye(4), atol=1e-5)


def test_e1_vn_main(tmp_path):
    args = e1_vn.example_parser(nfft=2048).parse_args(
        ["--device", "cpu", "--train_dir", str(tmp_path)])
    y, y2 = e1_vn.main(args)
    assert y.shape == (1, 2048, 1) and not torch.equal(y, y2)
