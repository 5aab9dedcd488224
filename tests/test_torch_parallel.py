"""The port's multi-device layer (``flamo_tpu_torch.parallel``) on gloo
ranks on the CPU.

Two groups run ``flamo_tpu_torch.scripts.shard_smoke``'s families, each
once a module: two ranks for the colorless FDN's K1 step,
``bin_sharded_forward``, ``shard_spectrum`` and the data-parallel step,
the attenuated FDN (K5), the active-acoustics magnitude (K9) and
eigenvalue (K7) steps, the scattering FDN's masked step (K6 on 'pallas')
and the multi-seed ensemble; four ranks for the seed x bins step.  Three
more groups run ``torch_rank_workers``: a raising rank, hung ranks and the
mesh helpers.  A group has DEADLINE seconds, so a rank that raises or
hangs fails its test, not the run.

Each sharded step runs in lockstep with the port's unsharded step of the
same model (the unsharded steps are pinned to JAX's by the other test
files), at the JAX package's tolerances (tests/test_parallel.py): loss
1e-5 relative (the eigenvalue step 1e-4), parameters and the first
step's gradients 1e-5 of the max on K1 and 1e-4 on K5, K9 and K7,
allclose(1e-4, 1e-6) for the data-parallel and masked steps, the forward
1e-5 of the max, and parameters identical across ranks.  K5 and K9 make
their phasor from the bin index, so rank 1 passes a nonzero
``bin_offset``.  The colorless models carry JAX's weights, the
eigenvalue step walks JAX's partitions and the masked step JAX's masks,
at the sizes of the JAX package's tests; the port is also held to JAX's
own data-parallel step and sharded forward.  The kernels' wrappers run
their plain versions on CPU tensors, so no launch is counted here.
"""

from __future__ import annotations

import copy
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flamo_tpu
import flamo_tpu.parallel as JP
from flamo_tpu.models import build_colorless_fdn as jax_build_colorless
from flamo_tpu.optimize.loss import masked_mse_loss as jax_masked_mse
from flamo_tpu.optimize.utils import generate_partitions as jax_partitions
from flamo_tpu_torch import parallel as P
from flamo_tpu_torch.models import (build_colorless_fdn,
                                    build_colorless_sfdn, colorless_loss,
                                    sfdn_masked_loss)
from flamo_tpu_torch.parallel import MultiSeedEnsemble
from flamo_tpu_torch.parallel.launch import RankError, spawn
from flamo_tpu_torch.scripts import shard_smoke as S

import chip_smoke
import torch_rank_workers as W

DEADLINE = 60  # seconds a group may take, start-up included
NFFT = 2048
M = NFFT // 2 + 1
BLOCK = math.ceil(M / 2)
DELAYS = (89, 97, 107, 113, 127, 131)


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_model():
    flamo_tpu.set_seed(11)
    return jax_build_colorless(nfft=NFFT, delays=DELAYS)


@pytest.fixture(scope="module")
def cfg(jax_model) -> dict:
    """shard_smoke's configuration at the JAX tests' small sizes: the
    active-acoustics rigs of tests/test_parallel.py:360-497 (2 x 3 and 3
    x 4, 8-tap mixers), JAX's partitions (iter_num 4) and JAX's first
    cycle of 100-bin masks."""
    parts = jax_partitions(jnp.arange(M), math.ceil(M / 4), 1,
                           key=jax.random.PRNGKey(7))
    masks = jax_masked_mse(nfft=NFFT, n_samples=100, n_sets=1,
                           regenerate_mask=True,
                           key=jax.random.PRNGKey(9)).masks_for_cycle(0)
    return {**S.FULL, "nfft": NFFT, "device": "cpu", "time_steps": 0,
            "delays": DELAYS, "params": _keyed(jax_model), "arrays": True,
            "aa": dict(n_mics=2, n_loudspeakers=3, rir_length=64,
                       fir_order=8, t60=0.5),
            "evs": dict(n_M=3, n_L=4, FIR_order=8, rir_length=128,
                        wgn_RT=0.3, room_t60=0.2, iter_num=4, target=0.3,
                        gain=None, masks=np.asarray(parts)),
            "sfdn": dict(n_samples=100, solve_method="pallas",
                         masks=np.asarray(masks))}


@pytest.fixture(scope="module")
def two(cfg) -> list:
    ranks = spawn(S.run_families, 2, "gloo", S.TWO_RANK_FAMILIES, cfg,
                  timeout_s=DEADLINE, threads=2)
    S.check_families(ranks, cfg, on_card=False)
    return ranks


@pytest.fixture(scope="module")
def four(cfg) -> list:
    ranks = spawn(S.run_families, 4, "gloo", ("seed_bins",), cfg,
                  timeout_s=DEADLINE, threads=1)
    S.check_families(ranks, cfg, on_card=False)
    return ranks


def _lockstep(ranks, fam: str, count: int = BLOCK):
    """Lockstep within the family's gates, identical replicas, each
    rank's block, the same losses on every rank."""
    for rank, r in enumerate(ranks):
        assert r["loss_rel"] < S.LOSS_TOL.get(fam, 1e-5)
        assert r["spread"] == 0.0
        assert tuple(r["block"]) == (rank * count, count)
        assert r["losses"] == ranks[0]["losses"]
        assert np.isfinite(r["losses"]).all()
        if fam in S.ALLCLOSE:
            assert r["allclose_ratio"] <= 1.0
        else:
            assert r["param_gap"] < S.PARAM_TOL[fam]
            assert r["grad_gap"] < S.PARAM_TOL[fam]


def test_sharded_fused_step_lockstep(two):
    fused = [r["colorless"]["fused"] for r in two]
    _lockstep(fused, "colorless")
    assert fused[0]["losses"][-1] < fused[0]["losses"][0]


def test_bin_sharded_forward_matches_unsharded_and_jax(two, jax_model):
    x = jnp.zeros((1, NFFT, 1)).at[:, 0, :].set(1.0)
    y_jax = np.asarray(jax.jit(JP.bin_sharded_forward(
        jax_model, JP.get_mesh(2, "bins")))(x))
    for r in two:
        f = r["colorless"]["forward"]
        assert f["rel"] < S.FORWARD_TOL
        assert f["spectrum_equal"]
        assert np.abs(f["y"] - y_jax).max() < 1e-5 * np.abs(y_jax).max()


def test_dp_step_matches_single_process_and_jax(two, jax_model):
    """tests/test_parallel.py:82-128 on a 2-device 'batch' mesh and a
    batch of 4, from the same weights."""
    B = S.FULL["dp_batch"]
    x = jnp.zeros((B, M, 1)).at[:, 0, :].set(1.0)
    t = jnp.ones((B, M, 1)) * jnp.linspace(0.8, 1.2, B)[:, None, None]
    mesh = JP.get_mesh(2, "batch")
    tx = optax.adam(1e-2)
    step = JP.make_dp_train_step(
        lambda m, x, t: jnp.mean((m(x) - t) ** 2), tx, mesh, "batch")
    xs, ts = JP.shard_batch((x, t), mesh, "batch")
    m, o, losses = jax_model, tx.init(jax_model), []
    for _ in range(3):
        m, o, loss = step(m, o, xs, ts)
        losses.append(float(loss))
    want = _keyed(m)
    dp = [r["colorless"]["dp"] for r in two]
    _lockstep(dp, "dp", count=B // 2)
    for d in dp:
        np.testing.assert_allclose(d["losses"], losses, rtol=1e-5)
        for key, value in d["params"].items():
            np.testing.assert_allclose(value, want[key], rtol=1e-4,
                                       atol=1e-6)


def test_dp_rejects_a_ragged_batch(two):
    for r in two:
        assert "not divisible by mesh axis 'batch' of size 2" in \
            r["colorless"]["dp"]["ragged"]


def test_sharded_attenuated_step_lockstep(two):
    """K5 with the octave GEQ in its loop; rank 1 at bin_offset 513."""
    att = [r["attenuated"] for r in two]
    _lockstep(att, "attenuated")
    assert att[1]["block"][0] == 513
    assert att[0]["losses"][-1] < att[0]["losses"][0]


def test_sharded_aa_taps_step_lockstep(two):
    """K9 'high' on the 2 x 3 rig; rank 1 at bin_offset 513."""
    _lockstep([r["aa_taps"] for r in two], "aa_taps")


def test_sharded_evs_step_lockstep_on_jax_partitions(two, cfg):
    evs = [r["evs"] for r in two]
    parts = cfg["evs"]["masks"]
    _lockstep(evs, "evs", count=math.ceil(parts.shape[1] / 2))
    assert evs[0]["partitions"] == list(parts.shape)


def test_sharded_evs_multi_continues_the_schedule(two):
    """``step.multi(3, 2)`` takes partitions 3 and 4 mod n after the
    lockstep's three, as the unsharded step does."""
    for r in two:
        m = r["evs"]["multi"]
        assert len(m["losses"]) == 2
        assert m["loss_rel"] < S.LOSS_TOL["evs"]
        assert m["losses"] == two[0]["evs"]["multi"]["losses"]


def test_masked_sharded_sfdn_lockstep_on_jax_masks(two):
    """tests/test_parallel.py:500-535: 100-bin masks (JAX's first cycle),
    the solve on 'pallas' (K6's plain version here)."""
    _lockstep([r["masked"] for r in two], "masked", count=50)


def test_seed_bins_step_lockstep(four):
    """Two members on a 2 x 2 seed x bins mesh: each against its own
    unsharded fused step; every rank reports both members' losses."""
    for rank, r in enumerate(four):
        s = r["seed_bins"]
        assert s["member"] == rank // 2
        assert s["loss_rel"] < 1e-5 and s["param_gap"] < 1e-5
        assert s["grad_gap"] < 1e-5 and s["spread"] == 0.0
        assert tuple(s["block"]) == ((rank % 2) * BLOCK, BLOCK)
        assert s["all_members"] == four[0]["seed_bins"]["all_members"]
        got = [v[s["member"]] for v in s["all_members"]]
        np.testing.assert_allclose(got, s["ref"], rtol=1e-5)
    assert four[0]["seed_bins"]["losses"] != four[2]["seed_bins"]["losses"]


def test_ensemble_on_a_seed_mesh_matches_single_runs(two):
    """tests/test_parallel.py:58-79: four seeds, ten steps, two ranks of
    two members each; each member against its run alone."""
    losses = np.asarray(two[0]["ensemble"]["losses"])
    assert losses.shape == (10, 4)
    assert losses[-1].mean() < losses[0].mean()
    for rank, r in enumerate(two):
        e = r["ensemble"]
        assert e["first"] == 2 * rank
        np.testing.assert_array_equal(e["losses"], losses)
        assert max(e["member_rel"]) < S.ENSEMBLE_TOL
        assert max(e["member_gap"]) < S.ENSEMBLE_TOL
        assert e["best_finite"]
        assert e["best_index"] == int(np.argmin(losses[-1]))


def test_ensemble_member_loop_equals_vmap():
    """Without a mesh: the members one after another (``vmap=False``, the
    route of a loss that reaches a hand kernel) against ``vmap``."""
    def model_fn(g):
        return build_colorless_fdn(nfft=256, delays=DELAYS[:4],
                                   device="cpu", generator=g)

    x = torch.zeros((1, 256, 1))
    x[:, 0] = 1.0
    t = torch.ones((1, 129, 1))
    runs = []
    for vmap in (True, False):
        ens = MultiSeedEnsemble(model_fn, 3, base_seed=4, vmap=vmap)
        runs.append((ens, ens.fit(colorless_loss, x, t, n_steps=5, lr=1e-2)))
    (ev, lv), (el, ll) = runs
    assert lv.shape == (5, 3)
    assert float((lv - ll).abs().max() / ll.abs().max()) < 1e-5
    for a, b in zip(ev.model_at(1).parameters(), el.model_at(1).parameters()):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    best = int(torch.argmin(ll[-1]))
    assert ev.best_model() is ev.members[best]
    with pytest.raises(RuntimeError, match="fit"):
        MultiSeedEnsemble(model_fn, 2).best_model()


def test_chip_smoke_phase_4k_report(two, four, cfg, capsys):
    """chip_smoke.py's phase 4k on the CPU: the report of both groups (the
    gates; no launch is counted on the CPU) and the QR scenario at 16 x
    16; a result that breaks a gate is refused, naming it."""
    out = {"two": two, "four": four, "two_seconds": 0.0,
           "four_seconds": 0.0}
    assert chip_smoke.report_families(out, cfg, "cpu") == {}
    text = capsys.readouterr().out
    for name in ("make_bins_sharded_fused_step (K1)", "bin_sharded_forward",
                 "make_dp_train_step", "(K5)", "(K9 'high'", "(K7",
                 "make_masked_sharded_sfdn_step", "MultiSeedEnsemble",
                 "make_seed_bins_sharded_fused_step"):
        assert name in text, name
    bad = copy.deepcopy(two)
    bad[1]["attenuated"]["spread"] = 1e-7
    with pytest.raises(AssertionError, match="rank 1 attenuated"):
        S.check_families(bad, cfg, on_card=False)
    with pytest.raises(AssertionError, match="launches"):
        S.check_families(two, cfg, on_card=True)
    q = chip_smoke.qr_scenario(8, 16, device="cpu")
    assert q["set_err"] < chip_smoke.QR_SET_TOL
    assert q["loss_rel"] < chip_smoke.QR_LOSS_TOL
    assert q["grad_rel"] < chip_smoke.QR_GRAD_TOL


def test_a_raising_rank_surfaces_its_traceback():
    t0 = time.perf_counter()
    with pytest.raises(RankError) as info:
        spawn(W.raise_on, 2, "gloo", 1, timeout_s=DEADLINE)
    assert time.perf_counter() - t0 < DEADLINE
    text = str(info.value)
    assert "rank 1 of 2 failed" in text
    assert "ValueError: rank 1 refuses" in text and "raise_on" in text


def test_hung_ranks_stop_at_the_deadline():
    t0 = time.perf_counter()
    with pytest.raises(RankError, match=r"ranks \[0, 1\] of 2 not done "
                                        "after 4 s"):
        spawn(W.sleep_on, 2, "gloo", 120.0, timeout_s=4)
    assert time.perf_counter() - t0 < 20


def test_mesh_helpers_on_two_ranks():
    out = spawn(W.mesh_checks, 2, "gloo", timeout_s=DEADLINE, threads=2)
    model = build_colorless_sfdn(nfft=256, delays=(13, 17, 19, 23),
                                 n_stages=1, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    X = torch.ones((1, 129, 1), dtype=torch.complex64)
    with torch.no_grad():
        want = float(sfdn_masked_loss(model, X, torch.ones((1, 129, 1)),
                                      torch.arange(0, 129, 4),
                                      sparsity_weight=0.0))
    for rank, o in enumerate(out):
        assert o["blocks"] == [(rank * 4, 4), (rank * 4, 4), (rank * 5, 5)]
        assert o["take"] == [3.0, 4.0, 0.0, 0.0]
        assert o["replicated"] == [0.0, 0.5]  # rank 0's weights
        assert o["grad_sum"] == 3.0 and o["bias_grad"] is None
        assert "drew different masks" in o["differ"]
        assert "need 3 ranks" in o["too_many"]
        assert o["coords"] == (rank, 0)
        assert "batch 0 only" in o["batch"] and "a batch of 2" in o["batch"]
        assert abs(o["masked_total"] - want) <= 1e-6 * abs(want)
        sharded, unsharded = o["own_schedule"]
        np.testing.assert_allclose(sharded, unsharded, rtol=1e-5)


def test_parallel_exports_match_jax():
    jax_names = {n for n in dir(JP) if not n.startswith("_")
                 and callable(getattr(JP, n))}
    assert set(P.__all__) == jax_names
    assert all(callable(getattr(P, n)) for n in P.__all__)
