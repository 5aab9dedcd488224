"""chip_smoke.py's phase 4l on the CPU at a small nfft: its kernel checks
(the looped wrappers' plain versions against themselves, K2 on
``k2_systems`` at 20 channels, the tied diagonal systems bit for bit),
its looped-against-unrolled comparison at 16 channels, and its paths:
HomogeneousFDN at 32 and 64 channels, the colorless FDN with the
Trainer's fused gate and the dense (non-diagonal feedforward) loop at
32, each in lockstep with 'ge' and gating its launches, with the public
wrappers counting their calls as the looped kernels' launches, as the
kernels count on the card.  Then the report: every path named, the
launches by kernels-line row."""

from __future__ import annotations

import pytest

import chip_smoke as cs
from flamo_tpu_torch.ops import fdn_kernels as fk

NFFT = 512


@pytest.fixture()
def counted_loops(monkeypatch):
    """K1's, K2's and K6's wrappers counting a call above 16 channels as a
    launch of the looped kernel, each way apart."""
    def spy(attr, name, at):
        fn = getattr(fk, attr)

        def run(*args, **kwargs):
            N = args[0].shape[-1]
            if N > fk.MAX_N:
                tr = at is not None and kwargs.get(
                    "transpose", len(args) > at and args[at])
                fk.LAUNCHES[f"{name}_transposed" if tr else name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(fk, attr, run)

    spy("fdn_solve_kernel", "fdn_solve_loop", 3)
    spy("dense_solve_kernel", "dense_solve_loop", 2)
    spy("fdn_tf_mse_kernel", "fdn_tf_mse_loop", None)


def test_phase_4l_kernel_checks_on_cpu(capsys):
    errs, tied = cs.loop_kernel_checks(20, M=40, device="cpu")
    assert set(errs) == {"fdn_solve_loop", "fdn_solve_loop_transposed",
                         "dense_solve_loop", "dense_solve_loop_transposed",
                         "fdn_tf_mse_loop"}
    assert all(v == 0.0 for v in errs.values())  # plain against plain
    assert tied == 2 * 40
    gaps = cs.loop_versus_unrolled(M=40, device="cpu")
    assert len(gaps) == 8 and all(v == 0.0 for v in gaps.values())
    text = capsys.readouterr().out
    assert "K2 looped N=20 tied lower" in text and "pivoting" in text


def test_phase_4l_paths_and_report_on_cpu(counted_loops, capsys):
    paths = cs.loop_paths(nfft=NFFT, device="cpu")
    assert [h["counts"] for h in paths["hfdn"]] == [
        {"fdn_solve_loop": 1 + cs.LOOP_STEPS,
         "fdn_solve_loop_transposed": cs.LOOP_STEPS}] * 2
    assert paths["colorless"]["counts"] == {
        "fdn_tf_mse_loop": cs.LOOP_STEPS + 3}
    assert paths["dense"]["counts"] == {
        "dense_solve_loop": cs.LOOP_STEPS,
        "dense_solve_loop_transposed": cs.LOOP_STEPS}
    for h in paths["hfdn"]:
        assert h["err"] < cs.HFDN_TOL and h["rel"] < cs.LOOP_LOSS_TOL
    launches = cs.loop_report(paths)
    S = cs.LOOP_STEPS
    assert launches == {
        "fdn_solve_loop@N32": 1 + S, "fdn_solve_loop_transposed@N32": S,
        "fdn_solve_loop@N64": 1 + S, "fdn_solve_loop_transposed@N64": S,
        "fdn_tf_mse_loop@N32": S + 3, "dense_solve_loop@N32": S,
        "dense_solve_loop_transposed@N32": S}
    text = capsys.readouterr().out
    for name in ("HomogeneousFDN N=32", "HomogeneousFDN N=64",
                 "colorless FDN N=32", "colorless_fused_step",
                 "dense loop N=32 (K6)", "launches in phase 4l"):
        assert name in text, name
