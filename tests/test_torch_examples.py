"""The port's e8 examples end to end on the CPU at nfft=512: each
``main`` trains, writes its WAVs and parameters, and its loss does not
rise.  The colorless and scattering examples take the Trainer there
(``--fast auto`` takes the fast path only on the card) and, with
``--fast fused``, their fast path through the kernels' plain versions;
the active-acoustics example takes ``aa_evs_fit`` (K7's plain version)
under ``auto`` and the Trainer under ``graph``."""

from __future__ import annotations

import os

import numpy as np
import pytest

from flamo_tpu_torch.examples import (e8_active_acoustics, e8_colorless_fdn,
                                      e8_colorless_sfdn)
from flamo_tpu_torch.examples._common import setup
from flamo_tpu_torch.utils import load_audio

CASES = [
    (e8_colorless_fdn, "auto", ["checkpoints", "parameters_optim.mat"]),
    (e8_colorless_fdn, "fused", ["parameters_optim.mat"]),
    (e8_colorless_sfdn, "auto", ["checkpoints", "parameters_optim.mat"]),
    (e8_colorless_sfdn, "fused", ["parameters_optim.mat"]),
    (e8_active_acoustics, "auto", ["AA_parameters_init.mat",
                                   "AA_parameters_optim.mat"]),
    (e8_active_acoustics, "graph", ["AA_parameters_optim.mat",
                                    "checkpoints"]),
]


@pytest.mark.parametrize("example,fast,written", CASES,
                         ids=[f"{c[0].__name__.rsplit('.', 1)[1]}-{c[1]}"
                              for c in CASES])
def test_example_main_on_cpu(tmp_path, example, fast, written, capsys):
    args = setup(example.parser().parse_args([
        "--device", "cpu", "--nfft", "512", "--fast", fast,
        "--train_dir", str(tmp_path)]))
    example.main(args)
    out = capsys.readouterr().out
    assert "final" in out
    assert ("fast path:" in out) == (fast != "graph" and (
        fast == "fused" or example is e8_active_acoustics))
    for name in ["args.txt", "ir_init.wav", "ir_optim.wav", *written]:
        assert os.path.exists(tmp_path / name), name
    ir, fs = load_audio(str(tmp_path / "ir_optim.wav"))
    assert fs == 48000 and ir.shape[1] == 1
    assert np.isfinite(ir).all() and 0 < np.abs(ir).max() <= 1


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_audio_io_matches_jax(tmp_path, subtype):
    """save_audio/load_audio write and read the JAX package's WAVs: each
    package reads the other's file to the same samples."""
    import torch

    from flamo_tpu import utils as ju
    from flamo_tpu_torch.functional import get_magnitude
    from flamo_tpu_torch.utils import save_audio

    x = np.random.default_rng(0).uniform(-1.2, 1.2, (300, 2))
    ours, theirs = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    save_audio(ours, torch.tensor(x), fs=44100, subtype=subtype)
    ju.save_audio(theirs, x, fs=44100, subtype=subtype)
    a, fa = load_audio(theirs)
    b, fb = ju.load_audio(ours)
    assert fa == fb == 44100 and a.shape == b.shape == (300, 2)
    np.testing.assert_array_equal(a, b)
    assert get_magnitude(torch.tensor([-3.0, 4.0])).tolist() == [3.0, 4.0]


FAST_CASES = [
    # (fast, history, graph0, outcome): the fast path keeps a first loss
    # within the parity; outside it, or with a non-finite or rising loss,
    # it raises under every mode, 'auto' too
    ("auto", [1.0, 0.5], 1.0, "kept"),
    ("auto", [1.0, 0.5], 1.1, "raises"),
    ("fused", [1.0, 0.5], 1.1, "raises"),
    ("auto", [1.0, np.nan], 1.0, "raises"),
    ("auto", [np.nan, 0.5], 1.0, "raises"),
    ("auto", [1.0, 1.01], 1.0, "raises"),
]


@pytest.mark.parametrize("fast,history,graph0,outcome", FAST_CASES)
def test_fast_path_falls_back_only_on_parity(fast, history, graph0,
                                             outcome):
    """No fallback is left: a failed parity check raises under 'auto' as
    under 'fused', naming the gate, and a kept result comes back whole."""
    from flamo_tpu_torch.examples._common import fast_path

    run = lambda: fast_path(  # noqa: E731
        fast, graph0, lambda: ("net", np.asarray(history, np.float32)))
    if outcome == "raises":
        match = "parity gate" if np.isfinite(history).all() and \
            history[-1] <= history[0] else None
        with pytest.raises(RuntimeError, match=match):
            run()
    else:
        trained, hist = run()
        assert trained == "net" and list(hist) == history


def test_active_acoustics_fast_path_raises_on_nan(tmp_path, monkeypatch):
    """A non-finite loss from aa_evs_fit (K7's route) under --fast auto
    raises; it does not retrain through the graph Trainer."""
    def nan_fit(aa, *args, n_steps, **kwargs):
        return aa.F_MM, np.full(n_steps, np.nan, np.float32)

    monkeypatch.setattr(e8_active_acoustics, "aa_evs_fit", nan_fit)
    args = setup(e8_active_acoustics.parser().parse_args([
        "--device", "cpu", "--nfft", "512", "--fast", "auto",
        "--train_dir", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="non-finite"):
        e8_active_acoustics.main(args)
