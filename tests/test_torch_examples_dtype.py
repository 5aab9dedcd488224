"""The examples' ``--dtype`` (counterpart of ``examples/_common.py``'s): each
of the port's twenty examples takes ``float32`` (the default) and
``float64``, and ``setup`` makes float64 torch's default dtype, as JAX's
``setup`` turns on x64 mode: tensors made without a dtype become float64,
the modules keep their float32.  e2_chaining_filters' assigned chain under
``--dtype float64`` is held against JAX's same example run with x64 in a
subprocess (x64 is a process-global flag), to 1e-6 of the IR's max: on
both sides the signal gallery and the modules set float32 themselves, so
the IRs stay float32 under x64 and float64 alike, and differ by the
float32 rounding of the responses.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flamo_tpu_torch.examples import _common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "flamo_tpu_torch",
                                            "examples"))
    if f.startswith("e") and f.endswith(".py"))
IR_TOL = 1e-6


@pytest.fixture()
def default_dtype():
    """torch's default dtype, restored after the test (a whole file runs in
    one worker process)."""
    before = torch.get_default_dtype()
    yield
    torch.set_default_dtype(before)


def _parser(name: str):
    mod = importlib.import_module(f"flamo_tpu_torch.examples.{name}")
    return mod, (mod.parser() if hasattr(mod, "parser")
                 else _common.example_parser())


def test_twenty_examples():
    assert len(EXAMPLES) == 20


@pytest.mark.parametrize("name", EXAMPLES)
def test_parser_takes_dtype(name, tmp_path, default_dtype):
    """float32 by default, float64 on request, nothing else; setup makes
    the default dtype float64 and leaves float32 alone."""
    mod, ap = _parser(name)
    assert ap.parse_args([]).dtype == "float32"
    with pytest.raises(SystemExit):
        ap.parse_args(["--dtype", "bfloat16"])
    for dtype, want in (("float32", torch.float32),
                        ("float64", torch.float64)):
        args = mod.setup(ap.parse_args(["--dtype", dtype, "--train_dir",
                                        str(tmp_path)]))
        assert args.dtype == dtype
        assert torch.get_default_dtype() == want
        torch.set_default_dtype(torch.float32)


_JAX_E2 = r"""
import importlib.util, os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(root, "examples"))
spec = importlib.util.spec_from_file_location(
    "jax_e2", os.path.join(root, "examples", "e2_chaining_filters.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
args = mod.setup(mod.example_parser(nfft=4096).parse_args(
    ["--dtype", "float64", "--device", "cpu", "--train_dir",
     os.path.dirname(out)]))
irs = []
mod.plot_signal = lambda y, path, **kw: irs.append(np.asarray(y)) or path
from flamo_tpu.functional import signal_gallery
from flamo_tpu.processor import dsp
mod.scenario_assign_values(args, dsp, signal_gallery)
np.save(out, irs[0])
print("X64", jax.config.jax_enable_x64)
"""


def test_e2_float64_matches_jax_x64(tmp_path, default_dtype):
    """e2_chaining_filters' assigned chain (gains 0.5 and -1, integer
    delays) under --dtype float64 against JAX's e2 under x64: the same
    dtype on both sides, 1e-6 of the max apart."""
    out = tmp_path / "jax_e2.npy"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_E2, ROOT, str(out)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "X64 True" in proc.stdout, proc.stdout
    ref = np.load(out)
    from flamo_tpu_torch.examples import e2_chaining_filters as e2

    args = e2.setup(e2.example_parser(nfft=4096).parse_args(
        ["--dtype", "float64", "--device", "cpu", "--train_dir",
         str(tmp_path)]))
    got = e2.main(args)["assigned"]
    assert torch.get_default_dtype() == torch.float64
    assert str(got.dtype) == f"torch.{ref.dtype}"
    assert got.shape == ref.shape
    gap = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert gap < IR_TOL, gap
