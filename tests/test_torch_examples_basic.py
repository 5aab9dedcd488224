"""The tutorial examples of the port against flamo_tpu on the CPU: e6's
IRs from JAX's weights (both routes), the construction errors of e3 and
e5 (the JAX package's exception types), the in-place ``assign_value``
and ``resample`` (where the JAX package returns new modules), each new
example's ``main`` at ``--device cpu`` and a small nfft, and
chip_smoke.py's phase 4i helpers with the kernels' wrappers counted.
(e4_recursion_nn's comb_nn against JAX's: tests/test_torch_recursion_nn.py,
apart so that each file stays short under the test runner's workers.)

Tolerance: e6's IRs 1e-5 of the max."""

from __future__ import annotations

import importlib.util
import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamo_tpu.processor import dsp as jdsp
from flamo_tpu.processor import system as jsystem
from flamo_tpu_torch.auxiliary.velvet import VelvetNoiseFilter
from flamo_tpu_torch.convert import load_jax_params
from flamo_tpu_torch.examples import (e0_siso, e1_mimo, e2_chaining_filters,
                                      e3_series_class, e4_recursion_nn,
                                      e5_shell, e6_anti_aliasing, e7_geq)
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import sos_kernels as sk
from flamo_tpu_torch.processor import dsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000
IR_TOL = 1e-5
CPU = torch.device("cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# e6 against JAX's
# ---------------------------------------------------------------------------
E6_NFFT = 2048


@pytest.fixture(scope="module")
def jax_e6():
    """alias decay -> (JAX's e6 model's leaves, its IR), the IRs jitted."""
    je6 = _jax_example("e6_anti_aliasing")
    ir_of = jax.jit(lambda m: m.get_time_response()[0, :, 0])
    out = {}
    for db in (0.0, 30.0):
        jmodel = je6.build(E6_NFFT, db, jax.random.PRNGKey(1))
        out[db] = (_leaves(jmodel), np.asarray(ir_of(jmodel)))
    return out


@pytest.mark.parametrize("solve_method", ["ge", "pallas"])
def test_e6_irs_match_jax(jax_e6, solve_method):
    for db, (leaves, ref) in jax_e6.items():
        model = e6_anti_aliasing.build(E6_NFFT, db, 1, CPU, solve_method)
        load_jax_params(model, leaves)
        ir = model.get_time_response()[0, :, 0]
        assert _rel(ir, ref) < IR_TOL
        assert model.core.l.solve_method == solve_method


# ---------------------------------------------------------------------------
# the construction errors and the in-place edits
# ---------------------------------------------------------------------------
def _jax_error_cases(nfft: int) -> dict:
    def gain(size, **kw):
        return jdsp.Gain(size=size, nfft=kw.pop("nfft", nfft), **kw)

    core = jsystem.Series(OrderedDict({
        "in": jdsp.Gain(size=(3, 1), nfft=nfft),
        "filt": jdsp.parallelFilter(size=(16, 3), nfft=nfft),
        "out": jdsp.Gain(size=(1, 3), nfft=nfft)}))
    return {
        "IO mismatch": lambda: jsystem.Series(gain((3, 1)), gain((2, 4))),
        "nfft mismatch": lambda: jsystem.Series(
            gain((2, 1)), gain((2, 2), nfft=nfft * 2)),
        "alias_decay_db mismatch": lambda: jsystem.Series(
            gain((2, 1), alias_decay_db=0.0),
            gain((2, 2), alias_decay_db=30.0)),
        "duplicate key": lambda: jsystem.Series(
            OrderedDict({"a": gain((2, 2))}),
            OrderedDict({"a": gain((2, 2))})),
        "input layer IO": lambda: jsystem.Shell(
            core=core, input_layer=jdsp.Gain(size=(2, 2), nfft=nfft)),
        "output layer IO": lambda: jsystem.Shell(
            core=core, output_layer=jdsp.Gain(size=(4, 4), nfft=nfft)),
        "shell nfft mismatch": lambda: jsystem.Shell(
            core=core, input_layer=jdsp.FFT(nfft * 2)),
    }


def test_construction_errors_raise_jax_types():
    nfft = 256
    ours = dict(e3_series_class.error_cases(nfft, CPU))
    ours.update({("shell " + k if k == "nfft mismatch" else k): v
                 for k, v in e5_shell.error_cases(nfft, CPU).items()})
    theirs = _jax_error_cases(nfft)
    assert set(ours) == set(theirs)
    for name, (kind, make) in ours.items():
        with pytest.raises(Exception) as mine:
            make()
        with pytest.raises(Exception) as ref:
            theirs[name]()
        assert type(mine.value) is type(ref.value) is kind, name
        assert str(mine.value) == str(ref.value), name


def test_assign_value_and_resample_write_in_place():
    """Pinned difference: the JAX package's assign_value and resample
    return new modules and leave the original as it was (its resample:
    tests/test_aux.py); the port's write into the module and return
    it."""
    jg = jdsp.parallelGain(size=(2,), nfft=256)
    jg2 = jg.assign_value(jnp.asarray([0.5, -1.0]))
    assert jg2 is not jg and not np.array_equal(np.asarray(jg.param),
                                                np.asarray(jg2.param))
    g = dsp.parallelGain(size=(2,), nfft=256, device="cpu")
    assert g.assign_value(torch.tensor([0.5, -1.0])) is g
    assert torch.equal(g.param.detach(), torch.tensor([0.5, -1.0]))
    v = VelvetNoiseFilter(size=(256, 1, 1), nfft=256, device="cpu")
    before = v.param.detach().clone()
    assert v.resample(torch.Generator().manual_seed(1)) is v
    assert not torch.equal(v.param, before)


# ---------------------------------------------------------------------------
# each new example's main on the CPU
# ---------------------------------------------------------------------------
MAINS = {
    "e0_siso": (e0_siso, lambda: e0_siso.example_parser(nfft=512)),
    "e1_mimo": (e1_mimo, e1_mimo.parser),
    "e2_chaining_filters": (e2_chaining_filters,
                            lambda: e2_chaining_filters.example_parser()),
    "e3_series_class": (e3_series_class, lambda: e3_series_class
                        .example_parser(max_epochs=10, num=16, lr=5e-2)),
    "e4_recursion_nn": (e4_recursion_nn, e4_recursion_nn.parser),
    "e5_shell": (e5_shell, lambda: e5_shell.example_parser(
        max_epochs=10, num=16, lr=1e-2)),
    "e6_anti_aliasing": (e6_anti_aliasing, e6_anti_aliasing.parser),
    "e7_geq": (e7_geq, e7_geq.parser),
}


@pytest.mark.parametrize("name,extra", [
    ("e0_siso", ["--num", "8"]), ("e1_mimo", ["--backend", "pallas",
                                             "--num", "8"]),
    ("e2_chaining_filters", ["--nfft", "2048"]), ("e3_series_class", ["--nfft", "2048", "--max_epochs", "2"]),
    ("e4_recursion_nn", ["--backend", "pallas", "--max_epochs", "1",
                         "--num", "8"]), ("e5_shell", []),
    ("e6_anti_aliasing", ["--nfft", "4096", "--backend", "pallas"]),
    ("e7_geq", ["--backend", "pallas", "--num", "8", "--max_epochs", "2"])])
def test_example_main_on_cpu(name, extra, tmp_path):
    module, parser = MAINS[name]
    if "--nfft" not in extra:
        extra = ["--nfft", "512"] + extra
    args = module.setup(parser().parse_args(
        ["--device", "cpu", "--train_dir", str(tmp_path)] + extra))
    module.main(args)  # each checks its own result and raises
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path)) or \
        name == "e4_recursion_nn" and args.scenario == "all"


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 4i on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture()
def counted_kernels(monkeypatch):
    """K2's, K4's and K6's wrappers counting their calls as launches."""
    def spy(mod, attr, name, transposed=None, at=None):
        """``at``: the position of the wrapper's ``transpose`` argument;
        a transposed call counts as ``transposed``."""
        fn = getattr(mod, attr)

        def run(*args, **kwargs):
            transpose = kwargs.get("transpose", len(args) > (at or 99)
                                   and args[at])
            mod.LAUNCHES[transposed if transpose else name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, attr, run)

    spy(sk, "sos_cascade_fwd_kernel", "sos_cascade_fwd")
    spy(sk, "sos_cascade_bwd_kernel", "sos_cascade_bwd")
    spy(fk, "dense_solve_kernel", "dense_solve", "dense_solve_transposed", 2)
    spy(fk, "fdn_solve_kernel", "fdn_solve", "fdn_solve", 3)


def test_phase_slice18_on_cpu(counted_kernels, monkeypatch):
    """phase 4i's scenarios at nfft 512: the accurate GEQs (K4f only),
    comb_nn (K4f, K4b, K6 and K6 transposed once each an item; 8 items
    here), gains_nn (K6 both ways, no K2), e6 (K2) and the velvet loop
    (K6), each gating its counts and its route gap inside; e7_geq's
    trained scenarios are phase 4h's (tests/test_torch_e7_nn_probe.py)."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "COMB_ITEMS", 8)

    for parallel in (False, True):
        a = cs.accurate_scenario(parallel, nfft=512, device="cpu")
        assert a["out"]["pallas"]["counts"] == {"sos_cascade_fwd": 2}
        assert a["out"]["xla"]["counts"] == {}
    c = cs.comb_scenario(nfft=512, device="cpu")
    assert c["epoch_counts"] == {k: cs.COMB_ITEMS for k in (
        "sos_cascade_fwd", "sos_cascade_bwd", "dense_solve",
        "dense_solve_transposed")}
    g = cs.gains_scenario(nfft=512, device="cpu", steps=3)
    assert g["counts"] == {"dense_solve": 3, "dense_solve_transposed": 3}
    assert cs.e6_scenario(nfft=1024, device="cpu")["counts"] == \
        {"fdn_solve": 2}
    assert cs.velvet_scenario(nfft=512, device="cpu")["counts"] == \
        {"dense_solve": 1}
    args, filt, _, in_ch = cs.zoo_filter("parallel_geq", "pallas", nfft=512,
                                         device="cpu")
    assert isinstance(filt, dsp.parallelGEQ) and in_ch == 2
    assert filt.cascade_backend == "pallas" and args.lr == 5e-2
