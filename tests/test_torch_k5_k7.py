"""The redesigned K5 (the attenuated FDN's fused step) and K7 (the
Durand-Kerner roots) on the CPU: their bounds in chip_smoke.py stay the
same work, K5's shared-memory limit takes every size the old one took, the
K7 wrapper's checks are unchanged, and the kernel build records each
library's own seconds.  The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import importlib.util
import stat
from pathlib import Path

import pytest
import torch

from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import eig_kernels as ek
from flamo_tpu_torch.ops import sos_kernels as sk

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,M,N,want", [
    ("fdn_sos_tf_mse", 48001, 6, 0.006972),
    ("dk_roots", 1601, 4, 0.000643),
])
def test_bounds_are_the_same_work(smoke, name, M, N, want):
    """The yardsticks of the two redesigned kernels do not move: the
    function's work, whatever implements it."""
    ms, by = smoke.bound(name, M, N)
    assert round(ms, 6) == want
    assert by == "operations"


def _old_fused_limit_ok(N: int, K: int, P: int) -> bool:
    """The rule before the redesign: four warps' rows of head and tap sums
    within 48 KB."""
    return 4 * (N * N + 2 * N + 1 + 2 * P * K * N) <= 12288


def test_fused_taps_limit_takes_every_old_size():
    """Every (N, K, P) that launched with fuse_taps before still fits a
    block's shared memory (every size within the kernels' limits does,
    by opting in above 48 KB)."""
    old = 0
    for N in range(1, 17):
        for K in range(1, sk.MAX_K + 1):
            for P in range(1, sk.MAX_P + 1):
                old += _old_fused_limit_ok(N, K, P)
                assert sk.tf_mse_smem_bytes(N, K, P) <= sk._MAX_SMEM
    assert old > 0
    assert sk.tf_mse_smem_bytes(16, 64, 8) == 87568  # the C comment's figure
    # the main path: taps, heads and the bins' rows, well under 48 KB
    assert sk.tf_mse_smem_bytes(6, 12, 3) == 4 * (432 + 4 * 49 + 256 * 7)
    assert sk.tf_mse_smem_bytes(6, 12, 3, fuse_taps=False) == 4 * (432 + 196)


def test_k5_source_mirrors_the_wrapper_limit():
    """The wrapper's limit and the kernel's are one rule: sos_kernels.cu
    holds the same 227 KB and the same terms."""
    src = (cuda_build.CSRC / "sos_kernels.cu").read_text()
    assert f"kMaxSmemFloats = {sk._MAX_SMEM} / 4" in src
    assert ("(fuse_taps ? 2 * kThreads * (N + 1) : 0) + taps + "
            "kWarps * fdn::n_partials(N)") in src
    assert "k5_smem_floats(N, K, P, fuse_taps != 0, 1) > sos::kMaxSmemFloats" \
        in src


@pytest.mark.parametrize("cr,ci,err,match", [
    (torch.zeros((9, 4)), torch.zeros((9, 4)), ValueError, "EIG_DK_MAX_N"),
    (torch.zeros((0, 4)), torch.zeros((0, 4)), ValueError, "EIG_DK_MAX_N"),
    (torch.zeros((4, 0)), torch.zeros((4, 0)), ValueError, "B = 0"),
    (torch.zeros((4, 4), dtype=torch.float64),
     torch.zeros((4, 4), dtype=torch.float64), TypeError, "float32"),
    (torch.zeros((4, 4)), torch.zeros((4, 5)), TypeError, "one shape"),
    (torch.zeros(4), torch.zeros(4), TypeError, "one shape"),
])
def test_dk_roots_wrapper_checks_are_unchanged(cr, ci, err, match):
    """K7's wrapper refuses what it refused before, naming the limit,
    before any device dispatch."""
    with pytest.raises(err, match=match):
        ek.dk_roots_rows(cr, ci)


def test_build_records_each_librarys_seconds(tmp_path, monkeypatch):
    """build() starts one compiler per library and records each one's
    seconds as it ends; a failed compile raises with its output."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; fi\n"
        "  case \"$1\" in *eig_kernels.cu) echo nvcc refused; exit 3;; esac\n"
        "  shift\n"
        "done\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    targets = [("sos_kernels", 6), ("fdn_kernels", 2)]
    seconds = cuda_build.build(targets)
    assert set(seconds) == set(targets)
    assert all(s > 0 for s in seconds.values())
    for lib, n in targets:
        assert cuda_build.library_path(n, lib).read_text() == "built\n"
    assert cuda_build.build(targets) == {}  # already built
    with pytest.raises(RuntimeError, match="nvcc refused"):
        cuda_build.build([("eig_kernels", 4)])
    assert not cuda_build.library_path(4, "eig_kernels").exists()
