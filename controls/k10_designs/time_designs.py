"""Time the candidate designs of K10 'full' and 'ps' (the phase-2
micro-benchmark's per-section and prefix/suffix kernels) against the
previous kernels and the package's, on one CUDA card.

Run from the root of the repository:

    python controls/k10_designs/time_designs.py [--check]

It builds, at once, with nvcc (sm_90a, with the register report):
``controls/k10_designs/phase2_designs.cu`` (each lever of the redesign
alone and together, behind ``full_design_launch`` and
``ps_design_launch``), the package's ``phase2_micro`` and the previous
library ``controls/phase2_micro_prev``.  Every case runs at the
micro-benchmark's sizes (nfft = 96000, P = 3, K = 12, N = 6, 48128 bins)
on its operands (t of ones) and on a seeded random t, and is first held
to the plain PyTorch version at chip_smoke.P2_TOL of the terms'
magnitudes.  The cases count the passes two ways: the distinct passes the
function needs (full: lcm(K, N) = 12 scaled by 12; ps: one pass over k
scaled by 2) and every one of the 2 K N = 144 passes as a distinct
section, as K5's tap phase has them (the "K5-section" count).  Then
(without ``--check``) each is timed by torch.profiler (device ms per call
over 50 calls), every case twice, the second round in reverse order, with
the package's and the previous kernels' floors (one bin).  The libraries,
the register report (k10_designs_ptxas.txt) and the times
(k10_designs.json) go to build/controls/.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flamo_tpu_torch.ops import cuda_build  # noqa: E402
from flamo_tpu_torch.ops import phase2_micro as pm  # noqa: E402
from flamo_tpu_torch.scripts import bench_phase2_micro as p2bench  # noqa: E402

BUILD = ROOT / "build" / "controls"
HERE = Path(__file__).resolve().parent
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
P, K, N, NFFT = p2bench.P, p2bench.K, p2bench.N, p2bench.NFFT
S = 2 * K * N
L = math.lcm(K, N)
# (label, pc, trees, passes, G, scale): pc 0 runtime P through L1, 3 P = 3
# with staged taps; trees 1: three warp trees a pass
FULL = [("lever 1 alone: 12 distinct passes x 12", 0, 1, L, L, S // L),
        ("lever 2 alone: 144 passes, 4 a thread", 0, 1, S, 4, 1),
        ("lever 3 alone: 144 passes, sums in registers", 0, 0, S, S, 1),
        ("lever 4 alone: 144 passes, P = 3, staged taps", 3, 1, S, S, 1),
        *((f"levers 1-4, {g} passes a thread", 3, 0, L, g, S // L)
          for g in (12, 6, 4, 3, 2, 1)),
        *((f"K5-section: levers 2-4, 144 passes, {g} a thread", 3, 0, S, g, 1)
          for g in (144, 12, 6, 4, 2))]
# (label, pc, trees, split, recur, reps, scale)
PS = [("lever 1 alone: one pass over k x 2, Horner once", 0, 1, 0, 0, 1, 2),
      ("lever 2 alone: a thread a (bin, channel), two passes", 0, 1, 1, 0,
       2, 1),
      ("lever 3 alone: sums in registers, two passes", 0, 0, 0, 0, 2, 1),
      ("lever 4 alone: P = 3, staged taps, two passes", 3, 1, 0, 0, 2, 1),
      ("levers 1-4", 3, 0, 1, 0, 1, 2),
      ("levers 1-4, recurrence (no suffix products)", 3, 0, 1, 1, 1, 2),
      ("levers 1, 3, 4: a thread a bin over the channels", 3, 0, 0, 0, 1,
       2),
      ("K5-section: levers 2-4, two passes over k", 3, 0, 1, 0, 2, 1),
      ("K5-section: levers 2-4, recurrence, two passes", 3, 0, 1, 1, 2, 1)]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def build():
    """The design library, the previous one and the package's, all nvcc's
    at once; returns (designs, cs.Previous)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "libk10_designs.so"
    proc = subprocess.Popen(
        [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
         "-o", str(so), str(HERE / "phase2_designs.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    prev_procs = cs.Previous.start(True, (("p2", 1),))
    cuda_build.build((("phase2_micro", 1),),
                     ptxas_log=BUILD / "k10_package_ptxas.txt")
    out, _ = proc.communicate()
    cs.check(proc.returncode == 0,
             f"nvcc failed for phase2_designs.cu:\n{out}")
    log = BUILD / "k10_designs_ptxas.txt"
    log.write_text(f"# k10 designs\n{out}")
    prev = cs.Previous(prev_procs, log)
    lib = ctypes.CDLL(str(so))
    lib.full_design_rows.restype = ctypes.c_longlong
    lib.full_design_rows.argtypes = [I_, I_, I_]
    lib.ps_design_rows.restype = ctypes.c_longlong
    lib.ps_design_rows.argtypes = [I_, I_, I_]
    lib.full_design_launch.argtypes = [I_, I_] + [P_] * 3 + [I_] * 6 + [
        F_, F_, P_]
    lib.ps_design_launch.argtypes = [I_] * 4 + [P_] * 3 + [I_] * 5 + [
        F_, F_, P_]
    return lib, prev


def main() -> int:
    check_only = "--check" in sys.argv[1:]
    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = cs.gpu_line()
    print(card)
    t0 = time.perf_counter()
    lib, prev = build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    name = tag = ""
    for line in ((BUILD / "k10_designs_ptxas.txt").read_text()
                 + (BUILD / "k10_package_ptxas.txt").read_text()
                 ).splitlines():
        if line.startswith("# "):
            tag = line[2:]
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif (("design_kernel" in name or "phase2_" in name)
              and ("registers" in line or "spill" in line)):
            print(f"  ptxas ({tag}) {name}: "
                  f"{line.split(':', 1)[-1].strip()}")
    w_scale = 2.0 * math.pi / NFFT

    def full_design(pc, trees, passes, g, scale, t, c):
        M = t.shape[1]
        part = torch.empty((lib.full_design_rows(M, passes, g), 3),
                           device=t.device)
        rc = lib.full_design_launch(pc, trees, t.data_ptr(), c.data_ptr(),
                                    part.data_ptr(), M, P, K, N, passes, g,
                                    scale, w_scale, stream())
        cs.check(rc == 0, f"full design: rc {rc}")
        return torch.sum(part, dim=0)

    def ps_design(pc, trees, split, recur, reps, scale, t, c):
        M = t.shape[1]
        part = torch.empty((lib.ps_design_rows(M, N, split), 3),
                           device=t.device)
        rc = lib.ps_design_launch(pc, trees, split, recur, t.data_ptr(),
                                  c.data_ptr(), part.data_ptr(), M, P, K, N,
                                  reps, scale, w_scale, stream())
        cs.check(rc == 0, f"ps design: rc {rc}")
        return torch.sum(part, dim=0)

    def package_k5(t, c):
        """The package's full kernel over all 144 passes, scale 1."""
        plib = cuda_build.load(1, "phase2_micro")
        M = t.shape[1]
        rows = plib.p2_rows(0, M, P, K, N, S, 1.0)
        part = torch.empty((rows, 3), device=t.device)
        rc = plib.p2_launch(0, t.data_ptr(), c.data_ptr(), part.data_ptr(),
                            M, P, K, N, S, 1.0, w_scale, stream())
        cs.check(rc == 0, f"package full at 144 passes: rc {rc}")
        return torch.sum(part, dim=0)

    t1, c = p2bench.inputs("cuda")
    tr = torch.tensor(np.random.default_rng(cs.SEED + 3).normal(
        size=tuple(t1.shape)).astype(np.float32), device="cuda")
    cases = []  # (variant, label, fn(t))
    for v in ("full", "ps"):
        cases.append((v, "previous", lambda t, v=v: prev.phase2(
            v, t, c, NFFT)))
        cases.append((v, "package", lambda t, v=v: pm.phase2_micro(
            v, t, c, NFFT)))
    cases.append(("full", "K5-section: the package's kernel, 144 passes",
                  lambda t: package_k5(t, c)))
    cases += [("full", label, lambda t, a=args: full_design(*a, t, c))
              for label, *args in FULL]
    cases += [("ps", label, lambda t, a=args: ps_design(*a, t, c))
              for label, *args in PS]
    sets = {"t of ones": t1, "random t": tr}
    for tag, t in sets.items():
        for v in ("full", "ps"):
            ref = pm.phase2_micro_plain(v, t, c, NFFT)
            scale = pm.phase2_micro_plain(v, t, c, NFFT, magnitude=True)
            for var, label, fn in cases:
                if var != v:
                    continue
                got = fn(t)
                rel = float(((got - ref).abs()
                             / scale.clamp_min(1e-30)).max())
                cs.check(rel <= cs.P2_TOL, f"{v} {label} ({tag}): "
                         f"{rel:.3e} > {cs.P2_TOL}")
                print(f"  {v} {label} ({tag}): {rel:.3e} of the terms' "
                      f"magnitudes")
                cs.check(torch.equal(got, fn(t)), f"{v} {label} ({tag}): "
                         "two launches differ")
    print(f"every case within P2_TOL = {cs.P2_TOL:g} of the plain version "
          "and equal over two launches")
    if check_only:
        print(f"total {time.perf_counter() - t0:.1f} s on {card}")
        return 0

    # ------------------------------------------------------------- timing
    kernel = {("full", "previous"): "phase2_full_kernel",
              ("ps", "previous"): "phase2_ps_kernel",
              ("full", "package"): "phase2_full_kernel",
              ("ps", "package"): "phase2_ps_kernel"}
    timed = []
    for tag, t in sets.items():
        for v, label, fn in cases:
            k = kernel.get((v, label), "phase2_full_kernel"
                           if label.startswith("K5-section: the package")
                           else f"{v}_design_kernel")
            timed.append((f"{v} {label} ({tag})",
                          lambda fn=fn, t=t: fn(t), k))
    one = t1[:, :1].contiguous()
    for v in ("full", "ps"):
        timed.append((f"{v} floor (one bin) previous",
                      lambda v=v: prev.phase2(v, one, c, NFFT),
                      f"phase2_{v}_kernel"))
        timed.append((f"{v} floor (one bin) package",
                      lambda v=v: pm.phase2_micro(v, one, c, NFFT),
                      f"phase2_{v}_kernel"))
    times = {}
    for rnd in range(2):
        for key, fn, k in (timed if rnd == 0 else timed[::-1]):
            times.setdefault(key, []).append(cs.device_ms(fn, k))
    for key, v in times.items():
        print(f"  {key}: {v[0]:.6f} {v[1]:.6f} (mean {np.mean(v):.6f})")
    (BUILD / "k10_designs.json").write_text(json.dumps(
        {"card": card, "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
