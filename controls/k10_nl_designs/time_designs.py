"""Time the candidate designs of K10 'noreduce' and 'lanered' (the
phase-2 micro-benchmark's running-sum and per-pass-reduction kernels)
against the previous kernels and the package's, on one CUDA card.

Run from the root of the repository:

    python controls/k10_nl_designs/time_designs.py [--check]

It builds, at once, with nvcc (sm_90a, with the register report):
``controls/k10_nl_designs/nl_designs.cu`` (each lever of the redesign
alone and together in the previous kernels' frame, behind
``nl_design_launch``, and the package's frame with four block sums behind
``pkg_design_launch``), the package's ``phase2_micro`` and the previous
library ``controls/phase2_micro_prev``.  Every case runs at the
micro-benchmark's sizes (nfft = 96000, P = 3, K = 12, N = 6, 48128 bins)
on its operands (t of ones) and on a seeded random t, and is first held
to the plain PyTorch version at chip_smoke.P2_TOL of the terms'
magnitudes and launched twice with equal results.  The package's kernels
also run over all 2 K N = 144 passes scaled by 1 (the "K5-section"
count, every pass a distinct section, 144 warp trees a warp for
lanered).  Then (without ``--check``) each is timed by torch.profiler
(device ms per call over 50 calls), every case twice, the second round in
reverse order, with the package's and the previous kernels' floors (one
bin).  The libraries, the register report (k10_nl_designs_ptxas.txt) and
the times (k10_nl_designs.json) go to build/controls/.
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
VARIANTS = ("noreduce", "lanered")
# (label, pc, passes, scale): pc 0 runtime P through L1, 3 P = 3 with
# staged taps; every design one thread a bin, q and its projections a pass
DESIGNS = [
    (f"lever 1 alone: {L} distinct passes x {S // L}", 0, L, S // L),
    (f"lever 2 alone: {S} passes, P = 3, staged taps", 3, S, 1),
    (f"levers 1-2 in the previous frame: {L} passes x {S // L}, P = 3, "
     "staged taps", 3, L, S // L)]
# the package's frame with each block sum (variant, label, epi)
EPILOGUES = [
    ("full", "package frame, full's 3-wide sum", 0),
    ("noreduce", "package frame, a 2-wide sum, thread 2 stores the 0", 1),
    ("noreduce", "package frame, a 3-wide sum with a tree of 0", 2),
    ("noreduce", "package frame, a 3-wide sum, lane 0 zeroes the third",
     3)]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def build():
    """The design library, the previous one and the package's, all nvcc's
    at once; returns (designs, cs.Previous)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "libk10_nl_designs.so"
    # the headers are controls/k10_designs' copies (with sos::horner)
    proc = subprocess.Popen(
        [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
         "-I", str(HERE.parent / "k10_designs"), "-o", str(so),
         str(HERE / "nl_designs.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    prev_procs = cs.Previous.start(True, (("p2", 1),))
    cuda_build.build((("phase2_micro", 1),),
                     ptxas_log=BUILD / "k10_nl_package_ptxas.txt")
    out, _ = proc.communicate()
    cs.check(proc.returncode == 0,
             f"nvcc failed for nl_designs.cu:\n{out}")
    log = BUILD / "k10_nl_designs_ptxas.txt"
    log.write_text(f"# k10 nl designs\n{out}")
    prev = cs.Previous(prev_procs, log)
    lib = ctypes.CDLL(str(so))
    lib.nl_design_rows.restype = ctypes.c_longlong
    lib.nl_design_rows.argtypes = [I_]
    lib.nl_design_launch.argtypes = [I_, I_] + [P_] * 3 + [I_] * 5 + [
        F_, F_, P_]
    lib.pkg_design_rows.restype = ctypes.c_longlong
    lib.pkg_design_rows.argtypes = [I_, I_]
    lib.pkg_design_launch.argtypes = [I_] + [P_] * 3 + [I_] * 5 + [
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
    for line in ((BUILD / "k10_nl_designs_ptxas.txt").read_text()
                 + (BUILD / "k10_nl_package_ptxas.txt").read_text()
                 ).splitlines():
        if line.startswith("# "):
            tag = line[2:]
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif (("design_kernel" in name or "phase2_noreduce" in name
               or "phase2_lanered" in name or "phase2_full" in name)
              and ("registers" in line or "spill" in line)):
            print(f"  ptxas ({tag}) {name}: "
                  f"{line.split(':', 1)[-1].strip()}")
    w_scale = 2.0 * math.pi / NFFT

    def design(v, pc, passes, scale, t, c):
        M = t.shape[1]
        part = torch.empty((lib.nl_design_rows(M), 3), device=t.device)
        rc = lib.nl_design_launch(pc, int(v == "lanered"), t.data_ptr(),
                                  c.data_ptr(), part.data_ptr(), M, P, K, N,
                                  passes, scale, w_scale, stream())
        cs.check(rc == 0, f"{v} design: rc {rc}")
        return torch.sum(part, dim=0)

    def pkg_design(epi, t, c):
        M = t.shape[1]
        part = torch.empty((lib.pkg_design_rows(M, L), 3), device=t.device)
        rc = lib.pkg_design_launch(epi, t.data_ptr(), c.data_ptr(),
                                   part.data_ptr(), M, P, K, N, L, S // L,
                                   w_scale, stream())
        cs.check(rc == 0, f"pkg design {epi}: rc {rc}")
        return torch.sum(part, dim=0)

    def package_k5(v, t, c):
        """The package's kernel over all 144 passes, scale 1."""
        plib = cuda_build.load(1, "phase2_micro")
        M = t.shape[1]
        vi = pm.VARIANTS.index(v)
        part = torch.empty((plib.p2_rows(vi, M, P, K, N, S, 1.0), 3),
                           device=t.device)
        rc = plib.p2_launch(vi, t.data_ptr(), c.data_ptr(), part.data_ptr(),
                            M, P, K, N, S, 1.0, w_scale, stream())
        cs.check(rc == 0, f"package {v} at {S} passes: rc {rc}")
        return torch.sum(part, dim=0)

    t1, c = p2bench.inputs("cuda")
    tr = torch.tensor(np.random.default_rng(cs.SEED + 3).normal(
        size=tuple(t1.shape)).astype(np.float32), device="cuda")
    cases = []  # (variant, label, kernel name, fn(t))
    for v in VARIANTS:
        kernel = f"phase2_{v}_kernel"
        cases += [(v, "previous", kernel,
                   lambda t, v=v: prev.phase2(v, t, c, NFFT)),
                  (v, "package", kernel,
                   lambda t, v=v: pm.phase2_micro(v, t, c, NFFT)),
                  (v, f"K5-section: the package's kernel, {S} passes",
                   kernel, lambda t, v=v: package_k5(v, t, c))]
        cases += [(v, label, "nl_design_kernel",
                   lambda t, v=v, a=args: design(v, *a, t, c))
                  for label, *args in DESIGNS]
    cases += [("full", "package", "phase2_full_kernel",
               lambda t: pm.phase2_micro("full", t, c, NFFT))]
    cases += [(v, label, "pkg_design_kernel",
               lambda t, e=epi: pkg_design(e, t, c))
              for v, label, epi in EPILOGUES]
    sets = {"t of ones": t1, "random t": tr}
    for tag, t in sets.items():
        for v in ("full", *VARIANTS):
            ref = pm.phase2_micro_plain(v, t, c, NFFT)
            scale = pm.phase2_micro_plain(v, t, c, NFFT, magnitude=True)
            for var, label, _, fn in cases:
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
    for tag, t in sets.items():
        same = [torch.equal(pkg_design(e, t, c),
                            pm.phase2_micro(v, t, c, NFFT))
                for e, v in ((0, "full"), (1, "noreduce"))]
        print(f"  the package frame's copies equal to the package's kernels "
              f"({tag}): full {same[0]}, noreduce {same[1]}")
    if check_only:
        print(f"total {time.perf_counter() - t0:.1f} s on {card}")
        return 0

    # ------------------------------------------------------------- timing
    timed = [(f"{v} {label} ({tag})", lambda fn=fn, t=t: fn(t), kernel)
             for tag, t in sets.items() for v, label, kernel, fn in cases]
    one = t1[:, :1].contiguous()
    timed.append(("full floor (one bin) package",
                  lambda: pm.phase2_micro("full", one, c, NFFT),
                  "phase2_full_kernel"))
    for v in VARIANTS:
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
    mean = {key: float(np.mean(v)) for key, v in times.items()}
    for tag in sets:
        for label in ["previous", "package",
                      f"K5-section: the package's kernel, {S} passes",
                      *(d[0] for d in DESIGNS)]:
            diff = (mean[f"lanered {label} ({tag})"]
                    - mean[f"noreduce {label} ({tag})"])
            print(f"  lanered - noreduce, {label} ({tag}): {diff:.6f}")
        for label in ("package", *(e[1] for e in EPILOGUES[1:])):
            diff = (mean[f"full package ({tag})"]
                    - mean[f"noreduce {label} ({tag})"])
            print(f"  full (package) - noreduce, {label} ({tag}): "
                  f"{diff:.6f}")
    (BUILD / "k10_nl_designs.json").write_text(json.dumps(
        {"card": card, "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
