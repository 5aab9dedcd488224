"""Time the candidate designs of K3f (the FDN transfer function) and K3b
(its VJP) against the previous kernels and the package's, on one CUDA
card.

Run from the root of the repository:

    python controls/k3_designs/time_designs.py [--check]

It builds, at once, with nvcc (sm_90a, with the register report):
``controls/k3_designs/fdn_designs.cu`` (N = 6: K3f and K3b with
ge_pivot's selects or a vote a candidate row, U, b and c staged or read
through L1, float4 or float2 rows, K3f's Y and K3b's D_bar stored
through shared memory as whole lines, their inputs also loaded so, K3b
in blocks of 128 or 64 bins, behind
``tf_fwd_design_launch`` and ``tf_bwd_design_launch``), the package's
``fdn_kernels`` and the previous library ``controls/fdn_tf_prev``.  Each
candidate is first held to the plain PyTorch version (VAL_TOL on tf and
y, GRAD_TOL of the max on the cotangents) and compared bit for bit with
the previous kernel on the main path's operands and on
chip_smoke.k3_systems (random, pivoting at every step, tied, a cycle) at
M = 48001; K3b's D_bar and its sums are compared apart, since blocks of
64 bins sum the partials in another order.  Then (without ``--check``)
each is timed by torch.profiler (device ms per call over 50 calls),
every case twice, the second pass in reverse order, on the main path's
operands and on the random and pivoting systems, with the package's and
the previous kernels' floors (one bin).  The libraries, the register
report (k3_designs_ptxas.txt) and the times (k3_designs.json) go to
build/controls/.
"""

from __future__ import annotations

import ctypes
import json
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
from flamo_tpu_torch.ops import fdn_kernels as fk  # noqa: E402

BUILD = ROOT / "build" / "controls"
HERE = Path(__file__).resolve().parent
P_, I_ = ctypes.c_void_p, ctypes.c_int
N = cs.N_MAIN
K3F_DESIGNS = {0: "selects, ldg, float2 (the previous choices)",
               1: "selects, staged, float4", 2: "row vote, ldg, float2",
               3: "row vote, staged, float2",
               4: "row vote, staged, float4 (first redesign)",
               5: "row vote, staged, float4, Y as whole lines (package)",
               6: "row vote, staged, D and Y as whole lines"}
K3B_DESIGNS = {0: "selects, ldg, float2 (the previous choices)",
               1: "selects, staged, float4", 2: "row vote, ldg, float2",
               3: "row vote, staged, float2",
               4: "row vote, staged, float4 (first redesign)",
               5: "row vote, staged, float4, 64-bin blocks",
               6: "row vote, staged, float4, D_bar as whole lines "
                  "(package)",
               7: "row vote, staged, D, Y and D_bar as whole lines"}


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def build():
    """The design library, the previous one and the package's, all nvcc's
    at once; returns (designs, cs.Previous)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"libk3_designs-n{N}.so"
    proc = subprocess.Popen(
        [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
         f"-DFDN_N={N}", "-o", str(so), str(HERE / "fdn_designs.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    prev_procs = cs.Previous.start(True, (("tf", N),))
    cuda_build.build((("fdn_kernels", N),),
                     ptxas_log=BUILD / "k3_package_ptxas.txt")
    out, _ = proc.communicate()
    cs.check(proc.returncode == 0, f"nvcc failed for fdn_designs.cu:\n{out}")
    log = BUILD / "k3_designs_ptxas.txt"
    log.write_text(f"# k3 designs\n{out}")
    prev = cs.Previous(prev_procs, log)
    lib = ctypes.CDLL(str(so))
    lib.tf_fwd_design_launch.argtypes = [I_, I_] + [P_] * 6 + [I_, P_]
    lib.tf_bwd_design_launch.argtypes = [I_, I_] + [P_] * 8 + [I_, P_]
    lib.tf_bwd_design_threads.argtypes = [I_]
    return lib, prev


def main() -> int:
    check_only = "--check" in sys.argv[1:]
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_line()
    print(card)
    t0 = time.perf_counter()
    lib, prev = build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    cs.print_ptxas((BUILD / "k3_designs_ptxas.txt").read_text()
                   + (BUILD / "k3_package_ptxas.txt").read_text())
    name = ""
    for line in (BUILD / "k3_designs_ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "design_kernel" in name and ("registers" in line
                                          or "spill" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    def fwd(design, D, U, b, c):
        if design == "prev":
            return prev.tf_fwd(D, U, b, c)
        if design == "package":
            return fk.fdn_tf_fwd_kernel(D, U, b, c)
        tf = torch.empty((D.shape[0],), dtype=D.dtype, device=D.device)
        Y = torch.empty_like(D)
        rc = lib.tf_fwd_design_launch(design, N, D.data_ptr(), U.data_ptr(),
                                      b.data_ptr(), c.data_ptr(),
                                      tf.data_ptr(), Y.data_ptr(),
                                      D.shape[0], stream())
        cs.check(rc == 0, f"K3f design {design}: rc {rc}")
        return tf, Y

    def bwd(design, D, U, b, c, y, tb):
        if design == "prev":
            return prev.tf_bwd(D, U, b, c, y, tb)
        if design == "package":
            return fk.fdn_tf_bwd_kernel(D, U, b, c, y, tb)
        M = D.shape[0]
        threads = lib.tf_bwd_design_threads(design)
        partials = torch.empty((-(-M // threads), N * N + 2 * N + 1),
                               device=D.device)
        D_bar = torch.empty_like(D)
        rc = lib.tf_bwd_design_launch(design, N, D.data_ptr(), U.data_ptr(),
                                      b.data_ptr(), c.data_ptr(),
                                      y.data_ptr(), tb.data_ptr(),
                                      D_bar.data_ptr(), partials.data_ptr(),
                                      M, stream())
        cs.check(rc == 0, f"K3b design {design}: rc {rc}")
        return (D_bar, *fk._sum_partials(partials, N)[:3])

    mo = cs.main_path_operands(cs.M_MAIN, N)
    sets = {}
    for tr in (False, True):
        sets["main path", tr] = tuple(mo[k] for k in "DUbc") + (mo["tf_bar"],)
        for label, system in cs.k3_systems(np.random.default_rng(30 + tr),
                                           cs.M_MAIN, N, tr).items():
            sets[label, tr] = cs.k3_tensors(system)
    designs = {False: ["package", *K3F_DESIGNS],
               True: ["package", *K3B_DESIGNS]}
    same = {(tr, d): [] for tr in (False, True) for d in designs[tr]}
    same_dbar = {d: [] for d in designs[True]}
    ys = {}
    for (label, tr), (D, U, b, c, tb) in sets.items():
        tfp, yp = fk.fdn_tf_fwd_plain(D, U, b, c)
        ys[label, tr] = yp
        if tr:
            old = prev.tf_bwd(D, U, b, c, yp, tb)
            ref = fk.fdn_tf_bwd_plain(D, U, b, c, yp, tb)
            tol = cs.GRAD_TOL
        else:
            old = prev.tf_fwd(D, U, b, c)
            ref = (tfp, yp)
            tol = cs.VAL_TOL
        for d in designs[tr]:
            got = bwd(d, D, U, b, c, yp, tb) if tr else fwd(d, D, U, b, c)
            rel = max(cs.rel_err(g, r)[1] for g, r in zip(got, ref))
            cs.check(rel < tol, f"K3{'b' if tr else 'f'} design {d} on "
                     f"{label}: rel {rel:.3e} >= {tol:g}")
            same[tr, d].append(all(torch.equal(g, o)
                                   for g, o in zip(got, old)))
            if tr:
                same_dbar[d].append(torch.equal(got[0], old[0]))
            if not same[tr, d][-1]:
                diff = (got[0] != old[0]).reshape(got[0].shape[0], -1)
                print(f"  K3{'b' if tr else 'f'} design {d} on {label}: "
                      f"differs from the previous kernel; first output "
                      f"{cs.rel_err(got[0], old[0])[1]:.3e} of the max "
                      f"apart in {int(diff.any(dim=1).sum())} of "
                      f"{D.shape[0]} bins")
        share = cs.pivot_vote_share(fk._loop_matrix(D, U, tr))
        print(f"  pivot-vote share on {label}, "
              f"{'K3b (transposed)' if tr else 'K3f'}: bins {share[0]:.4f}, "
              f"warps {share[1]:.4f} of the steps k < N - 1")
    print("K3f: every design within VAL_TOL of the plain version; "
          "bit-identical to the previous K3f on every set: "
          + ", ".join(f"{K3F_DESIGNS.get(d, d)} {all(same[False, d])}"
                      for d in designs[False]))
    print("K3b: every design within GRAD_TOL of the plain version; "
          "bit-identical to the previous K3b on every set (D_bar alone): "
          + ", ".join(f"{K3B_DESIGNS.get(d, d)} {all(same[True, d])} "
                      f"({all(same_dbar[d])})" for d in designs[True]))
    if check_only:
        print(f"total {time.perf_counter() - t0:.1f} s on {card}")
        return 0

    # ------------------------------------------------------------- timing
    cases = []
    for label in ("main path", "random", "pivoting"):
        D, U, b, c, tb = sets[label, False]
        for d in ["prev", *designs[False]]:
            kernel = "tf_fwd_design" if isinstance(d, int) else "fdn_tf_fwd"
            cases.append((f"K3f {label} {K3F_DESIGNS.get(d, d)}",
                          lambda d=d, D=D, U=U, b=b, c=c: fwd(d, D, U, b, c),
                          kernel))
        D, U, b, c, tb = sets[label, True]
        y = ys[label, True]
        for d in ["prev", *designs[True]]:
            kernel = "tf_bwd_design" if isinstance(d, int) else "fdn_tf_bwd"
            cases.append((f"K3b {label} {K3B_DESIGNS.get(d, d)}",
                          lambda d=d, D=D, U=U, b=b, c=c, y=y, tb=tb:
                          bwd(d, D, U, b, c, y, tb), kernel))
    D, U, b, c, tb = sets["main path", False]
    D1, tb1, y1 = D[:1].contiguous(), tb[:1].contiguous(), \
        ys["main path", False][:1].contiguous()
    for d in ("prev", "package"):
        cases.append((f"K3f floor (one bin) {d}",
                      lambda d=d: fwd(d, D1, U, b, c), "fdn_tf_fwd"))
        cases.append((f"K3b floor (one bin) {d}",
                      lambda d=d: bwd(d, D1, U, b, c, y1, tb1), "fdn_tf_bwd"))
    times = {}
    for rnd in range(2):
        for key, fn, kernel in (cases if rnd == 0 else cases[::-1]):
            times.setdefault(key, []).append(cs.device_ms(fn, kernel))
    for key, v in times.items():
        print(f"  {key}: {v[0]:.6f} {v[1]:.6f} (mean {np.mean(v):.6f})")
    (BUILD / "k3_designs.json").write_text(json.dumps(
        {"card": card, "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
