"""Time the candidate designs of K9 'highest' (the active-acoustics taps
step's FP32 kernel) and of K2 (the FDN per-bin solve) against the previous
kernels, on one CUDA card.

Run from the root of the repository:

    python controls/k9_k2_designs/time_designs.py [--check]

It builds, at once, with nvcc (sm_90a, with the register report):
``controls/k9_k2_designs/aa_designs.cu`` (N = 4: the FP32 K9 with its tile
shapes as template arguments behind ``aa_taps_design_launch``: tw staged
or through L1, cotangent tiles of 8 x 4 or 4 x 8, synthesis tiles of 4 or
8 columns, the powers from sincospif, and the package's kernel with one
phase left out, to time the others: such a probe's results are wrong and
not checked), ``controls/k9_k2_designs/fdn_designs.cu`` (N = 6: K2 with
ge_pivot's selects at every step, a vote a step or a vote a candidate
row, U staged or through L1, float4 or float2 rows, blocks of 128 or 64
bins, behind ``fdn_solve_design_launch``), the package's ``aa_kernels``
and ``fdn_kernels`` and the previous libraries ``controls/aa_kernels_prev``
and ``controls/fdn_kernels_prev``.  Each candidate is first held to the
plain PyTorch version: K9 on the active-acoustics rig's own rows (pivot
on and off, bin offset 0 and 24000) and on random rows at ragged sizes
(1e-5 on the loss, 1e-4 of the max on the tap cotangent); K2 on the
main path's operands and on chip_smoke.k2_systems (random, pivoting at
every step, tied), each way, bit for bit against the previous K2.  Then
(without ``--check``) each is timed by torch.profiler (device ms per call
over 50 calls), every case twice, the second pass in reverse order, and
on one tile or one bin (the floor).  The K2 pivot-vote shares of those
systems are printed.  The libraries, the register report
(designs_ptxas.txt) and the times (k9_k2_designs.json) go to
build/controls/.
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
from flamo_tpu_torch.ops import aa_kernels as ak  # noqa: E402
from flamo_tpu_torch.ops import cuda_build  # noqa: E402
from flamo_tpu_torch.ops import fdn_kernels as fk  # noqa: E402

BUILD = ROOT / "build" / "controls"
HERE = Path(__file__).resolve().parent
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K9_DESIGNS = {0: "staged, cot 8x4, syn 4 (first version)", 1: "tw in L1",
              2: "cot 4x8", 3: "syn 8", 4: "probe: no cotangent",
              5: "probe: no synthesis", 6: "probe: no solve",
              7: "probe: no powers", 8: "sincospif powers", 9: "cot 6x4",
              10: "cot 8x3", 11: "cot 8x4 columns first",
              12: "cot 6x4, sincospif", 13: "cot 8x3, sincospif",
              14: "cot 6x4 columns first (package)",
              15: "cot 6x4 columns first, "
              "sincospif", 16: "cot 7x4 columns first",
              17: "cot 6x5 columns first", 18: "cot 4x6 columns first"}
K9_PROBES = (4, 5, 6, 7)  # a phase left out: timed, not checked
K2_DESIGNS = {0: "selects, ldg U, float2", 1: "step vote, smem U, float4",
              2: "row vote, smem U, float4 (package)",
              3: "step vote, ldg U, float2", 4: "selects, smem U, float4",
              5: "step vote, 64-bin blocks", 6: "row vote, 64-bin blocks",
              7: "row vote, ldg U, float2"}


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def build():
    """The two design libraries, the previous ones and the package's, all
    nvcc's at once; returns (aa designs, fdn designs, cs.Previous)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, n in (("aa_designs", cs.AA_N), ("fdn_designs", cs.N_MAIN)):
        so = BUILD / f"lib{name}-n{n}.so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
             f"-DFDN_N={n}", "-o", str(so), str(HERE / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    prev_procs = cs.Previous.start(True, (("fdn", cs.N_MAIN), ("aa", cs.AA_N)))
    log = BUILD / "designs_ptxas.txt"
    log.write_text("")
    cuda_build.build((("aa_kernels", cs.AA_N), ("fdn_kernels", cs.N_MAIN)),
                     ptxas_log=BUILD / "package_ptxas.txt")
    with log.open("a") as f:
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{out}")
            f.write(f"# {name}\n{out}")
    prev = cs.Previous(prev_procs, log)
    aa = ctypes.CDLL(str(jobs["aa_designs"][0]))
    aa.aa_taps_design_grid.argtypes = [I_] * 5
    aa.aa_taps_design_launch.argtypes = ([I_, I_] + [P_] * 8 + [F_]
                                         + [I_] * 5 + [F_, I_, P_])
    fdn = ctypes.CDLL(str(jobs["fdn_designs"][0]))
    fdn.fdn_solve_design_launch.argtypes = [I_] * 3 + [P_] * 4 + [I_, P_]
    return aa, fdn, prev


def main() -> int:
    check_only = "--check" in sys.argv[1:]
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_line()
    print(card)
    t0 = time.perf_counter()
    aa, fdn, prev = build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    cs.print_ptxas((BUILD / "designs_ptxas.txt").read_text()
                   + (BUILD / "package_ptxas.txt").read_text())
    name = ""
    for line in (BUILD / "designs_ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "design_kernel" in name and ("registers" in line
                                          or "spill" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # ---------------------------------------------------------------- K9
    def k9(design, rows, pivot=False, off=0, N=cs.AA_N, L=cs.AA_L):
        hr, hi, tw, rr, ri, t = rows
        M, order = hr.shape[1], tw.shape[0]
        grid = aa.aa_taps_design_grid(design, int(pivot), order, L, M)
        cs.check(grid > 0, f"K9 design {design} grid {grid}")
        loss_row = torch.empty((M,), device="cuda")
        parts = torch.empty((grid, order, L * N), device="cuda")
        rc = aa.aa_taps_design_launch(
            design, int(pivot), hr.data_ptr(), hi.data_ptr(), tw.data_ptr(),
            rr.data_ptr(), ri.data_ptr(), t.data_ptr(), loss_row.data_ptr(),
            parts.data_ptr(), 2.0 / (M * N), L, M, order, cs.NFFT, off,
            2.0 * math.pi / cs.NFFT, grid, stream())
        cs.check(rc == 0, f"K9 design {design}: rc {rc}")
        return torch.sum(loss_row) / (M * N), torch.sum(parts, dim=0)

    rig = cs.aa_rig()
    o = cs.aa_kernel_operands(rig)
    keys = ("hr", "hi", "tw", "rr", "ri", "t")
    cases9 = [((False, 0), [o[k] for k in keys])]
    cases9.append(((True, 0), cases9[0][1]))
    cases9.append(((False, cs.AA_OFFSET),
                   [o[k][:, cs.AA_OFFSET:].contiguous() if k != "tw"
                    else o[k] for k in keys]))
    rng = np.random.default_rng(11)
    for M, order in ((1, 1), (65, 17), (4097, 284), (4097, 150)):
        x = [torch.tensor(rng.normal(size=(cs.AA_N * cs.AA_L, M)).astype(
            np.float32), device="cuda") for _ in range(2)]
        x.append(torch.tensor((0.05 / order * rng.normal(
            size=(order, cs.AA_L * cs.AA_N))).astype(np.float32),
            device="cuda"))
        x += [torch.tensor(rng.normal(size=(cs.AA_N, M)).astype(np.float32),
                           device="cuda") for _ in range(2)]
        x.append(torch.tensor(rng.uniform(size=(cs.AA_N, M)).astype(
            np.float32), device="cuda"))
        cases9.append(((False, 1000), x))
    for (pivot, off), rows in cases9:
        ref = ak.aa_taps_tf_mse_plain(*rows, cs.AA_N, cs.AA_L, cs.NFFT, pivot,
                                      off, "highest")
        for d in (d for d in K9_DESIGNS if d not in K9_PROBES):
            got = k9(d, rows, pivot, off)
            again = k9(d, rows, pivot, off)
            cs.check(abs(float(got[0] - ref[0])) / float(ref[0])
                     < cs.AA_LOSS_TOL and rel(got[1], ref[1]) < cs.AA_GRAD_TOL
                     and all(torch.equal(g, a) for g, a in zip(got, again)),
                     f"K9 design {d} pivot={pivot} off={off} "
                     f"M={rows[0].shape[1]} order={rows[2].shape[0]}: loss "
                     f"{float(got[0])} vs {float(ref[0])}, tb rel "
                     f"{rel(got[1], ref[1]):.3e}")
        got = ak.aa_taps_tf_mse_kernel(*rows, cs.AA_N, cs.AA_L, cs.NFFT, pivot,
                                       "highest", off)
        cs.check(abs(float(got[0] - ref[0])) / float(ref[0]) < cs.AA_LOSS_TOL
                 and rel(got[1], ref[1]) < cs.AA_GRAD_TOL,
                 f"package K9 'highest' pivot={pivot} off={off}")
        for p in ("high", "default"):
            new = ak.aa_taps_tf_mse_kernel(*rows, cs.AA_N, cs.AA_L, cs.NFFT,
                                           pivot, p, off)
            old = prev.aa_taps(*rows, cs.AA_N, cs.AA_L, cs.NFFT, pivot, p, off)
            cs.check(all(torch.equal(a, b) for a, b in zip(new, old)),
                     f"K9 {p}: not bit-identical to the previous library")
    print("K9: every design and the package's 'highest' equal the plain "
          "version (the rig's rows, pivot and bin offset, random rows at "
          "M = 1/65/4097, orders 1/17/150/284); 'high' and 'default' equal "
          "the previous library bit for bit")

    # ---------------------------------------------------------------- K2
    N = cs.N_MAIN

    def k2(design, D, U, B, tr):
        Y = torch.empty_like(B)
        if design == "prev":
            return prev.fdn_solve(D, U, B, bool(tr))
        if design == "package":
            return fk.fdn_solve_kernel(D, U, B, bool(tr))
        rc = fdn.fdn_solve_design_launch(design, N, tr, D.data_ptr(),
                                         U.data_ptr(), B.data_ptr(),
                                         Y.data_ptr(), D.shape[0], stream())
        cs.check(rc == 0, f"K2 design {design}: rc {rc}")
        return Y

    mo = cs.main_path_operands(cs.M_MAIN, N)
    k2_sets = {}
    for tr in (0, 1):
        k2_sets[("main path", tr)] = (mo["D"], mo["U"], mo["B"])
        for label, system in cs.k2_systems(np.random.default_rng(20 + tr),
                                           cs.M_MAIN, N, bool(tr)).items():
            k2_sets[(label, tr)] = cs.k2_tensors(system)
    same = {d: [] for d in ["package", *K2_DESIGNS]}
    for (label, tr), (D, U, B) in k2_sets.items():
        old = prev.fdn_solve(D, U, B, bool(tr))
        plain = fk.fdn_solve_plain(D, U, B, bool(tr))
        exact = (torch.ones(D.shape[0], dtype=torch.bool)
                 if label.startswith("tied")
                 else torch.zeros(D.shape[0], dtype=torch.bool))
        ref_cpu = fk.fdn_solve_plain(D.cpu(), U.cpu(), B.cpu(), bool(tr))
        for d in same:
            got = k2(d, D, U, B, tr)
            cs.check(rel(got, plain) < cs.VAL_TOL and torch.equal(
                got.cpu()[exact], ref_cpu[exact]),
                f"K2 design {d} on {label} tr={tr}: rel {rel(got, plain)}")
            same[d].append(torch.equal(got, old))
            if not same[d][-1]:
                print(f"  K2 design {d} on {label} tr={tr}: differs from the "
                      f"previous K2 by {rel(got, old):.3e} of the max in "
                      f"{int((got != old).any(dim=1).sum())} of "
                      f"{D.shape[0]} bins")
        share = cs.pivot_vote_share(fk._loop_matrix(D, U, bool(tr)))
        print(f"  K2 pivot-vote share on {label}, transpose={tr}: bins "
              f"{share[0]:.4f}, warps {share[1]:.4f} of the steps k < N - 1")
    print("K2: every design equals the plain version (1e-5; the exact tied "
          "systems bit for bit); bit-identical to the previous K2 on every "
          "set: " + ", ".join(f"{K2_DESIGNS.get(d, d)} {all(v)}"
                               for d, v in same.items()))
    if check_only:
        print(f"total {time.perf_counter() - t0:.1f} s on {card}")
        return 0

    # ------------------------------------------------------------- timing
    main9 = cases9[0][1]
    one_tile = [x[:, :64].contiguous() if x is not main9[2] else x
                for x in main9]
    cases = []
    for d, label in K9_DESIGNS.items():
        cases.append((f"K9 {label}", lambda d=d: k9(d, main9),
                      "aa_taps_design"))
    cases += [("K9 previous", lambda: prev.aa_taps(
        *main9, cs.AA_N, cs.AA_L, cs.NFFT, precision="highest"),
        "aa_taps_tf_mse_kernel"),
        ("K9 package", lambda: ak.aa_taps_tf_mse_kernel(
            *main9, cs.AA_N, cs.AA_L, cs.NFFT, precision="highest"),
         "aa_taps_tf_mse_kernel"),
        ("K9 package 'high'", lambda: ak.aa_taps_tf_mse_kernel(
            *main9, cs.AA_N, cs.AA_L, cs.NFFT, precision="high"),
         "aa_taps_tf_mse_tc_kernel"),
        ("K9 package floor (one tile)", lambda: ak.aa_taps_tf_mse_kernel(
            *one_tile, cs.AA_N, cs.AA_L, cs.NFFT, precision="highest"),
         "aa_taps_tf_mse_kernel"),
        ("K9 previous floor (one tile)", lambda: prev.aa_taps(
            *one_tile, cs.AA_N, cs.AA_L, cs.NFFT, precision="highest"),
         "aa_taps_tf_mse_kernel")]
    for label in ("main path", "random", "pivoting", "cycle"):
        for tr in (0, 1):
            D, U, B = k2_sets[(label, tr)]
            for d in ["prev", "package", *K2_DESIGNS]:
                name = K2_DESIGNS.get(d, d)
                cases.append((f"K2 {label} tr={tr} {name}",
                              lambda d=d, D=D, U=U, B=B, tr=tr:
                              k2(d, D, U, B, tr), "fdn_solve"))
            if label == "main path":
                D1, B1 = D[:1].contiguous(), B[:1].contiguous()
                for d in ("prev", "package"):
                    cases.append((f"K2 floor (one bin) tr={tr} {d}",
                                  lambda d=d, D1=D1, U=U, B1=B1, tr=tr:
                                  k2(d, D1, U, B1, tr), "fdn_solve"))
    times = {}
    for rnd in range(2):
        for key, fn, kernel in (cases if rnd == 0 else cases[::-1]):
            times.setdefault(key, []).append(cs.device_ms(fn, kernel))
    for key, v in times.items():
        print(f"  {key}: {v[0]:.6f} {v[1]:.6f} (mean {np.mean(v):.6f})")
    (BUILD / "k9_k2_designs.json").write_text(json.dumps(
        {"card": card, "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
