"""Time the candidate designs of K6 (the dense per-bin solve) and of K1's
block sums against the previous kernels, on one CUDA card.

Run from the root of the repository:

    python controls/k6_k1_designs/time_designs.py

It builds two libraries for N = 6 with nvcc (sm_90a, with the register
report), at once: ``controls/fdn_kernels_prev/fdn_kernels.cu``, the kernels
before the redesign, and ``controls/k6_k1_designs/fdn_kernels.cu``, which
holds every candidate behind ``fdn_dense_solve_variant_launch`` (K6: one
thread a system staged through shared memory in blocks of 32 or 128, a
group of lanes a system, one thread a system loading its own system in
blocks of 32 or 64), ``fdn_tf_mse_variant_launch`` and
``fdn_tf_bwd_variant_launch`` (K1 and K3b with their block sums as warp
trees, recursive halving or transposed through shared memory; K1's
training variant also in blocks of 64) and ``fdn_floor_launch`` (an empty
kernel and a one-load-one-store kernel).  Each candidate is held to the
plain PyTorch version first (K6 on random, on the scattering FDN's own and
on tied-pivot systems, the exact ones bit for bit; K1 and K3b at 1e-5 on
the loss and 1e-4 on the cotangents), then timed by torch.profiler (device
ms per call over 50 calls), every case twice, the second pass in reverse
order.  The libraries, the register report (designs_ptxas.txt) and the
times (k6_k1_designs.json) go to build/controls/.
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
N = 6
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K6 candidates of fdn_dense_solve_variant_launch
K6_DESIGNS = {0: "staged/32", 1: "staged/128", 2: "group/8 lanes",
              3: "direct/32", 4: "direct/64"}
REDUCE = {0: "trees", 1: "halving", 2: "transposed"}
SWEEP = (1, 2000, 4000, 8000, 16000, 32000, 48001)


def build() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in (("prev", "controls/fdn_kernels_prev/fdn_kernels.cu"),
                      ("designs", "controls/k6_k1_designs/fdn_kernels.cu")):
        so = BUILD / f"libfdn_{name}-n{N}.so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
             f"-DFDN_N={N}", "-o", str(so), str(ROOT / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{out}")
        logs.append(f"# {name}\n{out}")
    (BUILD / "designs_ptxas.txt").write_text("\n".join(logs))
    prev = ctypes.CDLL(str(jobs["prev"][0]))
    new = ctypes.CDLL(str(jobs["designs"][0]))
    prev.fdn_dense_solve_launch.argtypes = [I_, I_, P_, P_, P_, I_, P_]
    prev.fdn_tf_mse_launch.argtypes = [I_] * 3 + [P_] * 8 + [F_, I_, P_]
    prev.fdn_tf_bwd_launch.argtypes = [I_] + [P_] * 8 + [I_, P_]
    new.fdn_dense_solve_variant_launch.argtypes = [I_] * 3 + [P_] * 3 + [
        I_, P_]
    new.fdn_tf_mse_variant_launch.argtypes = [I_] * 5 + [P_] * 8 + [F_, I_,
                                                                    P_]
    new.fdn_tf_bwd_variant_launch.argtypes = [I_, I_] + [P_] * 8 + [I_, P_]
    new.fdn_floor_launch.argtypes = [I_, P_, P_, P_]
    return prev, new


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def main() -> int:
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line())
    t0 = time.perf_counter()
    prev, new = build()
    print(f"built in {time.perf_counter() - t0:.1f} s")

    def k6(design, A, B, tr, Y):
        M = B.shape[0]
        args = (A.data_ptr(), B.data_ptr(), Y.data_ptr(), M, stream())
        rc = (prev.fdn_dense_solve_launch(N, tr, *args) if design == "prev"
              else new.fdn_dense_solve_variant_launch(N, tr, design, *args))
        cs.check(rc == 0, f"K6 {design}: rc {rc}")
        return Y

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    dense = cs.dense_operands()
    designs = ["prev", *K6_DESIGNS]
    for shape, systems in dense.items():
        for label, tol in (("random", cs.VAL_TOL), ("model", cs.SFDN_VAL_TOL)):
            A, B = systems[label]
            for tr in (0, 1):
                ref = fk.dense_solve_plain(A, B, bool(tr))
                for d in designs:
                    e = rel(k6(d, A, B, tr, torch.empty_like(B)), ref)
                    cs.check(e < tol, f"K6 {d} {shape} {label}: {e:.3e}")
    At, Bt, ex = cs.tied_pivot_systems(np.random.default_rng(9), 2000, N)
    At = torch.tensor(At.astype(np.complex64), device="cuda")
    Bt = torch.tensor(Bt.astype(np.complex64), device="cuda")
    ex = torch.tensor(ex, device="cuda")
    for tr in (0, 1):
        ref = fk.dense_solve_plain(At.cpu(), Bt.cpu(), bool(tr)).cuda()
        for d in designs:
            got = k6(d, At, Bt, tr, torch.empty_like(Bt))
            cs.check(rel(got, ref) < cs.VAL_TOL
                     and torch.equal(got[ex], ref[ex]), f"K6 {d} tied")
    print("K6: every design equals the plain version (random, model, "
          "tied-pivot systems, the exact ones bit for bit)")

    o = cs.main_path_operands(cs.M_MAIN, N)
    D, U, b, c, X, t = (o[k] for k in "DUbcXt")

    def k1(design, pivot, wd, threads=128, rows=None):
        Dx, Xx, tx = ((D, X, t) if rows is None
                      else (D[:rows].contiguous(), X[:rows].contiguous(),
                            t[:rows].contiguous()))
        M = Dx.shape[0]
        Db = torch.empty_like(Dx)
        parts = torch.empty((-(-M // threads), N * N + 2 * N + 1),
                            device="cuda")
        args = (Dx.data_ptr(), U.data_ptr(), b.data_ptr(), c.data_ptr(),
                Xx.data_ptr(), tx.data_ptr(), Db.data_ptr(), parts.data_ptr(),
                2.0 / M, M, stream())
        rc = (prev.fdn_tf_mse_launch(N, pivot, wd, *args) if design == "prev"
              else new.fdn_tf_mse_variant_launch(N, pivot, wd, design,
                                                 threads, *args))
        cs.check(rc == 0, f"K1 {design}: rc {rc}")
        s = parts.sum(0)
        return (s[-1] / M, Db if wd else None, s[:36].reshape(6, 6),
                s[36:42], s[42:48])

    k1_designs = [("prev", 128)] + [(r, 128) for r in REDUCE]
    for pivot in (0, 1):
        for wd in (0, 1):
            ref = fk.fdn_tf_mse_plain(D, U, b, c, X, t, bool(wd), bool(pivot))
            main = not pivot and not wd
            for d, th in k1_designs + ([(r, 64) for r in REDUCE] if main
                                       else []):
                got = k1(d, pivot, wd, th)
                cs.check(abs(float(got[0] - ref[0])) / float(ref[0])
                         < cs.VAL_TOL, f"K1 {d}/{th} loss")
                for g, r in zip(got[1:], ref[1:]):
                    cs.check(r is None or rel(g, r) < cs.GRAD_TOL,
                             f"K1 {d}/{th} pivot={pivot} wd={wd}")
    _, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    ref = fk.fdn_tf_bwd_plain(D, U, b, c, y, o["tf_bar"])

    def k3b(design):
        M = D.shape[0]
        Db = torch.empty_like(D)
        parts = torch.empty((-(-M // 128), 49), device="cuda")
        args = (D.data_ptr(), U.data_ptr(), b.data_ptr(), c.data_ptr(),
                y.data_ptr(), o["tf_bar"].data_ptr(), Db.data_ptr(),
                parts.data_ptr(), M, stream())
        rc = (prev.fdn_tf_bwd_launch(N, *args) if design == "prev"
              else new.fdn_tf_bwd_variant_launch(N, design, *args))
        cs.check(rc == 0, f"K3b {design}: rc {rc}")
        s = parts.sum(0)
        return Db, s[:36].reshape(6, 6), s[36:42], s[42:48]

    for d in ["prev", *REDUCE]:
        for g, r in zip(k3b(d), ref):
            cs.check(rel(g, r) < cs.GRAD_TOL, f"K3b {d}")
    print("K1 and K3b: every design equals the plain version")

    cases = []
    src = torch.zeros(2, dtype=torch.complex64, device="cuda")
    for which, label in ((0, "empty kernel"), (1, "one load, one store")):
        cases.append((f"floor {label}", lambda w=which: new.fdn_floor_launch(
            w, src.data_ptr(), src[1:].data_ptr(), stream()), "kernel"))
    Am, Bm = dense["M"]["model"]
    Ap, Bp = dense["P"]["model"]
    for rows in SWEEP:
        A, B = (Ap, Bp) if rows == 2000 else (Am[:rows].contiguous(),
                                              Bm[:rows].contiguous())
        Y = torch.empty_like(B)
        for tr in (0, 1):
            for d in designs:
                if d == 2 and rows not in (1, 2000, 48001):
                    continue
                cases.append((f"K6 rows={rows} tr={tr} "
                              f"{K6_DESIGNS.get(d, d)}",
                              lambda d=d, A=A, B=B, tr=tr, Y=Y: k6(d, A, B,
                                                                   tr, Y),
                              "dense_solve"))
    for d, th in k1_designs + [(r, 64) for r in REDUCE]:
        name = "prev" if d == "prev" else REDUCE[d]
        for rows in (None, 1):
            cases.append((f"K1 main rows={rows or cs.M_MAIN} {name}/{th}",
                          lambda d=d, th=th, rows=rows: k1(d, 0, 0, th, rows),
                          "fdn_tf_mse"))
    for pivot, wd in ((1, 1), (1, 0), (0, 1)):
        for d, _ in k1_designs:
            name = "prev" if d == "prev" else REDUCE[d]
            cases.append((f"K1 pivot={pivot} with_dbar={wd} {name}",
                          lambda d=d, p=pivot, w=wd: k1(d, p, w),
                          "fdn_tf_mse"))
    for d in ["prev", *REDUCE]:
        name = "prev" if d == "prev" else REDUCE[d]
        cases.append((f"K3b {name}", lambda d=d: k3b(d), "fdn_tf_bwd"))
    times = {}
    for rnd in range(2):
        for key, fn, kernel in (cases if rnd == 0 else cases[::-1]):
            times.setdefault(key, []).append(cs.device_ms(fn, kernel))
    for key, v in times.items():
        print(f"  {key}: {v[0]:.6f} {v[1]:.6f} (mean {np.mean(v):.6f})")
    (BUILD / "k6_k1_designs.json").write_text(json.dumps(
        {"card": cs.gpu_line(), "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {cs.gpu_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
