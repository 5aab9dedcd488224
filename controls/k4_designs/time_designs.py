"""Time the candidate designs of K4f and K4b (the SOS cascade and its tap
VJP) against the kernels before their redesign, on one CUDA card.

Run from the root of the repository:

    python controls/k4_designs/time_designs.py

It builds, at once, with nvcc (sm_90a, with the register report):
``controls/sos_kernels_prev/sos_kernels.cu`` for N = 6, the K4 kernels
before the redesign; ``controls/k4_designs/sos_cascade.cu``, which holds
every candidate (K4f: (a) one thread a bin over a block of cb channels,
(b) one thread per (bin, channel) in blocks of 32 bins x cb channels that
fill whole waves, (c) (a) with cb a compile-time count; K4b: (a) the
transposed tap sums over a block of cb channels, (b) the grid (bin
blocks, N) of the previous kernel with its warp sums taken by recursive
halving, (c) (a) with cb a compile-time count and blocks of 128, 64 or 32
bins, (d) (c) with branch-free tap sums and its G loads issued at once);
and the package's own ``sos_cascade`` library, which grew from (c) for
K4f and (d) for K4b: each section's Horner sum started from its top tap
times z, the taps staged with every load in flight, the cascade's k loop
unrolled by 2, the tap sums' items stepped without a division and their
reciprocal one instruction.  Each candidate is held to the
plain PyTorch version first, at the attenuated FDN's size (M = 48001,
N = 6, K = 12, P = 3; random taps at 1e-5 on H and 1e-4 on the tap
cotangents, the FDN's GEQ taps at 5e-3 and 1e-3), on a 5 x 5 GEQ's 25
channels and at a ragged M with a bin offset; then every case is timed
by torch.profiler (device ms per call over 50 calls), twice, the second
pass in reverse order: each design at several channel blocks, the
previous kernels, and K4f/K4b on one bin (the floor).  The times go to
``build/controls/k4_designs.json`` and the register report to
``build/controls/k4_designs_ptxas.txt``.
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
from flamo_tpu_torch.ops import sos_kernels as sk  # noqa: E402

BUILD = ROOT / "build" / "controls"
OUT = BUILD / "k4_designs.json"
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = {0: "bins", 1: "lanes", 2: "bins/NC"}
BWD = {0: "sums", 1: "halving", 2: "sums/NC", 3: "free"}


def nc_parts(cb: int, K: int, P: int, bins: int, row: int) -> int:
    """K4b (c)'s and (d)'s runs: sos_kernels.k4b_tap_parts with `bins`
    bins a block, rows of `row` float2 (the fewest bin visits for the
    busiest of 128 threads, within 48 KB)."""
    S, taps = 2 * K * cb, 2 * P * K * cb
    best, best_cost, parts = 1, -(-S // 128) * bins, 2
    while parts <= bins:
        if taps + 2 * bins * row + parts * taps > 48 * 1024 // 4:
            break
        cost = -(-S * parts // 128) * (bins // parts)
        if cost < best_cost:
            best, best_cost = parts, cost
        parts *= 2
    return best


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src, n in (
            ("prev", "controls/sos_kernels_prev/sos_kernels.cu", 6),
            ("designs", "controls/k4_designs/sos_cascade.cu", 1)):
        so = BUILD / f"lib{name}_k4-n{n}.so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.NVCC_FLAGS,
             f"-DFDN_N={n}", "-o", str(so), str(ROOT / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuda_build.load(1, "sos_cascade")
    logs = []
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{out}")
        logs.append(f"# {name}\n{out}")
    (BUILD / "k4_designs_ptxas.txt").write_text("\n".join(logs))
    for log in logs:
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line:
                print("  " + line.strip()[:150])
    prev = ctypes.CDLL(str(jobs["prev"][0]))
    new = ctypes.CDLL(str(jobs["designs"][0]))
    prev.sos_cascade_fwd_launch.argtypes = [P_] * 3 + [I_] * 4 + [F_, F_, P_]
    prev.sos_cascade_bwd_launch.argtypes = [P_] * 4 + [I_] * 4 + [F_, F_, P_]
    new.sos_cascade_fwd_launch.argtypes = [P_] * 3 + [I_] * 6 + [F_, F_, P_]
    new.sos_cascade_bwd_launch.argtypes = [P_] * 4 + [I_] * 7 + [F_, F_, P_]
    new.sos_cascade_fwd_nc_launch.argtypes = [P_] * 3 + [I_] * 5 + [F_, F_,
                                                                   P_]
    new.sos_cascade_bwd_nc_launch.argtypes = [P_] * 4 + [I_] * 7 + [F_, F_,
                                                                   P_]
    new.sos_cascade_bwd_free_launch.argtypes = (
        new.sos_cascade_bwd_nc_launch.argtypes)
    return prev, new


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def main() -> int:
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_line()
    print(card)
    t0 = time.perf_counter()
    prev, new = build()
    print(f"built in {time.perf_counter() - t0:.1f} s")

    def fwd(design, b, a, nfft, cb=None, off=0.0):
        P, K, N = b.shape
        M = nfft // 2 + 1
        H = torch.empty((M, N), dtype=torch.complex64, device="cuda")
        ws = 2 * math.pi / nfft
        if design == "prev":
            rc = prev.sos_cascade_fwd_launch(b.data_ptr(), a.data_ptr(),
                                             H.data_ptr(), M, N, K, P, ws,
                                             off, stream())
        elif design == 2:
            rc = new.sos_cascade_fwd_nc_launch(
                b.data_ptr(), a.data_ptr(), H.data_ptr(), M, N, K, P,
                cb or sk.k4_channel_block(N), ws, off, stream())
        else:
            rc = new.sos_cascade_fwd_launch(
                b.data_ptr(), a.data_ptr(), H.data_ptr(), M, N, K, P,
                cb or sk.k4_channel_block(N), design, ws, off, stream())
        cs.check(rc == 0, f"K4f {design}: rc {rc}")
        return H

    def bwd(design, b, a, g, nfft, cb=None, off=0.0, bins=128):
        P, K, N = b.shape
        M = g.shape[0]
        ws = 2 * math.pi / nfft
        rows = -(-M // 128)
        if design in (2, 3):
            cb = cb or sk.k4_channel_block(N)
            launch = (new.sos_cascade_bwd_nc_launch if design == 2
                      else new.sos_cascade_bwd_free_launch)
            part = torch.empty((-(-M // bins), 2, P, K, N), device="cuda")
            rc = launch(b.data_ptr(), a.data_ptr(), g.data_ptr(),
                        part.data_ptr(), M, N, K, P, cb,
                        nc_parts(cb, K, P, bins, cb + 1), bins, ws, off,
                        stream())
            cs.check(rc == 0, f"K4b (c): rc {rc}")
            s = part.sum(0)
            return s[0], s[1]
        if design == "prev":
            part = torch.empty((rows, N, 2 * P * K), device="cuda")
            rc = prev.sos_cascade_bwd_launch(b.data_ptr(), a.data_ptr(),
                                             g.data_ptr(), part.data_ptr(),
                                             M, N, K, P, ws, off, stream())
            cs.check(rc == 0, f"K4b prev: rc {rc}")
            s = part.sum(0).reshape(N, 2, P, K).permute(1, 2, 3, 0)
            return s[0].contiguous(), s[1].contiguous()
        cb = cb or sk.k4_channel_block(N)
        part = torch.empty((rows, 2, P, K, N), device="cuda")
        rc = new.sos_cascade_bwd_launch(
            b.data_ptr(), a.data_ptr(), g.data_ptr(), part.data_ptr(), M, N,
            K, P, cb, sk.k4b_tap_parts(cb, K, P), design, ws, off, stream())
        cs.check(rc == 0, f"K4b {design}: rc {rc}")
        s = part.sum(0)
        return s[0], s[1]

    def rel(x, r):
        return float((x - r).abs().max() / r.abs().max())

    o = cs.main_path_operands(cs.M_MAIN, 6)
    g25 = cs.geq25_taps(cs.geq25())
    rng = np.random.default_rng(25)
    r25 = cs._stable_taps(rng, 3, 12, 25)
    cases = [("random N=6", o["bt"], o["at"], cs.NFFT, 0.0, cs.VAL_TOL,
              cs.GRAD_TOL),
             ("GEQ N=6", o["geq_bt"], o["geq_at"], cs.NFFT, 0.0,
              cs.GEQ_VAL_TOL, cs.GEQ_GRAD_TOL),
             ("GEQ 5x5 N=25", *g25, cs.NFFT, 0.0, cs.GEQ_VAL_TOL,
              cs.GEQ_GRAD_TOL),
             ("random N=25", *r25, cs.NFFT, 0.0, cs.VAL_TOL, cs.GRAD_TOL),
             ("random N=6 M=1001 offset 17", o["bt"], o["at"], 2000, 17.0,
              cs.VAL_TOL, cs.GRAD_TOL)]
    for label, b, a, nfft, off, vtol, gtol in cases:
        N = b.shape[2]
        M = nfft // 2 + 1
        g = torch.tensor((rng.normal(size=(M, N)) + 1j * rng.normal(
            size=(M, N))).astype(np.complex64), device="cuda")
        ref = sk.sos_cascade_fwd_plain(b, a, nfft, off or None)
        refb = sk.sos_cascade_bwd_plain(b, a, g, nfft, off or None)
        for d in ["prev", *FWD] if N == 6 else list(FWD):
            for cb in ((None,) if d == "prev" else (None, 3, 1)):
                e = rel(fwd(d, b, a, nfft, cb, off), ref)
                cs.check(e < vtol, f"K4f {d} cb={cb} {label}: {e:.3e}")
        for d in ["prev", *BWD] if N == 6 else list(BWD):
            for cb in ((None,) if d == "prev" else (None, 3, 1)):
                for bins in ((128, 64, 32) if d in (2, 3) else (128,)):
                    got = bwd(d, b, a, g, nfft, cb, off, bins)
                    e = max(rel(x, r) for x, r in zip(got, refb))
                    cs.check(e < gtol, f"K4b {d} cb={cb} bins={bins} "
                             f"{label}: {e:.3e}")
                    if d in (0, 2, 3):
                        again = bwd(d, b, a, g, nfft, cb, off, bins)
                        cs.check(all(torch.equal(x, y) for x, y in
                                     zip(got, again)), f"K4b {label} twice")
        # the package's library
        e = rel(sk.sos_cascade_fwd_kernel(b, a, nfft, off or None), ref)
        cs.check(e < vtol, f"package K4f {label}: {e:.3e}")
        got = sk.sos_cascade_bwd_kernel(b, a, g, nfft, off or None)
        e = max(rel(x, r) for x, r in zip(got, refb))
        cs.check(e < gtol, f"package K4b {label}: {e:.3e}")
        again = sk.sos_cascade_bwd_kernel(b, a, g, nfft, off or None)
        cs.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                 f"package K4b {label} twice")
        print(f"  {label}: every design and the package's kernels equal the "
              "plain version")

    gb, ga, g = o["geq_bt"], o["geq_at"], o["g"]
    g1 = g[:1].contiguous()
    timing = []
    for d, cbs in (("prev", (None,)), (0, (6,)), (1, (6,)), (2, (6, 3, 2))):
        for cb in cbs:
            name = FWD.get(d, "prev") + ("" if cb is None else f" cb={cb}")
            timing.append((f"K4f {name}", lambda d=d, cb=cb: fwd(
                d, gb, ga, cs.NFFT, cb), "fwd"))
    for d, cbs, binss in (("prev", (None,), (128,)), (0, (6, 2), (128,)),
                          (1, (None,), (128,)), (2, (6, 2), (128,)),
                          (3, (6, 3, 2), (128, 64)), (3, (1,), (128,))):
        for cb in cbs:
            for bins in binss:
                name = (BWD.get(d, "prev") + ("" if cb is None else
                                              f" cb={cb}")
                        + (f" bins={bins}" if d in (2, 3) else ""))
                timing.append((f"K4b {name}", lambda d=d, cb=cb, bins=bins:
                               bwd(d, gb, ga, g, cs.NFFT, cb, 0.0, bins),
                               "bwd"))
    gk1, ak1 = gb[:, :1].contiguous(), ga[:, :1].contiguous()
    timing += [
        ("K4f package", lambda: sk.sos_cascade_fwd_kernel(gb, ga, cs.NFFT),
         "fwd"),
        ("K4b package", lambda: sk.sos_cascade_bwd_kernel(gb, ga, g, cs.NFFT),
         "bwd"),
        ("K4f package floor (M=1)",
         lambda: sk.sos_cascade_fwd_kernel(gb, ga, 1), "fwd"),
        ("K4b package floor (M=1)",
         lambda: sk.sos_cascade_bwd_kernel(gb, ga, g1, cs.NFFT), "bwd"),
        ("K4f package floor (M=1, K=1)",
         lambda: sk.sos_cascade_fwd_kernel(gk1, ak1, 1), "fwd"),
        ("K4b package floor (M=1, K=1)",
         lambda: sk.sos_cascade_bwd_kernel(gk1, ak1, g1, cs.NFFT), "bwd")]
    for d in ("prev", 0, 2):
        name = FWD.get(d, "prev")
        timing.append((f"K4f {name} floor (M=1)", lambda d=d: fwd(
            d, gb, ga, 1), "fwd"))
        timing.append((f"K4f {name} floor (M=1, K=1)", lambda d=d: fwd(
            d, gk1, ak1, 1), "fwd"))
    for d in ("prev", 0, 2, 3):
        name = BWD.get(d, "prev")
        timing.append((f"K4b {name} floor (M=1)", lambda d=d: bwd(
            d, gb, ga, g1, cs.NFFT), "bwd"))
        timing.append((f"K4b {name} floor (M=1, K=1)", lambda d=d: bwd(
            d, gk1, ak1, g1, cs.NFFT), "bwd"))
    g25b, g25a = g25
    G25 = torch.tensor((rng.normal(size=(cs.M_MAIN, 25)) + 1j * rng.normal(
        size=(cs.M_MAIN, 25))).astype(np.complex64), device="cuda")
    for d in FWD:
        timing.append((f"K4f {FWD[d]} N=25", lambda d=d: fwd(
            d, g25b, g25a, cs.NFFT), "fwd"))
    for d in BWD:
        timing.append((f"K4b {BWD[d]} N=25", lambda d=d: bwd(
            d, g25b, g25a, G25, cs.NFFT), "bwd"))
    timing.append(("K4b free N=25 bins=64", lambda: bwd(
        3, g25b, g25a, G25, cs.NFFT, None, 0.0, 64), "bwd"))
    timing.append(("K4f package N=25", lambda: sk.sos_cascade_fwd_kernel(
        g25b, g25a, cs.NFFT), "fwd"))
    timing.append(("K4b package N=25", lambda: sk.sos_cascade_bwd_kernel(
        g25b, g25a, G25, cs.NFFT), "bwd"))
    times = {}
    for rnd in range(2):
        for key, fn, kernel in (timing if rnd == 0 else timing[::-1]):
            times.setdefault(key, []).append(cs.device_ms(fn, kernel))
    for key, v in times.items():
        print(f"  {key}: {v[0]:.6f} {v[1]:.6f} (mean {np.mean(v):.6f})")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "device_ms": times}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
