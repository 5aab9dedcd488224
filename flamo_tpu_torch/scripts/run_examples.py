"""Run the port's examples at their defaults, one process each, and print
each one's exit code, seconds (wall clock, start-up included) and last
output line; exits non-zero when any example fails.

    python -m flamo_tpu_torch.scripts.run_examples [name ...] [--out DIR]

``name`` defaults to the filter-zoo examples (e4_recursion, e7_biquad,
e7_biquad_nn, e7_peq, e7_svf, e10_probe), the tutorial examples
(e0_siso, e1_mimo, e1_vn, e2_chaining_filters, e3_series_class,
e4_recursion_nn, e5_shell, e6_anti_aliasing, e7_geq) and the reverb
examples (e8_fdn, its four scenarios, and e9_loss_profile); each writes
into ``DIR/<name>`` (default ``build/examples``), its output in
``DIR/<name>.log``.  ``--nfft N`` passes N to every example (the
default: each example's own).  Without ``--device`` the examples run on
the CUDA card and stop without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ZOO = ("e4_recursion", "e7_biquad", "e7_biquad_nn", "e7_peq", "e7_svf",
       "e10_probe")
TUTORIAL = ("e0_siso", "e1_mimo", "e1_vn", "e2_chaining_filters",
            "e3_series_class", "e4_recursion_nn", "e5_shell",
            "e6_anti_aliasing", "e7_geq")
REVERB = ("e8_fdn", "e9_loss_profile")


def run(name: str, out: Path, extra=()) -> tuple[int, float, str]:
    """(exit code, seconds, last line) of one example's main, given the
    arguments ``extra`` besides its ``--train_dir``."""
    log = out / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.call([sys.executable, "-m",
                              f"flamo_tpu_torch.examples.{name}",
                              "--train_dir", str(out / name), *extra],
                             stdout=f, stderr=subprocess.STDOUT)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in log.read_text().splitlines() if ln.strip()]
    return rc, seconds, lines[-1] if lines else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*",
                    default=list(ZOO + TUTORIAL + REVERB))
    ap.add_argument("--out", type=Path, default=Path("build/examples"))
    ap.add_argument("--nfft", type=int, default=None)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    extra = () if args.nfft is None else ("--nfft", str(args.nfft))
    failed = []
    for name in args.names:
        rc, seconds, last = run(name, args.out, extra)
        print(f"{name}: rc {rc}, {seconds:.1f} s; {last}", flush=True)
        if rc:
            failed.append(name)
    if failed:
        print(f"failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
