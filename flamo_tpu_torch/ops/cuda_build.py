"""Build and load the hand-written CUDA kernels of ``flamo_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface (no PyTorch headers), under
``build/flamo_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``.  There is one library per kernel source and channel count
N (``-DFDN_N=<n>``): ``fdn_kernels.cu`` holds the per-bin eliminations
K1, K2, K3 and K6 and ``sos_kernels.cu`` the attenuated-FDN step K5 (n
in 1..16 for both), ``aa_kernels.cu`` the active-acoustics steps K8 and
K9 (N the microphone count, 1..8; the loudspeaker count and the FIR
order are runtime sizes), ``eig_kernels.cu`` the Durand-Kerner roots K7
(N the degree, 1..8, built without FMA contraction so that it repeats
its plain version's rounding).  Three sources take every size at run
time and are one library each, built as N = 1: ``sos_cascade.cu``, the
SOS cascade K4f and its tap VJP K4b (any channel count),
``phase2_micro.cu``, the four variants of the phase-2 micro-benchmark
K10, ``fdn_loop.cu``, the looped eliminations of K1, K2, K3f, K3b, K5
and K6 for more than 16 channels (one warp a bin, N a run-time argument;
linked with ``fdn_reg.cu``, the register-resident K2, K3f, K3b and K5
for 17..64 channels), and ``aa_loop.cu``, the looped K8 and K9 for more than 8
microphones.

The eliminations are unrolled over N and the large-N instantiations
compile slowly, so each (source, N) is its own library, built when a
kernel first needs it; :func:`build` starts several at once, one ``nvcc``
each.  A library's file name carries a hash of every source file, so an
edited source is rebuilt, and a finished build replaces the file
atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flamo_tpu_torch"
SOURCES = ("fdn_kernels.cu", "sos_kernels.cu", "sos_cascade.cu",
           "aa_kernels.cu", "eig_kernels.cu", "phase2_micro.cu", "fdn_loop.cu",
           "aa_loop.cu", "fdn_reg.cu", "fdn_ge.cuh", "fdn_loop.cuh",
           "fdn_reg.cuh", "sos_common.cuh", "aa_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_N = 16
# the channel counts (degrees for K7) each library is built for
LIB_MAX_N = {"fdn_kernels": MAX_N, "sos_kernels": MAX_N, "sos_cascade": 1,
             "aa_kernels": 8, "eig_kernels": 8, "phase2_micro": 1,
             "fdn_loop": 1, "aa_loop": 1}
# flags of one library only
LIB_FLAGS = {"eig_kernels": ("-fmad=false",)}
# the compile units of a library built from several (a source and its
# flags), each compiled to an object by its own nvcc, all started with the
# other libraries' compiles, then linked into the library; the looped
# library's register-resident kernels compile as six parts of fdn_reg.cu
LIB_UNITS = {"fdn_loop": (("fdn_loop.cu",),
                          *(("fdn_reg.cu", f"-DFDN_REG_PART={part}")
                            for part in range(1, 7)))}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# library -> (prefix of its C entry points, {name: (restype, argtypes)});
# every pointer and the stream are c_void_p
_SIGNATURES = {
    "fdn_kernels": ("fdn", {
        "fdn_threads_per_block": (_I, []),
        "fdn_channels": (_I, []),
        "fdn_error_string": (ctypes.c_char_p, [_I]),
        "fdn_tf_mse_launch": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _F, _I, _P]),
        "fdn_solve_launch": (_I, [_I, _I, _P, _P, _P, _P, _I, _P]),
        "fdn_dense_solve_launch": (_I, [_I, _I, _P, _P, _P, _I, _P]),
        "fdn_tf_fwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _P]),
        "fdn_tf_bwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _P]),
    }),
    "sos_kernels": ("sos", {
        "sos_threads_per_block": (_I, []),
        "sos_channels": (_I, []),
        "sos_error_string": (ctypes.c_char_p, [_I]),
        "fdn_sos_tf_mse_launch": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _F, _I, _I,
                                       _I, _F, _F, _P]),
    }),
    "sos_cascade": ("sc", {
        "sc_threads_per_block": (_I, []),
        "sc_channels": (_I, []),
        "sc_error_string": (ctypes.c_char_p, [_I]),
        "sos_cascade_fwd_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                                        _F, _P]),
        "sos_cascade_bwd_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _F, _F, _P]),
    }),
    "aa_kernels": ("aa", {
        "aa_threads_per_block": (_I, []),
        "aa_channels": (_I, []),
        "aa_error_string": (ctypes.c_char_p, [_I]),
        "aa_tf_mse_launch": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _F, _I, _I, _P]),
        "aa_taps_grid": (_I, [_I, _I, _I, _I, _I, _I]),
        "aa_taps_tf_mse_launch": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _F, _I, _I, _I, _I, _I, _F,
                                       _I, _P]),
    }),
    "eig_kernels": ("eig", {
        "eig_threads_per_block": (_I, []),
        "eig_channels": (_I, []),
        "eig_error_string": (ctypes.c_char_p, [_I]),
        "dk_roots_launch": (_I, [_I, _P, _P, _P, _P, _I, _I, _P]),
    }),
    "fdn_loop": ("fl", {
        "fl_threads_per_block": (_I, []),
        "fl_channels": (_I, []),
        "fl_error_string": (ctypes.c_char_p, [_I]),
        "fl_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
        "fl_warps": (_I, [_I, _I]),
        "fl_tf_mse_grid": (_I, [_I, _I, _I, _I]),
        "fl_solve_launch": (_I, [_I, _I, _P, _P, _P, _P, _I, _P]),
        "fl_dense_solve_launch": (_I, [_I, _I, _P, _P, _P, _I, _P]),
        "fl_tf_mse_launch": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _F, _I, _I, _P]),
        "fl_tf_fwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _P]),
        "fl_tf_bwd_grid": (_I, [_I, _I]),
        "fl_tf_bwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _P]),
        "fl_sos_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I, _I]),
        "fl_sos_warps": (_I, [_I, _I, _I, _I]),
        "fl_sos_tf_mse_grid": (_I, [_I, _I, _I, _I, _I, _I, _I]),
        "fl_sos_tf_mse_launch": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P, _F, _I, _I, _I, _F,
                                      _F, _I, _P]),
        "fl_solve_resident_warps": (_I, [_I, _I]),
        "fl_tf_resident_warps": (_I, [_I, _I]),
        "fl_sos_resident_warps": (_I, [_I, _I, _I, _I, _I, _I]),
        "fl_reg_bins": (_I, [_I, _I, _I, _I, _I]),
        "fl_reg_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I, _I, _I]),
        "fl_reg_group_warps": (_I, [_I]),
        "fl_reg_solve_resident_warps": (_I, [_I]),
        "fl_reg_tf_fwd_resident_warps": (_I, [_I]),
        "fl_reg_tf_bwd_resident_warps": (_I, [_I]),
        "fl_reg_sos_resident_warps": (_I, [_I, _I, _I, _I, _I]),
        "fl_reg_solve_launch": (_I, [_I, _I, _P, _P, _P, _P, _I, _P]),
        "fl_reg_tf_fwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _P]),
        "fl_reg_tf_bwd_grid": (_I, [_I, _I]),
        "fl_reg_tf_bwd_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _P]),
        "fl_reg_sos_tf_mse_grid": (_I, [_I, _I, _I, _I, _I, _I]),
        "fl_reg_sos_tf_mse_launch": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _P, _P, _P, _F, _I, _I,
                                          _I, _F, _F, _I, _P]),
    }),
    "aa_loop": ("aal", {
        "aal_threads_per_block": (_I, []),
        "aal_channels": (_I, []),
        "aal_error_string": (ctypes.c_char_p, [_I]),
        "aal_tf_mse_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
        "aal_tf_mse_warps": (_I, [_I, _I]),
        "aal_taps_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I, _I, _I]),
        "aal_taps_bins": (_I, [_I, _I, _I, _I]),
        "aal_taps_solvers": (_I, [_I, _I, _I, _I]),
        "aal_tf_mse_launch": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _F, _I, _I, _P]),
        "aal_taps_grid": (_I, [_I, _I, _I, _I, _I, _I]),
        "aal_taps_launch": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _F, _I, _I, _I, _I, _I, _F, _I, _P]),
    }),
    "phase2_micro": ("p2", {
        "p2_threads_per_block": (_I, []),
        "p2_channels": (_I, []),
        "p2_error_string": (ctypes.c_char_p, [_I]),
        "p2_rows": (_I, [_I, _I, _I, _I, _I, _I, _F]),
        "p2_launch": (_I, [_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                           _P]),
        "p2_attributes": (_I, [_I, _I, _P, _P]),
    }),
}

_LIBS: dict[tuple[str, int], ctypes.CDLL] = {}
_THREADS: dict[tuple[str, int], int] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _check_target(lib: str, n: int) -> None:
    if lib not in _SIGNATURES:
        raise ValueError(f"unknown kernel library {lib!r}")
    if not 1 <= n <= LIB_MAX_N[lib]:
        raise ValueError(f"N = {n} channels; the kernels of {lib} take "
                         f"1..{LIB_MAX_N[lib]}")


def library_path(n: int, lib: str = "fdn_kernels") -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{lib}-n{n}-{digest.hexdigest()[:16]}.so"


def build(targets, ptxas_log: Path | None = None) -> dict:
    """Compile the (library, N) pairs of ``targets`` that are not built
    yet, one ``nvcc`` each (one a unit for the libraries of
    ``LIB_UNITS``, then a link), all started together; returns the
    seconds from the start to the end of each compiled library's
    ``nvcc``, by (library, N) (empty when nothing was built: the largest
    is the call's wall time).  With ``ptxas_log`` every named library is
    compiled and the compiler's per-kernel register and spill report
    goes there."""
    todo = []
    for lib, n in dict.fromkeys((lib, int(n)) for lib, n in targets):
        _check_target(lib, n)
        if ptxas_log is not None or not library_path(n, lib).exists():
            todo.append((lib, n))
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []  # (lib, n, output, log, process): a library or one unit's object
    for lib, n in todo:
        tmp = library_path(n, lib).with_suffix(f".{os.getpid()}.tmp")
        units = LIB_UNITS.get(lib)
        if units is None:
            cmds = [(tmp, [*NVCC_FLAGS, *LIB_FLAGS.get(lib, ()),
                           f"-DFDN_N={n}", "-o", str(tmp),
                           str(CSRC / f"{lib}.cu")])]
        else:
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            cmds = [(obj, [*compile_flags, "-c", *LIB_FLAGS.get(lib, ()),
                           f"-DFDN_N={n}", *flags, "-o", str(obj),
                           str(CSRC / src)])
                    for i, (src, *flags) in enumerate(units)
                    for obj in [tmp.with_suffix(f".{i}.o")]]
        for out, args in cmds:
            cmd = [nvcc, *args]
            if ptxas_log is not None:
                cmd[1:1] = ["-Xptxas", "-v"]
            log = tempfile.TemporaryFile(mode="w+")
            jobs.append((lib, n, out, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    ended, pending = {}, list(jobs)
    while pending:  # each job's own time, taken when its nvcc ends
        for job in [j for j in pending if j[4].poll() is not None]:
            ended[job[2]] = time.perf_counter() - t0
            pending.remove(job)
        if pending:
            time.sleep(0.05)
    seconds, reports, failures = {}, [], []
    for lib, n in todo:
        mine = [j for j in jobs if j[:2] == (lib, n)]
        ok = True
        for *_, log, proc in mine:
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                failures.append(
                    f"{lib} N={n} (exit {proc.returncode}):\n{text}")
                ok = False
            else:
                reports.append(f"# {lib} N = {n}\n{text}")
        objs = [str(j[2]) for j in mine] if lib in LIB_UNITS else []
        if not ok:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            continue
        tmp = library_path(n, lib).with_suffix(f".{os.getpid()}.tmp")
        seconds[(lib, n)] = max(ended[j[2]] for j in mine)
        if objs:  # link the units' objects
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            for obj in objs:
                os.remove(obj)
            if link.returncode != 0:
                failures.append(f"{lib} N={n} (link, exit {link.returncode}):"
                                f"\n{link.stdout}{link.stderr}")
                continue
            seconds[(lib, n)] = time.perf_counter() - t0
        os.replace(tmp, library_path(n, lib))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    if ptxas_log is not None:
        ptxas_log.parent.mkdir(parents=True, exist_ok=True)
        ptxas_log.write_text("\n".join(reports))
    return seconds


def load(n: int, lib: str = "fdn_kernels") -> ctypes.CDLL:
    """The loaded kernel library ``lib`` for N channels (built first if
    needed)."""
    key = (lib, n)
    if key not in _LIBS:
        _check_target(lib, n)
        build(((lib, n),))
        path = library_path(n, lib)
        handle = ctypes.CDLL(str(path))
        prefix, sigs = _SIGNATURES[lib]
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(handle, name)
            fn.restype = restype
            fn.argtypes = argtypes
        built_n = getattr(handle, f"{prefix}_channels")()
        if built_n != n:
            raise RuntimeError(f"{path} holds N = {built_n}, not {n}")
        _THREADS[key] = getattr(handle, f"{prefix}_threads_per_block")()
        _LIBS[key] = handle
    return _LIBS[key]


def threads_per_block(n: int, lib: str = "fdn_kernels") -> int:
    """The block size of a library's kernels, read from it once, when it
    is loaded."""
    load(n, lib)
    return _THREADS[(lib, n)]


def check(rc: int, what: str, n: int, lib: str = "fdn_kernels") -> None:
    """Raise if a launch entry point reported an error."""
    if rc == -1:
        raise ValueError(f"{what}: the library of N = {n} refused the "
                         "channel count")
    if rc == -2:
        raise ValueError(f"{what}: the kernel refused its sizes")
    if rc != 0:
        prefix = _SIGNATURES[lib][0]
        msg = getattr(load(n, lib), f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
