"""Process groups for the multi-device layer (the torch-side counterpart of
the device list that JAX's runtime hands ``flamo_tpu.parallel``).

:func:`spawn` starts ``world_size`` processes with the ``spawn`` start
method (CUDA forbids ``fork`` once it is initialised), joins them in one
``torch.distributed`` group over a free 127.0.0.1 port, runs
``fn(rank, world_size, *args)`` in each and returns the results in rank
order.  Nothing outlives its deadline: the group's collectives time out
(a rank that dies leaves its peers blocked in a collective until then),
and the parent terminates every rank that has not finished by
``timeout_s`` after the start.  When a rank raises, the
parent terminates the others and raises that rank's traceback.

``fn`` must be importable (a module-level function): each process
re-imports the module that defines it.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# seconds the parent waits, after a rank fails or dies, for the others'
# reports
GRACE_S = 5.0


class RankError(RuntimeError):
    """A rank of :func:`spawn` raised, died or missed its deadline."""


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(rank, world_size, backend, port, timeout_s, threads, fn,
              args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent reports it; the rank exits with it
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn(fn, world_size: int, backend: str = "gloo", *args,
          timeout_s: float = 60.0, threads: int | None = None,
          collective_s: float | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes joined in one ``backend`` group and return their results,
    rank 0 first.  ``threads`` sets each rank's intra-op threads;
    ``collective_s`` (default ``timeout_s``) is the group's timeout, the
    longest a collective waits for a peer.  Raises
    :class:`RankError` when a rank raises (with the traceback of every
    rank that failed within ``GRACE_S`` of the first: a peer of a failed
    rank fails too, in its collective), when one dies without a result,
    and when the ranks are not all done ``timeout_s`` after the start."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(rank, world_size, backend, port,
                               collective_s or timeout_s, threads, fn, args,
                               results))
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.start()
    out, failed, died_at = {}, {}, None
    try:
        while len(out) + len(failed) < world_size:
            now = time.monotonic()
            if failed and now > min(deadline, first_failure + GRACE_S):
                break
            if now >= deadline:
                raise RankError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} of "
                    f"{world_size} not done after {timeout_s:g} s")
            try:
                rank, ok, value = results.get(timeout=min(deadline - now,
                                                          0.5))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a result may still be in flight: give it a moment
                    died_at = died_at or time.monotonic()
                    if not failed and time.monotonic() - died_at > GRACE_S:
                        raise RankError(
                            f"a rank died without a result (exit codes "
                            f"{[p.exitcode for p in procs]})")
                continue
            if ok:
                out[rank] = value
            else:
                if not failed:
                    first_failure = time.monotonic()
                failed[rank] = value
        if failed:
            raise RankError("\n".join(
                f"rank {rank} of {world_size} failed:\n{tb}"
                for rank, tb in sorted(failed.items())))
    finally:
        _stop(procs)
    return [out[r] for r in range(world_size)]
