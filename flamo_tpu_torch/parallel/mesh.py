"""Device meshes and bin sharding (counterpart of
``flamo_tpu/parallel/mesh.py``).

The frequency-bin axis M = nfft//2+1 is embarrassingly parallel: every
processor is a per-bin map and the closed-loop solve is independent per
bin.  In the JAX package a sharding constraint places the bin axis on a
mesh and XLA partitions the program.  Here each rank of a
``torch.distributed`` group is one device of the mesh and runs eagerly on
its own block of bins: the bin axis is zero-padded to a multiple of the
axis size and rank i takes rows ``[i loc, (i + 1) loc)``
(:func:`shard_block`).

The meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over
the initialised world, with ``mesh_dim_names``; their process groups
carry the collectives.  On one card every rank runs on ``cuda:0`` in a
``gloo`` group, which all-reduces and broadcasts CUDA tensors (it has no
CUDA all-gather, so a gather is an all-reduce of a zero-padded tensor).

Gradients: a rank differentiates only its own bins' share of a loss, so
the gradient of a replicated parameter is the sum over the axis of the
ranks' gradients (:func:`allreduce_grads`, after ``backward()``).  An
all-reduce under autograd would not do: its backward all-reduces the
cotangent as well, and a loss that every rank holds whole would get the
axis size times its gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flamo_tpu_torch.core import TopologyMismatch
from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.fdn_kernels import fdn_solve
from flamo_tpu_torch.ops.solve import closed_loop_solve
from flamo_tpu_torch.processor import system
from flamo_tpu_torch.utils import complex_dtype_for


def _mesh_device_type() -> str:
    """The mesh's device type: 'cuda' for NCCL groups; gloo groups carry
    CPU and CUDA tensors alike, and their mesh says 'cpu' so that
    building it touches no card."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def get_mesh(n_devices: Optional[int] = None,
             axis_name: str = "bins") -> DeviceMesh:
    """1-D mesh over ranks ``0 .. n_devices - 1`` of the world (default:
    all of it).  Every rank of the world must call it."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks for the mesh, have {world}")
    return DeviceMesh(_mesh_device_type(), torch.arange(n),
                      mesh_dim_names=(axis_name,))


def get_mesh_2d(n_seed: int, n_bins: int,
                axis_names=("seed", "bins")) -> DeviceMesh:
    """2-D ``n_seed x n_bins`` mesh: rank r sits at seed row
    ``r // n_bins`` and bins column ``r % n_bins``."""
    world = dist.get_world_size()
    need = n_seed * n_bins
    if need > world:
        raise ValueError(f"need {need} ranks for a {n_seed}x{n_bins} mesh, "
                         f"have {world}")
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(need).reshape(n_seed, n_bins),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def axis_index(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate on ``axis_name`` (JAX's ``axis_index``)."""
    return mesh.get_local_rank(axis_name)


def shard_block(M: int, mesh: DeviceMesh,
                axis_name: str = "bins") -> tuple[int, int]:
    """``(offset, count)`` of this rank's block of an axis of M rows
    zero-padded to a multiple of the axis size: rows
    ``[offset, offset + count)``, the same count on every rank."""
    n = axis_size(mesh, axis_name)
    count = -(-M // n)
    return axis_index(mesh, axis_name) * count, count


def take_block(x: torch.Tensor, offset: int, count: int,
               dim: int = 0) -> torch.Tensor:
    """Rows ``[offset, offset + count)`` of ``x`` along ``dim``, zero
    past its end."""
    n = x.shape[dim]
    part = x.narrow(dim, min(offset, n), max(0, min(count, n - offset)))
    short = count - part.shape[dim]
    if short == 0:
        return part
    pad = list(x.shape)
    pad[dim] = short
    return torch.cat([part, x.new_zeros(pad)], dim)


def shard_spectrum(x: torch.Tensor, mesh: DeviceMesh,
                   axis_name: str = "bins") -> torch.Tensor:
    """This rank's block of a (B, M, ...) spectrum's bin axis (dim 1),
    zero-padded to a multiple of the axis size."""
    offset, count = shard_block(x.shape[1], mesh, axis_name)
    return take_block(x, offset, count, dim=1)


def allreduce_grads(params, mesh: DeviceMesh, axis_name: str) -> None:
    """Sum the ``.grad`` of ``params`` over the mesh axis, in one
    all-reduce of their concatenation.  Parameters without a gradient are
    left as they are."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    group = mesh.get_group(axis_name)
    flat = torch.cat([torch.view_as_real(g).reshape(-1) if g.is_complex()
                      else g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        view = torch.view_as_real(g) if g.is_complex() else g
        view.copy_(flat[at:at + view.numel()].view_as(view))
        at += view.numel()


def replicate(module: torch.nn.Module, mesh: DeviceMesh,
              axis_name: Optional[str] = None) -> torch.nn.Module:
    """Overwrite every parameter and buffer of ``module`` with those of
    the mesh's first rank (JAX's fully replicated placement), or with
    those of the first rank of this rank's group on ``axis_name``.  Every
    rank of that group must call it; returns ``module``."""
    if axis_name is not None:
        group = mesh.get_group(axis_name)
        src = dist.get_global_rank(group, 0)
    else:
        group = mesh.get_group() if mesh.ndim == 1 else None
        src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            view = torch.view_as_real(t) if t.is_complex() else t
            tmp = view.contiguous()
            dist.broadcast(tmp, src=src, group=group)
            if tmp.data_ptr() != view.data_ptr():
                view.copy_(tmp)
    return module


def same_on_axis(t: torch.Tensor, mesh: DeviceMesh, axis_name: str,
                 what: str) -> None:
    """Raise ``ValueError`` unless every rank of the axis holds the same
    integer tensor ``t`` (masks and partitions drawn from generators)."""
    n = axis_size(mesh, axis_name)
    lo = t.to(device="cpu", dtype=torch.int64, copy=True)
    hi = -lo
    group = mesh.get_group(axis_name)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MIN, group=group)
    if n > 1 and not torch.equal(lo, -hi):
        raise ValueError(f"the ranks of mesh axis '{axis_name}' drew "
                         f"different {what}: give every rank a generator "
                         "in the same state")


# ---------------------------------------------------------------------------
# the core on a block of bins
# ---------------------------------------------------------------------------
def _rows(kind, H, offset: int, count: int):
    """A per-bin response restricted to the block: a flat or bin-constant
    response as it is, a per-bin one sliced (zero past the end)."""
    if kind == linop.FLAT or H.shape[0] == 1:
        return H
    return take_block(H, offset, count)


def _recursion_block(loop: system.Recursion, x, offset: int, count: int):
    """:meth:`system.Recursion.forward` on the block's bins: the branches'
    responses are sliced to the block before the loop is assembled and
    solved, so the solve (kernel K2 on 'pallas') covers this rank's bins
    only.  Padded bins have a zero feedforward: their loop is the
    identity and their output zero."""
    N = loop.output_channels
    rF = system._matrix_response_of(loop.feedforward)
    if rF is None:
        raise TopologyMismatch("bin_sharded_forward needs a Recursion whose "
                               "feedforward has a matrix_response")
    kF, HF = rF[0], _rows(rF[0], rF[1], offset, count)
    B = linop.apply(kF, HF, x)
    cdtype = B.dtype if B.is_complex() else complex_dtype_for(B.dtype)
    if loop.solve_method == "pallas" and kF == linop.DIAG and B.ndim == 3:
        split, rB = system._diag_flat_split(loop.feedback)
    else:
        split, rB = None, system._matrix_response_of(loop.feedback)
    if split is not None:
        dB, U = split
        D = (HF.to(cdtype) * _rows(linop.DIAG, dB, offset, count).to(cdtype)
             ).expand(count, N)
        Df = D[None].expand(B.shape[0], count, N).reshape(-1, N)
        y = fdn_solve(Df.contiguous(), torch.real(U).contiguous(),
                      B.reshape(-1, N).contiguous())
        return y.reshape(B.shape)
    if rB is None:
        raise TopologyMismatch("bin_sharded_forward needs a Recursion whose "
                               "feedback has a matrix_response")
    kL, L = linop.compose(kF, HF, rB[0], _rows(rB[0], rB[1], offset, count))
    eye = torch.eye(N, dtype=cdtype, device=B.device)
    A = eye - linop.materialize(kL, L.to(cdtype), count, N, N)
    return closed_loop_solve(A[None].expand(x.shape[0], count, N, N), B,
                             method=loop.solve_method)


def core_on_block(module, x, offset: int, count: int):
    """``module(x)`` for a spectrum block ``x`` (B, count, C) that holds
    global bins ``[offset, offset + count)``: a Series runs its stages in
    turn, a Recursion assembles and solves its loop on the block, and any
    other module applies its ``matrix_response`` restricted to the
    block.  Raises :class:`TopologyMismatch` for a module without one."""
    if isinstance(module, system.Series):
        for stage in module.stages:
            x = core_on_block(stage, x, offset, count)
        return x
    if isinstance(module, system.Recursion):
        return _recursion_block(module, x, offset, count)
    r = system._matrix_response_of(module)
    if r is None:
        raise TopologyMismatch(
            f"bin_sharded_forward cannot evaluate {type(module).__name__} "
            "on a block of bins: it has no matrix_response")
    return linop.apply(r[0], _rows(r[0], r[1], offset, count), x)


class _GatherBins(torch.autograd.Function):
    """All-reduce of a zero-padded (B, Mp, C) tensor that holds this
    rank's block; its backward hands back the block's rows of the
    cotangent, with no collective (every rank holds the whole output)."""

    @staticmethod
    def forward(ctx, y, offset, Mp, group):
        ctx.offset, ctx.count = offset, y.shape[1]
        full = y.new_zeros((y.shape[0], Mp) + tuple(y.shape[2:]))
        full[:, offset:offset + y.shape[1]] = y
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.offset:ctx.offset + ctx.count], None, None, None


def gather_bins(y: torch.Tensor, mesh: DeviceMesh, M: int,
                axis_name: str = "bins") -> torch.Tensor:
    """The (B, M, C) whole of the blocks ``y`` (B, count, C) that the
    ranks of the axis hold, on every rank (see :class:`_GatherBins`)."""
    offset, count = shard_block(M, mesh, axis_name)
    n = axis_size(mesh, axis_name)
    full = _GatherBins.apply(y, offset, n * count,
                             mesh.get_group(axis_name))
    return full[:, :M]


def bin_sharded_forward(model, mesh: DeviceMesh, axis_name: str = "bins"):
    """Wrap a Shell into a forward that evaluates its core on this rank's
    block of bins only and returns the unsharded output on every rank:
    input layer, :func:`shard_spectrum`, :func:`core_on_block`,
    :func:`gather_bins`, output layer.  Parameters get this rank's bins'
    share of a gradient: sum them over the axis with
    :func:`allreduce_grads` before an update."""
    if not isinstance(model, system.Shell):
        raise TypeError("bin_sharded_forward takes a Shell")

    def forward(x):
        h = model.input_layer(x)
        offset, count = shard_block(h.shape[1], mesh, axis_name)
        y = core_on_block(model.core, take_block(h, offset, count, 1),
                          offset, count)
        return model.output_layer(gather_bins(y, mesh, h.shape[1],
                                              axis_name))

    return forward
