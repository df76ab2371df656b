"""The five collectives of the distributed solves, with JAX's semantics.

Each JAX ``shard_map`` body of ``hybrid_fem_lssvr_tpu/parallel/`` becomes a
function that every rank runs on its own shard; each collective over a
named mesh axis becomes one over that dimension of a ``DeviceMesh``:

========================  =============================================
JAX                       here
========================  =============================================
``lax.axis_index(ax)``    ``axis_index(mesh, ax)`` (``get_local_rank``)
``lax.ppermute``          ``ppermute``: ``batch_isend_irecv`` with the
                          peers mapped to global ranks; a rank that no
                          pair sends to receives **zeros** (the halo code
                          relies on that at the domain edges)
``lax.psum``              ``psum``: ``all_reduce(SUM)`` over one
                          dimension's group, or over each of a tuple's
                          dimensions in turn (every rank gets the same
                          sum)
``lax.all_gather``        ``all_gather``: stacked on a new leading axis
                          in mesh order
``lax.all_to_all``        ``all_to_all``: ``all_to_all_single`` with
                          ``split_axis = concat_axis = 0``
========================  =============================================

Where the tensors live.  Under NCCL they stay on the card.  ``gloo``
moves CPU tensors only (its CUDA support stops short of point-to-point and
all-to-all), and NCCL refuses two ranks on one card, so ranks that share a
card run under ``gloo``: then each collective copies its tensor to host
memory before the exchange and back to the tensor's device after it.  The
choice is made from ``dist.get_backend(group)`` alone, never by catching a
failed attempt.  Ranks that share one card measure no multi-GPU scaling.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the group's backend can move it: host memory for a CUDA
    tensor under gloo, else ``x`` itself (contiguous)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu").contiguous()
    return x.contiguous()


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (JAX ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """JAX ``lax.ppermute``: for each (src, dst) pair of ``perm`` (positions
    along ``axis``) rank src's ``x`` arrives at rank dst.  A rank that no
    pair sends to gets zeros.  Every rank of the group calls it together."""
    group = _group(mesh, axis)
    me = mesh.get_local_rank(axis)
    perm = list(perm)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at {me}")
    if srcs and srcs[0] == me:  # a pair from this rank to itself
        out = x.clone()
        srcs = []
    else:
        out = None
    wire = _to_wire(x, group)
    ops = []
    if srcs:
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, srcs[0]), group))
    if dsts and dsts[0] != me:
        ops.append(dist.P2POp(dist.isend, wire,
                              dist.get_global_rank(group, dsts[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if srcs:
        return buf.to(x.device)
    return out if out is not None else torch.zeros_like(x)


def psum(x: torch.Tensor, mesh: DeviceMesh,
         axes: Union[str, Sequence[str]]) -> torch.Tensor:
    """JAX ``lax.psum`` over one axis or a tuple of axes (reduced one
    dimension after the other, so every rank gets the same sum)."""
    if isinstance(axes, str):
        axes = (axes,)
    shape = x.shape
    out = x.reshape(-1)
    for axis in axes:
        group = _group(mesh, axis)
        wire = _to_wire(out, group)
        if wire is out:
            wire = out.clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
        out = wire
    return out.to(x.device).reshape(shape)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """JAX ``lax.all_gather``: every rank's ``x`` stacked on a new leading
    axis in mesh order along ``axis``."""
    group = _group(mesh, axis)
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.stack(parts).to(x.device)


def all_to_all(blocks: torch.Tensor, mesh: DeviceMesh,
               axis: str) -> torch.Tensor:
    """JAX ``lax.all_to_all(blocks, axis, split_axis=0, concat_axis=0)``:
    ``blocks[e]`` goes to rank e; the result's ``[e]`` came from rank e."""
    group = _group(mesh, axis)
    wire = _to_wire(blocks, group)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.to(blocks.device)


def gather_solution(sol, mesh: DeviceMesh, axes=None):
    """Rebuild the global arrays of a ``Sharded*`` solution on every rank.

    Each field of a solution is sharded as JAX's ``out_specs`` place it:
    dimension k over mesh axis ``axes[k]`` (default: the mesh's dimension
    names).  Shards are concatenated along those dimensions in mesh order;
    shards of unequal length (the 1D solve's padded tail) are joined as they
    are.  Returns a solution of the same type; None fields stay None."""
    axes = tuple(mesh.mesh_dim_names if axes is None else axes)

    def gather(x):
        if x is None:
            return None
        flag = x.dtype == torch.bool  # gloo moves no bool tensors
        if flag:
            x = x.to(torch.uint8)
        for k in reversed(range(len(axes))):
            x = _concat(x, mesh, axes[k], k)
        return x.bool() if flag else x

    return type(sol)(*(gather(v) for v in sol))


def _concat(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int):
    n = x.shape[dim]
    lengths = all_gather(torch.tensor([n], device=x.device), mesh, axis)
    lengths = [int(v) for v in lengths.reshape(-1).tolist()]
    top = max(lengths)
    if top != n:
        pad = list(x.shape)
        pad[dim] = top - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = all_gather(x, mesh, axis).unbind(0)
    return torch.cat([p.narrow(dim, 0, m) for p, m in zip(parts, lengths)],
                     dim=dim)
