"""Multi-rank scaling over torch.distributed (port of
vloam_tpu/parallel/sharded.py).

The JAX reference is single-controller: one process holds a
jax.sharding.Mesh of devices, and shard_map'd functions run a body per
device whose psum / ppermute ride the interconnect. The port is SPMD, one
process per rank: every rank runs the same program on its own block of the
data, and

- ``psum`` is an all_reduce on the Mesh's process group,
- ``ppermute`` around the ring (perm [(j, j+1 mod D)]) is one
  batch_isend_irecv: rank r sends to r+1 and receives from r-1,
- ``axis_index`` is the rank.

Backends: NCCL on the card, one rank a card (NCCL refuses two ranks on one
GPU); gloo on the CPU. Ranks that share a card take gloo with CUDA tensors
when the caller asks for it (``backend="gloo"``): gloo all-reduces and
all-gathers CUDA tensors itself, but its send / recv of a CUDA tensor
aborted the process on an H100 host (torch 2.11: "writev ... Bad address"),
so the ring hop goes through host memory there. Nothing picks another
backend or device on its own: a CUDA mesh under NCCL with more ranks than
visible cards raises.

sharded_point_to_plane_gn is the reference's demonstration of the psum'd
6x6 normal equations: residuals sharded, pose replicated.
"""

from __future__ import annotations

import contextlib
import importlib
import os
from collections.abc import Iterator
from dataclasses import dataclass
from datetime import timedelta
from typing import ClassVar

import torch
import torch.distributed as dist

from ..geometry import so3
from ..solver.lm import ResidualFamily, normal_equations, solve_damped

TIMEOUT_S = 300.0  # every collective of a mesh gives up after this long


@dataclass(frozen=True)
class Mesh:
    """One rank's handle on a 1-D device mesh (the reference's Mesh with
    its one axis "data"). group is None for the default process group,
    which the Mesh does not hold: a group object kept alive here would keep
    the backend's threads running after destroy_process_group() (see
    spmd_mesh)."""

    group: object  # a torch.distributed ProcessGroup, or None: the default
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: ClassVar[str] = "data"

    @property
    def host_hops(self) -> bool:
        """gloo over CUDA tensors: ring hops go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _rank_device(device, backend: str, local_rank: int, size: int):
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the NCCL backend needs CUDA devices")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is false; pass device=\"cpu\" for a gloo mesh on the CPU")
    if backend == "nccl":
        n = torch.cuda.device_count()
        if size > n:
            raise ValueError(
                f"a mesh of {size} ranks under NCCL needs {size} cards (one "
                f"rank a card); {n} visible. Ranks that share a card need "
                "backend=\"gloo\"")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(group=None, device="cuda", backend: str | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """This rank's Mesh over `group` (default: the default process group).

    Where no group exists yet, the default group is initialised here: from
    torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT when RANK is
    set (parallel/launch.py sets them too), else as a world of one rank in
    this process. device: "cuda" (the default; under NCCL each rank takes
    the card of its LOCAL_RANK) or "cpu". backend: "nccl" for CUDA and
    "gloo" for the CPU unless given; gloo on CUDA serves ranks that share a
    card. Every collective gives up after timeout_s."""
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if group is None and not dist.is_initialized():
        # torch.distributed.nn.functional binds group.WORLD into its
        # functions' defaults when it is imported; imported while the group
        # lives (torch._dynamo imports it, at the pose graph's first
        # torch.func.jacfwd), it keeps the group and the backend's threads
        # alive past destroy_process_group(): import it first
        importlib.import_module("torch.distributed.nn.functional")

        kw = {"backend": backend, "timeout": timedelta(seconds=timeout_s)}
        if "RANK" in os.environ:
            dist.init_process_group(init_method="env://", **kw)
        else:
            dist.init_process_group(store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    have = dist.get_backend(group)
    if have != backend:
        raise ValueError(f"the process group runs {have!r}, {backend!r} was "
                         "asked for")
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, backend, local, size)
    return Mesh(group=group, rank=rank, size=size, device=dev,
                backend=backend)


@contextlib.contextmanager
def spmd_mesh(device="cuda", backend: str | None = None,
              timeout_s: float = TIMEOUT_S) -> Iterator[Mesh]:
    """data_mesh(device, backend, timeout_s) for the length of a with-block;
    the way an SPMD program starts and ends its default process group.

    Where the block initialised the group, it ends it on the way out: after
    a normal exit a barrier, so no rank tears its connections down while
    another still reads from them, then destroy_process_group(). The Mesh
    holds no reference to the default group, so that frees the group and
    joins the backend's threads (gloo's TCP loop and its two workers) while
    the interpreter is whole. A gloo worker still running at interpreter
    exit that frees a finished collective's tensors must take the GIL;
    Python 3.12 ends such a thread with pthread_exit, whose unwinding
    aborts the rank after its work is done ("terminate called without an
    active exception"). After an exception the block skips the barrier,
    which the other ranks may never reach, and destroys the group; the
    exception goes on. A group that existed before the block belongs to its
    creator and is left as it is."""
    owner = not dist.is_initialized()
    try:
        mesh = data_mesh(device=device, backend=backend, timeout_s=timeout_s)
        yield mesh
    except BaseException:
        if owner and dist.is_initialized():
            dist.destroy_process_group()
        raise
    if owner:
        try:
            dist.barrier(device_ids=[mesh.device.index]
                         if mesh.backend == "nccl" else None)
        finally:
            dist.destroy_process_group()


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The device a mesh engine or stage runs on: its rank's mesh.device,
    which must be of the type asked for (nothing moves to another device
    unasked)."""
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {str(device)!r} was asked for, but the "
                         f"mesh's rank runs on {mesh.device}")
    return mesh.device


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of x over the mesh's ranks (jax.lax.psum). x is reduced in place
    and returned: pass a tensor of your own."""
    dist.all_reduce(x, group=mesh.group)
    return x


def ppermute_ring(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """jax.lax.ppermute with perm [(j, j+1 mod D)]: this rank sends x to
    rank r+1 and returns what rank r-1 sent (x itself on one rank)."""
    if mesh.size == 1:
        return x
    send = x.cpu() if mesh.host_hops else x.contiguous()
    recv = torch.empty_like(send)
    dst, src = ((mesh.rank + d) % mesh.size for d in (1, -1))
    if mesh.group is not None:
        dst, src = (dist.get_global_rank(mesh.group, r) for r in (dst, src))
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, mesh.group),
            dist.P2POp(dist.irecv, recv, src, mesh.group)]):
        work.wait()
    return recv.to(mesh.device) if mesh.host_hops else recv


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x, concatenated along dim 0 in rank order."""
    if mesh.size == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts)


def shard_batch(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a batch-leading array, padded (zeros, False) to
    a multiple of the mesh size first (the reference's shard_batch places
    the same blocks on its devices)."""
    n = arr.shape[0]
    pad = (-n) % mesh.size
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad,) + arr.shape[1:])])
    per = arr.shape[0] // mesh.size
    return arr[mesh.rank * per:(mesh.rank + 1) * per]


def psum_normal_equations(mesh: Mesh):
    """A reduce hook for solver.lm.lm_solve: (H, g, cost) summed over the
    ranks in ONE all_reduce, so every rank takes the same LM branch."""
    def reduce(H, g, cost):
        d = g.shape[-1]
        packed = psum(torch.cat([H.reshape(-1), g, cost.reshape(1)]), mesh)
        return (packed[:d * d].reshape(d, d), packed[d * d:d * d + d],
                packed[-1])

    return reduce


def sharded_point_to_plane_gn(mesh: Mesh, pts, n_hat, d, w_mask, x0,
                              iterations: int = 4,
                              huber_delta: float = 0.1) -> torch.Tensor:
    """Gauss-Newton on a replicated 6-dof pose x0 [7] = (quat, t) with this
    rank's residual shard: residual n . (R p + t) + d over pts [B, 3],
    n_hat [B, 3], d [B], weights w_mask [B]. The 6x6 normal equations are
    psum'd each iteration and every rank applies the same step."""
    reduce = psum_normal_equations(mesh)
    x = x0.to(torch.float32)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=x.device)
    for _ in range(iterations):
        rp = so3.quat_rotate(x[:4], pts)
        r = torch.sum((rp + x[4:]) * n_hat, dim=-1) + d
        J = torch.sum(n_hat[:, :, None] * so3.point_jacobian(x[:4], rp),
                      dim=1)
        H, g, _ = reduce(*normal_equations(
            ResidualFamily(r[:, None], J[:, None, :], w_mask), huber_delta))
        delta = solve_damped(H, g, lam)
        q = so3.quat_normalize(so3.quat_multiply(
            x[:4], so3.quat_from_axis_angle(-delta[:3])))
        x = torch.cat([q, x[4:] - delta[3:]])
    return x
