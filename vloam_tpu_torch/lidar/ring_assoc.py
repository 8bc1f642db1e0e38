"""Exact per-ring nearest-neighbour association (port of
vloam_tpu/lidar/ring_assoc.py, exact semantics only).

Every pick the reference's KD-tree + ring-scan loop makes is a function of
PER-RING minima of the query-candidate distance: the global nearest is the
min over ring minima, the ring-constrained second point is the min over
rings != ring0 within +-nearby_scan, and the surf same-ring point is the
second minimum on ring0. ``ring_min2`` computes, per ring and per query,
the (min, argmin, second-min, second-argmin) of the exact f32 (q-c)^2
distances without materializing the [Q, C] distance block; on CUDA it is
the hand-written kernel kernels/csrc/ring_min2.cu (K2). ``ring_min1`` is
its min-only half (kernels/csrc/ring_min1.cu), which is all the corner
association reads.

The JAX main path defaults to quantized, saturated distances (impl="mxu");
the port holds association to the exact form, whose module-level
counterpart is ``ring_slab_assoc(..., impl="xla")``. The surf d3/p3 pick is
K2's second minimum on ring0 — "nearest on ring0 excluding slot0" — which
the JAX reference computes on a quantized grid; the two agree except where
two candidates' exact distances are within the quantization step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

SENTINEL = 1.0e6  # far but finite: squared distances ~3e12, no inf-inf NaN
_BIG = 3.9e12  # > any sentinel distance
_IBIG = 2**30
_RING_BLOCK = 8  # rings per step of the plain version (bounds its memory)


class RingSlab(NamedTuple):
    """Per-ring candidate layout: xyz [S, C, 3] with invalid slots at
    SENTINEL. Ring id of slab[r] is r; no mask needed (sentinel padding)."""

    xyz: torch.Tensor  # [S, C, 3] f32

    @staticmethod
    def empty(n_rings: int, ring_cap: int, device) -> "RingSlab":
        return RingSlab(xyz=torch.full((n_rings, ring_cap, 3), SENTINEL,
                                       dtype=torch.float32, device=device))


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Argmin with ties to the lowest index, in the explicit iota-min form
    the JAX kernels use (independent of any backend's tie convention)."""
    m = torch.amin(x, dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    idx = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return torch.amin(torch.where(x <= m, idx, _IBIG), dim=dim)


def _ring_blocks(queries: torch.Tensor, slab_t: torch.Tensor):
    """Yield, _RING_BLOCK rings at a time, the exact squared distances
    d [b, Q, C] = (dx^2 + dy^2) + dz^2 (each product and sum rounded, as the
    kernels round them) with their first minimum m1 [b, Q, 1] and its slot
    a1 [b, Q] (ties to the lowest slot)."""
    S, _, C = slab_t.shape
    col = torch.arange(C, device=slab_t.device)
    for s0 in range(0, S, _RING_BLOCK):
        c = slab_t[s0:s0 + _RING_BLOCK]  # [b, 3, C]
        dx = queries[None, :, 0, None] - c[:, None, 0, :]  # [b, Q, C]
        d = dx * dx
        dy = queries[None, :, 1, None] - c[:, None, 1, :]
        d = d + dy * dy
        dz = queries[None, :, 2, None] - c[:, None, 2, :]
        d = d + dz * dz
        m1 = torch.amin(d, dim=-1, keepdim=True)
        a1 = torch.amin(torch.where(d <= m1, col, _IBIG), dim=-1)
        yield d, m1, a1, col


def ring_min2_plain(queries: torch.Tensor, slab_t: torch.Tensor):
    """Plain PyTorch per-ring (min, argmin, 2nd-min, 2nd-argmin).

    queries [Q, 3] f32; slab_t [S, 3, C] f32 (coordinate-major ring slabs).
    Returns (dmin [S, Q] f32, amin [S, Q] int32, d2 [S, Q] f32,
    a2 [S, Q] int32); argmins are slots within the ring. Distances add as
    (dx^2 + dy^2) + dz^2, each product and sum rounded (as K2 does), ties
    go to the lowest slot and the second minimum excludes only the first
    argmin's slot: the argmin, mask the winner with _BIG, argmin again
    formulation that kernels.ring_argmin2 computes as written and K2 with a
    running top-2."""
    outs = []
    for d, m1, a1, col in _ring_blocks(queries, slab_t):
        d_wo = torch.where(col == a1[..., None], _BIG, d)
        m2 = torch.amin(d_wo, dim=-1, keepdim=True)
        a2 = torch.amin(torch.where(d_wo <= m2, col, _IBIG), dim=-1)
        outs.append((m1[..., 0], a1.to(torch.int32), m2[..., 0],
                     a2.to(torch.int32)))
    return tuple(torch.cat(o, dim=0) for o in zip(*outs))


def ring_min1_plain(queries: torch.Tensor, slab_t: torch.Tensor):
    """Plain PyTorch per-ring (min, argmin): the first two outputs of
    ring_min2_plain, bit for bit."""
    outs = [(m1[..., 0], a1.to(torch.int32))
            for _, m1, a1, _ in _ring_blocks(queries, slab_t)]
    return tuple(torch.cat(o, dim=0) for o in zip(*outs))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def ring_min2(queries: torch.Tensor, slab_t: torch.Tensor):
    """Per-ring 2-smallest reduction (K2). CPU tensors take
    ring_min2_plain; CUDA tensors launch kernels/csrc/ring_min2.cu (or
    raise — there is no fallback)."""
    if _on_cpu(queries, slab_t):
        return ring_min2_plain(queries, slab_t)
    return kernels.ring_min2(queries, slab_t)


def ring_min1(queries: torch.Tensor, slab_t: torch.Tensor):
    """Per-ring min-only reduction (S1, corner association). CPU tensors
    take ring_min1_plain; CUDA tensors launch kernels/csrc/ring_min1.cu (or
    raise)."""
    if _on_cpu(queries, slab_t):
        return ring_min1_plain(queries, slab_t)
    return kernels.ring_min1(queries, slab_t)


def ring_slab_assoc(queries: torch.Tensor, slab: RingSlab,
                    nearby_scan: float, mode: str = "corner"):
    """LO correspondence search over per-ring slabs (reference
    laser_odometry.cpp:266-444 semantics, exact f32 distances).

    Returns dict with:
      d0 [Q], p0 [Q, 3]   nearest candidate anywhere
      d2 [Q], p2 [Q, 3]   nearest on a DIFFERENT ring within +-nearby_scan
      d3 [Q], p3 [Q, 3]   (surf) second-nearest on the SAME ring
    """
    S = slab.xyz.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    slab_t = slab.xyz.transpose(1, 2).contiguous()  # [S, 3, C]
    # the corner picks need no second minimum: min-only kernel
    if mode == "surf":
        dmin, amin, d2r, a2r = ring_min2(queries.contiguous(), slab_t)
    else:
        dmin, amin = ring_min1(queries.contiguous(), slab_t)

    rings = torch.arange(S, device=dev)
    q_idx = torch.arange(Q, device=dev)
    ring0 = first_argmin(dmin, 0)  # [Q]
    d0 = torch.amin(dmin, dim=0)
    slot0 = amin[ring0, q_idx].to(torch.int64)
    p0 = slab.xyz[ring0, slot0]

    near = ((torch.abs(rings[:, None] - ring0[None, :]).to(torch.float32)
             <= nearby_scan) & (rings[:, None] != ring0[None, :]))  # [S, Q]
    d_other = torch.where(near, dmin, _BIG)
    ring2 = first_argmin(d_other, 0)
    d2 = torch.amin(d_other, dim=0)
    slot2 = amin[ring2, q_idx].to(torch.int64)
    p2 = slab.xyz[ring2, slot2]

    out = {"d0": d0, "p0": p0, "d2": d2, "p2": p2}
    if mode == "surf":
        out["d3"] = d2r[ring0, q_idx]
        slot3 = a2r[ring0, q_idx].to(torch.int64)
        out["p3"] = slab.xyz[ring0, slot3]
    return out
