"""Per-ring nearest-neighbour association (port of
vloam_tpu/lidar/ring_assoc.py).

Every pick the reference's KD-tree + ring-scan loop makes is a function of
PER-RING minima of the query-candidate distance: the global nearest is the
min over ring minima, the ring-constrained second point is the min over
rings != ring0 within +-nearby_scan, and the surf same-ring point is the
second minimum on ring0. ``ring_slab_assoc(impl=)`` takes the reference's
four forms of the per-ring reduction:

- "pallas": ``ring_min2`` (kernels/csrc/ring_min2.cu, K2), the exact
  (min, argmin, second-min, second-argmin), of which only the first two are
  read;
- "xla": ``ring_min1`` (kernels/csrc/ring_min1.cu::ring_min1, S1), the
  exact (min, argmin);
- "packed": ``ring_min1_packed``, each exact f32 distance quantized to
  30 - ceil(log2 C) bits, clipped at 64 m^2 and packed with its slot into one
  int32, so one integer minimum gives the minimum and its first slot;
- "mxu" (the default, as in the reference and its engines): the same packed
  minimum over |q|^2 + |c|^2 - 2 q.c.

The packed forms run kernels/csrc/ring_min1.cu::ring_min1_packed on CUDA
tensors. Their distances round as the reference's compiled CPU code rounds
them: XLA contracts the sums of products into fused multiply-adds, e.g.
fma(dz, dz, fma(dy, dy, dx*dx)). The plain versions emulate each fused
multiply-add exactly (fma_f32), the kernel issues it, so the three agree
bit for bit. The surf d3 / p3 pick is the reference's under every impl: the
ring0 row gathered, its exact distances quantized as the packed form's, slot0
masked, one integer minimum; plain torch on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

SENTINEL = 1.0e6  # far but finite: squared distances ~3e12, no inf-inf NaN
_BIG = 3.9e12  # > any sentinel distance
_IBIG = 2**30
_RING_BLOCK = 8  # rings per step of the plain version (bounds its memory)
CLIP_D = 64.0  # the packed forms' saturation, m^2 (> LO's 25 m^2 gates)


class RingSlab(NamedTuple):
    """Per-ring candidate layout: xyz [S, C, 3] with invalid slots at
    SENTINEL. Ring id of slab[r] is r; no mask needed (sentinel padding)."""

    xyz: torch.Tensor  # [S, C, 3] f32

    @staticmethod
    def empty(n_rings: int, ring_cap: int, device) -> "RingSlab":
        return RingSlab(xyz=torch.full((n_rings, ring_cap, 3), SENTINEL,
                                       dtype=torch.float32, device=device))


def slab_from_flat(xyz: torch.Tensor, ring: torch.Tensor, mask: torch.Tensor,
                   n_rings: int, ring_cap: int) -> RingSlab:
    """A RingSlab from a flat masked cloud in any order (reference
    ring_assoc.py:64): one stable sort by ring, each point at its rank in its
    ring; points past ring_cap and masked points are dropped."""
    n = xyz.shape[0]
    key = torch.where(mask, ring.to(torch.int64), n_rings)
    ks, order = torch.sort(key, stable=True)
    counts = torch.bincount(ks, minlength=n_rings + 1)[:n_rings]
    starts = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(n, device=xyz.device)
            - starts[torch.clamp(ks, max=n_rings - 1)])
    # the dropped points land in a dump row n_rings, sliced off
    dest_r = torch.where((ks < n_rings) & (rank < ring_cap), ks, n_rings)
    rank = torch.clamp(rank, 0, ring_cap - 1)
    slab = xyz.new_full((n_rings + 1, ring_cap, 3), SENTINEL)
    slab[dest_r, rank] = xyz[order]
    return RingSlab(xyz=slab[:n_rings])


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Argmin with ties to the lowest index, in the explicit iota-min form
    the JAX kernels use (independent of any backend's tie convention)."""
    m = torch.amin(x, dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    idx = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return torch.amin(torch.where(x <= m, idx, _IBIG), dim=dim)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once to float32: a fused
    multiply-add, as XLA's CPU code and CUDA's __fmaf_rn compute it, on any
    device. The product is exact in float64, and rounding the float64 sum
    to float32 is correct unless that sum lies on a float32 rounding
    midpoint (or below float32's normal range) while the exact sum does
    not: there the sum is rounded to odd instead (TwoSum gives its error;
    an inexact sum with an even last bit steps one ulp towards the exact
    value). On the CPU that step is taken only when some sum needs it."""
    ad = a.double()
    p = ad * (ad if b is a else b.double())
    cd = c.double()
    s = p + cd
    bits = s.view(torch.int64)
    if s.device.type == "cpu":
        exp = bits & 0x7FF0000000000000
        risky = (((bits & 0x1FFFFFFF) == 0x10000000)
                 | ((exp < (1023 - 125) << 52) & (exp != 0)))
        if not bool(risky.any()):
            return s.to(torch.float32)
    t = s - cd
    e = (p - t) + (cd - (s - t))  # s + e == p + cd exactly
    # sign(e * s) is 0 where the sum is exact (e == 0)
    step = torch.where((bits & 1) == 0,
                       torch.sign(e * s).to(torch.int64), 0)
    return (bits + step).view(torch.float64).to(torch.float32)


def sq_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances over the coordinate axis 0 of q and c (broadcast),
    fma(dz, dz, fma(dy, dy, dx*dx)): the reference's sum of squared
    differences as XLA's CPU code contracts it."""
    dx, dy, dz = q[0] - c[0], q[1] - c[1], q[2] - c[2]
    return fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))


def _quant(C: int, clip_d: float = CLIP_D):
    """The packed forms' (bits, scale, clip): slots take the low `bits` bits,
    a distance d the rest as trunc(min(d, clip) * scale) (reference
    ring_assoc.py:200-208). scale is a power of two, so scaling and
    dequantizing are exact."""
    bits = max(1, (C - 1).bit_length())
    scale = float(1 << (30 - bits)) / clip_d
    return bits, scale, float(np.float32(clip_d * 0.999999))


def _keys(d: torch.Tensor, bits: int, scale: float,
          clip: float) -> torch.Tensor:
    """d quantized and shifted above the slot bits: trunc(min(d, clip) *
    scale) << bits, int32."""
    return (torch.clamp(d, max=clip) * scale).to(torch.int32) << bits


def _unpack(m: torch.Tensor, bits: int, scale: float):
    """(dequantized distance f32, slot int32) of packed keys m."""
    return (m >> bits).to(torch.float32) / scale, m & ((1 << bits) - 1)


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


def ring_min1_packed_plain(queries: torch.Tensor, slab_t: torch.Tensor):
    """Plain PyTorch per-ring packed minimum over the exact distances
    (reference ring_min1_packed, impl="packed"): queries [Q, 3] f32, slab_t
    [S, 3, C] f32 -> (d [S, Q] f32, slot [S, Q] int32). d is the ring's
    smallest distance quantized to 30 - ceil(log2 C) bits and clipped at
    64 m^2, dequantized; ties of the quantized value go to the lowest slot,
    an all-SENTINEL ring gives the clip and slot 0."""
    return _packed_rings(queries, slab_t, product=False)


def ring_min1_mxu_plain(queries: torch.Tensor, slab_t: torch.Tensor):
    """ring_min1_packed_plain over max(|q|^2 + |c|^2 - 2 q.c, 0) (reference
    ring_min1_mxu, impl="mxu"). Each of |q|^2, |c|^2 and q.c is a chain of
    fused multiply-adds from the first term on, the order of XLA's CPU code:
    no matmul, so no TF32 and no cuBLAS."""
    return _packed_rings(queries, slab_t, product=True)


def _fused_dist(q: torch.Tensor, c: torch.Tensor,
                product: bool) -> torch.Tensor:
    """The packed forms' distances between q and c [3, ...] (broadcast),
    rounded as the reference's compiled code rounds them."""
    if not product:
        return sq_dist(q, c)
    qq = fma_f32(q[2], q[2], fma_f32(q[1], q[1], q[0] * q[0]))
    cc = fma_f32(c[2], c[2], fma_f32(c[1], c[1], c[0] * c[0]))
    qc = fma_f32(q[2], c[2], fma_f32(q[1], c[1], q[0] * c[0]))
    return torch.clamp((qq + cc) - 2.0 * qc, min=0.0)


def _rounded_dist(q: torch.Tensor, c: torch.Tensor, product: bool):
    """_fused_dist's distances with each product and sum rounded on its own
    (no float64), and a bound on how far they can lie from _fused_dist's.
    Both round the same real distance: each of its three-term sums to within
    3 float32 units of roundoff u of the sum of its terms' magnitudes, so
    the difference form's two lie within 6u d of each other, bounded by
    2^-20 d = 16u d, and the product form's within 18u (|q|^2 + |c|^2)
    (|q.c| adds up to (|q|^2 + |c|^2) / 2), bounded by 2^-18 (|q|^2 +
    |c|^2)."""
    if not product:
        dx, dy, dz = q[0] - c[0], q[1] - c[1], q[2] - c[2]
        d = (dx * dx + dy * dy) + dz * dz
        return d, d * 2.0**-20
    qq = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
    cc = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
    qc = (q[0] * c[0] + q[1] * c[1]) + q[2] * c[2]
    s = qq + cc
    return torch.clamp(s - 2.0 * qc, min=0.0), s * 2.0**-18


def _packed_rings(queries: torch.Tensor, slab_t: torch.Tensor, product: bool):
    """Ring by ring: the cheap rounded distances and their bound single out
    the slots that can reach the ring's smallest key (a lower bound within
    a quantization step of the smallest upper bound), and only those get the
    fused distances and keys. Where every slot lies surely past the clip the
    key is the clip's at slot 0."""
    S, _, C = slab_t.shape
    Q = queries.shape[0]
    bits, scale, clip = _quant(C)
    clip_key = int(clip * scale) << bits  # exact: scale is a power of two
    q = queries.T[:, :, None]  # [3, Q, 1]
    outs = []
    for s in range(S):
        d, err = _rounded_dist(q, slab_t[s][:, None, :], product)  # [Q, C]
        lo = d - err
        hi_min = torch.clamp(torch.amin(d + err, dim=1, keepdim=True),
                             max=clip)
        keep = ((torch.clamp(lo, max=clip) < hi_min + 1.0 / scale)
                & (torch.amin(lo, dim=1, keepdim=True) < clip))
        qi, ci = keep.nonzero(as_tuple=True)
        key = _keys(_fused_dist(queries[qi].T, slab_t[s][:, ci], product),
                    bits, scale, clip) | ci.to(torch.int32)
        m = torch.full((Q,), clip_key, dtype=torch.int32,
                       device=queries.device).scatter_reduce(
            0, qi, key, "amin", include_self=False)
        outs.append(_unpack(m, bits, scale))
    return tuple(torch.stack(o) for o in zip(*outs))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def ring_min2(queries: torch.Tensor, slab_t: torch.Tensor):
    """Per-ring 2-smallest reduction (K2, impl="pallas"). CPU tensors take
    ring_min2_plain; CUDA tensors launch kernels/csrc/ring_min2.cu (or
    raise — there is no fallback)."""
    if _on_cpu(queries, slab_t):
        return ring_min2_plain(queries, slab_t)
    return kernels.ring_min2(queries, slab_t)


def ring_min1(queries: torch.Tensor, slab_t: torch.Tensor):
    """Per-ring exact min-only reduction (S1, impl="xla"). CPU tensors take
    ring_min1_plain; CUDA tensors launch kernels/csrc/ring_min1.cu (or
    raise)."""
    if _on_cpu(queries, slab_t):
        return ring_min1_plain(queries, slab_t)
    return kernels.ring_min1(queries, slab_t)


def ring_min1_packed(queries: torch.Tensor, slab_t: torch.Tensor,
                     product: bool = True):
    """Per-ring packed minimum: impl="mxu" (product=True) or "packed". CPU
    tensors take ring_min1_mxu_plain / ring_min1_packed_plain; CUDA tensors
    launch kernels/csrc/ring_min1.cu::ring_min1_packed (or raise)."""
    if _on_cpu(queries, slab_t):
        return _packed_rings(queries, slab_t, product)
    return kernels.ring_min1_packed(queries, slab_t, product,
                                    *_quant(slab_t.shape[2]))


def ring_slab_assoc(queries: torch.Tensor, slab: RingSlab,
                    nearby_scan: float, mode: str = "corner",
                    impl: str = "mxu"):
    """LO correspondence search over per-ring slabs (reference
    laser_odometry.cpp:266-444 semantics; reference ring_assoc.py:264).

    impl: "mxu" (the default), "packed", "xla" or "pallas", the reference's
    forms (module docstring); any other name runs "packed", as in the
    reference. Returns dict with:
      d0 [Q], p0 [Q, 3]   nearest candidate anywhere
      d2 [Q], p2 [Q, 3]   nearest on a DIFFERENT ring within +-nearby_scan
      d3 [Q], p3 [Q, 3]   (surf) second-nearest on the SAME ring

    The distances are gate values: under "mxu" and "packed", and d3 under
    every impl, quantized to ~3e-5 m^2 steps and saturated at 64 m^2, as
    the reference's; the points p* feed the residuals.
    """
    S = slab.xyz.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    q = queries.contiguous()
    slab_t = slab.xyz.transpose(1, 2).contiguous()  # [S, 3, C]
    if impl == "pallas":
        dmin, amin, _, _ = ring_min2(q, slab_t)
    elif impl == "xla":
        dmin, amin = ring_min1(q, slab_t)
    else:
        dmin, amin = ring_min1_packed(q, slab_t, product=impl == "mxu")

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
        # the nearest on ring0 but slot0: the ring0 row's exact distances,
        # quantized as the packed form's, slot0 masked, one integer minimum
        row_t = slab_t[ring0].transpose(0, 1)  # [3, Q, C]
        C = row_t.shape[2]
        bits, scale, clip = _quant(C)
        col = torch.arange(C, dtype=torch.int32, device=dev)
        keys = torch.where(col == slot0[:, None], 1 << 30,
                           _keys(sq_dist(q.T[:, :, None], row_t), bits,
                                 scale, clip))
        out["d3"], slot3 = _unpack(torch.amin(keys | col, dim=-1), bits,
                                   scale)
        out["p3"] = slab.xyz[ring0, slot3.to(torch.int64)]
    return out
