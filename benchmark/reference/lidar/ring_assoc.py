"""Per-ring nearest-neighbour association (port of
vloam_tpu/lidar/ring_assoc.py).

Every pick the reference's KD-tree + ring-scan loop makes is a function of
PER-RING minima of the query-candidate distance: the global nearest is the
min over ring minima, the ring-constrained second point is the min over
rings != ring0 within +-nearby_scan, and the surf same-ring point is the
second minimum on ring0. The per-ring minimum is the engines' one form
(the reference's default, "mxu"): each distance |q|^2 + |c|^2 - 2 q.c
quantized to 30 - ceil(log2 C) bits, clipped at 64 m^2 and packed with its
slot into one int32, so one integer minimum gives the minimum and its
first slot.

The distances round as the reference's compiled CPU code rounds them: XLA
contracts the sums of products into fused multiply-adds, e.g.
fma(dz, dz, fma(dy, dy, dx*dx)); fma_f32 emulates each exactly. The surf
d3 / p3 pick is the reference's: the ring0 row gathered, its exact
distances quantized as the packed form's, slot0 masked, one integer
minimum. Plain torch on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


SENTINEL = 1.0e6  # far but finite: squared distances ~3e12, no inf-inf NaN
_BIG = 3.9e12  # > any sentinel distance
_IBIG = 2**30
CLIP_D = 64.0  # the packed forms' saturation, m^2 (> LO's 25 m^2 gates)


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


def _fused_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """max(|q|^2 + |c|^2 - 2 q.c, 0) between q and c [3, ...] (broadcast),
    each of |q|^2, |c|^2 and q.c a chain of fused multiply-adds from the
    first term on, the order of XLA's CPU code: no matmul, so no TF32 and
    no cuBLAS."""
    qq = fma_f32(q[2], q[2], fma_f32(q[1], q[1], q[0] * q[0]))
    cc = fma_f32(c[2], c[2], fma_f32(c[1], c[1], c[0] * c[0]))
    qc = fma_f32(q[2], c[2], fma_f32(q[1], c[1], q[0] * c[0]))
    return torch.clamp((qq + cc) - 2.0 * qc, min=0.0)


def _rounded_dist(q: torch.Tensor, c: torch.Tensor):
    """_fused_dist's distances with each product and sum rounded on its own
    (no float64), and a bound on how far they can lie from _fused_dist's.
    Both round the same real distance: each of its three-term sums to within
    3 float32 units of roundoff u of the sum of its terms' magnitudes, so
    the two lie within 18u (|q|^2 + |c|^2) of each other (|q.c| adds up to
    (|q|^2 + |c|^2) / 2), bounded by 2^-18 (|q|^2 + |c|^2)."""
    qq = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
    cc = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
    qc = (q[0] * c[0] + q[1] * c[1]) + q[2] * c[2]
    s = qq + cc
    return torch.clamp(s - 2.0 * qc, min=0.0), s * 2.0**-18


def ring_min1_packed(queries: torch.Tensor, slab_t: torch.Tensor):
    """Per-ring packed minimum: queries [Q, 3] f32, slab_t [S, 3, C] f32 -> (d
    [S, Q] f32, slot [S, Q] int32), the ring's smallest distance quantized,
    dequantized, ties of the quantized value to the lowest slot, an
    all-SENTINEL ring the clip and slot 0. Ring by ring: the cheap rounded
    distances and their bound single out the slots that can reach the ring's
    smallest key (a lower bound within a quantization step of the smallest
    upper bound), and only those get the fused distances and keys. Where every
    slot lies surely past the clip the key is the clip's at slot 0."""
    S, _, C = slab_t.shape
    Q = queries.shape[0]
    bits, scale, clip = _quant(C)
    clip_key = int(clip * scale) << bits  # exact: scale is a power of two
    q = queries.T[:, :, None]  # [3, Q, 1]
    outs = []
    for s in range(S):
        d, err = _rounded_dist(q, slab_t[s][:, None, :])  # [Q, C]
        lo = d - err
        hi_min = torch.clamp(torch.amin(d + err, dim=1, keepdim=True),
                             max=clip)
        keep = ((torch.clamp(lo, max=clip) < hi_min + 1.0 / scale)
                & (torch.amin(lo, dim=1, keepdim=True) < clip))
        qi, ci = keep.nonzero(as_tuple=True)
        key = _keys(_fused_dist(queries[qi].T, slab_t[s][:, ci]),
                    bits, scale, clip) | ci.to(torch.int32)
        m = torch.full((Q,), clip_key, dtype=torch.int32,
                       device=queries.device).scatter_reduce(
            0, qi, key, "amin", include_self=False)
        outs.append(_unpack(m, bits, scale))
    return tuple(torch.stack(o) for o in zip(*outs))


def ring_slab_assoc(queries: torch.Tensor, slab: RingSlab,
                    nearby_scan: float, mode: str = "corner"):
    """LO correspondence search over per-ring slabs (reference
    laser_odometry.cpp:266-444 semantics; reference ring_assoc.py:264).

    Returns dict with:
      d0 [Q], p0 [Q, 3]   nearest candidate anywhere
      d2 [Q], p2 [Q, 3]   nearest on a DIFFERENT ring within +-nearby_scan
      d3 [Q], p3 [Q, 3]   (surf) second-nearest on the SAME ring

    The distances are gate values, quantized to ~3e-5 m^2 steps and
    saturated at 64 m^2, as the reference's; the points p* feed the
    residuals.
    """
    S = slab.xyz.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    q = queries.contiguous()
    slab_t = slab.xyz.transpose(1, 2).contiguous()  # [S, 3, C]
    dmin, amin = ring_min1_packed(q, slab_t)

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
