"""Masked brute-force nearest neighbours (port of vloam_tpu/lidar/knn.py).

The reference sweeps candidates in tiles of a dense |q|^2 + |c|^2 - 2 q.c
distance matrix and merges a running top-k (XLA ops; no Pallas kernel). On
CUDA tensors masked_knn launches the hand-written kernel
kernels/csrc/knn.cu (one thread a query, its running top-k in registers,
candidates in slices across blocks and a merge). masked_knn_plain is its
plain version, taken for CPU tensors: the same expanded form with q.c as
three broadcast products, not a matmul, so no TF32 or cuBLAS setting
touches the distances, in tiles of at most q_tile x c_tile pairs: no [Q, C]
matrix is ever held. The two are bit-identical.

Ties fall as the reference's: its lax.top_k orders equal values lower index
first, and its merges put the running best before the new tile, so its
result is the k smallest by (distance, candidate index). Here every
distance is packed with its index into one int64 key, (float bits << 32) |
index (distances are >= 0 or +inf, so their bits order as the floats do),
and the k smallest keys are taken: exact on any device, whatever order
torch.topk leaves equal values in, and independent of the tile sizes.
Masked candidates are +inf; where fewer than k are live, the rest are the
lowest-index masked ones, and past the end of the candidates the indices of
the reference's padding (its 4096-wide tiles), so an index may be >= C
exactly where the reference's is.

Distances carry the float32 cancellation of the expanded form (~1e-3 m^2 at
80 m coordinates), as the reference's do.
"""

from __future__ import annotations

import torch

from .. import kernels

_REF_C_TILE = 4096  # the reference's candidate tile: its padding indices


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 of planar points p [3, N], summed in the reference's order."""
    return (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]


class _Operands:
    """Planar queries and candidates with what every tile reuses: |q|^2,
    -2 q and |c|^2 (+inf at masked candidates: inf + finite = inf)."""

    def __init__(self, queries, cands, c_mask):
        qT, self.cT = queries.T.contiguous(), cands.T.contiguous()
        self.qq, self.qm = _sq_norm(qT), -2.0 * qT
        self.cc = torch.where(c_mask, _sq_norm(self.cT), torch.inf)

    def dist_sq(self, qs: slice, cs: slice) -> torch.Tensor:
        """[Tq, Tc] max(|q|^2 + |c|^2 - 2 q.c, 0) of a tile. -2 q.c is
        summed from (-2 q) . c, which is -2 times the rounded q.c exactly (a
        power of two), so each pair rounds as the reference's form while the
        tile takes one pass fewer. Planar operands keep every broadcast
        product contiguous."""
        qm = self.qm[:, qs, None]  # [3, Tq, 1]
        c = self.cT[:, cs]
        qc = (qm[0] * c[0] + qm[1] * c[1]) + qm[2] * c[2]
        return torch.clamp((self.qq[qs, None] + self.cc[cs]) + qc, min=0.0)


def _tiles(device, q_tile, c_tile):
    """Tile sizes: 2048 x 8192 pairs on the card (few launches; a 64 MB
    distance tile), 128 x 2048 on the CPU (the tile stays in cache)."""
    cuda = torch.device(device).type == "cuda"
    return (q_tile or (2048 if cuda else 128),
            c_tile or (8192 if cuda else 2048))


def dist_key(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (d, idx) lexicographically, for d >= 0 (or
    +inf) float32 and 0 <= idx < 2^31."""
    return (d.view(torch.int32).to(torch.int64) << 32) | idx


def key_dist(key: torch.Tensor) -> torch.Tensor:
    """The float32 distance packed in dist_key's keys."""
    return (key >> 32).to(torch.int32).view(torch.float32)


def smallest_keys(key: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys along the last dim, ascending."""
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def _padding(n_cand: int, k: int) -> int:
    """How many of the reference's padding slots (masked, indices n_cand,
    n_cand + 1, ...) can reach a top-k."""
    rem = n_cand % _REF_C_TILE
    return 0 if rem == 0 else min(k, _REF_C_TILE - rem)


def masked_knn(queries: torch.Tensor, cands: torch.Tensor,
               c_mask: torch.Tensor, k: int = 5, q_tile: int | None = None,
               c_tile: int | None = None):
    """k nearest live candidates of each query: queries [Q, 3], cands
    [C, 3], c_mask [C] bool. Returns (d_sq [Q, k] ascending, idx [Q, k]
    int64); masked candidates appear as +inf. CPU tensors take
    masked_knn_plain (q_tile, c_tile: its tiles, which change no result);
    CUDA tensors launch kernels/csrc/knn.cu (k <= 8), or raise: there is no
    fallback."""
    if queries.device.type == "cpu":
        return masked_knn_plain(queries, cands, c_mask, k, q_tile, c_tile)
    return kernels.masked_knn(queries.contiguous(), cands.contiguous(),
                              c_mask.contiguous(), k,
                              _padding(cands.shape[0], k))


def masked_knn_plain(queries: torch.Tensor, cands: torch.Tensor,
                     c_mask: torch.Tensor, k: int = 5,
                     q_tile: int | None = None, c_tile: int | None = None):
    """masked_knn in plain PyTorch, on any device: the expanded distances
    tile by tile, the k smallest keys of each tile merged into a running
    top-k. The tile sizes change no result."""
    Q, C = queries.shape[0], cands.shape[0]
    dev = queries.device
    q_tile, c_tile = _tiles(dev, q_tile, c_tile)
    pad = _padding(C, k)
    ops = _Operands(queries, cands, c_mask)
    out = []
    for q0 in range(0, Q, q_tile):
        qs = slice(q0, q0 + q_tile)
        best = None
        for c0 in range(0, C, c_tile):
            d = ops.dist_sq(qs, slice(c0, c0 + c_tile))
            idx = torch.arange(c0, c0 + d.shape[1], device=dev)
            key = smallest_keys(dist_key(d, idx), min(k, d.shape[1]))
            best = key if best is None else smallest_keys(
                torch.cat([best, key], dim=1), min(k, best.shape[1]
                                                   + key.shape[1]))
        if pad:
            idx = torch.arange(C, C + pad, device=dev)
            tail = dist_key(torch.full((pad,), float("inf"), device=dev), idx)
            best = smallest_keys(
                torch.cat([best, tail.expand(best.shape[0], -1)], dim=1), k)
        out.append(best)
    key = torch.cat(out)
    return key_dist(key), key & 0xFFFFFFFF


def nearest_and_ring_constrained(queries: torch.Tensor, cands: torch.Tensor,
                                 c_ring: torch.Tensor, c_mask: torch.Tensor,
                                 nearby_scan: float, mode: str = "corner",
                                 c_tile: int | None = None) -> dict:
    """LO correspondence search (reference laser_odometry.cpp:266-444).

    Pass 1: the nearest live candidate -> (d0, i0) and its ring ring0.
    Pass 2 (corner): the nearest with ring != ring0 and |ring - ring0| <=
    nearby_scan -> (d2, i2). Pass 2 (surf): also the nearest with ring ==
    ring0 other than i0 -> (d3, i3). Where nothing qualifies: (+inf, 0), as
    the reference's scan leaves its initial carry."""
    d0, i0 = masked_knn(queries, cands, c_mask, k=1)
    d0, i0 = d0[:, 0], i0[:, 0]
    C = cands.shape[0]
    # a gather past the end clamps, as the reference's (all masked: i0 >= C)
    ring0 = c_ring[torch.clamp(i0, max=C - 1)]
    dev = queries.device
    c_tile = _tiles(dev, None, c_tile)[1]
    inf = torch.tensor(float("inf"), device=dev)
    ops = _Operands(queries, cands, c_mask)
    b2 = b3 = None
    for c0 in range(0, C, c_tile):
        sl = slice(c0, c0 + c_tile)
        d = ops.dist_sq(slice(None), sl)
        ti = torch.arange(c0, c0 + d.shape[1], device=dev)
        diff = c_ring[sl][None, :] - ring0[:, None]
        near = torch.abs(diff).to(torch.float32) <= nearby_scan
        k2 = torch.min(dist_key(torch.where((diff != 0) & near, d, inf), ti),
                       dim=1).values
        b2 = k2 if b2 is None else torch.minimum(b2, k2)
        if mode == "surf":
            same = (diff == 0) & (ti[None, :] != i0[:, None])
            k3 = torch.min(dist_key(torch.where(same, d, inf), ti),
                           dim=1).values
            b3 = k3 if b3 is None else torch.minimum(b3, k3)

    def split(key):
        if key is None:
            return (torch.full_like(d0, float("inf")),
                    torch.zeros_like(i0))
        dd = key_dist(key)
        return dd, torch.where(torch.isinf(dd), 0, key & 0xFFFFFFFF)

    (d2, i2), (d3, i3) = split(b2), split(b3)
    return {"d0": d0, "i0": i0, "d2": d2, "i2": i2, "d3": d3, "i3": i3}
