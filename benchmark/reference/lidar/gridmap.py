"""Incremental hashed cell-slab map (port of vloam_tpu/lidar/gridmap.py):
the map's storage layout is the k-NN acceleration structure, maintained
incrementally — nothing is rebuilt per frame.

- Points live in bucket rows [n_buckets, 3*cap] laid out x|y|z (one row
  gather fetches all three planes of a bucket); a point's bucket is a hash
  of its `cell`-sized grid cell, bit-identical to the JAX reference's, so
  both implementations fill the same rows. Slabs are SENTINEL-padded.
- INSERT sorts only the new frame's points by bucket (stable), drops any
  point whose map-resolution voxel is already occupied in its bucket, and
  writes the rest into the buckets' free slots.
- QUERY probes the 8 cells that can hold a neighbour within cell/2, gathers
  their rows and takes the k smallest distances.
- EVICT marks points outside the window as sentinels (no compaction).

Functions return new FeatureGrid values and leave their inputs untouched,
as the JAX reference's do.

A query's cell is ``floor(q * reciprocal_f32(cell))``: the reference's
``q / cell`` as XLA computes it (voxel.reciprocal_f32); the probe's
neighbour side rounds as XLA's fused multiply-add (probe_buckets).

A probe (``grid_gather``) is the plain composition of hashes, a row
gather and a permute, on every device; the insert fetches whole bucket
rows by id.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .voxel import (_cell_of, _mul32, as_u32, hash_avalanche,
                    reciprocal_f32)

SENTINEL = 1.0e6


def _hash_cell(ix, iy, iz, n_buckets: int) -> torch.Tensor:
    """Bucket id (int64) of int32 cell coordinates; bit-identical with
    vloam_tpu.lidar.gridmap._hash_cell."""
    h = (_mul32(as_u32(ix), 73856093) + _mul32(as_u32(iy), 19349669)
         + _mul32(as_u32(iz), 83492791)) & 0xFFFFFFFF
    h = hash_avalanche(h, final_shift=False)
    return h & (n_buckets - 1)


class FeatureGrid(NamedTuple):
    """One feature class's map: SENTINEL-padded bucket rows + a global live
    count (used only for the 'enough map' gates and stats)."""

    pts: torch.Tensor  # [n_buckets, 3*cap] f32 interleaved x|y|z blocks
    n_live: torch.Tensor  # [] int32 total live points

    @property
    def cap(self) -> int:
        return self.pts.shape[1] // 3


def grid_create(n_buckets: int, cap: int, device) -> FeatureGrid:
    return FeatureGrid(
        pts=torch.full((n_buckets, 3 * cap), SENTINEL, dtype=torch.float32,
                       device=device),
        n_live=torch.zeros((), dtype=torch.int32, device=device),
    )


def _bucket_of(p: torch.Tensor, cell: float, n_buckets: int) -> torch.Tensor:
    c = _cell_of(p, cell)
    return _hash_cell(c[..., 0], c[..., 1], c[..., 2], n_buckets)


def grid_insert(g: FeatureGrid, p: torch.Tensor, mask: torch.Tensor,
                cell: float, res: float, stored=None) -> FeatureGrid:
    """Insert world points `p [B,3]` (mask [B]) with voxel dedup at `res`.
    `cell` must be an integer multiple of `res`. stored [B, 3]: the values
    the slots take, where they are not p's own (the lockstep map's fixed
    point, mapping.fixed_point); buckets and voxels are always p's."""
    nb, cap = g.pts.shape[0], g.cap
    B = p.shape[0]
    dev = p.device
    b = _bucket_of(p, cell, nb)  # [B]
    v = _cell_of(p.T, res)  # [3, B] voxel index, rounded as the reference's
    rows = g.pts[b]  # [B, 3*cap]
    slab = rows.reshape(B, 3, cap).permute(1, 0, 2)  # [3, B, cap]
    sv = _cell_of(slab, res)
    dup = torch.any(torch.all(sv == v[:, :, None], dim=0), dim=-1)
    keep = mask & ~dup
    key = torch.where(keep, b, nb)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    # within-bucket rank from the sorted keys (segment starts via cummax)
    idx = torch.arange(B, device=dev)
    boundary = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          ks[1:] != ks[:-1]])
    seg_start = torch.cummax(torch.where(boundary, idx, -1), dim=0).values
    rank = idx - seg_start
    # destination = (rank+1)-th FREE slot of the bucket row (evict leaves
    # holes; this per-row scan is O(frame))
    free = slab[0][order] > SENTINEL * 0.5  # [B, cap]
    fcsum = torch.cumsum(free, dim=1)
    pos = torch.argmax((fcsum >= (rank + 1)[:, None]).to(torch.int32), dim=1)
    ok = (ks < nb) & (rank < fcsum[:, -1])
    # dropped points land in a dump row nb, sliced off below
    dest_b = torch.where(ok, ks, nb)
    cols = torch.stack([pos, pos + cap, pos + 2 * cap], dim=1)  # [B, 3]
    pts = torch.cat([g.pts, g.pts.new_full((1, 3 * cap), SENTINEL)])
    pts[dest_b[:, None], cols] = (p if stored is None else stored)[order]
    return FeatureGrid(pts=pts[:nb],
                       n_live=g.n_live + torch.sum(ok, dtype=torch.int32))


def grid_evict(g: FeatureGrid, center: torch.Tensor,
               radius: torch.Tensor) -> FeatureGrid:
    """Drop points outside the box center +- radius (both [3], meters):
    one elementwise pass marking sentinels; slots are not compacted."""
    cap = g.cap
    xyz = g.pts.reshape(-1, 3, cap)  # [nb, 3, cap]
    live = xyz[:, 0] < SENTINEL * 0.5
    inside = torch.all(
        torch.abs(xyz - center[None, :, None]) <= radius[None, :, None],
        dim=1)  # [nb, cap]
    keep = live & inside
    pts = torch.where(keep[:, None, :], xyz, SENTINEL).reshape(-1, 3 * cap)
    return FeatureGrid(pts=pts, n_live=torch.sum(keep, dtype=torch.int32))


def probe_buckets(queries: torch.Tensor, cell: float,
                  n_buckets: int) -> torch.Tensor:
    """Bucket ids [..., 8] (int64) of the 8 cells that can hold a neighbour
    within cell/2 of each query [..., 3]: per axis the query's cell and the
    nearer neighbour, in the order (sx, sy, sz) in {0, 1}^3 of the
    reference's loops. The side is q * (1 / cell) - c < 0.5 with the
    product not rounded before the subtraction: XLA's CPU backend contracts
    the reference's s - c into a fused multiply-add. Emulated in float64,
    which holds the product exactly and, wherever the result is near 0.5,
    the difference too, then rounded once to float32 as the fma rounds."""
    c = _cell_of(queries, cell)
    side = (queries.double() * reciprocal_f32(cell)
            - c.float().double()).float()
    off = torch.where(side < 0.5, -1, 1).to(torch.int32)  # [..., 3]
    hs = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                hs.append(_hash_cell(c[..., 0] + sx * off[..., 0],
                                     c[..., 1] + sy * off[..., 1],
                                     c[..., 2] + sz * off[..., 2], n_buckets))
    return torch.stack(hs, dim=-1)


def grid_gather(g: FeatureGrid, queries: torch.Tensor, cell: float):
    """Each query's 8-cell probe candidates, [3, Q, 8*cap] planar: the
    plain composition (hashes, a row gather, a permute copy)."""
    nb, cap = g.pts.shape[0], g.cap
    q = queries.shape[0]
    buckets = probe_buckets(queries, cell, nb)  # [Q, 8]
    rows = g.pts[buckets.reshape(-1)]  # [8Q, 3*cap]
    planar = rows.reshape(q, 8, 3, cap)
    return planar.permute(2, 0, 1, 3).reshape(3, q, 8 * cap)


def knn_among_planar(cand: torch.Tensor, queries: torch.Tensor, k: int = 5):
    """k-NN among pre-gathered planar candidates [3, Q, C]. Returns
    (d_sq [Q, k] ascending, near [3, Q, k] planar). Among exactly equal
    distances (e.g. sentinel slots, whose points are identical) the slot
    order may differ from the JAX reference's top_k."""
    diff = cand - queries.T[:, :, None]
    sq = diff * diff
    d = (sq[0] + sq[1]) + sq[2]  # [Q, C]
    nd, ni = torch.topk(-d, k, dim=1, largest=True, sorted=True)
    near = torch.take_along_dim(cand, ni[None, :, :], dim=2)  # [3, Q, k]
    return -nd, near


