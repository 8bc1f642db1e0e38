"""Flat-batched scan-to-map mapping: B independent sequences, ONE index space
(port of vloam_tpu/lidar/batch_mapping.py).

The stream axis is folded into the hash-bucket axis: B per-stream tables
become ONE [B*nb, 3*cap] table, a point's row is ``stream*nb + hash(cell)``,
and every gather, sort and scatter of the mapping stage is a single flat op
over all streams, so its fixed costs (on this port: its kernel launches) are
paid once per lockstep frame instead of once per stream. On CUDA both grids'
candidate probes are one launch of kernels/csrc/grid_probe.cu over all
streams (``batch_grid_gather_pair``), and each insert's row fetch is one
``gridmap.row_gather`` (kernels/csrc/row_gather.cu).

Insert is a segment-merged ROW scatter: points are sorted by flat bucket,
each bucket-segment's points are merged into one updated row image with
int32 prefix sums, and only segment-end rows are written.

Per-stream semantics are those of mapping.solve_mapping (reference
laser_mapping.cpp:458-626 and :638-702). Eviction (the cube-shift
recentering, :207-402) is hoisted to once per chunk (batch_map_evict): the
window is ~+-500 m while a pose moves < ~2 m per frame, so evicting at chunk
granularity drops the same points a few frames earlier or later, outside the
1 m association radius either way.

Departures from the JAX module: the LM linearizes in closed form
(mapping.mo_families with a stream axis) where the reference vmaps jacfwd;
rows that the reference drops with an out-of-range scatter index go to a
dump row that is sliced off. Nothing here reads a device value back to the
host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import so3
from ..solver.lm import lm_solve
from .gridmap import (SENTINEL, _bucket_of, _cell_of, probe_buckets,
                      row_gather)
from .mapping import (_cube_coord, _retract, corner_fit, mo_families,
                      surf_fit, window_half_extent)
from .voxel import reciprocal_f32


class BatchFeatureGrid(NamedTuple):
    """B per-stream hashed cell-slab maps in one flat table.

    Row ``s*nb + h`` is stream s's bucket h; the x|y|z row layout is
    gridmap.FeatureGrid's."""

    pts: torch.Tensor  # [B*nb, 3*cap] f32, SENTINEL-padded
    n_live: torch.Tensor  # [B] int32

    @property
    def cap(self) -> int:
        return self.pts.shape[1] // 3

    def n_buckets(self, batch: int) -> int:
        return self.pts.shape[0] // batch


class BatchGridMap(NamedTuple):
    corner: BatchFeatureGrid
    surf: BatchFeatureGrid
    center: torch.Tensor  # [B, 3] int32 cube coordinate at last eviction

    @staticmethod
    def create(cfg, batch: int, device) -> "BatchGridMap":
        def grid(cap):
            return BatchFeatureGrid(
                pts=torch.full((batch * cfg.map_n_buckets, 3 * cap), SENTINEL,
                               dtype=torch.float32, device=device),
                n_live=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))

        return BatchGridMap(
            corner=grid(cfg.corner_bucket_cap),
            surf=grid(cfg.surf_bucket_cap),
            center=torch.zeros((batch, 3), dtype=torch.int32, device=device))


def _stream_offsets(batch: int, nb: int, device) -> torch.Tensor:
    """[B, 1] int64 first flat row of each stream's table."""
    return (torch.arange(batch, device=device) * nb)[:, None]


def _flat_buckets(p: torch.Tensor, cell: float, nb: int) -> torch.Tensor:
    """p [B, Q, 3] -> flat row ids [B*Q] = stream*nb + hash(cell(p)),
    int64, bit-identical with the reference's."""
    b = _bucket_of(p, cell, nb)  # [B, Q]
    return (b + _stream_offsets(p.shape[0], nb, p.device)).reshape(-1)


def batch_grid_gather_plain(g: BatchFeatureGrid, queries: torch.Tensor,
                            cell: float, batch: int) -> torch.Tensor:
    """8-cell probe candidates for per-stream queries [B, Q, 3] as ONE flat
    row gather: planar [3, B*Q, 8*cap] (cf. gridmap.grid_gather_plain)."""
    nb, cap = g.n_buckets(batch), g.cap
    B, Q = queries.shape[:2]
    soff = _stream_offsets(B, nb, queries.device)
    buckets = probe_buckets(queries, cell, nb) + soff[..., None]  # [B, Q, 8]
    rows = row_gather(g.pts, buckets.reshape(-1))  # [8*B*Q, 3*cap]
    planar = rows.reshape(B * Q, 8, 3, cap)
    return planar.permute(2, 0, 1, 3).reshape(3, B * Q, 8 * cap)


def batch_grid_gather_pair(g_c: BatchFeatureGrid, q_c: torch.Tensor,
                           cell_c: float, g_s: BatchFeatureGrid,
                           q_s: torch.Tensor, cell_s: float, batch: int):
    """Both grids' probe candidates, each as batch_grid_gather_plain gives
    it. CPU tensors take batch_grid_gather_plain; CUDA tensors launch
    kernels/csrc/grid_probe.cu once for both grids and all streams (or
    raise — there is no fallback)."""
    if all(t.device.type == "cpu" for t in (g_c.pts, q_c, g_s.pts, q_s)):
        return (batch_grid_gather_plain(g_c, q_c, cell_c, batch),
                batch_grid_gather_plain(g_s, q_s, cell_s, batch))
    return tuple(kernels.grid_probe([
        (g.pts, q.reshape(-1, 3).contiguous(), reciprocal_f32(cell),
         g.n_buckets(batch), batch)
        for g, q, cell in ((g_c, q_c, cell_c), (g_s, q_s, cell_s))]))


def _segment_first(flag: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Per element the `value` at the start of its segment (flag marks
    segment starts; values are >= 0 and non-decreasing at the starts)."""
    return torch.cummax(torch.where(flag, value, -1), dim=0).values


def _merged_row_insert(tab: torch.Tensor, key: torch.Tensor, p: torch.Tensor,
                       res: float):
    """Insert points into bucket rows by segment-merged ROW scatter.

    tab [NBt, 3*cap]; key [N] int64 destination row (NBt = dropped);
    p [N, 3]. Returns (tab', ok [N] insert mask in sorted order, ks [N]
    sorted keys).

    One stable sort by key, one row gather that fetches each sorted point's
    bucket row, voxel dup-check and free-slot ranking in sorted order,
    per-bucket updates merged with prefix sums, and only segment-end rows
    written (row indices are unique by construction).

    The prefix-sum merge runs ENTIRELY in int32: coordinates are split into
    an exact integer res-voxel index and a fixed-point fractional part
    (scale chosen so the worst-case all-same-sign prefix stays < 2^31). A
    float32 cumsum would difference two large prefixes per segment, and its
    cancellation grows with N*|coord|; the int path's only loss is the
    fixed-point quantization of the fraction (~res/2^14, deterministic)."""
    NBt, W = tab.shape
    cap = W // 3
    N = key.shape[0]
    dev = tab.device
    i32 = torch.int32

    # fixed-point scale for the in-voxel fraction: frac in [0, res), the
    # worst-case all-in-one-column prefix N*res*q must fit int32 with margin
    q = float(min(1 << 18,
                  max(1, (2 ** 31 - 1) // int(math.ceil(res * N * 1.25)))))
    inv_q = 1.0 / q

    ks, order = torch.sort(key, stable=True)
    pstack = p[order].T  # [3, N]
    # dropped keys fetch the last row (and write nothing)
    rows = row_gather(tab, torch.clamp(ks, max=NBt - 1))  # [N, 3*cap]
    slab = rows.reshape(N, 3, cap).permute(1, 0, 2)  # [3, N, cap]

    # voxel dedup vs the existing map row (first observation wins,
    # reference laser_mapping.cpp:688-702; see gridmap.grid_insert)
    v = _cell_of(pstack, res)  # [3, N] exact voxel index
    sv = _cell_of(slab, res)
    dup = torch.any(torch.all(sv == v[:, :, None], dim=0), dim=-1)  # [N]

    idx = torch.arange(N, dtype=i32, device=dev)
    differs = ks[1:] != ks[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    boundary = torch.cat([one, differs])
    seg_start = _segment_first(boundary, idx)
    # rank among NON-dup points of the segment (dups occupy no slot)
    dup_i = dup.to(i32)
    cs_ex = torch.cumsum(dup_i, dim=0, dtype=i32) - dup_i
    rank = (idx - seg_start) - (cs_ex - _segment_first(boundary, cs_ex))

    free = slab[0] > SENTINEL * 0.5  # [N, cap]; identical within a segment
    fcsum = torch.cumsum(free, dim=1, dtype=i32)
    pos = torch.argmax((fcsum >= (rank + 1)[:, None]).to(i32), dim=1)
    ok = (ks < NBt) & ~dup & (rank < fcsum[:, -1])

    # split each coordinate into (voxel index, fixed-point fraction)
    frac_q = torch.round((pstack - v.to(torch.float32) * res) * q).to(i32)

    col = torch.arange(cap, device=dev)[None, :]
    hi = ((col == pos[:, None]) & ok[:, None]).to(i32)  # [N, cap]

    def columns(x):  # [3, N] per-point values -> [N, 3*cap] at the hit slot
        return torch.cat([hi * x[0][:, None], hi * x[1][:, None],
                          hi * x[2][:, None]], dim=1)

    prev = seg_start - 1
    pc = torch.clamp(prev, min=0).to(torch.int64)
    has_prev = (prev >= 0)[:, None]

    def segment_sum(x):  # inclusive prefix minus the previous segment's end
        cs = torch.cumsum(x, dim=0, dtype=i32)
        return cs - torch.where(has_prev, cs[pc], 0)

    seg_v = segment_sum(columns(v))
    seg_f = segment_sum(columns(frac_q))
    seg_m = segment_sum(torch.cat([hi, hi, hi], dim=1))

    # exactly one contributor per written column: reconstruct its value.
    # XLA contracts the reference's v * res + f * inv_q into
    # fma(v, res, f * inv_q); emulated in float64, which holds the product
    # and the sum exactly, then rounded once to float32. The int32 index
    # times a float64 0-d tensor is one float64 kernel, and f * inv_q one
    # float32 kernel, so no cast is launched but the final rounding
    res64 = torch.tensor(res, dtype=torch.float32).double()
    val = (seg_v * res64 + seg_f * inv_q).float()
    new_row = torch.where(seg_m > 0, val, rows)
    is_end = torch.cat([differs, one])
    # rows that are not written land in a dump row NBt, sliced off below
    dest = torch.where(is_end & (ks < NBt), ks, NBt)
    out = torch.cat([tab, tab.new_empty((1, W))])
    out[dest] = new_row
    return out[:NBt], ok, ks


def batch_grid_insert(g: BatchFeatureGrid, p: torch.Tensor,
                      mask: torch.Tensor, cell: float, res: float,
                      batch: int) -> BatchFeatureGrid:
    """Insert per-stream world points p [B, S, 3] (mask [B, S]) into the
    flat table: one sort + one row gather + one row scatter for ALL
    streams."""
    nb = g.n_buckets(batch)
    NBt = g.pts.shape[0]
    key = torch.where(mask.reshape(-1), _flat_buckets(p, cell, nb), NBt)
    tab, ok, ks = _merged_row_insert(g.pts, key, p.reshape(-1, 3), res)
    stream = torch.clamp(ks // nb, max=batch - 1)
    added = torch.zeros_like(g.n_live).index_add_(0, stream,
                                                  ok.to(torch.int32))
    return BatchFeatureGrid(pts=tab, n_live=g.n_live + added)


def batch_grid_evict(g: BatchFeatureGrid, center_w: torch.Tensor,
                     radius: torch.Tensor, batch: int) -> BatchFeatureGrid:
    """Per-stream box eviction (one elementwise pass over the flat table):
    center_w [B, 3] world centers, radius [3] or [B, 3] half extents."""
    cap = g.cap
    nb = g.n_buckets(batch)
    xyz = g.pts.reshape(batch, nb, 3, cap)
    live = xyz[:, :, 0] < SENTINEL * 0.5
    radius = radius.expand(batch, 3)
    inside = torch.all(
        torch.abs(xyz - center_w[:, None, :, None])
        <= radius[:, None, :, None], dim=2)
    keep = live & inside
    pts = torch.where(keep[:, :, None, :], xyz, SENTINEL)
    return BatchFeatureGrid(
        pts=pts.reshape(batch * nb, 3 * cap),
        n_live=torch.sum(keep, dim=(1, 2), dtype=torch.int32))


def _world(x: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """Per-stream stack points [B, Q, 3] at poses x [B, 7] = [q, t]."""
    return so3.quat_rotate(x[:, None, :4], stack) + x[:, None, 4:]


def _batch_corner_terms(stack, mask, cand, x, cfg):
    """mapping.corner_fit over [B, Qc] stacks with pre-gathered flat
    candidates: the math is per row, so it runs flat over all streams."""
    B, Q = stack.shape[:2]
    a, b, de, valid = corner_fit(_world(x, stack).reshape(B * Q, 3),
                                 mask.reshape(-1), cand, cfg)
    return (a.reshape(B, Q, 3), b.reshape(B, Q, 3), de.reshape(B, Q),
            valid.reshape(B, Q))


def _batch_surf_terms(stack, mask, cand, x, cfg):
    """mapping.surf_fit over [B, Qs] stacks, run flat."""
    B, Q = stack.shape[:2]
    n_hat, nood, valid = surf_fit(_world(x, stack).reshape(B * Q, 3),
                                  mask.reshape(-1), cand, cfg)
    return n_hat.reshape(B, Q, 3), nood.reshape(B, Q), valid.reshape(B, Q)


def batch_solve_mapping(gm: BatchGridMap, corner_stack_xyz, corner_stack_mask,
                        surf_stack_xyz, surf_stack_mask, q_pred, t_pred, cfg,
                        batch: int):
    """B concurrent mapping solves + map inserts (no eviction: call
    batch_map_evict at chunk boundaries). Stacks [B, Qc, 3] / [B, Qc] and
    [B, Qs, 3] / [B, Qs], predictions q_pred [B, 4], t_pred [B, 3]. Returns
    (gm', q_w [B, 4], t_w [B, 3]); per-stream semantics match
    mapping.solve_mapping."""
    B = batch
    x0 = torch.cat([q_pred, t_pred], dim=-1).to(torch.float32)
    enough = ((gm.corner.n_live > cfg.min_corner_map_points)
              & (gm.surf.n_live > cfg.min_surf_map_points))  # [B]

    # one flat candidate gather at the prediction pose, reused by both
    # rounds (the same argument as in mapping.solve_mapping)
    cand_c, cand_s = batch_grid_gather_pair(
        gm.corner, _world(x0, corner_stack_xyz), cfg.corner_cell,
        gm.surf, _world(x0, surf_stack_xyz), cfg.surf_cell, B)

    Qc = corner_stack_xyz.shape[1]
    Qs = surf_stack_xyz.shape[1]
    is_edge = (torch.arange(Qc + Qs, device=x0.device) < Qc)[:, None]
    cp = torch.cat([corner_stack_xyz, surf_stack_xyz], dim=1)

    x = x0
    for _ in range(cfg.outer_rounds):
        a, b, de, v_c = _batch_corner_terms(corner_stack_xyz,
                                            corner_stack_mask, cand_c, x, cfg)
        n_hat, nood, v_s = _batch_surf_terms(surf_stack_xyz, surf_stack_mask,
                                             cand_s, x, cfg)
        # ONE fused residual family per stream (plane rows in slot 0)
        A = torch.cat([a, torch.zeros_like(n_hat)], dim=1)
        Bp = torch.cat([b, torch.zeros_like(n_hat)], dim=1)
        DE = torch.cat([de, torch.ones_like(nood)], dim=1)
        NH = torch.cat([torch.zeros_like(a), n_hat], dim=1)
        NOOD = torch.cat([torch.zeros_like(de), nood], dim=1)
        w = torch.cat([v_c, v_s], dim=1).to(torch.float32)
        x = lm_solve(mo_families(cp, is_edge, A, Bp, DE, NH, NOOD, w),
                     _retract, x, iterations=cfg.gn_iterations,
                     huber_delta=cfg.huber_delta)

    # sparse-map streams keep their prediction (the unconditional solve +
    # select is exact, see mapping.solve_mapping)
    x = torch.where(enough[:, None], x, x0)
    q_w, t_w = x[:, :4], x[:, 4:]

    corner = batch_grid_insert(gm.corner, _world(x, corner_stack_xyz),
                               corner_stack_mask, cfg.corner_cell,
                               cfg.line_resolution, B)
    surf = batch_grid_insert(gm.surf, _world(x, surf_stack_xyz),
                             surf_stack_mask, cfg.surf_cell,
                             cfg.plane_resolution, B)
    return BatchGridMap(corner, surf, gm.center), q_w, t_w


def batch_map_evict(gm: BatchGridMap, t_w: torch.Tensor, cfg,
                    batch: int) -> BatchGridMap:
    """Chunk-granularity recentering (reference laser_mapping.cpp:207-402):
    evict points outside each stream's window when its pose t_w [B, 3]
    crossed a cube boundary since the last eviction. The pass runs every
    chunk; streams that did not move get an effectively infinite window, so
    the host never reads `changed`."""
    center = _cube_coord(t_w, cfg.cube_size)  # [B, 3]
    changed = torch.any(center != gm.center, dim=-1)  # [B]
    radius = window_half_extent(cfg, t_w.device)
    c_w = center.to(torch.float32) * cfg.cube_size
    radius_b = torch.where(changed[:, None], radius[None, :], 1e9)
    return BatchGridMap(
        batch_grid_evict(gm.corner, c_w, radius_b, batch),
        batch_grid_evict(gm.surf, c_w, radius_b, batch),
        torch.where(changed[:, None], center, gm.center))
