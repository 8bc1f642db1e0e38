"""The work of one LiDAR frame (the `LoamEngine` polar frame, and a
stream's frame of `BatchLoamEngine`), counted from the configuration's
shapes and the frame's live counts: the operations it must do and the bytes
it must move, stage by stage. A frozen copy of the port's per-stage
arithmetic (`vloam_tpu_torch/tools/work.py`), fed with the live counts of
the benchmark's own reference pass (`frame_counts`), never with the port's
internals, so it reads the same work whatever implements the frame.

A roofline counts the work itself, whatever implements it:

- each input byte read once and each output byte written once; a stage's
  dict counts its own inputs and outputs (``bytes_in``, ``bytes_out``), the
  frame's bytes only what the frame reads and writes outside itself: the
  range image, the carried state it reads, the state it writes and the
  output row. Tensors that pass between stages stay out of the frame's
  bytes: a fused frame need not move them;
- only the work these inputs need: live counts go wherever the inputs leave
  slots empty (valid returns, features per class, live slab slots, live
  stack rows, distinct bucket rows, live map candidates, accepted
  residuals), never the capacities;
- the engine's fixed iteration counts (2 outer rounds x 4 LM iterations in
  LO and in MO; it has no early exit).

Stages: ingest (the range image to the ring layout), scanreg (curvature,
break prefix, the sector selection, label partition, the per-ring less-flat
voxel filter), lo (2 rounds of the ring association and 4 LM iterations),
voxel (the two mapping stacks), mo (the 8-cell probe of both grids, per
round the 5-NN, eig3 and the float64 plane fit, 4 LM iterations),
map_update (the inserts and, on a recentre, the eviction), output (the
row). Operations are float32 unless named ``ops_f64``; each counts the
operations a lane must issue (a fused multiply-add counts 2).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..reference.geometry import so3
from ..reference.lidar.gridmap import _bucket_of, probe_buckets

# ---- per-unit operation counts ----------------------------------------------
INGEST_PIXEL_OPS = 3  # widen, scale to metres, the range gate
INGEST_POINT_OPS = 5  # direction x range (3), relative time, ring count
CURVATURE_OPS = 17  # prefix sums (3), window difference (3), sum - 11 p (6),
#                     squared norm (5)
BREAK_OPS = 10  # neighbour difference (3), squared norm (5), gate, prefix
PARTITION_OPS = 4  # group key, per-group count, destination, mask
VOXEL_POINT_OPS = 29  # cell (6) and murmur hash (15), centring (3),
#                       segment start (1), prefix sums of count + xyz (4)
VOXEL_OUT_OPS = 7  # prefix differences (3), divides (3), occupancy (1)
TRANSFORM_OPS = 18  # rotate (15) and translate (3) a point
ASSOC_PAIR_OPS = 8  # (q - c)^2 summed: 3 subtractions, 3 products, 2 sums
LO_CORNER_GEOMETRY_OPS = 9  # |a - b|
LO_SURF_GEOMETRY_OPS = 21  # two differences (6), cross (9), norm (6)
# one LM residual row: the transformed point (18), the residual, its
# Jacobian row(s) (d r / d p times d p / d delta), the Huber weight (4), the
# upper triangle of J^T W J (21 entries), J^T W r and the cost
EDGE_ROW_OPS = 299  # 3 residuals: 18 + 18 + 90 + 5 + 4 + 126 + 36 + 2
PLANE_ROW_OPS = 117  # 1 residual: 18 + 8 + 30 + 1 + 4 + 42 + 12 + 2
LM_STEP_OPS = 240  # the damped, Jacobi-scaled 6x6 solve and the retraction
PROBE_QUERY_OPS = 110  # the 8 cells' hashes and sides of a query
KNN_PAIR_OPS = 6  # 3 fused multiply-adds: q.c against precomputed norms
CORNER_GEOMETRY_OPS = 210  # mean, centred Gram, eig3, eigenvector, a, b
SURF_FIT_F64_OPS = 180  # Gram, adjugate solve, norm, 5 plane residuals
INSERT_POINT_OPS = 30  # the bucket's cell and hash (22), the voxel (6),
#                        the free-slot pick (2)
INSERT_PAIR_OPS = 9  # a live slot's voxel (6) against the point's (3)
EVICT_SLOT_OPS = 9  # 3 differences, 3 magnitudes, 3 compares

# ---- bytes ------------------------------------------------------------------
POINT_BYTES = 12  # float32 xyz
CLOUD_ROW_BYTES = 21  # a FeatureCloud row: xyz, ring int32, rel_time, mask
STACK_ROW_BYTES = 13  # a mapping stack row: xyz and its mask
POSE_BYTES = 28  # float32 quaternion and translation
LO_COUNT_BYTES = 16  # solve_lo's two correspondence counts (int64)
OUT_ROW_BYTES = 24 * 4
# the carried scalars of LoamState: q_f2f, t_f2f, q_w, t_w, q_wmap_wodom,
# t_wmap_wodom, frame_idx, the map's centre (3 int32) and two live counts
STATE_SCALAR_BYTES = 3 * POSE_BYTES + 4 + 12 + 8
_SENTINEL_HALF = 0.5e6  # live slots lie below half the sentinel
RANGE_SCALE = 0.005  # metres a range unit: LoamEngine.push_polar's default


def _sort_ops(n: int) -> int:
    """Compares of a comparison sort of n keys."""
    return n * math.ceil(math.log2(n)) if n > 1 else 0


def _stage(ops=0, bytes_in=0, bytes_out=0, ops_f64=0) -> dict:
    return {"ops": int(ops), "ops_f64": int(ops_f64),
            "bytes_in": int(bytes_in), "bytes_out": int(bytes_out)}


def row_bytes(cap: int) -> int:
    """One map bucket row: 3 * cap float32."""
    return 3 * cap * 4


# ---- per-kernel work (the bounds of tools/timing.py) ------------------------

def select_rings(n_points: int, n_rings: int, scanreg) -> tuple[int, int]:
    """K1 over n_points ring slots of n_rings rings: per pick round one
    compare a point for the sector's running extremum and one for the
    suppression, 2 x (corner + flat picks a sector) rounds a point; curv
    (f32), bf (int32) and the labels (int32) once a point, the counts once a
    ring. (operations, bytes)."""
    picks = scanreg.max_less_sharp_per_sector + scanreg.max_flat_per_sector
    return 2 * picks * n_points, 12 * n_points + 4 * n_rings


def ring_reduce(Q: int, S: int, C: int, n_out: int,
                pairs: int | None = None) -> tuple[int, int]:
    """A per-ring reduction of Q queries over S rings of C slots:
    ASSOC_PAIR_OPS a (query, slot) pair (all S x Q x C unless `pairs` names
    the live ones) and one compare per minimum kept (n_out // 2 of the n_out
    [S, Q] 4-byte outputs); the queries and the slabs read once, the outputs
    written once. (operations, bytes)."""
    pairs = S * Q * C if pairs is None else pairs
    return (pairs * (ASSOC_PAIR_OPS + n_out // 2),
            Q * POINT_BYTES + S * C * POINT_BYTES + n_out * S * Q * 4)


def association(Q: int, live_slots: int, n_rings: int,
                surf: bool) -> tuple[int, int]:
    """One ring_slab_assoc call of Q queries against a slab of n_rings rings
    with live_slots live slots: ring_reduce over every (query, live slot)
    pair (a corner search keeps each ring's minimum, a surf search its two
    smallest, which give the same-ring pick without a second pass), then a
    query's picks among its ring minima (3 compares a ring). The queries and
    the live slots read once; each pick (2, surf 3: a float32 distance and a
    point) written once. (operations, bytes)."""
    ops = (ring_reduce(Q, n_rings, 0, 4 if surf else 2,
                       pairs=Q * live_slots)[0] + 3 * n_rings * Q)
    return ops, (POINT_BYTES * (Q + live_slots)
                 + (3 if surf else 2) * (4 + POINT_BYTES) * Q)


def row_gather(n_rows: int, width: int, n_unique: int) -> tuple[int, int]:
    """Each of the n_unique distinct float32 rows the indices name read once,
    each of the n_rows output rows written once, each int64 index read once;
    no arithmetic."""
    return 0, (n_unique + n_rows) * width * 4 + n_rows * 8


def grid_probe(jobs) -> tuple[int, int]:
    """S2's map probe, jobs of (Q queries, bucket capacity cap, distinct
    bucket rows probed): per job each distinct float32 row of 3*cap read
    once, the [3, Q, 8*cap] candidates written once, the [Q, 3] queries read
    once; PROBE_QUERY_OPS a query for the hashes."""
    return (sum(PROBE_QUERY_OPS * Q for Q, _, _ in jobs),
            sum(4 * (rows * 3 * cap + Q * 24 * cap + 3 * Q)
                for Q, cap, rows in jobs))


def zncc(K: int, p: int, H: int, W: int) -> tuple[int, int]:
    """K3: the [H, W] image, the [K, 2] keypoints and the [K, p*p]
    descriptors once, all float32; per descriptor element 5 operations (an
    add for the mean, a subtract, a multiply and an add for the centred
    norm, the multiply that scales it)."""
    n_desc = K * p * p
    return 5 * n_desc, 4 * (H * W + 2 * K + n_desc)


def knn(Q: int, C: int, k: int, pairs: int | None = None) -> tuple[int, int]:
    """A masked k-NN of Q queries against C candidates: KNN_PAIR_OPS a pair
    (all Q x C unless `pairs` names the live ones); the [Q, 3] queries, the
    [C, 3] candidates and their [C] mask read once, the [Q, k] float32
    distances and int64 indices written once."""
    pairs = Q * C if pairs is None else pairs
    return KNN_PAIR_OPS * pairs, Q * 12 + C * 13 + Q * k * 12


# ---- the frame's live counts ------------------------------------------------

@dataclasses.dataclass
class FrameCounts:
    """The live counts of one frame (frame_counts reads them)."""

    n_rings: int
    n_azimuth: int
    pixel_bytes: int  # of the range image (2: uint16)
    valid: int  # returns past the minimum range
    selectable: int  # ring slots the selection may pick from
    sharp: int
    less_sharp: int
    flat: int
    less_flat: int
    corner_last: int  # live slots of the last frame's slabs (LO reads)
    surf_last: int
    lo_corner: int  # n_corner_corr / n_plane_corr of the output row
    lo_surf: int
    corner_stack: int
    surf_stack: int
    probe_rows_c: int  # distinct bucket rows of the probe
    probe_rows_s: int
    cand_c: int  # (query, live candidate) pairs over each query's rows
    cand_s: int
    fit_c: int  # live stack rows with at least knn live candidates
    fit_s: int
    insert_rows_c: int  # distinct bucket rows the inserts read
    insert_rows_s: int
    insert_pairs_c: int  # (inserted point, live slot of its row) pairs
    insert_pairs_s: int
    update_rows_c: int  # distinct rows the map update reads: the inserts',
    update_rows_s: int  # and on a recentre every row holding a live slot
    recentre: int  # 1 when the map's centre moved (the eviction runs)
    live_slots_c: int  # live map slots before the frame
    live_slots_s: int
    read_rows_c: int  # distinct rows read: probe, inserts, eviction
    read_rows_s: int
    written_rows_c: int  # rows the frame changed: inserts and eviction
    written_rows_s: int


def _live_slab(xyz: torch.Tensor) -> int:
    return int((xyz[..., 0] < _SENTINEL_HALF).sum())


def _live_per_row(pts: torch.Tensor) -> torch.Tensor:
    """Live slots of each bucket row [nb, 3*cap] (its x block)."""
    cap = pts.shape[1] // 3
    return (pts[:, :cap] < _SENTINEL_HALF).sum(dim=1)


def _probe(pts: torch.Tensor, live_row: torch.Tensor, queries: torch.Tensor,
           cell: float, k: int):
    """(distinct rows [n], live candidate pairs, queries with >= k live
    candidates) of the 8-cell probe of `queries` (the live stack rows)."""
    b, _ = torch.sort(probe_buckets(queries, cell, pts.shape[0]), dim=1)
    first = torch.ones_like(b, dtype=torch.bool)
    first[:, 1:] = b[:, 1:] != b[:, :-1]  # each row once per query
    cand = torch.sum(live_row[b] * first, dim=1)
    return torch.unique(b), int(cand.sum()), int((cand >= k).sum())


def frame_counts(cfg, image, q_off, t_off, last_slabs, map_before,
                 map_after, feats, stacks, out) -> FrameCounts:
    """The live counts of one frame from the reference's pass: the range
    image (numpy [S, A] uint16), the odom -> map offset and the last
    frame's slabs before the frame, the map before and after it, the
    frame's ScanFeatures and mapping stacks (c_xyz, c_m, s_xyz, s_m) and
    its output row [24]. The probe's and the inserts' buckets are hashed
    from the stacks at the row's poses, as the frame step hashes them."""
    lidar, mc = cfg.lidar, cfg.mapping
    S, A = image.shape
    valid = (image.astype(np.float32) * np.float32(RANGE_SCALE)
             >= lidar.minimum_range)
    cnt = valid.sum(axis=1)
    selectable = int(np.where(cnt - 11 >= 6, cnt - 11, 0).sum())

    c_xyz, c_m, s_xyz, s_m = stacks
    out = out.to(torch.float32)
    q_w, t_w, q_m, t_m = out[7:11], out[11:14], out[14:18], out[18:21]
    # the probe at the prediction pose (mapping.solve_mapping's x0)
    q_pred = so3.quat_normalize(so3.quat_multiply(q_off, q_w))
    t_pred = t_off + so3.quat_rotate(q_off, t_w)
    recentre = int(torch.any(map_after.center != map_before.center))
    res = {}
    for tag, g0, g1, xyz, m, cell in (
            ("c", map_before.corner, map_after.corner, c_xyz, c_m,
             mc.corner_cell),
            ("s", map_before.surf, map_after.surf, s_xyz, s_m,
             mc.surf_cell)):
        live_row = _live_per_row(g0.pts)
        pts = xyz[m]
        rows_p, cand, fit = _probe(g0.pts, live_row,
                                   so3.quat_rotate(q_pred, pts) + t_pred,
                                   cell, mc.knn)
        b = _bucket_of(so3.quat_rotate(q_m, pts) + t_m, cell,
                       g0.pts.shape[0])
        rows_i = torch.unique(b)
        rows_u = (torch.unique(torch.cat([rows_i, torch.nonzero(
            live_row)[:, 0]])) if recentre else rows_i)  # the eviction's
        res.update({
            f"probe_rows_{tag}": rows_p.numel(), f"cand_{tag}": cand,
            f"fit_{tag}": fit, f"insert_rows_{tag}": rows_i.numel(),
            f"insert_pairs_{tag}": int(live_row[b].sum()),
            f"live_slots_{tag}": int(live_row.sum()),
            f"update_rows_{tag}": rows_u.numel(),
            f"read_rows_{tag}": torch.unique(torch.cat([rows_p,
                                                       rows_u])).numel(),
            f"written_rows_{tag}": int(torch.any(g1.pts != g0.pts,
                                                 dim=1).sum())})
    return FrameCounts(
        n_rings=S, n_azimuth=A, pixel_bytes=image.itemsize,
        valid=int(valid.sum()), selectable=selectable,
        sharp=int(feats.sharp.mask.sum()),
        less_sharp=int(feats.less_sharp.mask.sum()),
        flat=int(feats.flat.mask.sum()),
        less_flat=int(feats.less_flat.mask.sum()),
        corner_last=_live_slab(last_slabs[0].xyz),
        surf_last=_live_slab(last_slabs[1].xyz),
        lo_corner=int(out[21]), lo_surf=int(out[22]),
        corner_stack=int(c_m.sum()), surf_stack=int(s_m.sum()),
        recentre=recentre, **res)


# ---- the frame's work by stage ----------------------------------------------

def ingest(c: FrameCounts) -> dict:
    """polar_layout: the range image read once and its ray directions at
    the valid returns; the layout's live points, relative times and ring
    counts written once."""
    V, S = c.valid, c.n_rings
    return _stage(INGEST_PIXEL_OPS * S * c.n_azimuth + INGEST_POINT_OPS * V,
                  bytes_in=c.pixel_bytes * S * c.n_azimuth + POINT_BYTES * V,
                  bytes_out=16 * V + 4 * S)


def scan_registration(cfg, c: FrameCounts) -> dict:
    """Curvature and break prefix of the live ring points, K1's pick rounds
    over them, the label partition and the per-ring less-flat voxel filter
    (its inputs: the selectable slots not labelled corner); the four
    feature classes and the two slabs written once."""
    V, S = c.valid, c.n_rings
    lf_in = max(c.selectable - c.less_sharp, 0)
    ops = ((CURVATURE_OPS + BREAK_OPS + PARTITION_OPS) * V
           + select_rings(V, S, cfg.scanreg)[0]
           + VOXEL_POINT_OPS * lf_in + _sort_ops(lf_in)
           + VOXEL_OUT_OPS * c.less_flat)
    return _stage(ops, bytes_in=16 * V + 4 * S,
                  bytes_out=CLOUD_ROW_BYTES * (c.sharp + c.less_sharp
                                               + c.flat + c.less_flat)
                  + POINT_BYTES * (c.less_sharp + c.less_flat))


def _lm(iterations: int, edge_rows: int, plane_rows: int) -> int:
    """One lm_solve: iterations + 1 evaluations of the weighted rows and
    `iterations` damped steps."""
    return ((iterations + 1) * (EDGE_ROW_OPS * edge_rows
                                + PLANE_ROW_OPS * plane_rows)
            + iterations * LM_STEP_OPS)


def lo(cfg, c: FrameCounts) -> dict:
    """solve_lo: per outer round the live queries moved by the pose, their
    association() against the last slabs, the residual geometry, then the
    LM over the accepted correspondences (the output row's counts, the last
    round's). The sharp and flat points, the
    last slabs' live slots and the seed read once; the pose and the two
    counts written once."""
    lc, S = cfg.lo, c.n_rings
    Q = c.sharp + c.flat
    per_round = (TRANSFORM_OPS * Q
                 + association(c.sharp, c.corner_last, S, False)[0]
                 + association(c.flat, c.surf_last, S, True)[0]
                 + LO_CORNER_GEOMETRY_OPS * c.sharp
                 + LO_SURF_GEOMETRY_OPS * c.flat
                 + _lm(lc.gn_iterations, c.lo_corner, c.lo_surf))
    point = POINT_BYTES + (4 if lc.distortion else 0)
    return _stage(lc.outer_rounds * per_round,
                  bytes_in=point * Q + POINT_BYTES * (c.corner_last
                                                      + c.surf_last)
                  + POSE_BYTES,
                  bytes_out=POSE_BYTES + LO_COUNT_BYTES)


def voxel(cfg, c: FrameCounts) -> dict:
    """The two mapping stacks: voxel_downsample of the live less-sharp and
    less-flat points."""
    ops = sum(VOXEL_POINT_OPS * n + _sort_ops(n) + VOXEL_OUT_OPS * m
              for n, m in ((c.less_sharp, c.corner_stack),
                           (c.less_flat, c.surf_stack)))
    return _stage(ops, bytes_in=STACK_ROW_BYTES * (c.less_sharp
                                                   + c.less_flat),
                  bytes_out=STACK_ROW_BYTES * (c.corner_stack
                                               + c.surf_stack))


def mo(cfg, c: FrameCounts) -> dict:
    """solve_mapping: the live stack rows moved to the prediction and hashed
    (the probe reads each distinct bucket row once), then per outer round
    the rows moved by the pose, the 5-NN over each query's live candidates,
    corner_geometry and surf_geometry (float64) of the rows with at least
    knn live candidates, and the LM over those rows: the residuals that can
    be accepted (the acceptance gates past that are decided in the solve,
    and not among the frame's outputs). The stacks, the prediction and the
    probed rows read once; the pose written once."""
    mc = cfg.mapping
    Q = c.corner_stack + c.surf_stack
    probe = grid_probe([(c.corner_stack, mc.corner_bucket_cap,
                         c.probe_rows_c),
                        (c.surf_stack, mc.surf_bucket_cap, c.probe_rows_s)])
    per_round = (TRANSFORM_OPS * Q
                 + knn(Q, 0, mc.knn, c.cand_c + c.cand_s)[0]
                 + CORNER_GEOMETRY_OPS * c.fit_c
                 + _lm(mc.gn_iterations, c.fit_c, c.fit_s))
    return _stage(TRANSFORM_OPS * Q + probe[0] + mc.outer_rounds * per_round,
                  bytes_in=STACK_ROW_BYTES * Q + POSE_BYTES
                  + row_bytes(mc.corner_bucket_cap) * c.probe_rows_c
                  + row_bytes(mc.surf_bucket_cap) * c.probe_rows_s,
                  bytes_out=POSE_BYTES,
                  ops_f64=mc.outer_rounds * SURF_FIT_F64_OPS * c.fit_s)


def map_update(cfg, c: FrameCounts) -> dict:
    """The inserts: the live stack rows moved to the refined pose and
    hashed, each against the live slots of its bucket row (the voxel
    dedup), ranked within its bucket (a sort); on a recentre every live
    slot tested against the window. The stacks and the pose read, with the
    inserts' distinct rows (and on a recentre every row holding a live
    slot); the changed rows written once."""
    mc = cfg.mapping
    ops = 0
    for n, pairs, live in ((c.corner_stack, c.insert_pairs_c,
                            c.live_slots_c),
                           (c.surf_stack, c.insert_pairs_s, c.live_slots_s)):
        ops += ((TRANSFORM_OPS + INSERT_POINT_OPS) * n + _sort_ops(n)
                + INSERT_PAIR_OPS * pairs + c.recentre * EVICT_SLOT_OPS * live)
    rb_c, rb_s = row_bytes(mc.corner_bucket_cap), row_bytes(mc.surf_bucket_cap)
    return _stage(ops, bytes_in=STACK_ROW_BYTES * (c.corner_stack
                                                   + c.surf_stack)
                  + POSE_BYTES + rb_c * c.update_rows_c
                  + rb_s * c.update_rows_s,
                  bytes_out=rb_c * c.written_rows_c
                  + rb_s * c.written_rows_s)


def output(c: FrameCounts) -> dict:
    """The frame's row: 24 float32 values written once."""
    return _stage(bytes_out=OUT_ROW_BYTES)


def frame_work(cfg, c: FrameCounts) -> dict:
    """{"stages": {name: stage dict}, "ops", "ops_f64", "bytes"} of one
    frame. ops: the float32 operations summed over the stages; bytes: the
    frame's own inputs and outputs (module docstring): the range image and
    its directions at the valid returns, the carried state read (the last
    slabs' live slots, the scalars, each distinct map row read by the probe,
    the inserts or the eviction), the state written (the new slabs' live
    slots, the scalars, the changed map rows) and the output row."""
    mc = cfg.mapping
    stages = {"ingest": ingest(c), "scanreg": scan_registration(cfg, c),
              "lo": lo(cfg, c), "voxel": voxel(cfg, c), "mo": mo(cfg, c),
              "map_update": map_update(cfg, c), "output": output(c)}
    rb_c, rb_s = row_bytes(mc.corner_bucket_cap), row_bytes(mc.surf_bucket_cap)
    n_bytes = (stages["ingest"]["bytes_in"]
               + POINT_BYTES * (c.corner_last + c.surf_last)
               + rb_c * c.read_rows_c + rb_s * c.read_rows_s
               + POINT_BYTES * (c.less_sharp + c.less_flat)
               + rb_c * c.written_rows_c + rb_s * c.written_rows_s
               + 2 * STATE_SCALAR_BYTES + OUT_ROW_BYTES)
    return {"stages": stages,
            "ops": sum(s["ops"] for s in stages.values()),
            "ops_f64": sum(s["ops_f64"] for s in stages.values()),
            "bytes": int(n_bytes)}


def mean_work(works: list[dict]) -> dict:
    """The mean per frame of frame_work results, stage by stage too."""
    def mean(key, stage=None):
        return float(np.mean([(w["stages"][stage] if stage else w)[key]
                              for w in works]))

    return {"ops": mean("ops"), "ops_f64": mean("ops_f64"),
            "bytes": mean("bytes"),
            "stages": {n: {k: mean(k, n) for k in st}
                       for n, st in works[0]["stages"].items()}}
