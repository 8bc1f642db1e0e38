"""Scan-to-map refinement (port of vloam_tpu/lidar/mapping.py; reference
laser_mapping.cpp).

The reference's cube array, per-cube VoxelGrid and KdTreeFLANN 5-NN are one
structure here, the hashed cell-slab map (gridmap.py). The line test uses
the closed-form 3x3 eigensolver, the plane fit a 3x3 normal-equation solve
by adjugate (in float64, where the reference's is float32: see
surf_geometry), and the pose refinement the shared Huber-IRLS LM.

Nothing in solve_mapping reads a device value back to the host: the
"enough map" gate and the recentering evict are ``torch.where`` selects over
results computed unconditionally.

State transform chain (reference :140-144, :185-195):
  q_w_curr = q_wmap_wodom * q_wodom_curr (prediction), refined by the solve;
  transformUpdate: q_wmap_wodom = q_w_curr * q_wodom_curr^-1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry import so3
from ..solver.eig3 import eigvals_sym3, principal_eigenvector
from ..solver.lm import ResidualFamily, lm_solve
from .gridmap import (FeatureGrid, grid_create, grid_evict, grid_gather,
                      grid_insert, knn_among_planar)
from .voxel import _cell_of, reciprocal_f32

_EPS = 1e-9


class GridMap(NamedTuple):
    """The full map state: one grid per feature class + eviction center."""

    corner: FeatureGrid
    surf: FeatureGrid
    center: torch.Tensor  # [3] int32 cube coordinate of the last eviction

    @staticmethod
    def create(cfg, device) -> "GridMap":
        return GridMap(
            corner=grid_create(cfg.map_n_buckets, cfg.corner_bucket_cap,
                               device),
            surf=grid_create(cfg.map_n_buckets, cfg.surf_bucket_cap, device),
            center=torch.zeros((3,), dtype=torch.int32, device=device),
        )


def _cube_coord(p: torch.Tensor, cube_size: float) -> torch.Tensor:
    """World point -> integer cube coordinate (reference :207-216,:643-652:
    int((x+25)/50) with negative correction == floor)."""
    return _cell_of(p + cube_size / 2.0, cube_size)


def window_half_extent(cfg, device) -> torch.Tensor:
    """[3] half extents of the map window around its cube center, built on
    the device (a host tensor would be a copy per call)."""
    half = [cfg.cube_width * cfg.cube_size / 2.0,
            cfg.cube_height * cfg.cube_size / 2.0,
            cfg.cube_depth * cfg.cube_size / 2.0]
    return sum(h * so3.unit_vector(3, i, device) for i, h in enumerate(half))


def _gram(v: torch.Tensor) -> torch.Tensor:
    """Per query the 3x3 Gram matrix of its k points, planar v [3, Q, k] ->
    [Q, 3, 3], as a broadcast product and a sum (no cuBLAS call, so no TF32
    on CUDA)."""
    return torch.sum(v[:, None] * v[None, :], dim=-1).permute(2, 0, 1)


def _corner_terms(stack_xyz, stack_mask, cand, x, cfg):
    """Line features of the stack points at pose x = [q, t] over the
    pre-gathered planar candidates `cand` [3, Q, 8*cap]."""
    return corner_fit(so3.quat_rotate(x[:4], stack_xyz) + x[4:], stack_mask,
                      cand, cfg)


def corner_fit(p_w, stack_mask, cand, cfg):
    """Line features from 5-NN covariance (reference :472-517) of world
    points p_w [Q, 3] among their candidates `cand` [3, Q, 8*cap]. Every row
    is fitted on its own, so Q may hold several streams' points."""
    d, near = knn_among_planar(cand, p_w, k=cfg.knn)  # near [3, Q, k]
    return corner_geometry(stack_mask, d, near, cfg)


def corner_geometry(stack_mask, d, near, cfg):
    """Line features (a, b, |a - b|, valid) from each query's k nearest
    map points: d [Q, k] ascending, near [3, Q, k] planar."""
    ok = stack_mask & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    center_p = torch.mean(near, dim=2)  # [3, Q]
    dm = near - center_p[:, :, None]
    cov = _gram(dm) * reciprocal_f32(cfg.knn)
    lams = eigvals_sym3(cov)
    is_line = lams[:, 2] > cfg.eigen_ratio * lams[:, 1]
    u = principal_eigenvector(cov, lams[:, 2])
    center = center_p.T  # [Q, 3]
    a = center + cfg.edge_half_length * u
    b = center - cfg.edge_half_length * u
    valid = ok & is_line
    de = torch.linalg.norm(a - b, dim=-1)
    return a, b, de, valid


def _surf_terms(stack_xyz, stack_mask, cand, x, cfg):
    """Plane features of the stack points at pose x = [q, t]."""
    return surf_fit(so3.quat_rotate(x[:4], stack_xyz) + x[4:], stack_mask,
                    cand, cfg)


def surf_fit(p_w, stack_mask, cand, cfg):
    """Plane features from a 5-NN least-squares fit A n = -1 (reference
    :538-581) of world points p_w [Q, 3], planar [3, Q, k] throughout; rows
    are independent, as in corner_fit."""
    d, near = knn_among_planar(cand, p_w, k=cfg.knn)  # near [3, Q, k]
    return surf_geometry(stack_mask, d, near, cfg)


def surf_geometry(stack_mask, d, near, cfg):
    """Plane features (n_hat, 1/|n|, valid) from each query's k nearest map
    points, as corner_geometry takes them.

    The fit runs in float64 and rounds its outputs to float32. The k points
    lie within a metre of each other but up to hundreds of metres from the
    world origin, so A^T A is nearly of rank one; the reference solves it in
    float32, where the normal's direction is lost to rounding more and more
    as the drive leaves the origin. That was most of MO's error on long
    drives, in the reference on the CPU as in the port."""
    ok = stack_mask & (d[:, cfg.knn - 1] < cfg.neighbor_radius_sq)
    near = near.to(torch.float64)
    AtA = _gram(near)
    Atb = -torch.sum(near, dim=2).T  # [Q, 3] = A^T * (-1)
    # closed-form 3x3 solve via adjugate; det by the 6-term rule of
    # jnp.linalg.det for 3x3 matrices
    a = AtA
    det = (a[:, 0, 0] * a[:, 1, 1] * a[:, 2, 2]
           + a[:, 0, 1] * a[:, 1, 2] * a[:, 2, 0]
           + a[:, 0, 2] * a[:, 1, 0] * a[:, 2, 1]
           - a[:, 0, 2] * a[:, 1, 1] * a[:, 2, 0]
           - a[:, 0, 0] * a[:, 1, 2] * a[:, 2, 1]
           - a[:, 0, 1] * a[:, 1, 0] * a[:, 2, 2])
    adj = torch.stack([so3.cross(AtA[:, 1], AtA[:, 2]),
                       so3.cross(AtA[:, 2], AtA[:, 0]),
                       so3.cross(AtA[:, 0], AtA[:, 1])], dim=-1)
    n = torch.sum(adj * Atb[:, None, :], dim=-1) / torch.where(
        torch.abs(det) > 1e-12, det, torch.inf)[:, None]
    norm = torch.linalg.norm(n, dim=-1)
    nood = 1.0 / torch.clamp(norm, min=_EPS)  # negative_OA_dot_norm (:558)
    n_hat = n / torch.clamp(norm, min=_EPS)[:, None]
    # plane validity: all 5 residuals within tolerance (:563-573)
    resid = torch.abs(torch.sum(near * n_hat.T[:, :, None], dim=0)
                      + nood[:, None])
    plane_ok = torch.all(resid <= cfg.plane_fit_tolerance, dim=-1)
    valid = ok & plane_ok & (torch.abs(det) > 1e-12) & (norm > _EPS)
    return n_hat.to(torch.float32), nood.to(torch.float32), valid


def _retract(x, delta):
    """x [..., 7] = [q, t] moved by the local step delta [..., 6]."""
    q = so3.quat_normalize(so3.quat_multiply(
        x[..., :4], so3.quat_from_axis_angle(delta[..., :3])))
    return torch.cat([q, x[..., 4:] + delta[..., 3:]], dim=-1)


def mo_residual(pw, is_edge, A, Bp, DE, NH, NOOD):
    """The fused mapping residual [..., B, 3] at world points pw
    [..., B, 3]: edge rows point-to-line, plane rows pw . n + 1/|n| in slot
    0 (zeros in slots 1-2)."""
    r_edge = so3.cross(pw - A, pw - Bp) / torch.clamp(DE, min=_EPS)[..., None]
    r_plane = torch.sum(pw * NH, dim=-1, keepdim=True) + NOOD[..., None]
    return torch.where(is_edge, r_edge, F.pad(r_plane, (0, 2)))


def mo_families(cp, is_edge, A, Bp, DE, NH, NOOD, w):
    """make_family(x) for the fused mapping residual over stack points
    cp [..., B, 3] (is_edge [B, 1]), linearized in closed form at x [..., 7].
    With leading stream axes each stream has its own pose and its own terms
    (the closed-form counterpart of the reference's vmapped jacfwd,
    batch_mapping._lm_solve_batched)."""
    # d r / d pw per row: edge -[A - B]x / |A - B|, plane n^T in row 0
    d_res = torch.where(is_edge[..., None],
                        -so3.skew(A - Bp)
                        / torch.clamp(DE, min=_EPS)[..., None, None],
                        F.pad(NH[..., None, :], (0, 0, 0, 2)))

    def make_family(xx):
        q, t = xx[..., None, :4], xx[..., None, 4:]
        rp = so3.quat_rotate(q, cp)
        return ResidualFamily(
            mo_residual(rp + t, is_edge, A, Bp, DE, NH, NOOD),
            so3.matmul(d_res, so3.point_jacobian(q, rp)), w)

    return make_family


def fused_family(cp, is_edge, corner, surf):
    """make_family of ONE fused residual family over a frame's stack points
    cp [Qc + Qs, 3]: the corner rows' line terms corner = (a, b, |a - b|,
    valid) and the surf rows' plane terms surf = (n_hat, 1/|n|, valid),
    plane rows in slot 0, zero-padded."""
    a, b, de, v_c = corner
    n_hat, nood, v_s = surf
    A = torch.cat([a, torch.zeros_like(n_hat)])
    Bp = torch.cat([b, torch.zeros_like(n_hat)])
    DE = torch.cat([de, torch.ones_like(nood)])
    NH = torch.cat([torch.zeros_like(a), n_hat])
    NOOD = torch.cat([torch.zeros_like(de), nood])
    w = torch.cat([v_c, v_s]).to(torch.float32)
    return mo_families(cp, is_edge, A, Bp, DE, NH, NOOD, w)


def solve_mapping(grid_map: GridMap, corner_stack_xyz, corner_stack_mask,
                  surf_stack_xyz, surf_stack_mask, q_pred, t_pred, cfg):
    """One mapping solve + map update. Returns (new_map, q_w, t_w, stats)."""
    n_map_corner = grid_map.corner.n_live
    n_map_surf = grid_map.surf.n_live
    x0 = torch.cat([q_pred, t_pred]).to(torch.float32)
    enough = ((n_map_corner > cfg.min_corner_map_points)
              & (n_map_surf > cfg.min_surf_map_points))
    dev = x0.device

    # The solve always runs and `enough` selects its result: on an empty
    # or sparse map every 5-NN fails its radius gate, all IRLS weights are
    # zero and the damped solve returns delta = 0, so the select is exact.
    # One candidate gather per frame at the prediction pose, reused by both
    # outer rounds (the pose moves well under the cell margin between them).
    x = x0
    pc0 = so3.quat_rotate(x[:4], corner_stack_xyz) + x[4:]
    ps0 = so3.quat_rotate(x[:4], surf_stack_xyz) + x[4:]
    cand_c = grid_gather(grid_map.corner, pc0, cfg.corner_cell)
    cand_s = grid_gather(grid_map.surf, ps0, cfg.surf_cell)
    B_c = corner_stack_xyz.shape[0]
    is_edge = (torch.arange(B_c + surf_stack_xyz.shape[0], device=dev)
               < B_c)[:, None]
    cp = torch.cat([corner_stack_xyz, surf_stack_xyz])
    for _ in range(cfg.outer_rounds):
        corner = _corner_terms(corner_stack_xyz, corner_stack_mask, cand_c,
                               x, cfg)
        surf = _surf_terms(surf_stack_xyz, surf_stack_mask, cand_s, x, cfg)
        x = lm_solve(fused_family(cp, is_edge, corner, surf), _retract, x,
                     iterations=cfg.gn_iterations,
                     huber_delta=cfg.huber_delta)
    x = torch.where(enough, x, x0)
    q_w, t_w = x[:4], x[4:]
    new_map = map_update(grid_map, corner_stack_xyz, corner_stack_mask,
                         surf_stack_xyz, surf_stack_mask, q_w, t_w, cfg)
    stats = {"n_map_corner": n_map_corner, "n_map_surf": n_map_surf,
             "solved": enough}
    return new_map, q_w, t_w, stats


def fixed_point(p: torch.Tensor, res: float, n: int) -> torch.Tensor:
    """Points [N, 3] as the lockstep engine's map stores them: each
    coordinate split into its res-voxel index and a fraction in int32 fixed
    point, the scale chosen so that n such fractions sum below 2^31 (n: the
    streams' stack rows of one insert), then res * index + fraction / scale
    rounded once to float32."""
    q = float(min(1 << 18, max(1, (2 ** 31 - 1)
                               // int(math.ceil(res * n * 1.25)))))
    pt = p.T
    v = _cell_of(pt, res)
    frac_q = torch.round((pt - v.to(torch.float32) * res) * q).to(torch.int32)
    res64 = torch.tensor(res, dtype=torch.float32).double()
    return (v * res64 + frac_q * (1.0 / q)).float().T


def map_update(grid_map: GridMap, corner_stack_xyz, corner_stack_mask,
               surf_stack_xyz, surf_stack_mask, q_w, t_w, cfg,
               streams: int = 0) -> GridMap:
    """Post-solve map maintenance: insert the refined-pose frame points
    (reference :638-686), then recenter (reference :207-402) by evicting
    outside the window extent when the pose crosses a cube boundary.
    streams > 0: the points are stored as a lockstep engine of that many
    streams stores them (fixed_point)."""
    def insert(g, pw, mask, cell, res):
        stored = (None if streams <= 0 else
                  fixed_point(pw, res, streams * pw.shape[0]))
        return grid_insert(g, pw, mask, cell, res, stored)

    pw_c = so3.quat_rotate(q_w, corner_stack_xyz) + t_w
    corner = insert(grid_map.corner, pw_c, corner_stack_mask,
                    cfg.corner_cell, cfg.line_resolution)
    pw_s = so3.quat_rotate(q_w, surf_stack_xyz) + t_w
    surf = insert(grid_map.surf, pw_s, surf_stack_mask, cfg.surf_cell,
                  cfg.plane_resolution)

    center = _cube_coord(t_w, cfg.cube_size)
    changed = torch.any(center != grid_map.center)
    radius = window_half_extent(cfg, t_w.device)
    c_w = center.to(torch.float32) * cfg.cube_size

    # The evict runs every frame and `changed` selects it, so the frame loop
    # never reads `changed` back to the host. What that costs: one extra
    # read + write of both grids per frame (corner + surf rows, 75 MB at
    # the kitti_hdl64 map size) where the reference evicts only when the
    # pose crosses a 50 m cube boundary.
    def select(g: FeatureGrid) -> FeatureGrid:
        e = grid_evict(g, c_w, radius)
        return FeatureGrid(torch.where(changed, e.pts, g.pts),
                           torch.where(changed, e.n_live, g.n_live))

    return GridMap(select(corner), select(surf), center)


