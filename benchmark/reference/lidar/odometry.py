"""Frame-to-frame laser odometry (port of vloam_tpu/lidar/odometry.py;
reference laser_odometry.cpp solveLO() :187-536): two outer rounds of
{correspondence search, 4 LM iterations} over point-to-line and
point-to-plane residuals with Huber(0.1) loss and a quaternion-local
parameterization.

Correspondences come from ring_assoc.ring_slab_assoc (the reference's
default per-ring packed minimum, plain torch). The (q, t) parameters
transform a current-frame point into the last frame: lp = R(q) p + t
(TransformToStart, :149-167).
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from ..geometry import so3
from ..solver.lm import ResidualFamily, lm_solve
from .ring_assoc import RingSlab, ring_slab_assoc
from .types import FeatureCloud

_EPS = 1e-9


def _pack(q, t):
    return torch.cat([q, t])


def _unpack(x):
    return x[:4], x[4:]


def _retract(x, delta):
    q, t = _unpack(x)
    qn = so3.quat_normalize(
        so3.quat_multiply(q, so3.quat_from_axis_angle(delta[:3])))
    return _pack(qn, t + delta[3:])


def _deskew_fraction(cloud: FeatureCloud, cfg):
    """Interpolation fraction s per point (reference TransformToStart,
    laser_odometry.cpp:149-158): rel_time/scan_period when DISTORTION,
    else None (s == 1)."""
    if cfg.distortion:
        return torch.clamp(cloud.rel_time, 0.0, 1.0)[:, None]
    return None


def _transform_to_start(q, t, pts, s):
    """Apply slerp(I, q, s), s*t per point (lidarFactor.hpp:29-32);
    s=None means s==1 (DISTORTION=false fast path)."""
    if s is None:
        return so3.quat_rotate(q, pts) + t
    w = so3.axis_angle_from_quat(q)
    q_s = so3.quat_from_axis_angle(s * w)
    return so3.quat_rotate(q_s, pts) + s * t


def transform_to_start_jac(q, t, pts, s):
    """_transform_to_start(q, t, pts, s) as lp [B, 3], and its Jacobian
    [B, 3, 6] in the LM's local perturbation (q ⊗ exp(omega), t + tau) at 0.

    With deskew, lp = R(exp(s phi')) p + s (t + tau), phi' = log(q exp(omega));
    d phi' / d omega = J_r(phi)^-1 and d/d phi' of R(exp(s phi')) p is
    -s R_s [p]x J_r(s phi) = -s [R_s p]x R_s J_r(s phi), so
    d lp / d omega = -s [rp]x R_s J_r(s phi) J_r(phi)^-1, d lp / d tau = s I.
    """
    if s is None:
        rp = so3.quat_rotate(q, pts)
        return rp + t, so3.point_jacobian(q, rp)
    phi = so3.axis_angle_from_quat(q)
    q_s = so3.quat_from_axis_angle(s * phi)
    rp = so3.quat_rotate(q_s, pts)
    m = so3.matmul(so3.quat_to_matrix(q_s),
                   so3.matmul(so3.right_jacobian(s * phi),
                              so3.right_jacobian_inv(phi)))
    j_rot = -s[:, :, None] * so3.matmul(so3.skew(rp), m)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    return rp + s * t, torch.cat([j_rot, s[:, :, None] * eye], dim=-1)


def associate_corners(sharp: FeatureCloud, corner_last: RingSlab, x, cfg):
    """Edge correspondences: nearest last-frame corner + nearest corner on a
    different nearby ring (reference :266-350)."""
    q, t = _unpack(x)
    p_hat = _transform_to_start(q, t, sharp.xyz, _deskew_fraction(sharp, cfg))
    res = ring_slab_assoc(p_hat, corner_last, cfg.nearby_scan, mode="corner")
    thr = cfg.distance_sq_threshold
    valid = sharp.mask & (res["d0"] < thr) & (res["d2"] < thr)
    a = res["p0"]
    b = res["p2"]
    de = torch.linalg.norm(a - b, dim=-1)
    valid = valid & (de > 1e-6)
    return a, b, de, valid


def associate_surfs(flat: FeatureCloud, surf_last: RingSlab, x, cfg):
    """Plane correspondences: nearest j + same-ring l + other-ring m
    (reference :353-444)."""
    q, t = _unpack(x)
    p_hat = _transform_to_start(q, t, flat.xyz, _deskew_fraction(flat, cfg))
    res = ring_slab_assoc(p_hat, surf_last, cfg.nearby_scan, mode="surf")
    thr = cfg.distance_sq_threshold
    valid = (flat.mask & (res["d0"] < thr) & (res["d2"] < thr)
             & (res["d3"] < thr))
    pj = res["p0"]
    pl = res["p3"]  # same ring
    pm = res["p2"]  # neighboring ring
    n = so3.cross(pj - pl, pj - pm)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    valid = valid & (nn[:, 0] > 1e-6)
    n_hat = n / torch.clamp(nn, min=_EPS)
    return pj, n_hat, valid


def lo_residual(lp, is_edge, A, Bp, DE, PJ, NH):
    """The fused LO residual [B, 3] at transformed points lp [B, 3]: edge
    rows (is_edge) point-to-line (lp - A) x (lp - B) / |A - B|, plane rows
    (lp - PJ) . n in slot 0 and zeros in slots 1-2 (identical Huber block
    norms)."""
    r_edge = so3.cross(lp - A, lp - Bp) / torch.clamp(DE, min=_EPS)[:, None]
    r_plane = torch.sum((lp - PJ) * NH, dim=-1, keepdim=True)
    return torch.where(is_edge, r_edge, F.pad(r_plane, (0, 2)))


def lo_families(cp, is_edge, A, Bp, DE, PJ, NH, w, s):
    """make_family(x) for the fused LO residual over points cp [B, 3], in
    closed form: the residual at x and d r / d lp times d lp / d delta."""
    # d r / d lp per row: edge -[A - B]x / |A - B|, plane n^T in row 0
    d_res = torch.where(is_edge[:, :, None],
                        -so3.skew(A - Bp)
                        / torch.clamp(DE, min=_EPS)[:, None, None],
                        F.pad(NH[:, None, :], (0, 0, 0, 2)))

    def make_family(xx):
        lp, j_lp = transform_to_start_jac(xx[:4], xx[4:], cp, s)
        return ResidualFamily(lo_residual(lp, is_edge, A, Bp, DE, PJ, NH),
                              so3.matmul(d_res, j_lp), w)

    return make_family


def solve_lo(sharp: FeatureCloud, flat: FeatureCloud, corner_last: RingSlab,
             surf_last: RingSlab, q_init: torch.Tensor, t_init: torch.Tensor,
             cfg):
    """Two rounds x 4 LM iterations; returns (q_last_curr, t_last_curr,
    n_corner_corr, n_plane_corr) as device tensors (no host reads)."""
    x = _pack(q_init, t_init)
    n_c = n_s = None
    B_c = sharp.xyz.shape[0]
    dev = sharp.xyz.device
    is_edge = (torch.arange(B_c + flat.xyz.shape[0], device=dev)
               < B_c)[:, None]
    cp = torch.cat([sharp.xyz, flat.xyz])
    for _ in range(cfg.outer_rounds):
        a, b, de, v_c = associate_corners(sharp, corner_last, x, cfg)
        pj, n_hat, v_s = associate_surfs(flat, surf_last, x, cfg)
        n_c = torch.sum(v_c.to(torch.int32))
        n_s = torch.sum(v_s.to(torch.int32))
        if cfg.distortion:
            s = torch.cat([_deskew_fraction(sharp, cfg),
                           _deskew_fraction(flat, cfg)])
        else:
            s = None
        # ONE fused residual family [B_c + B_s, 3]: plane residuals ride in
        # slot 0 with zero-padded slots 1-2 (identical Huber block norms).
        A = torch.cat([a, torch.zeros_like(pj)])
        Bp = torch.cat([b, torch.zeros_like(pj)])
        DE = torch.cat([de, torch.ones_like(pj[:, 0])])
        PJ = torch.cat([torch.zeros_like(a), pj])
        NH = torch.cat([torch.zeros_like(a), n_hat])
        w = torch.cat([v_c, v_s]).to(torch.float32)
        x = lm_solve(lo_families(cp, is_edge, A, Bp, DE, PJ, NH, w, s),
                     _retract, x, iterations=cfg.gn_iterations,
                     huber_delta=cfg.huber_delta)
    q, t = _unpack(x)
    return q, t, n_c, n_s
