"""Residual factor library, the reference's full cost-functor set (port of
vloam_tpu/solver/factors.py): the active factors live inline where they are
used (lidar/odometry.py, lidar/mapping.py, vision/vo.py); this module has
all of them, including those the reference defines but does not wire into
its active path (CostFunctor33 / CostFunctor23, ceres_cost_function.h:10-52,
98-145; LidarDistanceFactor, lidarFactor.hpp:141-171), as batched tensor
functions.

Conventions: (w, t) = angle-axis + translation for camera factors (the
reference's VO parameter block), (q, t) quaternion + translation for lidar
factors.
"""

from __future__ import annotations

import torch

from ..geometry import so3


def point_3d3d(w, t, X0, X1):
    """CostFunctor33: R(w) X0 + t - X1 -> [B, 3]."""
    return so3.rotate_axis_angle(w.expand(X0.shape), X0) + t - X1


def point_3d2d(w, t, X0, x1_bar):
    """CostFunctor32 (active): [B, 2]."""
    Xp = so3.rotate_axis_angle(w.expand(X0.shape), X0) + t
    return Xp[:, :2] - Xp[:, 2:3] * x1_bar


def point_2d3d(w, t, x0_bar, X1):
    """CostFunctor23: inverse-direction 2D-3D residual: [B, 2]."""
    wi = -w
    RtX1 = so3.rotate_axis_angle(wi.expand(X1.shape), X1)
    Rtt = so3.rotate_axis_angle(wi, t)
    d = RtX1 - Rtt
    return d[:, :2] - d[:, 2:3] * x0_bar


def _bearing(x_bar):
    return torch.cat([x_bar, torch.ones_like(x_bar[:, :1])], dim=1)


def epipolar_2d2d(w, t, x0_bar, x1_bar):
    """CostFunctor22 (active): x1b . (t x R x0b) -> [B, 1]."""
    b0, b1 = _bearing(x0_bar), _bearing(x1_bar)
    Rb0 = so3.rotate_axis_angle(w.expand(b0.shape), b0)
    tx = so3.cross(t, Rb0)
    return torch.sum(b1 * tx, dim=-1, keepdim=True)


def _lidar_point(q, t, p, s):
    """R p + t, or with de-skew fraction s: slerp(I, q, s) p + s t."""
    if s is None:
        return so3.quat_rotate(q, p) + t
    w = so3.axis_angle_from_quat(q)
    return so3.quat_rotate(so3.quat_from_axis_angle(s * w), p) + s * t


def lidar_edge(q, t, p, a, b, s=None):
    """LidarEdgeFactor: ||(p'-a) x (p'-b)|| / ||a-b|| per axis -> [B, 3]."""
    lp = _lidar_point(q, t, p, s)
    nu = so3.cross(lp - a, lp - b)
    de = torch.linalg.norm(a - b, dim=-1, keepdim=True)
    return nu / torch.clamp(de, min=1e-9)


def lidar_plane(q, t, p, pj, pl, pm, s=None):
    """LidarPlaneFactor: (p'-pj) . normalize((pj-pl) x (pj-pm)) -> [B, 1]."""
    n = so3.cross(pj - pl, pj - pm)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    lp = _lidar_point(q, t, p, s)
    return torch.sum((lp - pj) * n, dim=-1, keepdim=True)


def lidar_plane_norm(q, t, p, n_hat, d):
    """LidarPlaneNormFactor: n . (R p + t) + d -> [B, 1]."""
    pw = so3.quat_rotate(q, p) + t
    return (torch.sum(pw * n_hat, dim=-1) + d)[:, None]


def lidar_distance(q, t, p, target):
    """LidarDistanceFactor: R p + t - target -> [B, 3]."""
    return so3.quat_rotate(q, p) + t - target
