"""Depth-enhanced visual odometry (port of vloam_tpu/vision/vo.py::solve_vo;
reference visual_odometry.cpp solveNlsAll() :254-450 and the cost functors
of ceres_cost_function.h):

- CostFunctor32 (:54-96): 3D-2D residual (R X0 + t)_xy - (R X0 + t)_z x1bar
  for matches whose previous-frame pixel has LiDAR depth,
- CostFunctor22 (:147-185): epipolar residual x1bar . (t x R x0bar) for
  the rest, riding in slot 0 of the same 2-wide residual block,
- Huber, angle-axis + translation parameters with the retraction x + d,
  linearized in closed form (vo_family) and solved by solver.lm.lm_solve.

The reference truncates keypoint coordinates to int before the depth
lookup and the residuals (:283-307); the engines keep the subpixel
coordinates in the residuals (cfg.subpixel; the depth lookup truncates
either way).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import so3
from ..solver.lm import ResidualFamily, lm_solve
from .depth_map import DepthGrid, fma_matvec, query_depth


def vo_residual(x: torch.Tensor, X0, x1_bar, b0, b1, sel32):
    """The fused VO residual [M, 2] at x = (angle-axis w, t): 3D-2D rows
    (sel32) r = Xp_xy - Xp_z x1bar with Xp = R(w) X0 + t; epipolar rows
    b1 . (t x R(w) b0) in slot 0 and 0 in slot 1. Also returns R(w) X0 and
    R(w) b0 for the Jacobian."""
    w, t = x[:3], x[3:]
    RX0 = so3.rotate_axis_angle(w.expand_as(X0), X0)
    Xp = RX0 + t
    r32 = Xp[:, :2] - Xp[:, 2:3] * x1_bar
    Rb0 = so3.rotate_axis_angle(w.expand_as(b0), b0)
    r22 = torch.sum(b1 * so3.cross(t, Rb0), dim=-1)
    return torch.where(sel32, r32, F.pad(r22[:, None], (0, 1))), RX0, Rb0


def vo_family(x: torch.Tensor, X0, x1_bar, b0, b1, sel32, w_rows):
    """The VO residual family at x and its Jacobian [M, 2, 6] in closed form
    with respect to the additive step (dw, dt).

    R(w + dw) ~ R(w) Exp(J_r(w) dw), so d(R(w) p)/dw = -R [p]x J_r =
    -[R p]x R J_r (so3.right_jacobian). 3D-2D rows: d Xp = [-[R X0]x R J_r |
    I], then r = D Xp with D = [[1, 0, -x1], [0, 1, -y1]]. Epipolar row:
    d/dt = R b0 x b1, d/dw = -((b1 x t) x R b0)^T R J_r."""
    r, RX0, Rb0 = vo_residual(x, X0, x1_bar, b0, b1, sel32)
    w, t = x[:3], x[3:]
    RJ = so3.matmul(so3.axis_angle_to_matrix(w), so3.right_jacobian(w))
    M = X0.shape[0]
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(M, 3, 3)
    dXp = torch.cat([-so3.matmul(so3.skew(RX0), RJ), eye], dim=-1)  # [M,3,6]
    J32 = dXp[:, :2] - x1_bar[:, :, None] * dXp[:, 2:3]
    c = so3.cross(so3.cross(b1, t), Rb0)  # [M, 3]
    dw = -torch.sum(c[:, :, None] * RJ, dim=1)
    J22 = F.pad(torch.cat([dw, so3.cross(Rb0, b1)], dim=-1)[:, None],
                (0, 0, 0, 1))
    J = torch.where(sel32[:, :, None], J32, J22)
    return ResidualFamily(r, J, w_rows)


def solve_vo(prev_uv: torch.Tensor, curr_uv: torch.Tensor,
             valid: torch.Tensor, grid0: DepthGrid, Kinv: torch.Tensor,
             angles0: torch.Tensor, t0: torch.Tensor, cfg):
    """Frame-to-frame VO from matches prev_uv [M, 2] -> curr_uv [M, 2]
    (valid [M]) and the previous frame's depth grid. Kinv [3, 3] is the
    inverse intrinsics (computed once on the host: an inverse on the device
    checks for singularity and so waits for it). Returns (angles, t, n32,
    n22): cam0_curr_T_cam0_last as angle-axis + translation (maps frame-0
    points into frame 1) and the 3D-2D / epipolar match counts, all on the
    device."""
    p_int = torch.trunc(prev_uv)
    p_uv, c_uv = prev_uv, curr_uv

    if cfg.remove_VO_outlier > 0:
        disp = torch.sum((p_uv - c_uv) ** 2, dim=-1)
        valid = valid & (disp <= cfg.remove_VO_outlier ** 2)

    depth0 = query_depth(grid0, p_int, cfg)

    ones = torch.ones_like(p_uv[:, :1])
    bear0 = fma_matvec(torch.cat([p_uv, ones], dim=1), Kinv)
    bear1 = fma_matvec(torch.cat([c_uv, ones], dim=1), Kinv)
    x0_bar = bear0[:, :2] / bear0[:, 2:3]
    x1_bar = bear1[:, :2] / bear1[:, 2:3]
    X0 = bear0 * depth0[:, None] / bear0[:, 2:3]  # 3D point at depth0

    has_depth = depth0 > 0
    m32 = valid & has_depth
    m22 = valid & ~has_depth
    w_rows = (m32 | m22).to(torch.float32)
    sel32 = m32[:, None]
    b0 = torch.cat([x0_bar, ones], dim=1)
    b1 = torch.cat([x1_bar, ones], dim=1)

    x = lm_solve(
        lambda xx: vo_family(xx, X0, x1_bar, b0, b1, sel32, w_rows),
        lambda xx, d: xx + d,
        torch.cat([angles0, t0]).to(torch.float32),
        iterations=cfg.max_iterations, huber_delta=cfg.huber_delta)
    return (x[:3], x[3:], torch.sum(m32.to(torch.int32)),
            torch.sum(m22.to(torch.int32)))
