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
lookup and the residuals (:283-307); cfg.subpixel keeps the subpixel
coordinates in the residuals (the depth lookup truncates either way).

VisualOdometry is the host engine's VO stage around solve_vo: features or
LK flow per image, the depth grid per scan, one solve a frame read back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import so3
from ..solver.lm import ResidualFamily, lm_solve
from . import features
from .depth_map import DepthGrid, build_depth_grid, fma_matvec, query_depth
from .optical_flow import lk_flow


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
    p_uv = prev_uv if cfg.subpixel else p_int
    c_uv = curr_uv if cfg.subpixel else torch.trunc(curr_uv)

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


class VisualOdometry:
    """Host-side VO stage with the reference's 2-slot ring buffer
    (visual_odometry.h:86-90) for the host engine: detect / describe / match
    (or LK flow), depth grid and solve on `device`, the pose and the match
    counts read back (VisualOdometry::{processImage, processPointCloud,
    solveNlsAll}). K [3, 3] is inverted once, here, on the host. device: the
    card by default; "cpu" runs the kernels' plain versions."""

    def __init__(self, cfg, K, P_velo_to_img, device="cuda"):
        from ..lidar.loam_step import engine_device

        self.cfg = cfg
        self.device = engine_device(device)

        def dev(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=self.device)

        self.Kinv = dev(np.linalg.inv(np.asarray(K, np.float32)))
        self.P_velo_to_img = dev(P_velo_to_img)
        self.count = -1
        self.i = 0
        self.kp = [None, None]
        self.desc = [None, None]
        self.kp_mask = [None, None]
        self.grids = [None, None]
        self.images = [None, None]
        self.angles = np.zeros(3)
        self.t = np.zeros(3)
        self.stats = {}

    def reset(self):
        self.count += 1
        self.i = self.count % 2

    def process_image(self, img):
        """img: [H, W] float32 in [0, 1] (reference processImage :92-130)."""
        i = self.i
        im = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        if self.cfg.clahe:
            im = features.clahe(im)
        self.images[i] = im
        xy, score, mask = features.detect_keypoints(im, self.cfg)
        if self.cfg.keypoint_nms:
            mask = features.bucket_nms(
                xy, score, mask, self.cfg.img_width, self.cfg.img_height,
                self.cfg.nms_bucket, self.cfg.nms_bucket,
                self.cfg.nms_max_total)
        self.kp[i] = xy
        self.kp_mask[i] = mask
        if not self.cfg.optical_flow_match:
            self.desc[i] = features.describe_keypoints(im, xy, self.cfg)

    def process_point_cloud(self, pts_velo, mask):
        """Build the frame's depth grid from velodyne points [N, 3] and
        their mask [N] (host arrays or tensors on the device; reference
        processPointCloud :157-186)."""
        self.grids[self.i] = build_depth_grid(
            torch.as_tensor(pts_velo, dtype=torch.float32,
                            device=self.device),
            torch.as_tensor(mask, device=self.device), self.P_velo_to_img,
            self.cfg)

    def solve(self, prior_angles=None, prior_t=None):
        """Frame-to-frame solve (reference solveNlsAll :254-450). Returns
        (angles, t) of cam0_curr_T_cam0_last, float64 on the host."""
        i, j = self.i, 1 - self.i
        if self.count < 1:
            return self.angles, self.t
        if self.cfg.optical_flow_match:
            curr_uv, status = lk_flow(self.images[j], self.images[i],
                                      self.kp[j], self.cfg)
            valid = self.kp_mask[j] & status
        else:
            idx1, valid = features.match_descriptors(
                self.desc[j], self.kp_mask[j], self.desc[i], self.kp_mask[i],
                self.cfg.match_ratio, matcher=self.cfg.matcher,
                select=self.cfg.match_select)
            curr_uv = self.kp[i][idx1]
        prev_uv = self.kp[j]
        if self.cfg.reset_VO_to_identity or prior_angles is None:
            a0 = torch.zeros(3, device=self.device)
            t0 = torch.zeros(3, device=self.device)
        else:
            a0 = torch.tensor(np.asarray(prior_angles), dtype=torch.float32,
                              device=self.device)
            t0 = torch.tensor(np.asarray(prior_t), dtype=torch.float32,
                              device=self.device)
        angles, t, n32, n22 = solve_vo(prev_uv, curr_uv, valid,
                                       self.grids[j], self.Kinv, a0, t0,
                                       self.cfg)
        self.angles = angles.cpu().numpy().astype(np.float64)
        self.t = t.cpu().numpy().astype(np.float64)
        self.stats = {"n32": int(n32), "n22": int(n22)}
        # kept for the debug-image renderers (reference visualize_* flags)
        self.last_matches = (prev_uv.cpu().numpy(), curr_uv.cpu().numpy(),
                             valid.cpu().numpy())
        return self.angles, self.t
