"""SE(3) rigid transforms as (quat, t) pairs of tensors (port of
vloam_tpu/geometry/se3.py; reference vloam_tf.cpp's tf2::Transform
algebra)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import so3


class Pose(NamedTuple):
    """Rigid transform: x_parent = R(q) @ x_child + t. Batch dims allowed."""

    q: torch.Tensor  # [..., 4]  (x, y, z, w)
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(device="cpu", dtype=torch.float32, batch=()) -> "Pose":
        q = so3.identity_quat(device).to(dtype).expand(tuple(batch) + (4,))
        t = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
        return Pose(q, t)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other (apply other first)."""
        return Pose(
            so3.quat_normalize(so3.quat_multiply(self.q, other.q)),
            so3.quat_rotate(self.q, other.t) + self.t,
        )

    def inverse(self) -> "Pose":
        qinv = so3.quat_conjugate(self.q)
        return Pose(qinv, -so3.quat_rotate(qinv, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        q = self.q[..., None, :] if pts.dim() > self.q.dim() else self.q
        t = self.t[..., None, :] if pts.dim() > self.t.dim() else self.t
        return so3.quat_rotate(q, pts) + t

    def matrix34(self) -> torch.Tensor:
        """[..., 3, 4] = [R | t]."""
        return torch.cat([so3.quat_to_matrix(self.q), self.t[..., :, None]],
                         dim=-1)

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous matrix."""
        top = self.matrix34()
        bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
            top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def from_matrix(m) -> "Pose":
        m = torch.as_tensor(m)
        return Pose(so3.quat_from_matrix(m[..., :3, :3]), m[..., :3, 3])

    @staticmethod
    def from_axis_angle(axis_angle, t) -> "Pose":
        return Pose(so3.quat_from_axis_angle(torch.as_tensor(axis_angle)),
                    torch.as_tensor(t))

    def as_float64(self) -> "Pose":
        """The pose as host-side float64 numpy arrays (the accumulators'
        form, as the reference's)."""
        return Pose(self.q.detach().cpu().numpy().astype(np.float64),
                    self.t.detach().cpu().numpy().astype(np.float64))


def pose_from_np_matrix(m: np.ndarray) -> Pose:
    """Host-side (numpy, float64) construction for accumulators."""
    R = torch.from_numpy(np.asarray(m, np.float64)[:3, :3].copy())
    return Pose(so3.quat_from_matrix(R).numpy(),
                np.asarray(m[:3, 3], np.float64))
