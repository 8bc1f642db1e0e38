"""SO(3) primitives on quaternions (port of vloam_tpu/geometry/so3.py).

Quaternions are stored ``[x, y, z, w]``. All functions broadcast over
leading batch dimensions and work in float32. point_jacobian, right_jacobian
and right_jacobian_inv give the LM's closed-form Jacobians; matrix products
go through ``matmul``, which calls no cuBLAS routine, so TF32 and
reduced-precision matmul settings never apply to them.
"""

from __future__ import annotations

import torch

from ..lidar.voxel import reciprocal_f32

_EPS = 1e-12


def unit_vector(n: int, i: int, device) -> torch.Tensor:
    """e_i in R^n (float32), built on `device` by a compare: no host value
    is copied, so building it never waits for the device."""
    return (torch.arange(n, device=device) == i).to(torch.float32)


def identity_quat(device) -> torch.Tensor:
    return unit_vector(4, 3, device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b with [x,y,z,w] storage."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v by unit quaternion q: v' = v + 2 w (u×v) + 2 u×(u×v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_axis_angle(axis_angle: torch.Tensor) -> torch.Tensor:
    """Exponential map R^3 -> quaternion, Taylor-safe near zero."""
    theta2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    half = 0.5 * theta
    # sin(x/2)/x with series fallback: 0.5 - theta^2/48 for tiny angles.
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 * reciprocal_f32(48.0),
                    torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([axis_angle * k, w], dim=-1)


def axis_angle_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Log map quaternion -> R^3 rotation vector."""
    q = torch.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    u = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    norm_u = torch.linalg.norm(u, dim=-1)
    theta = 2.0 * torch.atan2(norm_u, w)
    small = norm_u < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                        theta / torch.clamp(norm_u, min=_EPS))
    return u * scale[..., None]


def _rodrigues_coeffs(axis_angle: torch.Tensor):
    """sin(t)/t and (1 - cos t)/t^2 of t = |axis_angle| [..., 1], with the
    reference's series below t^2 = 1e-8."""
    theta2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    s = torch.where(small, 1.0 - theta2 * reciprocal_f32(6.0),
                    torch.sin(theta) / theta)
    c1 = torch.where(small, 0.5 - theta2 * reciprocal_f32(24.0),
                     (1.0 - torch.cos(theta)) / theta2)
    return s, c1


def rotate_axis_angle(axis_angle: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of v by a rotation vector (Ceres
    AngleAxisRotatePoint, reference ceres_cost_function.h:30):
    v + s (w x v) + c1 w x (w x v)."""
    s, c1 = _rodrigues_coeffs(axis_angle)
    wxv = cross(axis_angle, v)
    wxwxv = cross(axis_angle, wxv)
    return v + s * wxv + c1 * wxwxv


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """The matrix of rotate_axis_angle: I + s [w]x + c1 [w]x^2, [..., 3] ->
    [..., 3, 3]."""
    s, c1 = _rodrigues_coeffs(axis_angle)
    t2 = torch.sum(axis_angle * axis_angle, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return (eye + s[..., None] * skew(axis_angle)
            + c1[..., None] * _skew_sq(axis_angle, t2))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] with skew(a) @ b == a x b."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(v.shape + (3,))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes (broadcasting), in full float32: a
    broadcast product and a sum, for the 3x3 and 3x6 blocks used here."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def point_jacobian(q: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """d/d(omega, tau) at 0 of R(q ⊗ exp(omega)) p + t + tau, given
    rp = R(q) p [..., B, 3]: [-[rp]x R(q) | I] as [..., B, 3, 6] (the local
    parameterization of the LM retractions). q is [4], or [..., 1, 4] with
    rp's leading axes."""
    eye = torch.eye(3, dtype=rp.dtype, device=rp.device).expand(
        rp.shape[:-1] + (3, 3))
    return torch.cat([-matmul(skew(rp), quat_to_matrix(q)), eye], dim=-1)


def _skew_sq(v: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """[v]x^2 = v v^T - |v|^2 I, given t2 = |v|^2 as [..., 1, 1]."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return v[..., :, None] * v[..., None, :] - t2 * eye


# Below |v| = 0.5 the closed-form coefficients lose digits to cancellation
# in float32, and their Taylor series to the v^4 term are within 1e-6.
_SERIES_T2 = 0.25


def right_jacobian(v: torch.Tensor) -> torch.Tensor:
    """J_r(v) with Exp(v + dv) = Exp(v) Exp(J_r(v) dv):
    I - (1 - cos t)/t^2 [v]x + (t - sin t)/t^3 [v]x^2, t = |v|.
    [..., 3] -> [..., 3, 3]."""
    t2 = torch.sum(v * v, dim=-1)[..., None, None]
    small = t2 < _SERIES_T2
    t = torch.sqrt(torch.where(small, 1.0, t2))
    a = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(t)) / (t * t))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (t - torch.sin(t)) / (t * t * t))
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye - a * skew(v) + b * _skew_sq(v, t2)


def right_jacobian_inv(v: torch.Tensor) -> torch.Tensor:
    """J_r(v)^-1 with Log(Exp(v) Exp(dw)) = v + J_r(v)^-1 dw:
    I + [v]x / 2 + (1/t^2 - (1 + cos t) / (2 t sin t)) [v]x^2, t = |v| < pi.
    [..., 3] -> [..., 3, 3]."""
    t2 = torch.sum(v * v, dim=-1)[..., None, None]
    small = t2 < _SERIES_T2
    t = torch.sqrt(torch.where(small, 1.0, t2))
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                    1.0 / (t * t) - (1.0 + torch.cos(t))
                    / torch.clamp(2.0 * t * torch.sin(t), min=_EPS))
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + 0.5 * skew(v) + c * _skew_sq(v, t2)
