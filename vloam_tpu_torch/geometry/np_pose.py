"""Host-side (numpy, float64) pose recomposition for unpack_outputs and
unpack_vloam_outputs.

A numpy-only copy of vloam_tpu/geometry/np_pose.py: vloam_tpu.geometry
cannot be imported without jax. The cumulative compositions are
Hillis-Steele doubling prefix scans (SE(3) composition is associative), so
a long sequence costs O(log n) vectorized passes instead of a per-frame
Python loop. Quaternions are xyzw.
"""

from __future__ import annotations

import numpy as np


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, batched, xyzw layout."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors [..., 3] by quaternions [..., 4] (xyzw), batched."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def cumulative_se3(q_f2f: np.ndarray, t_f2f: np.ndarray):
    """Inclusive prefix composition of per-frame (q, t) increments.

    world_k = world_{k-1} * D_k with D_k = (q_f2f[k], t_f2f[k]) and
    composition (q1,t1)*(q2,t2) = (q1 q2, t1 + R(q1) t2). Returns
    (q_w [n,4], t_w [n,3]) in float64, quaternions normalized.
    """
    q = np.asarray(q_f2f, np.float64).copy()
    t = np.asarray(t_f2f, np.float64).copy()
    # normalize: inputs are f32-rounded; quat_rotate assumes unit quats
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    n = len(q)
    step = 1
    while step < n:
        ql = q[:-step].copy()
        tl = t[:-step].copy()
        t[step:] = tl + quat_rotate(ql, t[step:])
        q[step:] = quat_mul(ql, q[step:])
        q[step:] /= np.linalg.norm(q[step:], axis=-1, keepdims=True)
        step *= 2
    return q, t


def mat_cumprod(Ms: np.ndarray) -> np.ndarray:
    """Inclusive prefix product of a stack of 4x4 matrices [n, 4, 4]
    (P_k = M_0 @ M_1 @ ... @ M_k), same doubling scheme."""
    P = np.asarray(Ms, np.float64).copy()
    n = len(P)
    step = 1
    while step < n:
        left = P[:-step].copy()
        P[step:] = left @ P[step:]
        step *= 2
    return P


def quats_to_mats(q: np.ndarray) -> np.ndarray:
    """[n, 4] xyzw -> [n, 3, 3] rotation matrices, vectorized."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n2 = x * x + y * y + z * z + w * w
    s = 2.0 / np.maximum(n2, 1e-300)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    M = np.empty(q.shape[:-1] + (3, 3), np.float64)
    M[..., 0, 0] = 1.0 - (yy + zz)
    M[..., 0, 1] = xy - wz
    M[..., 0, 2] = xz + wy
    M[..., 1, 0] = xy + wz
    M[..., 1, 1] = 1.0 - (xx + zz)
    M[..., 1, 2] = yz - wx
    M[..., 2, 0] = xz - wy
    M[..., 2, 1] = yz + wx
    M[..., 2, 2] = 1.0 - (xx + yy)
    return M


def qt_to_T(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """[n, 4], [n, 3] -> [n, 4, 4] homogeneous transforms, vectorized."""
    n = len(q)
    T = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    T[:, :3, :3] = quats_to_mats(np.asarray(q, np.float64))
    T[:, :3, 3] = np.asarray(t, np.float64)
    return T


def inv_T(T: np.ndarray) -> np.ndarray:
    """Batched rigid-transform inverse [..., 4, 4]."""
    Ti = np.broadcast_to(np.eye(4), T.shape).copy()
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return Ti
