"""KITTI odometry evaluation metrics (the port's copy of
vloam_tpu/eval/kitti_metrics.py, tested equal to it).

Reimplements the KITTI devkit / KITTI_odometry_evaluation_tool metrics the
reference reports (README.md:27-31, BASELINE.md): translational RMSE (%) and
rotational error (deg/m) averaged over all subsequences of length
100..800 m, plus ATE RMSE.

Poses are [N, 3, 4] or [N, 4, 4] cam0-start-frame matrices (the format the
pipeline exports, vloam_tf.cpp:93-99).
"""

from __future__ import annotations

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _to44(poses: np.ndarray) -> np.ndarray:
    poses = np.asarray(poses, np.float64)
    if poses.shape[1:] == (3, 4):
        out = np.tile(np.eye(4), (len(poses), 1, 1))
        out[:, :3, :] = poses
        return out
    return poses


def load_kitti_poses(path) -> np.ndarray:
    data = np.loadtxt(path).reshape(-1, 3, 4)
    return _to44(data)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _last_frame_from_len(dist, first, length):
    target = dist[first] + length
    idx = np.searchsorted(dist, target)
    return idx if idx < len(dist) else -1


def kitti_seq_errors(gt: np.ndarray, pred: np.ndarray, step: int = 10):
    """Per-subsequence (t_err [fraction], r_err [rad/m]) pairs, KITTI-style."""
    gt = _to44(gt)
    pred = _to44(pred)
    n = min(len(gt), len(pred))
    gt, pred = gt[:n], pred[:n]
    dist = trajectory_distances(gt)
    errors = []
    for first in range(0, n, step):
        for length in LENGTHS:
            last = _last_frame_from_len(dist, first, length)
            if last < 0:
                continue
            dgt = np.linalg.inv(gt[first]) @ gt[last]
            dpred = np.linalg.inv(pred[first]) @ pred[last]
            err = np.linalg.inv(dpred) @ dgt
            t_err = np.linalg.norm(err[:3, 3]) / length
            c = (np.trace(err[:3, :3]) - 1.0) * 0.5
            r_err = np.arccos(np.clip(c, -1.0, 1.0)) / length
            errors.append((t_err, r_err))
    return errors


def kitti_metrics(gt: np.ndarray, pred: np.ndarray, step: int = 10) -> dict:
    """Returns translational % and rotational deg/m (KITTI table format,
    cf. BASELINE.md) plus ATE RMSE in meters."""
    errors = kitti_seq_errors(gt, pred, step)
    out = {}
    if errors:
        e = np.asarray(errors)
        out["t_rel_percent"] = float(np.mean(e[:, 0]) * 100.0)
        out["r_deg_per_m"] = float(np.degrees(np.mean(e[:, 1])))
    else:
        out["t_rel_percent"] = float("nan")
        out["r_deg_per_m"] = float("nan")
    gt44, pred44 = _to44(gt), _to44(pred)
    n = min(len(gt44), len(pred44))
    ate = np.linalg.norm(gt44[:n, :3, 3] - pred44[:n, :3, 3], axis=1)
    out["ate_rmse_m"] = float(np.sqrt(np.mean(ate**2)))
    out["ate_max_m"] = float(np.max(ate)) if n else float("nan")
    return out
