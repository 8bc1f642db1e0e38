"""Loop-closure backend: scan re-matching + pose-graph optimization (port of
vloam_tpu/backend/loop_closure.py).

Spatially close, non-consecutive frames are registered against each other
with the odometry's own feature extraction and point-to-line / point-to-plane
solver (register_scan, solve_lo: kernels K1 and ring_min1_packed on the
card),
the accepted relative poses become loop edges, and the whole trajectory is
re-optimized by the pose-graph solver (parallel/pose_graph.py).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..lidar.loam_step import engine_device
from ..lidar.odometry import solve_lo
from ..lidar.scan_registration import register_scan
from ..parallel.pose_graph import (PoseGraph, optimize_pose_graph,
                                   shard_graph)
from ..parallel.sharded import mesh_device


def find_loop_candidates(
    positions: np.ndarray,  # [N, 3]
    radius: float = 10.0,
    min_gap: int = 50,
    max_candidates: int = 10,
) -> list[tuple[int, int]]:
    """Pairs (i, j), j < i - min_gap, whose positions are within radius.
    Greedy spread: at most one candidate per `min_gap` window of i."""
    n = len(positions)
    cands = []
    last_i = -(10**9)
    for i in range(n):
        if i - last_i < min_gap:
            continue
        js = np.where(
            (np.arange(n) < i - min_gap)
            & (np.linalg.norm(positions - positions[i], axis=1) < radius)
        )[0]
        if len(js):
            j = int(js[np.argmin(np.linalg.norm(positions[js] - positions[i],
                                                axis=1))])
            cands.append((i, j))
            last_i = i
            if len(cands) >= max_candidates:
                break
    return cands


def match_pair(
    scan_i: np.ndarray, n_i: int, scan_j: np.ndarray, n_j: int,
    T_init: np.ndarray, cfg, device="cuda",
):
    """Relative pose T_j^-1 T_i refined by feature scan matching: solves for
    the transform mapping frame-i points into frame j (the solve_lo
    convention), seeded with the odometry estimate. Returns (q, t, n_corr)
    on the host (one read back per pair)."""
    dev = engine_device(device)
    feats_i = register_scan(torch.tensor(scan_i, device=dev), int(n_i),
                            cfg.lidar, cfg.scanreg)
    feats_j = register_scan(torch.tensor(scan_j, device=dev), int(n_j),
                            cfg.lidar, cfg.scanreg)
    q0 = R.from_matrix(T_init[:3, :3]).as_quat()
    t0 = T_init[:3, 3]
    q, t, n_c, n_s = solve_lo(
        feats_i.sharp, feats_i.flat, feats_j.less_sharp_slab,
        feats_j.less_flat_slab,
        torch.tensor(q0, dtype=torch.float32, device=dev),
        torch.tensor(t0, dtype=torch.float32, device=dev), cfg.lo)
    return (q.cpu().numpy().astype(np.float64),
            t.cpu().numpy().astype(np.float64), int(n_c) + int(n_s))


def close_loops(
    traj_q: np.ndarray,  # [N, 4] world orientations (e.g. MO)
    traj_t: np.ndarray,  # [N, 3] world positions
    get_scan,  # callable k -> (scan_padded [M,3], n_points)
    cfg,
    radius: float = 10.0,
    min_gap: int = 50,
    max_candidates: int = 10,
    min_correspondences: int = 100,
    loop_weight: float = 3.0,
    mesh=None,
    device="cuda",
) -> dict:
    """Optimize the trajectory with detected loop closures. Returns
    {"poses": [N,7], "loops": [(i, j), ...]}. The scan matching and the
    pose graph run on `device` (the card by default). mesh: a
    parallel.sharded.Mesh whose every rank calls with the same trajectory:
    each matches the loop candidates, and the pose graph is solved with
    its edges sharded over the ranks (on each rank's mesh.device)."""
    dev = engine_device(device) if mesh is None else mesh_device(mesh, device)
    n = len(traj_t)
    poses = np.concatenate([traj_q, traj_t], axis=1)

    # odometry edges from the input trajectory
    edges_i, edges_j, meas, weights = [], [], [], []
    for k in range(n - 1):
        qi = R.from_quat(poses[k, :4])
        qj = R.from_quat(poses[k + 1, :4])
        edges_i.append(k)
        edges_j.append(k + 1)
        meas.append(np.concatenate([
            (qi.inv() * qj).as_quat(),
            qi.inv().apply(poses[k + 1, 4:] - poses[k, 4:]),
        ]))
        weights.append(1.0)

    loops = []
    for i, j in find_loop_candidates(traj_t, radius, min_gap, max_candidates):
        Ti = np.eye(4)
        Ti[:3, :3] = R.from_quat(poses[i, :4]).as_matrix()
        Ti[:3, 3] = poses[i, 4:]
        Tj = np.eye(4)
        Tj[:3, :3] = R.from_quat(poses[j, :4]).as_matrix()
        Tj[:3, 3] = poses[j, 4:]
        T_init = np.linalg.inv(Tj) @ Ti  # maps i-frame points into j
        scan_i, n_i = get_scan(i)
        scan_j, n_j = get_scan(j)
        q, t, n_corr = match_pair(scan_i, n_i, scan_j, n_j, T_init, cfg, dev)
        if n_corr < min_correspondences:
            continue
        # edge j -> i measurement: T_j^-1 T_i
        edges_i.append(j)
        edges_j.append(i)
        meas.append(np.concatenate([q, t]))
        weights.append(loop_weight)
        loops.append((i, j))

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    graph = PoseGraph(
        poses=f32(poses),
        edge_i=torch.tensor(edges_i, dtype=torch.int64, device=dev),
        edge_j=torch.tensor(edges_j, dtype=torch.int64, device=dev),
        meas=f32(np.stack(meas)), weight=f32(weights))
    if mesh is not None:
        graph = shard_graph(graph, mesh)
    cg = max(64, 3 * n)
    opt = optimize_pose_graph(graph, mesh=mesh, gn_iters=6, cg_iters=cg)
    return {"poses": opt.cpu().numpy(), "loops": loops}
