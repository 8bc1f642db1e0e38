"""The host engine's mapping stage as distributed BA over a Mesh (port of
vloam_tpu/parallel/mesh_pipeline.py).

MeshLaserMapping is lidar.mapping.LaserMapping with its pose refinement run
by sharded_mapping.sharded_map_alignment on every rank of the mesh:

- the frame's voxel-downsampled corner / surf stacks are sharded over the
  ranks (shard_batch: each rank owns 1/D of the scan points);
- the map candidates are the grid map's slots viewed flat
  (gridmap.grid_flat_points), sharded as map blocks; the global 5-NN comes
  from ring hops of those blocks;
- the normal equations and the LM costs are all-reduced, so every rank
  applies the same update;
- the map's maintenance (insert, boundary evict: mapping.map_update) runs
  whole on every rank, as on one device, so each rank keeps the same map
  and it stays in step with a single-device run.

Equivalence to mapping.solve_mapping: the single-device 8-cell probe is
exact within the 1 m gate (gridmap.py) and its candidates are a subset of
the flat map, so both searches accept the same residuals; the LM rule is
the same, so trajectories agree to float accumulation order
(tests/test_torch_mesh.py). The host engine reads the refined pose back
every frame, and so does this stage (the map counts too).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..lidar.gridmap import grid_flat_points
from ..lidar.mapping import GridMap, LaserMapping, map_update
from .sharded import Mesh, mesh_device, shard_batch
from .sharded_mapping import sharded_map_alignment


def mesh_solve_mapping(mesh: Mesh, grid_map: GridMap, corner_stack_xyz,
                       corner_stack_mask, surf_stack_xyz, surf_stack_mask,
                       q_pred, t_pred, cfg):
    """One mapping solve + map update with the pose refinement distributed
    over `mesh`; the contract of mapping.solve_mapping: returns (new_map,
    q_w, t_w, stats). The 'enough map' gate is read on the host."""
    n_map_corner = int(grid_map.corner.n_live)
    n_map_surf = int(grid_map.surf.n_live)
    x0 = torch.cat([q_pred, t_pred]).to(torch.float32)
    enough = (n_map_corner > cfg.min_corner_map_points
              and n_map_surf > cfg.min_surf_map_points)
    x = x0
    if enough:
        mc, mc_m = grid_flat_points(grid_map.corner)
        ms, ms_m = grid_flat_points(grid_map.surf)
        x = sharded_map_alignment(
            mesh, *(shard_batch(a, mesh) for a in (
                corner_stack_xyz, corner_stack_mask, surf_stack_xyz,
                surf_stack_mask, mc, mc_m, ms, ms_m)), x0, cfg)
    q_w, t_w = x[:4], x[4:]
    new_map = map_update(grid_map, corner_stack_xyz, corner_stack_mask,
                         surf_stack_xyz, surf_stack_mask, q_w, t_w, cfg)
    stats = {"n_map_corner": n_map_corner, "n_map_surf": n_map_surf,
             "solved": enough}
    return new_map, q_w, t_w, stats


class MeshLaserMapping(LaserMapping):
    """LaserMapping (same step() contract, the same float64 odom -> map
    bookkeeping) whose per-frame solve is distributed over `mesh`. The
    engine runs on the rank's mesh.device (of the type `device` names)."""

    def __init__(self, cfg, mesh: Mesh, device="cuda"):
        super().__init__(cfg, device=mesh_device(mesh, device))
        self.mesh = mesh

    def _solve(self, *args):
        return mesh_solve_mapping(self.mesh, *args)


def run_mesh_drive(cfg, frames, mesh: Mesh, device="cuda") -> dict:
    """Drive a LiDAR sequence with the mapping stage distributed over
    `mesh`: scan registration and LO whole on each rank, MO by
    MeshLaserMapping. `frames` yields [N, 3] point arrays. Returns
    {'q_w_lo', 't_w_lo', 'q_w_mo', 't_w_mo'} numpy arrays [F, 4] / [F, 3]."""
    from ..data.synthetic import pad_scan
    from ..lidar.odometry import LaserOdometry
    from ..lidar.scan_registration import register_scan

    lo = LaserOdometry(cfg.lo, device=mesh_device(mesh, device))
    mo = MeshLaserMapping(cfg.mapping, mesh, device)
    out = {"q_w_lo": [], "t_w_lo": [], "q_w_mo": [], "t_w_mo": []}
    for pts in frames:
        padded, n = pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(torch.from_numpy(padded).to(mo.device), n,
                              cfg.lidar, cfg.scanreg)
        lo_out = lo.step(feats)
        mo_out = mo.step(feats.less_sharp, feats.less_flat, lo_out["q_w"],
                         lo_out["t_w"], skip_frame=lo_out["skip_frame"])
        out["q_w_lo"].append(np.asarray(lo_out["q_w"]))
        out["t_w_lo"].append(np.asarray(lo_out["t_w"]))
        out["q_w_mo"].append(np.asarray(mo_out["q_w"]))
        out["t_w_mo"].append(np.asarray(mo_out["t_w"]))
    return {k: np.stack(v) for k, v in out.items()}
