"""Sequence runners of the port (port of vloam_tpu/pipeline.py): frames in,
the three KITTI-format trajectories out.

- VloamPipeline / run_sequence: the per-stage host engine (--engine host,
  the reference's per-frame callback, vloam_main_node.cpp:125-180):

    [S1] VO.processImage        (detect / describe or LK flow)
    [S2] static transforms      (FrameChain from calib, once)
    [S3] VO.processPointCloud   (depth grid)
    [S4] VO.solveNlsAll         (seeded from the last LO f2f unless reset)
    [S5] LOAM scanRegistration / laserOdometry / laserMapping
    [S6] trajectories           (KITTI cam0-start-frame format)

  Each stage runs on the device and reads its result back to the host
  (float64 pose chain, scipy rotations), so each stage's t_*_ms is a host
  clock: a stage that reads nothing back (scan registration) is timed at
  enqueue, its device time lands in the next stage that reads. Combined
  mode (detach_VO_LO false) seeds LO from VO; detached runs them apart;
  lidar-only skips VO. Optional debug PNGs (vision/viz.py).
- run_sequence_fused: the fused engines LoamEngine (LiDAR-only) and
  VloamEngine (combined): chunks of frames queued on the device, one
  download at the end; optional map publication to .npz files, and
  checkpoint / resume of the whole device state (runtime/checkpoint.py).

Either runner takes a mesh (parallel/sharded.py): every rank of it runs the
same sequence, and the mapping stage runs as distributed BA over the ranks
(MeshLaserMapping in the host engine, the mesh mapping chunk in the fused
engines). Rank 0 alone writes trajectories and maps.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from .data.synthetic import pad_scan
from .fusion.frame_chain import FrameChain, write_kitti_pose_line
from .lidar.loam_step import engine_device
from .lidar.mapping import LaserMapping
from .lidar.odometry import LaserOdometry
from .lidar.scan_registration import register_scan
from .parallel.sharded import mesh_device
from .runtime.profiling import TicToc, Watchdog
from .vision.vo import VisualOdometry


class VloamPipeline:
    """The per-stage host engine: one synchronized frame at a time through
    VisualOdometry, scan registration, LaserOdometry and LaserMapping on
    `device` (the card by default; "cpu" runs the kernels' plain versions),
    the pose chain on the host.

    calib: data.kitti.Calib (or a namespace with K, P_velo_to_img,
    imu_T_velo, imu_T_cam0). viz_dir: dump match (or flow) and depth debug
    PNGs every viz_every frames (frames 1, 1 + viz_every, ...; the
    reference's visualize_* image topics, visual_odometry.cpp:489-522).
    mesh: a parallel.sharded.Mesh: the mapping stage is then
    MeshLaserMapping, its solve distributed over the ranks, and every stage
    runs on the rank's mesh.device."""

    def __init__(self, cfg, calib, viz_dir: str | None = None,
                 viz_every: int = 10, mesh=None, device="cuda"):
        self.cfg = cfg
        self.calib = calib
        self.viz_dir = viz_dir
        self.viz_every = viz_every
        self.device = (engine_device(device) if mesh is None
                       else mesh_device(mesh, device))
        self.chain = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                                np.asarray(calib.imu_T_cam0, np.float64))
        self.vo = VisualOdometry(cfg.vo, calib.K, calib.P_velo_to_img,
                                 device=self.device)
        self.lo = LaserOdometry(cfg.lo, device=self.device)
        if mesh is None:
            self.mo = LaserMapping(cfg.mapping, device=self.device)
        else:
            from .parallel.mesh_pipeline import MeshLaserMapping

            self.mo = MeshLaserMapping(cfg.mapping, mesh, device=self.device)
        self.count = -1
        self.watchdog = Watchdog(budget_ms=100.0,
                                 verbose=cfg.verbose_level > 0)

    def step(self, points: np.ndarray, image: np.ndarray | None = None) -> dict:
        """Process one synchronized frame. points: [N, 3] velodyne xyz;
        image: [H, W] float32 in [0, 1], or None (LiDAR only)."""
        self.count += 1
        cfg = self.cfg
        t_frame = TicToc()
        out: dict = {"frame": self.count}

        padded, n = pad_scan(points, cfg.lidar.max_points)
        pts_dev = torch.from_numpy(padded).to(self.device)

        # ---- visual odometry (S1, S3, S4) ----
        if image is not None:
            t = TicToc()
            self.vo.reset()
            self.vo.process_image(image)
            out["t_image_ms"] = t.toc_ms()
            t = TicToc()
            self.vo.process_point_cloud(
                pts_dev, torch.arange(len(padded), device=self.device) < n)
            out["t_depth_ms"] = t.toc_ms()
            t = TicToc()
            if self.count > 0:
                if cfg.vo.reset_VO_to_identity:
                    angles, tr = self.vo.solve()
                else:
                    angles, tr = self.vo.solve(*self.chain.vo_prior())
                cam_T = np.eye(4)
                cam_T[:3, :3] = Rotation.from_rotvec(angles).as_matrix()
                cam_T[:3, 3] = tr
                self.chain.vo_update(cam_T)
                if (self.viz_dir is not None
                        and (self.count - 1) % self.viz_every == 0):
                    self._render_debug_images()
            out["t_vo_solve_ms"] = t.toc_ms()

        # ---- scan registration (S5a) ----
        t = TicToc()
        feats = register_scan(pts_dev, n, cfg.lidar, cfg.scanreg)
        out["t_scanreg_ms"] = t.toc_ms()

        # ---- laser odometry (S5b) ----
        t = TicToc()
        prior_q = prior_t = None
        if image is not None and not cfg.detach_VO_LO and self.count > 0:
            prior_q, prior_t = self.chain.lo_prior()
        lo_out = self.lo.step(feats, prior_q, prior_t)
        self.chain.lo_update(lo_out["q_f2f"], lo_out["t_f2f"],
                             lo_out["q_w"], lo_out["t_w"])
        out["t_lo_ms"] = t.toc_ms()

        # ---- mapping (S5c) ----
        t = TicToc()
        mo_out = self.mo.step(feats.less_sharp, feats.less_flat,
                              lo_out["q_w"], lo_out["t_w"],
                              skip_frame=lo_out["skip_frame"])
        self.chain.mo_update(mo_out["q_w"], mo_out["t_w"])
        out["t_mo_ms"] = t.toc_ms()

        out["t_frame_ms"] = t_frame.toc_ms()
        self.watchdog.check(out["t_frame_ms"])
        out.update(
            vo_pose=self.chain.world_VOT_base_last.copy(),
            lo_pose=self.chain.world_LOT_base_last.copy(),
            mo_pose=self.chain.world_MOT_base_last.copy(),
        )
        return out

    def _render_debug_images(self):
        from .vision.viz import render_depth, render_flow, render_matches

        Path(self.viz_dir).mkdir(parents=True, exist_ok=True)
        cur = self.vo.images[self.vo.i].cpu().numpy()
        prev_uv, curr_uv, valid = self.vo.last_matches
        if self.cfg.vo.optical_flow_match:
            # flow arrows on the current frame (reference
            # visualize_optical_flow, visual_odometry.cpp:489-522)
            render_flow(cur, prev_uv, curr_uv, valid,
                        path=f"{self.viz_dir}/flow_{self.count:06d}.png")
        else:
            pairs = [(k, k) for k in np.flatnonzero(valid)]
            render_matches(self.vo.images[1 - self.vo.i].cpu().numpy(), cur,
                           prev_uv, curr_uv, pairs,
                           path=f"{self.viz_dir}/matches_{self.count:06d}.png")
        render_depth(cur, self.vo.grids[self.vo.i], self.cfg.vo,
                     path=f"{self.viz_dir}/depth_{self.count:06d}.png")

    def export_poses(self, which: str) -> np.ndarray:
        return self.chain.to_cam0_start(which, self.count)


def run_sequence(cfg, calib, frames, out_dir: str | None = None,
                 save_traj: bool | None = None, progress=None,
                 viz_dir: str | None = None, mesh=None,
                 device="cuda") -> dict:
    """Drive a sequence through the host engine (the execute() / rosbag-play
    equivalent, vloam_main_node.cpp:182-222). `frames` yields dicts with
    'points' and optional 'image'. Writes {VO,LO,MO}{suffix}.txt under
    out_dir as the frames go (suffix: int(detach_VO_LO)); progress(k, info)
    after each frame. Returns the trajectories [N, 3, 4] and the per-frame
    stage timings (t_*_ms). mesh: see VloamPipeline; rank 0 alone writes
    the files."""
    pipe = VloamPipeline(cfg, calib, viz_dir=viz_dir, mesh=mesh,
                         device=device)
    save = cfg.save_traj if save_traj is None else save_traj
    if mesh is not None and mesh.rank != 0:
        out_dir = None
    files = {}
    if out_dir is not None and save:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        suffix = str(int(cfg.detach_VO_LO))  # reference suffix convention
        for which in ("VO", "LO", "MO"):
            files[which] = open(Path(out_dir) / f"{which}{suffix}.txt", "w")
    trajs = {"VO": [], "LO": [], "MO": []}
    stats = []
    try:
        for k, frame in enumerate(frames):
            info = pipe.step(frame["points"], frame.get("image"))
            stats.append({k2: v for k2, v in info.items()
                          if k2.startswith("t_")})
            for which in ("VO", "LO", "MO"):
                T34 = pipe.export_poses(which)
                trajs[which].append(np.asarray(T34))
                if which in files:
                    write_kitti_pose_line(files[which], T34)
            if progress is not None:
                progress(k, info)
    finally:
        for f in files.values():
            f.close()
    out = {k: np.stack(v) for k, v in trajs.items() if v}
    out["timings"] = stats
    return out


def run_sequence_fused(cfg, calib, frames, out_dir: str | None = None,
                       chunk: int = 8, lidar_only: bool = False,
                       verbose: int = 0, save_map: str | None = None,
                       init_state: str | None = None,
                       save_state_path: str | None = None,
                       mesh=None, device="cuda") -> dict:
    """Drive a sequence through the fused device-resident engines (chunks of
    frames queued on `device`, one download per sequence). Returns the
    exported trajectories (+ fps). save_map: directory receiving the
    accumulated map every cfg.mapping.map_pub_number frames as
    map_<frame>.npz (reference /laser_cloud_map publisher,
    laser_mapping.cpp:778-793). init_state / save_state_path: restore /
    persist the full device state (map, feature slabs, pose chain) via
    runtime.checkpoint; a resumed run continues the SAME map (the reference
    loses its map on any restart). mesh: a parallel.sharded.Mesh; the
    engines' mapping stage runs over its ranks (result["mesh_window"]: the
    peak active map rows against the window's), rank 0 alone writes files,
    and a checkpoint path with it raises, as the reference's (the map is
    sharded)."""
    if mesh is not None and (init_state or save_state_path):
        raise NotImplementedError(
            "checkpointing the mesh-sharded map is not wired up (as in the "
            "reference); run the mesh without --init-state / --save-state")
    writer = mesh is None or mesh.rank == 0
    t0 = time.perf_counter()
    n_frames = 0
    map_cb = None
    if save_map is not None:
        if writer:
            Path(save_map).mkdir(parents=True, exist_ok=True)

        def map_cb(frame_idx, corner, surf):
            # every rank gathers the sharded map (a collective), rank 0 saves
            if writer:
                np.savez(Path(save_map) / f"map_{frame_idx:06d}.npz",
                         corner=corner, surf=surf)
    if lidar_only:
        from .lidar.loam_step import LoamEngine, unpack_outputs

        eng = LoamEngine(cfg, chunk=chunk, map_callback=map_cb, device=device,
                         mesh=mesh)
        if init_state is not None:
            from .runtime.checkpoint import load_state

            eng.state = load_state(init_state, eng.state)
        for frame in frames:
            if "polar" in frame:  # quantized range image (smallest upload)
                eng.push_polar(frame["polar"])
            else:
                eng.push(frame["points"])
            n_frames += 1
        raw = unpack_outputs(eng.finish(),
                             min_correspondences=cfg.lo.min_correspondences)
        if save_state_path is not None:
            from .runtime.checkpoint import save_state

            save_state(save_state_path, eng.state)
        # export through the frame chain algebra (vloam_tf.cpp:77-153),
        # vectorized over the frames
        from .geometry.np_pose import inv_T, qt_to_T

        chain = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                           np.asarray(calib.imu_T_cam0, np.float64))
        B = chain.base_T_cam0
        Binv = np.linalg.inv(B)
        result = {}
        for which, (q_w, t_w) in (("LO", (raw["q_w_lo"], raw["t_w_lo"])),
                                  ("MO", (raw["q_w_mo"], raw["t_w_mo"]))):
            W = qt_to_T(q_w, t_w)
            X = np.einsum("ij,njk,kl->nil", Binv, W, B)
            start_inv = inv_T(X[0]) if n_frames > 0 else np.eye(4)
            result[which] = np.einsum("ij,njk->nik", start_inv, X)[:, :3, :]
        result["raw"] = raw
    else:
        from .vloam_step import VloamEngine, unpack_vloam_outputs

        eng = VloamEngine(cfg, calib, chunk=chunk, map_callback=map_cb,
                          device=device, mesh=mesh)
        if init_state is not None:
            from .runtime.checkpoint import load_state

            eng.vstate, eng.lstate = load_state(
                init_state, (eng.vstate, eng.lstate))
            # as the reference: the publish cadence counts the resumed
            # state's frame as its first (VO / LO initialization follows the
            # state's own frame_idx)
            eng._frame = 1
        for frame in frames:
            if "polar" in frame:  # quantized range image (smallest upload)
                eng.push_polar(frame["polar"], frame["image"])
            else:
                eng.push(frame["points"], frame["image"])
            n_frames += 1
        raw = unpack_vloam_outputs(
            eng.finish(), calib,
            min_correspondences=cfg.lo.min_correspondences)
        if save_state_path is not None:
            from .runtime.checkpoint import save_state

            save_state(save_state_path, (eng.vstate, eng.lstate))
        result = {w: raw[f"traj_{w}"] for w in ("VO", "LO", "MO")}
        result["raw"] = raw
    dt = time.perf_counter() - t0
    result["fps"] = n_frames / max(dt, 1e-9)
    if mesh is not None:
        active, cap = eng.window_active_rows
        result["mesh_window"] = {"active_rows_max": active, "cap": cap}
        if verbose:
            print(f"mesh mapping: peak active map rows {active} / window "
                  f"cap {cap}", flush=True)

    if out_dir is not None and cfg.save_traj and writer:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        suffix = str(int(cfg.detach_VO_LO))
        for which in ("VO", "LO", "MO"):
            if which not in result:
                continue
            with open(Path(out_dir) / f"{which}{suffix}.txt", "w") as f:
                for T34 in result[which]:
                    write_kitti_pose_line(f, T34)
    return result
