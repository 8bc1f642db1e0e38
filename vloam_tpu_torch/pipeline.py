"""Sequence runner of the fused engines (port of the fused half of
vloam_tpu/pipeline.py): frames in, the three KITTI-format trajectories out.

run_sequence_fused drives a sequence through LoamEngine (LiDAR-only) or
VloamEngine (combined camera + LiDAR): chunks of frames queued on the
device, one download at the end; optional map publication to .npz files,
and checkpoint / resume of the whole device state (runtime/checkpoint.py).
The per-stage host engine (the reference's VloamPipeline / run_sequence,
--engine host) is not ported.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .fusion.frame_chain import FrameChain, write_kitti_pose_line


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
    loses its map on any restart). mesh: not ported (raises)."""
    if mesh is not None:
        raise NotImplementedError(
            "run_sequence_fused(mesh=...) is not ported (ROADMAP queue 1, "
            "distributed)")
    t0 = time.perf_counter()
    n_frames = 0
    map_cb = None
    if save_map is not None:
        Path(save_map).mkdir(parents=True, exist_ok=True)

        def map_cb(frame_idx, corner, surf):
            np.savez(Path(save_map) / f"map_{frame_idx:06d}.npz",
                     corner=corner, surf=surf)
    if lidar_only:
        from .lidar.loam_step import LoamEngine, unpack_outputs

        eng = LoamEngine(cfg, chunk=chunk, map_callback=map_cb, device=device)
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
                          device=device)
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

    if out_dir is not None and cfg.save_traj:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        suffix = str(int(cfg.detach_VO_LO))
        for which in ("VO", "LO", "MO"):
            if which not in result:
                continue
            with open(Path(out_dir) / f"{which}{suffix}.txt", "w") as f:
                for T34 in result[which]:
                    write_kitti_pose_line(f, T34)
    return result
