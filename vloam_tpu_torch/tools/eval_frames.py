"""The drives of the JAX package's accuracy evaluations, built by the port,
and what the port's evaluation tools share.

One function per script: the same scene, trajectory, seeds, noise, ingest
and ground-truth frame as that script's generator, so each returns what the
script makes, bit for bit (tests/test_torch_eval.py):

- synthetic_drive: scripts/eval_synthetic.py's build_frames, the 100-frame
  S-curve street drive (points, range images and / or camera images; ground
  truth in cam0's frame);
- long_drive: scripts/eval_long.py's, 500 range images along an S-curve
  with buildings laid beside the road;
- loop_drive: scripts/eval_loop_closure.py's closed 320-frame circle;
- highway_drive: scripts/eval_highway.py's feature-poor highway at 3.2 m a
  frame, points and camera images.

The defaults are the scripts': 64 rings x 1800 azimuth bins and
kitti_hdl64()'s 1242 x 375 camera. Tests pass a small config and fewer
rays. Frames are made in spawned worker processes (the caller may already
hold a CUDA context) and cached in the temporary directory under a key that
folds in every generation parameter (tools/bench.py's _cached); each
drive prints the time it took and the number of workers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import time

import numpy as np
import torch

from ..data import synthetic
from .bench import _Calib, _cached, _pool_map, card_name, host_cpu

LONG_PERIOD = 160  # frames between the long drive's turns
HIGHWAY_SPEED = 3.2  # m a frame (the street drives run 1.2)


def _make(job) -> np.ndarray:
    """One array of a drive, in a worker: job = (synthetic's function name,
    scene, pose, keyword arguments)."""
    name, scene, T, kw = job
    return getattr(synthetic, name)(scene, T, **kw)


def _generate(key: str, jobs: list, workers: int | None, what: str) -> list:
    """The jobs' arrays, from the cache or made by `workers` processes."""
    workers = workers or max(1, min(8, os.cpu_count() or 1))
    made = []

    def gen():
        made.append(True)
        return _pool_map(_make, jobs, workers)

    t0 = time.perf_counter()
    tag = hashlib.sha1(pickle.dumps(jobs)).hexdigest()
    arrs = _cached(f"eval_{key}", (tag,), gen)
    how = (f"made by {workers} worker processes" if made
           else "read from the cache")
    print(f"[eval_frames] {what}: {how} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return arrs


def _scan_jobs(name, scene, poses, n_scans, n_azimuth) -> list:
    return [(name, scene, T, dict(n_scans=n_scans, n_azimuth=n_azimuth,
                                  noise=0.01, seed=k))
            for k, T in enumerate(poses)]


def _image_jobs(scene, poses, calib, w, h) -> list:
    return [("render_camera", scene, T @ calib.imu_T_cam0,
             dict(K=calib.K, width=w, height=h)) for T in poses]


def _cam0_truth(poses, velo_T_cam) -> np.ndarray:
    """[N, 3, 4] ground truth of cam0, relative to its first pose."""
    T0inv = np.linalg.inv(poses[0] @ velo_T_cam)
    return np.stack([(T0inv @ (T @ velo_T_cam))[:3, :] for T in poses])


def _camera_drive(key, scene, poses, cfg, with_cam, with_polar, n_scans,
                  n_azimuth, workers):
    """(calib, frames, gt) of a drive seen by the LiDAR and, with_cam, by
    cam0: frames are dicts of "points" (or "polar") and "image"."""
    w, h = cfg.vo.img_width, cfg.vo.img_height
    calib = _Calib(w, h)
    lidar, fn = (("polar", "simulate_scan_polar") if with_polar
                 else ("points", "simulate_scan"))
    n = len(poses)
    scans = _generate(f"{key}_{lidar}_{n}", _scan_jobs(
        fn, scene, poses, n_scans, n_azimuth), workers,
        f"{key}: {n} {lidar} frames {n_scans}x{n_azimuth}")
    frames = [{lidar: s} for s in scans]
    if with_cam:
        images = _generate(f"{key}_images_{n}", _image_jobs(
            scene, poses, calib, w, h), workers,
            f"{key}: {n} camera images {w}x{h}")
        for f, img in zip(frames, images):
            f["image"] = img
    return calib, frames, _cam0_truth(poses, calib.imu_T_cam0)


def synthetic_world(n_frames: int = 100):
    """(scene, sensor poses [N, 4, 4]) of scripts/eval_synthetic.py's
    drive: urban scene 0 (extent 160, 36 boxes, 48 poles, 24 scattered), an
    S-curve at 1.2 m a frame turning +-0.006 rad a frame."""
    scene = synthetic.urban_scene(0, extent=160.0, n_boxes=36, n_poles=48,
                                  scatter=24)
    k = np.arange(n_frames)
    yaw = np.where(k < n_frames // 4, 0.006,
                   np.where(k < 3 * n_frames // 4, -0.006, 0.006))
    return scene, synthetic.drive_trajectory(n_frames, speed=1.2,
                                             yaw_rate=yaw)


def synthetic_drive(n_frames: int = 100, cfg=None, with_cam: bool = False,
                    with_polar: bool = False, n_scans: int = 64,
                    n_azimuth: int = 1800, workers: int | None = None,
                    first: int | None = None):
    """scripts/eval_synthetic.py's drive (synthetic_world), noise 0.01,
    seed k. Returns (calib, frames, gt): frames hold "points" ([n, 3]
    float32) or, with_polar, "polar" ([n_scans, n_azimuth] uint16), and
    with_cam "image" ([H, W] float32 in [0, 1]); gt [N, 3, 4] is cam0's
    pose relative to its first. first: only the drive's first frames
    (tools/diag_vo.py reads the first pairs of the 100-frame drive)."""
    from ..config import kitti_hdl64

    scene, poses = synthetic_world(n_frames)
    return _camera_drive("synthetic", scene, poses[:first],
                         cfg or kitti_hdl64(), with_cam, with_polar, n_scans,
                         n_azimuth, workers)


def long_scene(poses) -> synthetic.Scene:
    """scripts/eval_long.py's world, built along the trajectory: a building
    either side of the road every 10 frames, a pole every 20 (rng 0). Raises
    if the road enters a building."""
    rng = np.random.default_rng(0)
    centers = np.stack([T[:3, 3] for T in poses])
    heads = np.stack([T[:3, 0] for T in poses])  # +x of the sensor frame
    boxes, poles = [], []
    for i in range(0, len(poses), 10):
        p = centers[i]
        n_vec = np.array([-heads[i][1], heads[i][0], 0.0])  # road normal
        for side in (-1.0, 1.0):
            c = p + side * rng.uniform(11.0, 18.0) * n_vec
            w = rng.uniform(3.0, 7.0)
            d = rng.uniform(3.0, 7.0)
            boxes.append([c[0] - w, c[0] + w, c[1] - d, c[1] + d, -1.73,
                          rng.uniform(4.0, 12.0)])
        if i % 20 == 0:
            pp = p + rng.choice([-1.0, 1.0]) * rng.uniform(5.0, 8.0) * n_vec
            poles.append([pp[0], pp[1], rng.uniform(0.08, 0.2), -1.73,
                          rng.uniform(3.0, 6.0)])
    b = np.asarray(boxes, np.float64)
    inside = ((b[None, :, 0] - 1 < centers[:, None, 0])
              & (centers[:, None, 0] < b[None, :, 1] + 1)
              & (b[None, :, 2] - 1 < centers[:, None, 1])
              & (centers[:, None, 1] < b[None, :, 3] + 1))
    if inside.any():
        raise RuntimeError("the long drive's road enters a building")
    return synthetic.Scene(boxes=b, poles=np.asarray(poles, np.float64))


def long_drive(n_frames: int = 500, n_scans: int = 64, n_azimuth: int = 1800,
               workers: int | None = None):
    """scripts/eval_long.py's drive: 1.2 m a frame, turning 0.004 rad a frame
    one way for 160 frames and then the other, through long_scene. Returns
    (range images [n_scans, n_azimuth] uint16, gt [N, 3, 4] of the sensor)."""
    k = np.arange(n_frames)
    yaw = np.where((k // LONG_PERIOD) % 2 == 0, 0.004, -0.004)
    poses = synthetic.drive_trajectory(n_frames, speed=1.2, yaw_rate=yaw)
    frames = _generate(f"long_polar_{n_frames}", _scan_jobs(
        "simulate_scan_polar", long_scene(poses), poses, n_scans, n_azimuth),
        workers, f"long: {n_frames} polar frames {n_scans}x{n_azimuth}")
    return frames, np.stack([T[:3, :] for T in poses])


def loop_drive(n_frames: int = 320, n_scans: int = 64, n_azimuth: int = 1800,
               workers: int | None = None):
    """scripts/eval_loop_closure.py's drive: urban scene 5 (extent 90, 20
    boxes, 40 poles, 40 scattered) once around a circle of n_frames frames
    at 1.0 m a frame. Returns (points [n, 3] float32 a frame, gt [N, 3, 4]
    of the sensor)."""
    poses = synthetic.drive_trajectory(n_frames, speed=1.0,
                                       yaw_rate=2.0 * np.pi / n_frames)
    scene = synthetic.urban_scene(5, extent=90.0, n_boxes=20, n_poles=40,
                                  scatter=40)
    scans = _generate(f"loop_points_{n_frames}", _scan_jobs(
        "simulate_scan", scene, poses, n_scans, n_azimuth), workers,
        f"loop: {n_frames} point frames {n_scans}x{n_azimuth}")
    return scans, np.stack([T[:3, :] for T in poses])


def highway_drive(n_frames: int = 80, cfg=None, n_scans: int = 64,
                  n_azimuth: int = 1800, workers: int | None = None):
    """scripts/eval_highway.py's drive: highway_scene(0) at 3.2 m a frame,
    turning 0.0015 rad a frame; points and camera images. Returns (calib,
    frames, gt) as synthetic_drive."""
    from ..config import kitti_hdl64

    poses = synthetic.drive_trajectory(n_frames, speed=HIGHWAY_SPEED,
                                       yaw_rate=0.0015)
    return _camera_drive("highway", synthetic.highway_scene(0), poses,
                         cfg or kitti_hdl64(), True, False, n_scans,
                         n_azimuth, workers)


# ------------------------------------------------------- the tools' shell

def tool_parser(prog: str, frames: int, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=doc)
    ap.add_argument("--frames", type=int, default=frames,
                    help=f"frames in the drive (default {frames})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    return ap


def stamp(device) -> dict:
    """Where a run's frames/s were taken: the card's name and power limit
    (nvidia-smi's) or "cpu", and the host CPU."""
    return {"device": card_name(torch.device(device)),
            "host_cpu": host_cpu()}


class Report:
    """Prints one JSON line per run and writes the same lines to `out` (and
    nothing else) when the tool ends."""

    def __init__(self, out: str | None):
        self.out = out
        self.lines: list[str] = []

    def line(self, rec: dict) -> None:
        self.lines.append(json.dumps(rec))
        print(self.lines[-1], flush=True)

    def close(self) -> None:
        if self.out:
            with open(self.out, "w") as f:
                f.write("".join(ln + "\n" for ln in self.lines))
