"""KITTI dataset IO (raw drives and odometry sequences), rosbag-free: the
port's copy of vloam_tpu/data/kitti.py, tested to give identical frames.

Replaces the reference's `rosbag play` + cv_bridge + pcl_conversions feed
(vloam_main_node.cpp:203-209, :125-151) and the offline loaders in
point_cloud_util.cpp (loadTransformations :5-116, loadPointCloud :118-146).

Formats:
- velodyne scans: flat float32 [N, 4] (x, y, z, reflectance) .bin files,
- raw calib: calib_cam_to_cam.txt (R_rect_00, P_rect_00), calib_velo_to_cam
  (R, T -> cam_T_velo), calib_imu_to_velo (R, T -> velo_T_imu),
- odometry calib.txt: P0..P3 + Tr (velo -> cam0 rectified).

The native C++ fast path (runtime/native) is used when available; numpy
otherwise. PIL (load_image_gray) is imported only when an image is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def load_velodyne_bin(path: str | os.PathLike) -> np.ndarray:
    """[N, 3] float32 xyz (reflectance dropped, reference :118-146)."""
    try:
        from ..runtime.native_io import load_bin_native

        return load_bin_native(str(path))
    except Exception:
        data = np.fromfile(path, dtype=np.float32)
        return data.reshape(-1, 4)[:, :3].copy()


def _parse_kv_file(path) -> dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                out[k.strip()] = np.asarray([float(x) for x in v.split()])
            except ValueError:
                pass
    return out


@dataclass
class Calib:
    """Static transform chain as used by the pipeline."""

    P_rect0: np.ndarray  # [3, 4]
    cam_T_velo: np.ndarray  # [4, 4] velo -> cam0 (unrectified)
    rect0_T_cam: np.ndarray  # [4, 4] rectification rotation
    imu_T_velo: np.ndarray  # [4, 4]
    imu_T_cam0: np.ndarray  # [4, 4]

    @property
    def K(self) -> np.ndarray:
        return self.P_rect0[:, :3]

    @property
    def P_velo_to_img(self) -> np.ndarray:
        """[3, 4]: the projection used by projectPointCloud (reference
        point_cloud_util.cpp:151-153)."""
        return self.P_rect0 @ self.rect0_T_cam @ self.cam_T_velo

    @property
    def velo_T_cam0(self) -> np.ndarray:
        """cam0 (rectified) -> velo, i.e. the velo_T_cam0 of vloam_tf."""
        cam0_T_velo = self.rect0_T_cam @ self.cam_T_velo
        R = cam0_T_velo[:3, :3]
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ cam0_T_velo[:3, 3]
        return T


def load_raw_calib(date_dir: str | os.PathLike) -> Calib:
    d = Path(date_dir)
    c2c = _parse_kv_file(d / "calib_cam_to_cam.txt")
    v2c = _parse_kv_file(d / "calib_velo_to_cam.txt")
    cam_T_velo = np.eye(4)
    cam_T_velo[:3, :3] = v2c["R"].reshape(3, 3)
    cam_T_velo[:3, 3] = v2c["T"]
    rect = np.eye(4)
    rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    P = c2c["P_rect_00"].reshape(3, 4)
    imu_T_velo = np.eye(4)
    i2v = d / "calib_imu_to_velo.txt"
    if i2v.exists():
        kv = _parse_kv_file(i2v)
        velo_T_imu = np.eye(4)
        velo_T_imu[:3, :3] = kv["R"].reshape(3, 3)
        velo_T_imu[:3, 3] = kv["T"]
        imu_T_velo = np.linalg.inv(velo_T_imu)
    # imu -> cam0 (rectified): imu_T_velo then velo -> rect0
    cam0_T_velo = rect @ cam_T_velo
    velo_T_cam0 = np.linalg.inv(cam0_T_velo)
    imu_T_cam0 = imu_T_velo @ velo_T_cam0
    return Calib(P_rect0=P, cam_T_velo=cam_T_velo, rect0_T_cam=rect,
                 imu_T_velo=imu_T_velo, imu_T_cam0=imu_T_cam0)


def load_odometry_calib(seq_dir: str | os.PathLike) -> Calib:
    kv = _parse_kv_file(Path(seq_dir) / "calib.txt")
    P = kv["P0"].reshape(3, 4)
    Tr = np.eye(4)
    Tr[:3, :] = kv["Tr"].reshape(3, 4)  # velo -> cam0 rectified
    rect = np.eye(4)  # odometry clouds are given directly in rect frame
    imu_T_velo = np.eye(4)
    velo_T_cam0 = np.linalg.inv(Tr)
    return Calib(P_rect0=P, cam_T_velo=Tr, rect0_T_cam=rect,
                 imu_T_velo=imu_T_velo, imu_T_cam0=imu_T_velo @ velo_T_cam0)


def load_image_gray(path: str | os.PathLike) -> np.ndarray:
    """[H, W] float32 in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32) / 255.0


class KittiOdometrySequence:
    """sequences/<seq>/{velodyne, image_0, calib.txt, times.txt}."""

    def __init__(self, root: str, seq: str, polar_ingest: bool = False,
                 polar_scans: int = 64, polar_az: int = 1800):
        self.polar_ingest = polar_ingest
        self.polar_scans, self.polar_az = polar_scans, polar_az
        self.dir = Path(root) / "sequences" / seq
        self.calib = load_odometry_calib(self.dir)
        self.velo_files = sorted((self.dir / "velodyne").glob("*.bin"))
        img_dir = self.dir / "image_0"
        self.img_files = sorted(img_dir.glob("*.png")) if img_dir.exists() else []

    def __len__(self):
        return len(self.velo_files)

    def frame(self, i: int) -> dict:
        if self.polar_ingest:
            from ..runtime.native_io import project_polar_native

            out = {"polar": project_polar_native(
                str(self.velo_files[i]), self.polar_scans, self.polar_az)}
        else:
            out = {"points": load_velodyne_bin(self.velo_files[i])}
        if i < len(self.img_files):
            out["image"] = load_image_gray(self.img_files[i])
        return out


class KittiRawDrive:
    """<root>/<date>/<date>_drive_<seq>_sync/... (the layout the
    reference's action goal names, vloam_main.action {date, seq})."""

    def __init__(self, root: str, date: str, drive: str,
                 polar_ingest: bool = False, polar_scans: int = 64,
                 polar_az: int = 1800):
        self.polar_ingest = polar_ingest
        self.polar_scans, self.polar_az = polar_scans, polar_az
        base = Path(root) / date
        self.dir = base / f"{date}_drive_{drive}_sync"
        self.calib = load_raw_calib(base)
        self.velo_files = sorted((self.dir / "velodyne_points" / "data").glob("*.bin"))
        img_dir = self.dir / "image_00" / "data"
        self.img_files = sorted(img_dir.glob("*.png")) if img_dir.exists() else []

    def __len__(self):
        return len(self.velo_files)

    def frame(self, i: int) -> dict:
        if self.polar_ingest:
            from ..runtime.native_io import project_polar_native

            out = {"polar": project_polar_native(
                str(self.velo_files[i]), self.polar_scans, self.polar_az)}
        else:
            out = {"points": load_velodyne_bin(self.velo_files[i])}
        if i < len(self.img_files):
            out["image"] = load_image_gray(self.img_files[i])
        return out
