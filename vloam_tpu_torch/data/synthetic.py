"""Synthetic KITTI-like street scene, HDL-64 raycaster and pinhole camera
renderer (host-side numpy).

The urban and highway scenes, LiDAR and camera parts of
vloam_tpu/data/synthetic.py, with
the same arithmetic, so the same seeds give bit-identical scans and images
(tests/test_torch_loam_engine.py, tests/test_torch_vision.py and
tests/test_torch_eval.py hold the two equal). A scan casts its rays only
against what lies within the sensor's range (_within_range), which returns
the same points. The port keeps its own copy so that it, and
chip_smoke.py, import nothing of the JAX package.

The scene is a ground plane, building boxes (planes -> surf features) and
poles (vertical cylinders -> edge features) with exact ground-truth motion.
Velodyne frame: x forward, y left, z up. Camera frame: z forward, x right,
y down (KITTI cam0).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Scene:
    ground_z: float = -1.73
    # axis-aligned boxes: (xmin, xmax, ymin, ymax, zmin, zmax)
    boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 6)))
    # vertical cylinders: (cx, cy, radius, zmin, zmax)
    poles: np.ndarray = field(default_factory=lambda: np.zeros((0, 5)))
    max_range: float = 80.0
    # image texture contrast multiplier (1.0 = urban default)
    tex_scale: float = 1.0


def urban_scene(seed: int = 0, extent: float = 60.0, n_boxes: int = 14,
                n_poles: int = 24, scatter: int = 0) -> Scene:
    """Street corridor along +x; `scatter` extra buildings placed at random
    over [-extent, extent]^2 off the street."""
    rng = np.random.default_rng(seed)
    boxes = []
    for i in range(n_boxes):  # two rows of buildings flanking the street
        side = 1 if i % 2 == 0 else -1
        x0 = -extent + (2 * extent) * (i // 2) / max(1, n_boxes // 2)
        w = rng.uniform(6, 14)
        d = rng.uniform(4, 8)
        y0 = side * rng.uniform(8, 14)
        h = rng.uniform(4, 12)
        boxes.append([x0, x0 + w, min(y0, y0 + side * d),
                      max(y0, y0 + side * d), -1.73, h])
    for _ in range(scatter):
        x0 = rng.uniform(-extent, extent)
        y0 = rng.uniform(-extent, extent)
        if abs(y0) < 16.0:  # keep the street corridor drivable
            continue
        w = rng.uniform(6, 14)
        d = rng.uniform(6, 14)
        boxes.append([x0, x0 + w, y0, y0 + d, -1.73, rng.uniform(4, 12)])
    poles = []
    for _ in range(n_poles):
        px = rng.uniform(-extent, extent)
        py = rng.uniform(-7.0, 7.0) + np.sign(rng.standard_normal()) * 6.0
        poles.append([px, py, rng.uniform(0.08, 0.2), -1.73,
                      rng.uniform(3, 6)])
    return Scene(boxes=np.asarray(boxes, np.float64),
                 poles=np.asarray(poles, np.float64))


def highway_scene(seed: int = 0, extent: float = 260.0,
                  tex_scale: float = 0.06) -> Scene:
    """Feature-poor highway corridor, the KITTI seq-01 stress regime (the
    reason for the reference's detach_VO_LO flag): near-featureless images
    (tex_scale 0.06), flat ground, guardrail posts every ~8 m on both
    shoulders and a few distant structures. Meant to be driven fast (speed
    >= 3 m a frame)."""
    rng = np.random.default_rng(seed)
    boxes = []
    # a few distant buildings / sound barriers, far off the road
    for i in range(6):
        x0 = -extent + (2 * extent) * i / 6 + rng.uniform(0, 30)
        side = 1 if i % 2 == 0 else -1
        y0 = side * rng.uniform(35, 60)
        boxes.append([x0, x0 + rng.uniform(15, 40),
                      min(y0, y0 + side * 6.0), max(y0, y0 + side * 6.0),
                      -1.73, rng.uniform(3, 6)])
    poles = []
    # guardrail posts every ~8 m on both shoulders (thin, low)
    for x in np.arange(-extent, extent, 8.0):
        for side in (-1.0, 1.0):
            poles.append([x + rng.uniform(-0.3, 0.3), side * 7.5,
                          0.06, -1.73, -0.9])
    return Scene(boxes=np.asarray(boxes, np.float64),
                 poles=np.asarray(poles, np.float64),
                 tex_scale=tex_scale)


def hdl64_elevations(n_scans: int = 64) -> np.ndarray:
    """Per-ring elevation angles (deg) inside the reference's ring-id bins
    (scan_registration.cpp:213-226)."""
    if n_scans == 64:
        # offsets keep every beam strictly inside its ring bin and inside
        # the [-24.33, 2] elevation gate
        upper = 2.0 - (np.arange(32) + 0.2) / 3.0
        lower = -8.83 - (np.arange(32)) / 2.0 - 0.2
        return np.concatenate([upper, lower])
    if n_scans == 16:
        return -15.0 + 2.0 * np.arange(16)
    if n_scans == 32:
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0 + 0.2
    raise ValueError(n_scans)


def _ray_scene_range(origins: np.ndarray, dirs: np.ndarray, scene: Scene,
                     with_ids: bool = False):
    """Min positive hit distance per ray (inf when no hit). origins [N, 3],
    dirs [N, 3] unit. With with_ids, also the hit object's id (0 = ground,
    1.. = boxes, then poles)."""
    tmin = np.full(dirs.shape[0], np.inf)
    ids = np.zeros(dirs.shape[0], np.int32)

    def update(hit, t, oid):
        nonlocal tmin, ids
        better = hit & (t < tmin)
        tmin = np.where(better, t, tmin)
        ids = np.where(better, oid, ids)

    # ground plane z = ground_z
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (scene.ground_z - origins[:, 2]) / dz
    update((np.abs(dz) > 1e-9) & (t > 0.1), t, 0)

    # boxes by the slab method
    for k, b in enumerate(scene.boxes):
        lo = b[[0, 2, 4]]
        hi = b[[1, 3, 5]]
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo[None, :] - origins) / dirs
            t2 = (hi[None, :] - origins) / dirs
        tnear = np.nanmax(np.minimum(t1, t2), axis=1)
        tfar = np.nanmin(np.maximum(t1, t2), axis=1)
        update((tnear <= tfar) & (tfar > 0) & (tnear > 0.1), tnear, 1 + k)

    # vertical cylinders
    for k, p in enumerate(scene.poles):
        cx, cy, r, zmin, zmax = p
        ox = origins[:, 0] - cx
        oy = origins[:, 1] - cy
        dx, dy = dirs[:, 0], dirs[:, 1]
        a = dx * dx + dy * dy
        bq = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - r * r
        disc = bq * bq - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-bq - sq) / (2 * a)
        z = origins[:, 2] + t * dirs[:, 2]
        update((disc > 0) & (a > 1e-12) & (t > 0.1) & (z >= zmin)
               & (z <= zmax), t, 1 + len(scene.boxes) + k)
    if with_ids:
        return tmin, ids
    return tmin


def _sensor_rays(n_scans: int, n_azimuth: int) -> np.ndarray:
    """Unit ray directions [n_scans * n_azimuth, 3], ring-major, azimuth
    clockwise from +x like a Velodyne."""
    elev = np.radians(hdl64_elevations(n_scans))
    az = -np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    return np.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (n_scans, n_azimuth))],
                    axis=-1).reshape(-1, 3)


def _within_range(scene: Scene, origin: np.ndarray) -> Scene:
    """The scene without the boxes and poles that lie more than max_range +
    1 m from `origin`. A ray from there meets them no nearer, and a scan
    keeps only returns inside max_range, so its returns are those of the
    whole scene, bit for bit, at a fraction of the ray tests on a wide
    world (the long drive's buildings line 600 m of road)."""
    reach = scene.max_range + 1.0
    b = scene.boxes
    gap = np.maximum(np.maximum(b[:, [0, 2, 4]] - origin,
                                origin - b[:, [1, 3, 5]]), 0.0)
    p = scene.poles
    return dataclasses.replace(
        scene, boxes=b[np.sqrt((gap * gap).sum(axis=1)) <= reach],
        poles=p[np.hypot(p[:, 0] - origin[0], p[:, 1] - origin[1]) - p[:, 2]
                <= reach])


def simulate_scan(scene: Scene, T_world_sensor: np.ndarray, n_scans: int = 64,
                  n_azimuth: int = 1800, noise: float = 0.01,
                  seed: int = 0) -> np.ndarray:
    """Raycast one scan from the sensor pose [4, 4] (sensor -> world);
    returns [n_valid, 3] float32 sensor-frame points, azimuth-major within
    each ring (Velodyne firing order)."""
    rng = np.random.default_rng(seed)
    d = _sensor_rays(n_scans, n_azimuth)
    R = T_world_sensor[:3, :3]
    t = T_world_sensor[:3, 3]
    dw = d @ R.T
    rngs = _ray_scene_range(np.broadcast_to(t, dw.shape), dw,
                            _within_range(scene, t))
    hit = np.isfinite(rngs) & (rngs < scene.max_range)
    rngs = np.where(hit, rngs, 0.0)
    if noise > 0:
        rngs = rngs + np.where(hit, rng.normal(0, noise, rngs.shape), 0.0)
    return (d * rngs[:, None])[hit].astype(np.float32)


def simulate_scan_polar(scene: Scene, T_world_sensor: np.ndarray,
                        n_scans: int = 64, n_azimuth: int = 1800,
                        noise: float = 0.01, seed: int = 0,
                        range_scale: float = 0.005) -> np.ndarray:
    """The same raycast as a quantized range image [n_scans, n_azimuth]
    uint16 in `range_scale`-metre units (0 = no return); the engine
    rebuilds xyz on the device from the static ray directions."""
    rng = np.random.default_rng(seed)
    d = _sensor_rays(n_scans, n_azimuth)
    R = T_world_sensor[:3, :3]
    t = T_world_sensor[:3, 3]
    rngs = _ray_scene_range(np.broadcast_to(t, d.shape), d @ R.T,
                            _within_range(scene, t))
    hit = np.isfinite(rngs) & (rngs < scene.max_range)
    if noise > 0:
        rngs = rngs + np.where(hit, rng.normal(0, noise, rngs.shape), 0.0)
    q = np.where(hit, np.clip(np.round(rngs / range_scale), 1, 65535), 0)
    return q.reshape(n_scans, n_azimuth).astype(np.uint16)


def pad_scan(pts: np.ndarray, cap: int) -> tuple[np.ndarray, int]:
    """Zero-pad (or truncate) points [n, 3] to [cap, 3]; returns the count
    kept."""
    n = min(len(pts), cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:n]
    return out, n


def _ray_scene_hit(origins: np.ndarray, dirs: np.ndarray, scene: Scene):
    """Hit distance and a textured intensity per ray (camera rendering).
    Texture phases depend on the hit object, and world-anchored cell noise
    (faded with distance) gives surfaces aperiodic detail, so that patches
    are distinctive enough for ratio-test matching."""
    t, oid = _ray_scene_range(origins, dirs, scene, with_ids=True)
    hit = np.isfinite(t)
    tt = np.where(hit, t, 0.0)
    p = origins + dirs * tt[:, None]
    ph1 = 2.39996 * oid  # decorrelate per object
    ph2 = 1.17 * oid
    cell = np.floor(p * 12.0).astype(np.int64)  # ~8 cm cells
    hsh = np.sin(cell[:, 0] * 12.9898 + cell[:, 1] * 78.233
                 + cell[:, 2] * 37.719 + ph1)
    noise = ((hsh * 43758.5453) % 1.0) * np.clip(1.0 - tt / 45.0, 0.0, 1.0)
    ts = scene.tex_scale
    tex = (
        0.52
        + ts * 0.16 * np.sin(2.1 * p[:, 0] + ph1) * np.cos(1.7 * p[:, 1] - ph2)
        + ts * 0.12 * np.sin(5.3 * p[:, 2] + 1.3 * p[:, 0] + 0.7 * ph2)
        + ts * 0.10 * np.sin(9.1 * p[:, 1] + 3.1 * p[:, 2] + ph1)
        + ts * 0.06 * np.sin(17.0 * p[:, 0] - 13.0 * p[:, 1] + 2.0 * ph2)
        + ts * 0.05 * np.sign(np.sin(4.9 * p[:, 0] + ph1)
                              * np.sin(4.3 * p[:, 2] - ph2))
        + ts * 0.14 * (noise - 0.5)
    )
    shade = np.clip(1.0 - tt / (scene.max_range * 1.2), 0.2, 1.0)
    img = np.where(hit, np.clip(tex * shade, 0.0, 1.0), 0.08)
    return img, np.where(hit, tt, np.inf)


def render_camera(scene: Scene, T_world_cam: np.ndarray, K: np.ndarray,
                  width: int, height: int) -> np.ndarray:
    """Raycast a grayscale image [height, width] float32 in [0, 1] from the
    camera pose [4, 4] (cam -> world; cam: z forward, x right, y down)."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([u.ravel() + 0.5, v.ravel() + 0.5, np.ones(u.size)],
                   axis=0)
    d_cam = np.linalg.solve(K, pix).T
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    R = T_world_cam[:3, :3]
    t = T_world_cam[:3, 3]
    dw = d_cam @ R.T
    img, _ = _ray_scene_hit(np.broadcast_to(t, dw.shape), dw, scene)
    return img.reshape(height, width).astype(np.float32)


def default_cam_calib(width: int = 320, height: int = 96):
    """KITTI-like intrinsics scaled to the image width, and the velo <-> cam
    extrinsics (the camera sits at the velodyne origin). Returns
    (K, P_rect0, cam_T_velo, velo_T_cam)."""
    f = 718.0 * width / 1242.0
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height * 0.55],
                  [0.0, 0.0, 1.0]])
    # cam axes in the velo frame: x_cam = -y_velo, y_cam = -z_velo,
    # z_cam = x_velo
    velo_T_cam = np.eye(4)
    velo_T_cam[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
    cam_T_velo = np.linalg.inv(velo_T_cam)
    P_rect0 = np.hstack([K, np.zeros((3, 1))])
    return K, P_rect0, cam_T_velo, velo_T_cam


def drive_trajectory(n_frames: int, speed: float = 1.0,
                     yaw_rate: float | np.ndarray = 0.01,
                     start: np.ndarray | None = None) -> list[np.ndarray]:
    """Ground-truth sensor poses along an arc: `speed` m and `yaw_rate` rad
    per frame (scalar, or one per frame for S-curves)."""
    poses = []
    T = np.eye(4) if start is None else start.copy()
    yr = np.broadcast_to(np.asarray(yaw_rate, float), (n_frames,))
    for k in range(n_frames):
        poses.append(T.copy())
        c, s = np.cos(yr[k]), np.sin(yr[k])
        dT = np.eye(4)
        dT[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        dT[0, 3] = speed
        T = T @ dT
    return poses
