"""Recorded drives for the benchmark, made on the card from a seed.

A drive is a closed circuit: L frames around a regular polygon of side
`speed_m` (one frame a side, turning 2 pi / L a frame), so the frame after
the last is the first and a run that laps the circuit never jumps back. The
scene is built up on both sides of the road, as a street: a building each
side every `box_every` frames, a pole every `pole_every` frames, on a
ground plane. From each pose the drive has
- a 64-ring polar range image [S, A] uint16 in `range_scale_m` units (0 =
  no return), the HDL-64 ray-cast with Gaussian range noise, and
- with a camera, a grayscale image [H, W] uint8 ray-cast from the camera.

The geometry is that of the port's host-side generator
(`vloam_tpu_torch/data/synthetic.py`: `simulate_scan_polar`,
`render_camera`, `_ray_scene_hit`), rewritten as batched PyTorch on the
card in float64; `benchmark/tests/test_bench_drive.py` holds the two equal
at a small size. The scene's layout comes from numpy's generator of the
seed (a few hundred numbers, on the host), every ray-cast and the range
noise from the card (a `torch.Generator` of the seed).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

GROUND_ID = 0


class Scene(NamedTuple):
    ground_z: float
    boxes: np.ndarray  # [nb, 6] xmin, xmax, ymin, ymax, zmin, zmax
    poles: np.ndarray  # [np, 5] cx, cy, radius, zmin, zmax
    max_range: float
    tex_scale: float


def hdl64_elevations(n_scans: int = 64) -> np.ndarray:
    """Per-ring elevations (deg): every beam strictly inside its ring bin of
    the reference's ring assignment (scan_registration.cpp:213-226), for
    the 64-ring sensor and the 16- and 32-ring ones of small tests."""
    if n_scans == 64:
        upper = 2.0 - (np.arange(32) + 0.2) / 3.0
        lower = -8.83 - (np.arange(32)) / 2.0 - 0.2
        return np.concatenate([upper, lower])
    if n_scans == 16:
        return -15.0 + 2.0 * np.arange(16)
    if n_scans == 32:
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0 + 0.2
    raise ValueError(n_scans)


def circuit_poses(n_frames: int, speed: float) -> np.ndarray:
    """Sensor poses [L, 4, 4] (sensor -> world) around the closed polygon:
    pose k+1 = pose k x (turn 2 pi / L, then `speed` m along the new x),
    as drive_trajectory's step; pose L is pose 0."""
    yaw = 2.0 * math.pi / n_frames
    k = np.arange(n_frames)
    heading = k * yaw
    step = np.stack([np.cos(heading), np.sin(heading)], axis=1) * speed
    xy = np.concatenate([np.zeros((1, 2)), np.cumsum(step, axis=0)[:-1]])
    T = np.tile(np.eye(4), (n_frames, 1, 1))
    T[:, 0, 0], T[:, 0, 1] = np.cos(heading), -np.sin(heading)
    T[:, 1, 0], T[:, 1, 1] = np.sin(heading), np.cos(heading)
    T[:, :2, 3] = xy
    return T


def circuit_scene(poses: np.ndarray, seed, p: dict) -> Scene:
    """Buildings and poles along both sides of the circuit, drawn from
    numpy's generator of `seed` (an int or a tuple of ints). Raises if the
    road passes within a metre of a building."""
    rng = np.random.default_rng(seed)
    centers, heads = poses[:, :3, 3], poses[:, :3, 0]
    boxes, poles = [], []
    for i in range(0, len(poses), p["box_every"]):
        n_vec = np.array([-heads[i][1], heads[i][0], 0.0])  # road normal
        for side in (-1.0, 1.0):
            c = centers[i] + side * rng.uniform(*p["box_offset_m"]) * n_vec
            w, d = rng.uniform(*p["box_half_m"]), rng.uniform(*p["box_half_m"])
            boxes.append([c[0] - w, c[0] + w, c[1] - d, c[1] + d,
                          p["ground_z"], rng.uniform(*p["box_height_m"])])
        if i % p["pole_every"] == 0:
            c = centers[i] + (rng.choice([-1.0, 1.0])
                              * rng.uniform(*p["pole_offset_m"]) * n_vec)
            poles.append([c[0], c[1], rng.uniform(*p["pole_radius_m"]),
                          p["ground_z"], rng.uniform(*p["pole_height_m"])])
    b = np.asarray(boxes, np.float64)
    inside = ((b[None, :, 0] - 1 < centers[:, None, 0])
              & (centers[:, None, 0] < b[None, :, 1] + 1)
              & (b[None, :, 2] - 1 < centers[:, None, 1])
              & (centers[:, None, 1] < b[None, :, 3] + 1))
    if inside.any():
        raise ValueError("the circuit's road enters a building")
    return Scene(p["ground_z"], b, np.asarray(poles, np.float64),
                 float(p["max_range_m"]), float(p["tex_scale"]))


def ray_scene_range(o: torch.Tensor, d: torch.Tensor, scene: Scene):
    """Nearest positive hit distance of each ray (inf where none) and the
    hit object's id (0 the ground, 1.. the boxes, then the poles): origins
    o and unit directions d [..., 3] float64."""
    dev = d.device
    tmin = torch.full(d.shape[:-1], math.inf, dtype=d.dtype, device=dev)
    ids = torch.zeros(d.shape[:-1], dtype=torch.int32, device=dev)

    def update(hit, t, oid):
        nonlocal tmin, ids
        better = hit & (t < tmin)
        tmin = torch.where(better, t, tmin)
        ids = torch.where(better, oid, ids)

    dz = d[..., 2]
    t = (scene.ground_z - o[..., 2]) / dz
    update((torch.abs(dz) > 1e-9) & (t > 0.1), t, GROUND_ID)
    for k, b in enumerate(scene.boxes):
        # the slab method; an axis the ray runs along gives NaN, which the
        # running max and min skip (numpy's nanmax / nanmin)
        tnear = torch.full_like(tmin, math.nan)
        tfar = torch.full_like(tmin, math.nan)
        for a in range(3):
            t1 = (b[2 * a] - o[..., a]) / d[..., a]
            t2 = (b[2 * a + 1] - o[..., a]) / d[..., a]
            tnear = torch.fmax(tnear, torch.minimum(t1, t2))
            tfar = torch.fmin(tfar, torch.maximum(t1, t2))
        update((tnear <= tfar) & (tfar > 0) & (tnear > 0.1), tnear, 1 + k)
    n_boxes = len(scene.boxes)
    for k, (cx, cy, r, zmin, zmax) in enumerate(scene.poles):
        ox, oy = o[..., 0] - cx, o[..., 1] - cy
        dx, dy = d[..., 0], d[..., 1]
        a = dx * dx + dy * dy
        bq = 2 * (ox * dx + oy * dy)
        disc = bq * bq - 4 * a * (ox * ox + oy * oy - r * r)
        t = (-bq - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
        z = o[..., 2] + t * d[..., 2]
        update((disc > 0) & (a > 1e-12) & (t > 0.1) & (z >= zmin)
               & (z <= zmax), t, 1 + n_boxes + k)
    return tmin, ids


def sensor_rays(n_scans: int, n_azimuth: int, device) -> torch.Tensor:
    """Unit ray directions [S, A, 3] float64, azimuth clockwise from +x."""
    elev = torch.as_tensor(np.radians(hdl64_elevations(n_scans)),
                           device=device)
    az = -torch.arange(n_azimuth, dtype=torch.float64,
                       device=device) * (2.0 * math.pi / n_azimuth)
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    return torch.stack([ce * torch.cos(az)[None], ce * torch.sin(az)[None],
                        se.expand(n_scans, n_azimuth)], dim=-1)


def range_images(scene: Scene, poses: torch.Tensor, rays: torch.Tensor,
                 noise: float, scale: float, gen: torch.Generator,
                 batch: int = 32) -> torch.Tensor:
    """Range images [L, S, A] uint16 (as int32 0..65535) of the poses [L,
    4, 4] float64: the ray-cast, plus N(0, noise) on every hit, in `scale`
    metre units, 0 where no return lies within max_range."""
    out = []
    for i in range(0, poses.shape[0], batch):
        T = poses[i:i + batch]
        dw = torch.einsum("fij,saj->fsai", T[:, :3, :3], rays)
        o = T[:, None, None, :3, 3].expand_as(dw)
        rng, _ = ray_scene_range(o, dw, scene)
        hit = torch.isfinite(rng) & (rng < scene.max_range)
        eps = torch.randn(rng.shape, generator=gen, dtype=torch.float64,
                          device=rng.device)
        rng = torch.where(hit, rng + noise * eps, 0.0)
        q = torch.clamp(torch.round(rng / scale), 1, 65535)
        out.append(torch.where(hit, q, 0.0).to(torch.int32))
    return torch.cat(out)


def camera_rays(K: np.ndarray, width: int, height: int,
                device) -> torch.Tensor:
    """Unit pixel-centre ray directions [H, W, 3] float64 in the camera
    frame (z forward, x right, y down)."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([u.ravel() + 0.5, v.ravel() + 0.5, np.ones(u.size)])
    d = np.linalg.solve(K, pix).T
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(d.reshape(height, width, 3), device=device)


def shade(o: torch.Tensor, d: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Grey level in [0, 1] of each ray: the hit object's texture, its
    world-anchored cell noise faded with distance, darkened with distance;
    0.08 where a ray hits nothing (`_ray_scene_hit`'s)."""
    t, oid = ray_scene_range(o, d, scene)
    hit = torch.isfinite(t)
    tt = torch.where(hit, t, 0.0)
    p = o + d * tt[..., None]
    oid = oid.to(torch.float64)
    ph1, ph2 = 2.39996 * oid, 1.17 * oid
    cell = torch.floor(p * 12.0)
    hsh = torch.sin(cell[..., 0] * 12.9898 + cell[..., 1] * 78.233
                    + cell[..., 2] * 37.719 + ph1)
    noise = torch.remainder(hsh * 43758.5453, 1.0) * torch.clamp(
        1.0 - tt / 45.0, 0.0, 1.0)
    ts = scene.tex_scale
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    tex = (0.52
           + ts * 0.16 * torch.sin(2.1 * x + ph1) * torch.cos(1.7 * y - ph2)
           + ts * 0.12 * torch.sin(5.3 * z + 1.3 * x + 0.7 * ph2)
           + ts * 0.10 * torch.sin(9.1 * y + 3.1 * z + ph1)
           + ts * 0.06 * torch.sin(17.0 * x - 13.0 * y + 2.0 * ph2)
           + ts * 0.05 * torch.sign(torch.sin(4.9 * x + ph1)
                                    * torch.sin(4.3 * z - ph2))
           + ts * 0.14 * (noise - 0.5))
    dim = torch.clamp(1.0 - tt / (scene.max_range * 1.2), 0.2, 1.0)
    return torch.where(hit, torch.clamp(tex * dim, 0.0, 1.0), 0.08)


def camera_images(scene: Scene, poses_cam: torch.Tensor,
                  rays: torch.Tensor, batch: int = 8) -> torch.Tensor:
    """Images [L, H, W] uint8 from the camera poses [L, 4, 4] (cam ->
    world)."""
    out = []
    for i in range(0, poses_cam.shape[0], batch):
        T = poses_cam[i:i + batch]
        dw = torch.einsum("fij,hwj->fhwi", T[:, :3, :3], rays)
        img = shade(T[:, None, None, :3, 3].expand_as(dw), dw, scene)
        out.append(torch.clamp(img * 255.0, 0, 255).to(torch.uint8))
    return torch.cat(out)


class Drive(NamedTuple):
    """One circuit: its range images [L, S, A] uint16 and camera images
    [L, H, W] uint8 (None without a camera) on the host, and the ground
    truth sensor poses [L, 4, 4]."""

    ranges: np.ndarray
    images: np.ndarray | None
    poses: np.ndarray


def make_drive(seed, p: dict, n_scans: int, n_azimuth: int, device,
               camera=None) -> Drive:
    """The circuit of traffic parameters `p` for `seed` (an int or a tuple
    of ints): its scene, range images and, with camera = (K [3, 3],
    velo_T_cam [4, 4], width, height), its images."""
    poses = circuit_poses(p["circuit_frames"], p["speed_m"])
    scene = circuit_scene(poses, seed, p)
    seeds = np.random.SeedSequence(seed).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seeds[0]) & ((1 << 63) - 1))
    T = torch.as_tensor(poses, device=device)
    ranges = range_images(scene, T, sensor_rays(n_scans, n_azimuth, device),
                          p["noise_m"], p["range_scale_m"], gen)
    images = None
    if camera is not None:
        K, velo_T_cam, w, h = camera
        T_cam = T @ torch.as_tensor(velo_T_cam, device=device)
        images = camera_images(scene, T_cam,
                               camera_rays(K, w, h, device)).cpu().numpy()
    return Drive(ranges.cpu().numpy().astype(np.uint16), images, poses)
