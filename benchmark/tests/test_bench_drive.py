"""The card-side drive generator against the port's host-side one
(vloam_tpu_torch/data/synthetic.py) at a small size, on the CPU."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.traffic import drive
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def circuit():
    p = dict(tiny.TRAFFIC, range_scale_m=0.005)
    poses = drive.circuit_poses(p["circuit_frames"], p["speed_m"])
    return p, poses, drive.circuit_scene(poses, (7, 1), p)


def _host_scene(scene):
    from vloam_tpu_torch.data import synthetic

    return synthetic.Scene(ground_z=scene.ground_z, boxes=scene.boxes,
                           poles=scene.poles, max_range=scene.max_range,
                           tex_scale=scene.tex_scale)


def test_circuit_closes():
    """The frame after the last is the first, and the step from the last
    frame to it is every other step: the same distance and turn."""
    L, speed = 40, 1.1
    T = drive.circuit_poses(L, speed)
    yaw = 2 * math.pi / L
    step = np.eye(4)
    step[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                    [math.sin(yaw), math.cos(yaw)]]
    step[0, 3] = speed
    for k in range(L):
        nxt = T[(k + 1) % L]
        np.testing.assert_allclose(T[k] @ step, nxt, atol=1e-9)
    moves = np.linalg.norm(np.diff(np.concatenate([T, T[:1]])[:, :3, 3],
                                   axis=0), axis=1)
    np.testing.assert_allclose(moves, speed, rtol=1e-9)


def test_scan_matches_host_generator(circuit):
    """Without noise the same returns and ranges (within one 5 mm unit at
    a rounding boundary) as simulate_scan_polar; with noise the same
    returns, within five standard deviations."""
    from vloam_tpu_torch.data import synthetic

    p, poses, scene = circuit
    S, A = 16, 360
    rays = drive.sensor_rays(S, A, "cpu")
    gen = torch.Generator().manual_seed(3)
    for k in (0, 17, 39):
        host = synthetic.simulate_scan_polar(
            _host_scene(scene), poses[k], n_scans=S, n_azimuth=A, noise=0.0,
            range_scale=0.005).astype(np.int64)
        T = torch.as_tensor(poses[k:k + 1])
        card = drive.range_images(scene, T, rays, 0.0, 0.005, gen)[0]
        card = card.numpy().astype(np.int64)
        np.testing.assert_array_equal(card > 0, host > 0)
        assert (host > 0).sum() > 0.5 * S * A
        assert np.abs(card - host).max() <= 1
        assert (card != host).mean() < 1e-3
        noisy = drive.range_images(scene, T, rays, p["noise_m"], 0.005,
                                   gen)[0].numpy().astype(np.int64)
        hit = host > 0
        np.testing.assert_array_equal(noisy > 0, hit)
        assert np.abs(noisy - host)[hit].max() * 0.005 < 5 * p["noise_m"]


def test_image_matches_host_renderer(circuit):
    """The same grey levels as render_camera, within one level on all but
    a few pixels (the texture's hashed cell noise rounds apart there)."""
    from vloam_tpu_torch.data import synthetic

    _, poses, scene = circuit
    K, _, _, velo_T_cam = synthetic.default_cam_calib(96, 32)
    T = poses[5] @ velo_T_cam
    host = np.clip(synthetic.render_camera(_host_scene(scene), T, K, 96, 32)
                   * 255.0, 0, 255).astype(np.uint8).astype(np.int64)
    card = drive.camera_images(scene, torch.as_tensor(T[None]),
                               drive.camera_rays(K, 96, 32, "cpu"))[0]
    diff = np.abs(card.numpy().astype(np.int64) - host)
    assert (diff > 1).mean() < 0.01


def test_drive_is_the_seeds():
    """The same seed gives the same drive; another seed another scene."""
    p = dict(tiny.TRAFFIC, range_scale_m=0.005)
    a = drive.make_drive(2**33 + 5, p, 16, 90, "cpu")
    b = drive.make_drive(2**33 + 5, p, 16, 90, "cpu")
    c = drive.make_drive(2**33 + 6, p, 16, 90, "cpu")
    np.testing.assert_array_equal(a.ranges, b.ranges)
    assert (a.ranges != c.ranges).any()
    assert a.ranges.dtype == np.uint16 and a.ranges.shape == (48, 16, 90)
