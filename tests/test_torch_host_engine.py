"""The port's per-stage host engine (LaserOdometry, LaserMapping,
VisualOdometry, VloamPipeline / run_sequence, vision/viz.py) against the
JAX package's on the CPU, on tests/test_pipeline.py's small_cfg drive of 4
frames.

Tolerances (those of tests/test_torch_vloam_engine.py): LO 1e-3 m, MO 1e-2
m, VO 2e-3 m; the 3D-2D / epipolar match counts n32 / n22 identical; LO
correspondence counts within 2 (the JAX LO associates with quantized
distances, the port with exact ones). The debug renderers' arrays are
identical.
"""

import dataclasses
import logging
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vloam_tpu import pipeline as jpipe
from vloam_tpu.lidar import mapping as jmap
from vloam_tpu.lidar import odometry as jodo
from vloam_tpu.lidar.scan_registration import register_scan as j_register
from vloam_tpu.vision import viz as jviz
from vloam_tpu.vision import vo as jvo
from vloam_tpu.vision.depth_map import build_depth_grid as j_grid
from vloam_tpu_torch import pipeline as tpipe
from vloam_tpu_torch.data.synthetic import pad_scan
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar import odometry as todo
from vloam_tpu_torch.lidar.scan_registration import register_scan as t_register
from vloam_tpu_torch.vision import viz as tviz
from vloam_tpu_torch.vision import vo as tvo
from vloam_tpu_torch.vision.depth_map import build_depth_grid as t_grid

from test_pipeline import small_cfg, synth_setup

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

N = 4
CFG = small_cfg()
MODES = ("combined", "detached", "lidar-only")
TOL = {"LO": 1e-3, "MO": 1e-2, "VO": 2e-3}


@pytest.fixture(scope="module")
def drive():
    calib, frames, gt = synth_setup(N)
    return calib, list(frames()), gt


def _recording(cls, log):
    """cls with a step() that also logs the stage counts of each frame."""

    class Recording(cls):
        def step(self, points, image=None):
            out = super().step(points, image)
            log.append({"n32": self.vo.stats.get("n32"),
                        "n22": self.vo.stats.get("n22"),
                        "n_corner": self.lo.n_corner,
                        "n_surf": self.lo.n_surf})
            return out

    return Recording


def _run_sequence(pipe_mod, mode, drive, out_dir, **kw):
    calib, frames, _ = drive
    cfg = CFG.replace(detach_VO_LO=(mode != "combined"))
    if mode == "lidar-only":
        frames = [{"points": f["points"]} for f in frames]
    log = []
    with mock.patch.object(pipe_mod, "VloamPipeline",
                           _recording(pipe_mod.VloamPipeline, log)):
        res = pipe_mod.run_sequence(cfg, calib, frames, out_dir=str(out_dir),
                                    **kw)
    return res, log


@pytest.fixture(scope="module")
def jax_runs(drive, tmp_path_factory):
    """The JAX run_sequence in each mode: (result, per-frame counts, the
    directory of its txt files)."""
    runs = {}
    for mode in MODES:
        out = tmp_path_factory.mktemp(mode)
        runs[mode] = (*_run_sequence(jpipe, mode, drive, out), out)
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_run_sequence_matches_jax(mode, drive, jax_runs, tmp_path):
    want, want_log, want_dir = jax_runs[mode]
    got, got_log = _run_sequence(tpipe, mode, drive, tmp_path, device="cpu")
    suffix = "0" if mode == "combined" else "1"
    for which in ("VO", "LO", "MO"):
        assert got[which].shape == (N, 3, 4)
        np.testing.assert_allclose(got[which], want[which], rtol=0,
                                   atol=TOL[which], err_msg=which)
        # the txt files hold the same poses, %f-rounded
        rows = np.loadtxt(tmp_path / f"{which}{suffix}.txt")
        ref = np.loadtxt(want_dir / f"{which}{suffix}.txt")
        assert rows.shape == ref.shape == (N, 12)
        np.testing.assert_allclose(rows, got[which].reshape(N, 12), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(rows, ref, rtol=0, atol=TOL[which])
    for g, w in zip(got_log, want_log, strict=True):
        assert g["n32"] == w["n32"] and g["n22"] == w["n22"], (g, w)
        assert abs(g["n_corner"] - w["n_corner"]) <= 2, (g, w)
        assert abs(g["n_surf"] - w["n_surf"]) <= 2, (g, w)
    if mode == "lidar-only":
        np.testing.assert_array_equal(got["VO"], np.broadcast_to(
            np.eye(4)[:3], (N, 3, 4)))
    else:
        assert all(g["n32"] > 0 for g in got_log[1:])
    assert len(got["timings"]) == N
    stages = {"t_scanreg_ms", "t_lo_ms", "t_mo_ms", "t_frame_ms"}
    if mode != "lidar-only":
        stages |= {"t_image_ms", "t_depth_ms", "t_vo_solve_ms"}
    assert set(got["timings"][0]) == set(want["timings"][0]) == stages


def _features(drive):
    """Each package's scan registration of the drive's frames."""
    cfg = CFG
    out = []
    for f in drive[1]:
        pts, n = pad_scan(f["points"], cfg.lidar.max_points)
        out.append((j_register(jnp.asarray(pts), jnp.int32(n), cfg.lidar,
                               cfg.scanreg),
                    t_register(torch.from_numpy(pts), n, cfg.lidar,
                               cfg.scanreg)))
    return out


@pytest.fixture(scope="module")
def features(drive):
    return _features(drive)


def test_laser_odometry_matches_jax(features, caplog):
    """LaserOdometry over the 4 frames (frame 0 initializes, then one solve
    each, with and without a prior); the correspondence warning goes to the
    port's logger."""
    j = jodo.LaserOdometry(CFG.lo)
    # the same solves; only the warning threshold differs
    t = todo.LaserOdometry(dataclasses.replace(CFG.lo,
                                               min_correspondences=10**6),
                           device="cpu")
    prior = (np.array([0.0, 0.0, 0.01, 1.0]) / np.linalg.norm(
        [0.0, 0.0, 0.01, 1.0]), np.array([1.0, 0.0, 0.0]))
    with caplog.at_level(logging.WARNING, logger="vloam_tpu_torch"):
        for k, (fj, ft) in enumerate(features):
            p = prior if k == 2 else (None, None)
            wj, wt = j.step(fj, *p), t.step(ft, *p)
            for key in ("q_f2f", "t_f2f", "q_w", "t_w"):
                np.testing.assert_allclose(wt[key], wj[key], rtol=0,
                                           atol=1e-3, err_msg=key)
                assert wt[key].dtype == np.float64
            assert wt["skip_frame"] == wj["skip_frame"]
            assert abs(t.n_corner - j.n_corner) <= 2
            assert abs(t.n_surf - j.n_surf) <= 2
    assert j.n_corner > 100 and j.n_surf > 100
    warned = [r for r in caplog.records if r.name == "vloam_tpu_torch"]
    assert len(warned) == N - 1 and "less correspondence" in warned[0].msg
    assert t.corner_last is features[-1][1].less_sharp_slab


def _angle(q0, q1) -> float:
    return (Rotation.from_quat(q0).inv() * Rotation.from_quat(q1)).magnitude()


def test_laser_mapping_matches_jax(features):
    """LaserMapping over the 4 frames from the same LO world poses, then
    one skipped frame (propagation only)."""
    lo = jodo.LaserOdometry(CFG.lo)
    j = jmap.LaserMapping(CFG.mapping)
    t = tmap.LaserMapping(CFG.mapping, device="cpu")
    for fj, ft in features:
        w = lo.step(fj)
        got = t.step(ft.less_sharp, ft.less_flat, w["q_w"], w["t_w"])
        want = j.step(fj.less_sharp, fj.less_flat, w["q_w"], w["t_w"])
        np.testing.assert_allclose(got["t_w"], want["t_w"], rtol=0, atol=1e-2)
        assert _angle(got["q_w"], want["q_w"]) < 1e-3
        assert got["skip"] is want["skip"] is False
        assert t.last_stats.keys() == j.last_stats.keys()
        assert all(type(v) is int for v in t.last_stats.values())
        assert t.last_stats["solved"] == j.last_stats["solved"]
        for key in ("n_map_corner", "n_map_surf"):
            assert abs(t.last_stats[key] - j.last_stats[key]) <= max(
                2, j.last_stats[key] // 100), key
    assert j.last_stats["solved"] == 1 and t.frame_count == N
    q, tr = np.array([0.0, 0.0, 0.02, 1.0]), np.array([5.0, 0.5, 0.0])
    q /= np.linalg.norm(q)
    got = t.step(None, None, q, tr, skip_frame=True)
    want = j.step(None, None, q, tr, skip_frame=True)
    assert got["skip"] and want["skip"] and t.frame_count == N
    np.testing.assert_allclose(got["t_w"], want["t_w"], rtol=0, atol=1e-2)
    assert _angle(got["q_w"], want["q_w"]) < 1e-3


@pytest.mark.parametrize("options", [
    {}, {"optical_flow_match": True, "clahe": True, "keypoint_nms": True,
         "nms_bucket": 50, "nms_max_total": 100}], ids=["default", "flow"])
def test_visual_odometry_matches_jax(drive, options):
    """VisualOdometry over the 4 frames: images, depth grids and solves
    (frame 2 from a prior), against the JAX class."""
    calib, frames, _ = drive
    cfg = dataclasses.replace(CFG.vo, **options)
    j = jvo.VisualOdometry(cfg, calib.K, calib.P_velo_to_img)
    t = tvo.VisualOdometry(cfg, calib.K, calib.P_velo_to_img, device="cpu")
    for k, f in enumerate(frames):
        pts, n = pad_scan(f["points"], CFG.lidar.max_points)
        prior = ((np.array([0.0, 0.01, 0.0]), np.array([0.0, 0.0, 1.0]))
                 if k == 2 else (None, None))
        for v in (j, t):
            v.reset()
            v.process_image(f["image"])
            v.process_point_cloud(pts, np.arange(len(pts)) < n)
        aj, tj = j.solve(*prior)
        at, tt = t.solve(*prior)
        assert at.dtype == tt.dtype == np.float64
        np.testing.assert_allclose(at, aj, rtol=0, atol=2e-3)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=2e-3)
        assert t.stats == j.stats
        np.testing.assert_array_equal(t.kp_mask[t.i].numpy(),
                                      np.asarray(j.kp_mask[j.i]))
        assert (t.desc[t.i] is None) == bool(cfg.optical_flow_match)
        if k:
            (p, c, ok), (pj, cj, okj) = t.last_matches, j.last_matches
            np.testing.assert_array_equal(ok, okj)
            np.testing.assert_allclose(p, pj, rtol=0, atol=1e-3)
            np.testing.assert_allclose(c[ok], cj[ok], rtol=0, atol=1e-3)
    assert j.stats["n32"] > 0 and j.stats["n22"] > 0


def test_pipeline_refuses_mesh(drive):
    """The host engine takes a mesh (its mapping stage distributed:
    tests/test_torch_mesh.py runs it), on the mesh's own device only: a
    mesh on the CPU with the card asked for is refused, nothing moves to
    another device unasked."""
    from vloam_tpu_torch.parallel.mesh_pipeline import MeshLaserMapping
    from vloam_tpu_torch.parallel.sharded import data_mesh

    mesh = data_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tpipe.VloamPipeline(CFG, drive[0], mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="mesh"):
        tpipe.run_sequence(CFG, drive[0], [], mesh=mesh, device="cuda")
    pipe = tpipe.VloamPipeline(CFG, drive[0], mesh=mesh, device="cpu")
    assert isinstance(pipe.mo, MeshLaserMapping)


def test_renderers_match_reference(drive):
    """The three debug renderers' arrays are the reference's: matches and
    flow on the same keypoints, depth through each package's own grid of
    the same scan."""
    calib, frames, _ = drive
    img0, img1 = frames[0]["image"], frames[1]["image"]
    rng = np.random.default_rng(3)
    kp0 = rng.random((40, 2)) * [300, 90]
    kp1 = kp0 + rng.normal(0, 2, (40, 2))
    ok = rng.random(40) < 0.7
    pairs = [(k, k) for k in np.flatnonzero(ok)]
    np.testing.assert_array_equal(
        tviz.render_matches(img0, img1, kp0, kp1, pairs),
        jviz.render_matches(img0, img1, kp0, kp1, pairs))
    np.testing.assert_array_equal(tviz.render_flow(img1, kp0, kp1, ok),
                                  jviz.render_flow(img1, kp0, kp1, ok))
    pts, n = pad_scan(frames[1]["points"], CFG.lidar.max_points)
    mask = np.arange(len(pts)) < n
    gj = j_grid(jnp.asarray(pts), jnp.asarray(mask),
                jnp.asarray(calib.P_velo_to_img, jnp.float32), CFG.vo)
    gt = t_grid(torch.from_numpy(pts), torch.from_numpy(mask),
                torch.tensor(calib.P_velo_to_img, dtype=torch.float32),
                CFG.vo)
    want = jviz.render_depth(img1, gj, CFG.vo)
    np.testing.assert_array_equal(tviz.render_depth(img1, gt, CFG.vo), want)
    assert (want != jviz._to_rgb(img1)).any()  # some depth was drawn
