"""The VO diagnosis and the upload stagings of the port
(vloam_tpu_torch/tools/diag_vo.py, profile_upload_overlap.py) on the CPU,
and what the last scripts' tools share:

- diag_vo on the first 2 pairs of the evaluation drive (tools/
  eval_frames.py's 100-frame drive at the small test profile: 16 x 360
  rays, 320 x 96 images, tests/test_pipeline.py::small_cfg's VO) against
  the JAX functions composed as scripts/diag_vo.py composes them (detect,
  describe, match or LK flow, the depth grid, solve_vo from rest) on the
  same frames: valid, n32 and n22 counts equal; the solve's rotation error
  within tests/test_torch_vision.py's solve_vo bound (1e-4 rad) and its
  translation error within tests/test_torch_vloam_engine.py's VO bound
  (2e-3 m). test_torch_vision's 1e-4 m holds for a solve seeded near its
  solution; diag_vo solves from rest, as the engine does (24 LM iterations
  on ~30 matches, LU in the port, Cholesky in the reference: 0.47 mm apart
  on the first pair here with the JAX package's own matches and grid);
  base and lk-flow; the ground-truth depth grid of
  error_anatomy against the script's raycast through the JAX package's
  scene code; every entry point runs and reports finite numbers;
- profile_upload_overlap's four stagings (A one upload a chunk, B one a
  frame, C and D with pack12) over 2 timed chunks: rows bit for bit equal
  to each other and to LoamEngine's own push_polar at the same scale;
- every new tool refuses the default device where there is no card.
"""

import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.vision import depth_map as jdm
from vloam_tpu.vision import features as jf
from vloam_tpu.vision import vo as jvo
from vloam_tpu_torch import config as tcfg
from vloam_tpu_torch.tools import diag_vo
from vloam_tpu_torch.tools import profile_upload_overlap as upo

from test_pipeline import small_cfg

torch.set_num_threads(1)

N_PAIRS = 2
ROT_TOL = 1e-4  # rad: tests/test_torch_vision.py's solve_vo
T_TOL = 2e-3  # m: tests/test_torch_vloam_engine.py's VO (a solve from rest)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("cache"))
    try:
        cfg = tcfg.tiny_test_profile()
        cfg = cfg.replace(vo=_port_vo())
        yield diag_vo.load_drive(N_PAIRS, cfg, "cpu", n_scans=16,
                                 n_azimuth=360, workers=1)
    finally:
        tempfile.tempdir = old


def _port_vo(**kw):
    jvo_cfg = small_cfg().vo
    return tcfg.VisualOdometryConfig(**{
        f.name: getattr(jvo_cfg, f.name)
        for f in dataclasses.fields(tcfg.VisualOdometryConfig)} | kw)


def _jax_pair(drive, k, vo):
    """scripts/diag_vo.py's main loop body for pair k: (valid, n32, n22,
    angles, t)."""
    img0 = jnp.asarray(drive.frames[k]["image"], jnp.float32)
    img1 = jnp.asarray(drive.frames[k + 1]["image"], jnp.float32)
    xy0, _, m0 = jf.detect_keypoints(img0, vo)
    xy1, _, m1 = jf.detect_keypoints(img1, vo)
    if vo.optical_flow_match:
        from vloam_tpu.vision.optical_flow import lk_flow

        xy1m, status = lk_flow(img0, img1, xy0, vo)
        prev_uv, curr_uv, valid = xy0, xy1m, m0 & status
    else:
        d0 = jf.describe_keypoints(img0, xy0, vo)
        d1 = jf.describe_keypoints(img1, xy1, vo)
        idx1, ok = jf.match_descriptors(d0, m0, d1, m1, vo.match_ratio,
                                        matcher=vo.matcher,
                                        select=vo.match_select)
        prev_uv, curr_uv, valid = xy0, xy1[idx1], ok
    pts0 = drive.frames[k]["points"]
    grid0 = jdm.build_depth_grid(jnp.asarray(pts0, jnp.float32),
                                 jnp.ones(len(pts0), bool),
                                 jnp.asarray(drive.P.numpy()), vo)
    a, t, n32, n22 = jvo.solve_vo(
        jnp.asarray(prev_uv), jnp.asarray(curr_uv), jnp.asarray(valid),
        grid0, jnp.asarray(drive.K, jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.zeros(3, jnp.float32), vo)
    return (int(np.asarray(valid).sum()), int(n32), int(n22),
            np.asarray(a, np.float64), np.asarray(t, np.float64), grid0)


@pytest.mark.parametrize("flow", [False, True])
def test_diag_vo_pairs_match_jax(drive, flow):
    vo_t = _port_vo(optical_flow_match=flow)
    vo_j = dataclasses.replace(small_cfg().vo, optical_flow_match=flow)
    for k in range(N_PAIRS):
        got = diag_vo.pair_stats(drive, k, vo_t, quality=True)
        valid, n32, n22, a, t, _ = _jax_pair(drive, k, vo_j)
        assert (got["valid"], got["n32"], got["n22"]) == (valid, n32, n22)
        assert n32 > 5 and valid > 10
        rot, err = diag_vo.error(drive.truth(k), a, t)
        assert abs(got["rot_mrad"] - rot) <= ROT_TOL * 1e3
        np.testing.assert_allclose(got["err_mm"], err, rtol=0,
                                   atol=T_TOL * 1e3)
        assert got["trans_mm"] < 1200.0  # the solve moved towards the truth
        assert np.isfinite(got["reproj_med"]) and 0 <= got["inlier2"] <= 1


def test_gt_depth_grid_is_the_scripts(drive):
    """error_anatomy's ground-truth grid against the script's raycast
    through the JAX package's scene code, on the JAX grid."""
    from vloam_tpu.data import synthetic as jsyn

    vo_t, vo_j = _port_vo(), small_cfg().vo
    got = diag_vo.gt_depth_grid(drive, 0, drive.grid(0, vo_t)).z.numpy()
    g = _jax_pair(drive, 0, vo_j)[5]
    u, v = np.asarray(g.u).ravel(), np.asarray(g.v).ravel()
    live = np.asarray(g.cnt).ravel() > 0
    bear = np.linalg.solve(drive.K, np.stack([u, v, np.ones_like(u)])).T
    bear /= np.linalg.norm(bear, axis=1, keepdims=True)
    T = drive.cam_poses[0]
    dirs = bear @ T[:3, :3].T
    rng_t = jsyn._ray_scene_range(np.broadcast_to(T[:3, 3], dirs.shape),
                                  dirs, drive.scene)
    zt = np.where(np.isfinite(rng_t), rng_t * bear[:, 2], 0.0)
    want = np.where(live & (zt > 0), zt, 0.0).astype(np.float32)
    np.testing.assert_allclose(got.ravel(), want, rtol=1e-5, atol=1e-5)
    assert (want > 0).sum() > 100


def test_every_entry_point_runs(drive, capsys):
    vo = _port_vo()
    for name in diag_vo.ENTRIES:
        rec = diag_vo.RUNS[name](drive, vo)
        assert rec, name
    out = capsys.readouterr().out
    for label in ("== base(zncc,bf,knn) ==", "== lk-flow ==", "nms_on",
                  "gt-ray depth", "only22", "subpix+spread1+kp2048",
                  "subpix_patch24"):
        assert label in out, label


def test_upload_modes_give_the_engines_rows(tmp_path, monkeypatch):
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.lidar.loam_step import _polar_dirs
    from vloam_tpu_torch.tools.stages import profile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg, n_az = profile(True)
    chunk, n_chunks = 2, 2
    frames = upo.drive(chunk * (n_chunks + 1), cfg.lidar.n_scans, n_az, 1)
    assert max(int(f.max()) for f in frames) <= 4095
    dirs = _polar_dirs(cfg, n_az, None, torch.device("cpu"))
    rows = {m: upo.run_mode(m, frames, cfg, torch.device("cpu"), chunk,
                            n_chunks, dirs)["rows"] for m in upo.MODES}
    for m in "BCD":
        np.testing.assert_array_equal(rows[m].view(np.int32),
                                      rows["A"].view(np.int32), err_msg=m)
    eng = LoamEngine(cfg, chunk=chunk, device="cpu")
    for f in frames:
        eng.push_polar(f, range_scale=upo.RANGE_SCALE)
    np.testing.assert_array_equal(eng.finish().view(np.int32),
                                  rows["A"].view(np.int32))
    assert np.isfinite(rows["A"]).all() and len(rows["A"]) == len(frames)


@pytest.mark.parametrize("tool", ["profile_upload_overlap",
                                  "model_mesh_scaling", "bench_mesh",
                                  "diag_vo", "profile_lo2", "bench_knn"])
def test_new_tools_refuse_the_card_without_one(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    mod = importlib.import_module(f"vloam_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="is_available"):
        if tool == "diag_vo":
            mod.main([])
        else:
            mod.run()
