"""The port's combined camera + LiDAR engine (VloamEngine) against the JAX
reference, on the CPU at the small test profile
(tests/test_pipeline.py::small_cfg with detach_VO_LO=False: each LO solve
seeded from the same frame's VO).

- push (xyz ingest) and push_polar with pack12 on, 4 frames in chunks of 2:
  LO trajectory to 1e-3 m, MO to 1e-2 m, VO to 2e-3 m, and the 3D-2D /
  epipolar match counts n32 / n22 identical. The LO and MO bounds are those
  of the LiDAR-only engine's tests (tests/test_torch_loam_engine.py: the
  port associates with exact distances where the JAX engine quantizes, and
  the mapping's plane fits amplify rounding); VO solves a 24-iteration LM
  on ~30 matches with Huber 0.05, factored by LU in the port and by
  Cholesky in the reference.
- one frame on state carried over from the JAX engine through convert.py
  (both loops, the assembled row) to the same bounds; the round trip of
  that state is bit-exact.
- the ORB detector, ORB descriptors and the FLANN matcher together, over
  the xyz drive, to the same bounds. The reference's engine state holds
  [K, p*p] descriptors whatever the descriptor, so its ORB engine runs only
  at p = 16 (16 * 16 = 256 bits); the test runs both engines there.
- the engine's host side: off-size images are fitted, the polar FOV wedge
  is checked, a mesh on another device than asked for is refused, and the
  new modules import neither jax nor the JAX package.
The four VO options CLAHE, bucket NMS, LK flow matching and the low-texture
fallback are held to the JAX engine in tests/test_torch_optical_flow.py.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vloam_tpu import vloam_step as jvs
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu_torch import convert
from vloam_tpu_torch import vloam_step as tvs
from vloam_tpu_torch.lidar.loam_step import LoamEngine

from test_pipeline import small_cfg, synth_setup

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG = small_cfg(detach_VO_LO=False)
N = 4
SCALE = 0.03  # pack12 needs range / scale < 4096: 122.8 m reach


def _polar_setup():
    """4 polar frames of the drive of tests/test_vloam_engine.py."""
    scene = jsyn.urban_scene(2)
    K, P_rect0, _, velo_T_cam = jsyn.default_cam_calib(
        CFG.vo.img_width, CFG.vo.img_height)

    class C:
        pass

    calib = C()
    calib.K = K
    calib.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    calib.imu_T_velo = np.eye(4)
    calib.imu_T_cam0 = velo_T_cam
    poses = jsyn.drive_trajectory(N, speed=1.0, yaw_rate=0.015)
    frames = [(jsyn.simulate_scan_polar(scene, T, n_scans=64, n_azimuth=900,
                                        seed=k, range_scale=SCALE),
               jsyn.render_camera(scene, T @ velo_T_cam, K,
                                  CFG.vo.img_width, CFG.vo.img_height))
              for k, T in enumerate(poses)]
    return calib, frames


@pytest.fixture(scope="module")
def xyz_drive():
    """The JAX engine over 4 xyz frames (chunk 2), with its state after
    frame 1 copied out before the next chunk."""
    calib, frames, gt = synth_setup(N, seed=2)
    frames = list(frames())
    eng = jvs.VloamEngine(CFG, calib, chunk=2)
    for k, f in enumerate(frames):
        eng.push(f["points"], f["image"])
        if k == 1:
            st1 = jax.tree.map(np.asarray, eng.state)
    return calib, frames, st1, eng.finish()


@pytest.fixture(scope="module")
def polar_drive():
    calib, frames = _polar_setup()
    eng = jvs.VloamEngine(CFG, calib, chunk=2, pack12=True)
    for r, img in frames:
        eng.push_polar(r, img, range_scale=SCALE)
    return calib, frames, eng.finish()


def _check_rows(got, want, calib):
    t = tvs.unpack_vloam_outputs(got, calib)
    j = jvs.unpack_vloam_outputs(want, calib)
    for which, tol in (("LO", 1e-3), ("MO", 1e-2), ("VO", 2e-3)):
        np.testing.assert_allclose(t[f"traj_{which}"], j[f"traj_{which}"],
                                   rtol=0, atol=tol, err_msg=which)
    np.testing.assert_array_equal(t["n32"], j["n32"])
    np.testing.assert_array_equal(t["n22"], j["n22"])
    assert (j["n32"][1:] > 0).all() and (j["n22"][1:] > 0).all()
    return t


def test_push_matches_jax_engine(xyz_drive):
    calib, frames, _, outs_j = xyz_drive
    eng = tvs.VloamEngine(CFG, calib, chunk=2, device="cpu")
    for f in frames:
        eng.push(f["points"], f["image"])
    outs = eng.finish()
    assert outs.shape == (N, tvs.VLOAM_OUT_DIM) and np.isfinite(outs).all()
    _check_rows(outs, outs_j, calib)


def test_push_polar_pack12_matches_jax_engine(polar_drive):
    calib, frames, outs_j = polar_drive
    eng = tvs.VloamEngine(CFG, calib, chunk=2, device="cpu", pack12=True)
    for r, img in frames:
        eng.push_polar(r, img, range_scale=SCALE)
    res = _check_rows(eng.finish(), outs_j, calib)
    assert res["traj_VO"][-1, 2, 3] > 2.0  # the VO stream moves forward


def test_orb_flann_engine_matches_jax_engine(xyz_drive):
    calib, frames, _, _ = xyz_drive
    # fast_threshold: tests/test_vision.py's for the synthetic images (the
    # default, 100/255, finds few corners on them)
    vo = dataclasses.replace(CFG.vo, detector="orb", descriptor="orb",
                             matcher="flann", descriptor_patch=16,
                             fast_threshold=0.06)
    cfg = CFG.replace(vo=vo)
    outs = []
    for eng in (jvs.VloamEngine(cfg, calib, chunk=2),
                tvs.VloamEngine(cfg, calib, chunk=2, device="cpu")):
        for f in frames:
            eng.push(f["points"], f["image"])
        outs.append(eng.finish())
    want, got = outs
    assert np.isfinite(got).all()
    _check_rows(got, want, calib)


def test_frame_on_carried_state_matches_jax_engine(xyz_drive):
    """Frame 2 through both loops from the JAX engine's state after frame
    1, converted by convert.py."""
    calib, frames, st1, outs_j = xyz_drive
    vstate, mstate = convert.vloam_state_from_numpy(st1, "cpu")
    assert int(vstate.frame_idx) == 2 and int(mstate.frame_idx) == 2
    f = frames[2]
    pts, n = tvs.pad_scan(f["points"], CFG.lidar.max_points)
    img = tvs._fit_image(tvs._to_u8(f["image"]), CFG.vo)
    ext = tvs.CamExtrinsics.from_calib(calib, "cpu")
    vstate, vl_out, stacks = tvs.vision_lo_run_chunk(
        vstate, torch.from_numpy(pts)[None], torch.tensor([n]),
        torch.from_numpy(img)[None], ext, CFG)
    mstate, mo_out = tvs.mapping_run_chunk(
        mstate, *stacks, vl_out[:, 7:11], vl_out[:, 11:14], CFG)
    row = torch.cat([vl_out[:, :14], mo_out[:, :7], vl_out[:, 14:16],
                     mo_out[:, 7:8], vl_out[:, 16:]], dim=1)[0].numpy()
    want = outs_j[2]
    np.testing.assert_allclose(row[:14], want[:14], atol=1e-4)  # LO
    np.testing.assert_allclose(row[14:21], want[14:21], atol=5e-3)  # MO
    np.testing.assert_allclose(row[24:31], want[24:31], atol=1e-3)  # VO
    np.testing.assert_array_equal(row[31:], want[31:])  # n32, n22
    assert abs(row[21] - want[21]) <= 2 and abs(row[22] - want[22]) <= 2
    assert int(vstate.frame_idx) == 3 and int(mstate.frame_idx) == 3


def test_vloam_convert_round_trip_is_exact(xyz_drive):
    st1 = xyz_drive[2]
    back = convert.vloam_state_to_numpy(
        *convert.vloam_state_from_numpy(st1, "cpu"))
    a, b = jax.tree.leaves(st1), jax.tree.leaves(tuple(back))
    assert len(a) == len(b) == 23
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_engine_fits_off_size_images(xyz_drive):
    """KITTI image sizes vary per sequence: the engine crops / zero-pads
    bottom-right as the reference does."""
    calib, frames, _, _ = xyz_drive
    vo = CFG.vo
    for shape in ((vo.img_height + 1, vo.img_width - 1),
                  (vo.img_height - 2, vo.img_width + 3)):
        img = np.arange(np.prod(shape)).reshape(shape).astype(np.uint8)
        np.testing.assert_array_equal(tvs._fit_image(img, vo),
                                      jvs._fit_image(img, vo))
    eng = tvs.VloamEngine(CFG, calib, chunk=2, device="cpu")
    for f in frames[:2]:
        eng.push(f["points"], f["image"][:vo.img_height - 2,
                                         :vo.img_width - 3])
    assert np.isfinite(eng.finish()).all()


def test_engine_rejects_what_is_not_ported(xyz_drive):
    calib = xyz_drive[0]
    # a mesh runs on its own device: a CPU mesh with the card asked for is
    # refused by both engines (tests/test_torch_mesh.py runs them on one)
    from vloam_tpu_torch.parallel.sharded import data_mesh

    mesh = data_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tvs.VloamEngine(CFG, calib, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="mesh"):
        LoamEngine(CFG, mesh=mesh, device="cuda")
    # a camera yawed outside the decoded polar wedge is refused loudly
    yawed = type(calib)()
    yawed.__dict__.update(calib.__dict__)
    T = np.array(calib.imu_T_cam0, float)
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ T[:3, :3]
    yawed.imu_T_cam0 = T
    with pytest.raises(ValueError, match="polar_fov_fraction"):
        tvs.VloamEngine(CFG, yawed, device="cpu")
    with pytest.raises(ValueError, match="mix"):
        eng = tvs.VloamEngine(CFG, calib, device="cpu")
        eng.push(np.zeros((10, 3), np.float32), np.zeros((96, 320)))
        eng.push_polar(np.zeros((64, 900), np.uint16), np.zeros((96, 320)))


def test_vision_modules_never_import_jax():
    code = ("import sys, vloam_tpu_torch.vloam_step, vloam_tpu_torch.convert, "
            "vloam_tpu_torch.vision.features, vloam_tpu_torch.vision.vo, "
            "vloam_tpu_torch.vision.depth_map, "
            "vloam_tpu_torch.vision.optical_flow, "
            "vloam_tpu_torch.fusion.frame_chain; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vloam_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
