"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where torch sees no GPU;
on a GPU machine run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(--noconftest: the suite's conftest.py pins JAX to the CPU, and nothing here
needs JAX.)

- K1 select_rings: labels identical to select_rings_plain on random rings
  with exact curvature ties, short rings and a full ring, at the main path's
  [64, 2560] and at [64, 4100], and on every crafted case of
  vloam_tpu_torch/tools/kernel_cases.py (a window that crosses a sector's
  end, equal curvatures, sectors of one point, candidates that run out, the
  threshold, NaN and zero, widths up to 7000, whose sectors no longer fit
  the registers and whose ring needs the >48 KB shared-memory opt-in).
- K2 ring_min2: argmins identical and distances within 1e-6 relative of
  ring_min2_plain (the kernel rounds every product and sum as the plain
  version does), including duplicate points, all-SENTINEL rings, a query
  count that is not a multiple of the block and a slab of many tiles; every
  output identical on the crafted cases (duplicates across chunk and tile
  boundaries, the second minimum before the first, SENTINEL slots between
  live ones, one query, two slots).
- The xyz-ingest engine (LoamEngine.push) on the card against the same
  engine on the CPU: LO within 2e-2 m and MO within 3e-2 m, the tolerances
  of tests/test_golden_regression.py (the order of the LM and map sums
  differs between the devices).
- The engine on the card gives identical rows with TF32 / reduced-precision
  matmuls allowed and with them off; so does the combined engine
  (VloamEngine), whose matcher is the path's one cuBLAS product (run in
  float64, which TF32 never touches).
- K3 zncc_describe: within 1e-5 of zncc_describe_plain at the main path's
  [375, 1242] image and 2048 keypoints, p = 24 and 16, with zero rows
  (the 1e-3 floor) in the same places, on keypoints at the image's corners
  (clipping) and on a constant patch.
- S2 row_gather: bit-identical to table[idx] at both map row widths and at
  widths below, at and above a warp of 16-byte words, with repeated and
  boundary rows and a row count that is not a multiple of the block; widths
  that are not a multiple of 4 floats and int32 indices are refused.
- S1 ring_min1 and ring_argmin2: every output identical to the plain
  versions and to K2's, on the shapes and the ties of the K2 test.
- The batch engine on the card against the same engine on the CPU, the
  tolerances of the single engine's test.
"""

import numpy as np
import pytest
import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.lidar import ring_assoc as ra
from vloam_tpu_torch.lidar import scan_registration as sr
from vloam_tpu_torch.tools import kernel_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(16833)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Sel:
    """The selection constants of ScanRegistrationConfig's defaults."""

    curvature_threshold = 0.1
    n_sectors = 6
    max_sharp_per_sector = 2
    max_less_sharp_per_sector = 20
    max_flat_per_sector = 4


def _rings(rng, S, R):
    curv = rng.exponential(0.3, (S, R)).astype(np.float32)
    curv[:, ::7] = np.float32(0.5)  # exact ties across the ring
    brk = rng.random((S, R)) < 0.05
    bf = np.concatenate([np.zeros((S, 1), np.int32),
                         np.cumsum(brk[:, 1:], 1, dtype=np.int32)], 1)
    counts = rng.integers(0, R + 1, S).astype(np.int32)
    counts[:4] = [0, 11, 17, R]  # empty, too short, shortest selectable, full
    return curv, bf, counts


@pytest.mark.parametrize("R", [2560, 4100])
def test_select_rings_kernel_matches_plain(cuda, rng, R):
    curv, bf, counts = (torch.from_numpy(a).to(cuda)
                        for a in _rings(rng, 64, R))
    n0 = kernels.LAUNCHES["select_rings"]
    got = sr.select_rings(curv, bf, counts, _Sel)
    want = sr.select_rings_plain(curv, bf, counts, _Sel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_rings"] == n0 + 1
    assert (got != 0).sum() > 1000
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", kernel_cases.select_rings_cases(),
                         ids=lambda c: c.name)
def test_select_rings_kernel_crafted_cases(cuda, case):
    curv, bf, counts = (torch.from_numpy(a).to(cuda)
                        for a in (case.curv, case.bf, case.counts))
    got = sr.select_rings(curv, bf, counts, _Sel)
    want = sr.select_rings_plain(curv, bf, counts, _Sel)
    torch.cuda.synchronize()
    assert (want != 0).sum() > 100
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", kernel_cases.ring_min2_cases(),
                         ids=lambda c: c.name)
def test_ring_min2_kernel_crafted_cases(cuda, case):
    q = torch.from_numpy(case.queries).to(cuda)
    slab_t = torch.from_numpy(case.slab_t).to(cuda)
    got = ra.ring_min2(q, slab_t)
    want = ra.ring_min2_plain(q, slab_t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("Q,C", [(768, 128), (1536, 512), (777, 5000)])
def test_ring_min2_kernel_matches_plain(cuda, rng, Q, C):
    S = 64
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    for s in range(1, S):
        n = int(rng.integers(1, C + 1))
        slab[s, :n] = rng.uniform(-40, 40, (n, 3))
    slab[3, 9] = slab[3, 2]  # duplicates: exact ties
    slab[3, C - 1] = slab[3, 2]
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    q[0] = slab[3, 2]
    q_t = torch.from_numpy(q).to(cuda)
    slab_t = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(0, 2, 1))).to(cuda)
    n0 = kernels.LAUNCHES["ring_min2"]
    got = ra.ring_min2(q_t, slab_t)
    want = ra.ring_min2_plain(q_t, slab_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_min2"] == n0 + 1
    for i in (1, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0)
    assert (got[1][0] == 0).all() and (got[3][0] == 1).all()  # all-SENTINEL
    assert int(got[1][3, 0]) == 2 and int(got[3][3, 0]) == 9


@pytest.mark.parametrize("Q,C", [(768, 128), (1536, 512), (777, 5000)])
def test_ring_min1_and_argmin2_kernels_match_plain_and_k2(cuda, rng, Q, C):
    S = 64
    slab = np.full((S, C, 3), ra.SENTINEL, np.float32)
    for s in range(1, S):
        n = int(rng.integers(1, C + 1))
        slab[s, :n] = rng.uniform(-40, 40, (n, 3))
    slab[3, 9] = slab[3, 2]  # duplicates: exact ties
    slab[3, C - 1] = slab[3, 2]
    q = rng.uniform(-40, 40, (Q, 3)).astype(np.float32)
    q[0] = slab[3, 2]
    q_t = torch.from_numpy(q).to(cuda)
    slab_t = torch.from_numpy(np.ascontiguousarray(
        slab.transpose(0, 2, 1))).to(cuda)
    n1, n2 = kernels.LAUNCHES["ring_min1"], kernels.LAUNCHES["ring_argmin2"]
    got1 = ra.ring_min1(q_t, slab_t)
    got2 = kernels.ring_argmin2(q_t, slab_t)
    k2 = ra.ring_min2(q_t, slab_t)
    want = ra.ring_min2_plain(q_t, slab_t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_min1"] == n1 + 1
    assert kernels.LAUNCHES["ring_argmin2"] == n2 + 1
    for g, w in zip(got1, ra.ring_min1_plain(q_t, slab_t)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w, k in zip(got2, want, k2):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, k)
    assert int(got1[1][3, 0]) == 2 and int(got2[3][3, 0]) == 9


@pytest.mark.parametrize("W,N", [(96, 16384), (48, 49152), (4, 1000),
                                 (128, 777), (260, 513)])
def test_row_gather_kernel_is_bit_identical(cuda, rng, W, N):
    from vloam_tpu_torch.lidar import gridmap

    nb = 1 << 12
    table = torch.from_numpy(
        rng.normal(size=(nb, W)).astype(np.float32)).to(cuda)
    table[5] = float("nan")  # payload bits travel untouched
    idx = rng.integers(0, nb, N)
    idx[:5] = [0, nb - 1, 5, 5, 7]
    idx = torch.from_numpy(idx).to(cuda)
    n0 = kernels.LAUNCHES["row_gather"]
    got = gridmap.row_gather(table, idx)
    want = gridmap.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_gather"] == n0 + 1
    assert got.shape == (N, W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_refuses_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((64, 6), device=cuda)
    idx = torch.zeros((8,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.row_gather(table, idx)
    with pytest.raises(ValueError, match="int64"):
        kernels.row_gather(torch.zeros((64, 8), device=cuda), idx.int())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.row_gather(torch.zeros((64, 16), device=cuda)[:, ::2], idx)
    assert kernels.row_gather(torch.zeros((64, 8), device=cuda),
                              idx[:0]).shape == (0, 8)


def test_batch_engine_on_card_matches_cpu(cuda):
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine,
                                                 unpack_outputs)

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    streams = [scans, scans[::-1]]

    def run(dev):
        eng = BatchLoamEngine(cfg, 2, chunk=2, device=dev)
        for k in range(len(scans)):
            for b in range(2):
                eng.push(b, streams[b][k])
        return eng.finish()

    kernels.reset_launches()
    gpu = run(cuda)
    n = 2 * len(scans)
    assert kernels.LAUNCHES["row_gather"] == 4 * len(scans)
    assert kernels.LAUNCHES["ring_min1"] == 2 * n
    assert kernels.LAUNCHES["ring_min2"] == 2 * n
    assert kernels.LAUNCHES["select_rings"] == n
    cpu = run("cpu")
    for b in range(2):
        g, c = unpack_outputs(gpu[b]), unpack_outputs(cpu[b])
        np.testing.assert_allclose(g["t_w_lo"], c["t_w_lo"], atol=2e-2)
        np.testing.assert_allclose(g["t_w_mo"], c["t_w_mo"], atol=3e-2)


def _xyz_drive(cfg):
    from vloam_tpu_torch.data import synthetic

    scene = synthetic.urban_scene(42)
    poses = synthetic.drive_trajectory(4, speed=1.0, yaw_rate=0.015)
    return [synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                    n_azimuth=500, seed=k)
            for k, T in enumerate(poses)]


def _run_engine(cfg, scans, dev):
    from vloam_tpu_torch.lidar.loam_step import LoamEngine

    eng = LoamEngine(cfg, chunk=2, device=dev)
    for s in scans:
        eng.push(s)
    return eng.finish()


def test_xyz_engine_on_card_matches_cpu(cuda):
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.lidar.loam_step import unpack_outputs

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    res = {}
    for dev in ("cpu", cuda):
        kernels.reset_launches()
        res[str(dev)] = (unpack_outputs(_run_engine(cfg, scans, dev)),
                         dict(kernels.LAUNCHES))
    (cpu, n_cpu), (gpu, n_gpu) = res["cpu"], res["cuda"]
    assert not any(n_cpu.values())
    # per frame: K1 once, 2 association rounds (K2 surf, ring_min1 corner),
    # 2 map probes and 2 inserts through row_gather
    assert n_gpu == {"select_rings": 4, "ring_min2": 8, "ring_min1": 8,
                     "row_gather": 16, "zncc_describe": 0, "ring_argmin2": 0}
    np.testing.assert_allclose(gpu["t_w_lo"], cpu["t_w_lo"], atol=2e-2)
    np.testing.assert_allclose(gpu["t_w_mo"], cpu["t_w_mo"], atol=3e-2)


def _tf32_on_and_off(run):
    """run() with TF32 / "medium" matmul precision off, then on."""
    off = run()
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = run()
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return off, on


def test_engine_on_card_ignores_tf32_settings(cuda):
    """The CUDA path does its float32 products as broadcast multiplies and
    sums (no cuBLAS call), so a process that allows TF32 matmuls gets the
    same rows, bit for bit, as one that does not."""
    from vloam_tpu_torch.config import tiny_test_profile

    cfg = tiny_test_profile()
    scans = _xyz_drive(cfg)
    off, on = _tf32_on_and_off(lambda: _run_engine(cfg, scans, cuda))
    assert np.isfinite(off).all()
    np.testing.assert_array_equal(on, off)


def _vloam_drive(n=4, w=320, h=96, n_scans=16):
    """A small polar camera + LiDAR drive and its calibration."""
    from vloam_tpu_torch.data import synthetic

    scene = synthetic.urban_scene(2)
    K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(w, h)

    class Calib:
        pass

    calib = Calib()
    calib.K = K
    calib.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    calib.imu_T_velo = np.eye(4)
    calib.imu_T_cam0 = velo_T_cam
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.015)
    frames = [(synthetic.simulate_scan_polar(scene, T, n_scans=n_scans,
                                             n_azimuth=900, seed=k),
               synthetic.render_camera(scene, T @ velo_T_cam, K, w, h))
              for k, T in enumerate(poses)]
    return calib, frames


def test_vloam_engine_on_card_ignores_tf32_settings(cuda):
    """The combined engine's rows are bit-identical with TF32 allowed: its
    one cuBLAS product (the matcher's similarity) runs in float64."""
    from vloam_tpu_torch.config import tiny_test_profile
    from vloam_tpu_torch.vloam_step import VloamEngine

    cfg = tiny_test_profile().replace(detach_VO_LO=False)
    calib, frames = _vloam_drive()

    def run():
        eng = VloamEngine(cfg, calib, chunk=2, device=cuda)
        for r, img in frames:
            eng.push_polar(r, img)
        return eng.finish()

    kernels.reset_launches()
    off, on = _tf32_on_and_off(run)
    assert kernels.LAUNCHES == {"select_rings": 8, "ring_min2": 16,
                                "ring_min1": 16, "row_gather": 32,
                                "zncc_describe": 8, "ring_argmin2": 0}
    assert np.isfinite(off).all() and (off[1:, 31] > 0).all()
    np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("p", [24, 16])
def test_zncc_describe_kernel_matches_plain(cuda, p):
    """K3 at the main path's shape: keypoints from detect_keypoints on a
    rendered 1242 x 375 frame, plus crafted rows at the corners (clipped
    patches) and on a constant patch (the floor)."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.vision import features as tf

    calib, frames = _vloam_drive(n=1, w=1242, h=375)
    img = torch.from_numpy(frames[0][1]).to(cuda)
    img[300:, :64] = 0.25  # a constant patch at the bottom-left
    vo = kitti_hdl64().vo
    xy, _, mask = tf.detect_keypoints(img, vo)
    assert int(mask.sum()) > 500
    crafted = torch.tensor([[0.0, 0.0], [1241.9, 0.0], [0.0, 374.9],
                            [1241.9, 374.9], [20.0, 350.0], [-3.5, 7.2],
                            [620.4, 187.6], [5.0, 200.0]], device=cuda)
    xy = torch.cat([xy[:-8], crafted]).contiguous()
    n0 = kernels.LAUNCHES["zncc_describe"]
    got = tf.zncc_describe(img, xy, p)
    want = tf.zncc_describe_plain(img, xy, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["zncc_describe"] == n0 + 1
    assert got.shape == (2048, p * p)
    zero_g, zero_w = (got == 0).all(1), (want == 0).all(1)
    assert torch.equal(zero_g, zero_w) and bool(zero_g[-4])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
